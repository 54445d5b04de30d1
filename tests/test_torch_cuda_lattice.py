"""K3 on the card: the periodic pure-tree walk's lattice (Ewald) pass
(`csrc/lattice.cu`) against its plain twin (`ops/walk.py`
`lattice_pass_torch`) on the card, from the same inputs.

The inputs are the walk's own: the benchmark's Ewald box
(`ewald_2x64.full`, lcdm_gas.param without PMGRID) cut to 2 x 16^3 with
lattice tables of EN 16, whose fresh solver walks with its caps cut (16
chunks a block, 32 frontier slots a level) so that its first attempts
overflow and are thrown away before the settled one; then a settled
solver's pass with the potential.  Every lattice pass of those passes is
recorded (`chip_smoke.record_lattice`), and each launch is held to the
twin as the walk received it and launched again with the potential off
and on: each component within RTOL_TERMS = 1e-5 of its target's sum of
|terms| (a pair's term is the twin's bit for bit; K3 sums the terms in
float64, the twin in float32).  `chip_smoke.py` phase 7 holds every launch of the 2 x 64^3
box's settling pass to the twin the same way.

Then the box steps on the card: one K3 launch a walk batch (`k3.lattice`),
and no host read of the batch's longest list (the twin's cut), so a step
reads the CPU's count less one a batch.

Every test here needs an NVIDIA GPU and skips without one; the file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_lattice.py
"""

import os
import sys
import tempfile

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "portbench"))

import chip_smoke as cs  # noqa: E402
import harness  # noqa: E402

from ngravs_tpu_torch.ops import lattice as tlat  # noqa: E402
from ngravs_tpu_torch.ops.solver import GravitySolver  # noqa: E402

pytestmark = pytest.mark.cuda
NSIDE, EN = 16, 16
SEED = 2 ** 31 + 29
CUT = dict(chunk=16, frontier=32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def ewald_box(dev, tmp):
    c = harness.Cell("ewald_2x64.full")
    c.config["ic"]["n_side"] = NSIDE
    c.config["port"].update(ngravs_en=EN, walk_batch_blocks=32,
                            solver="tree")
    box = c.config["param"]["BoxSize"]
    for k in ("SofteningGas", "SofteningHalo"):
        c.config["param"][k] = box / NSIDE / 30
    sim = harness.make_simulation(c, SEED, dev, tmp)
    assert sim.solver.lattice_tables is not None and sim.solver.pm is None
    assert not sim.solver.uses_direct(sim.p.n)
    return sim


def _solver(sim, cut=None):
    s = GravitySolver(sim.cfg, sim.wiring, sim.force_soft, sim.units.G,
                      hubble=sim.units.hubble, device=sim.device)
    s.fcaps.update(cut or {})
    return s


def test_every_launch_of_settling_and_overflowing_passes(cuda):
    with tempfile.TemporaryDirectory() as tmp:
        sim = ewald_box(cuda, tmp)
        p = cs.all_active(sim)
        # the cut caps: attempts that overflow, then the settled one
        solver = _solver(sim, CUT)
        k1, attempts, k3 = [], [], []
        with cs.record_lattice(k3), cs.record_attempts(solver, k1, attempts):
            solver.compute(p, sim.ti_current, p.n)
        assert cs.overflowing(attempts) > 0 and not attempts[-1][2]
        assert len(k3) == len(k1) and not any(a[6] for a in k3)
        cs.check_every_lattice_launch("cut caps", k3, attempts)
        # a settled solver's pass with the potential
        k3_pot = []
        with cs.record_lattice(k3_pot):
            solver.compute(p, sim.ti_current, p.n, want_pot=True)
        assert k3_pot and all(a[6] for a in k3_pot)
        cs.check_every_lattice_launch("potential", k3_pot)
        assert solver.trace.counts["k3.lattice"] \
            == solver.trace.counts["walk.batches"]


def test_steps_launch_k3_once_a_batch_and_read_no_list(cuda):
    with tempfile.TemporaryDirectory() as tmp:
        sim = ewald_box(cuda, tmp)
        for k in range(3):
            c0 = dict(sim.trace.counts)
            sim.step()
            c = {n: v - c0.get(n, 0) for n, v in sim.trace.counts.items()}
            assert c["k3.lattice"] == c["walk.batches"] > 0
            iters = c["sph.density_iters"]
            growths = c.get("sph.cap_growths", 0)
            # tests/test_torch_ewald_cell.py's count without the twin's
            # read a batch
            want = 3 + (c["tree.builds"] + 3 * c["walk.attempts"] + 1) \
                + (1 if k == 0 else 0) + (1 + 2 + 2 * iters + 1) + 1
            assert want + 2 * growths <= c["host_reads"] \
                <= want + 3 * growths, c
        assert bool(torch.isfinite(sim.p.accel).all())


def test_k3_refuses_what_it_does_not_take(cuda):
    tabs = torch.zeros(4, EN + 1, EN + 1, EN + 1, 4, device=cuda)
    targets = {k: torch.zeros(64, 1, device=cuda, dtype=torch.int32
                              if k in ("grav", "gid") else torch.float32)
               for k in ("x", "y", "z", "grav", "gid")}
    sp = torch.zeros(1, 8, 32, device=cuda)
    n_src = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tlat.lattice_eval_cuda(targets, sp.cpu(), n_src, tabs, 2, 10.0)
    with pytest.raises(ValueError):
        tlat.lattice_eval_cuda(targets, sp, n_src.long(), tabs, 2, 10.0)
    with pytest.raises(ValueError):
        tlat.lattice_eval_cuda(targets, sp, n_src, tabs, 3, 10.0)
    with pytest.raises(ValueError):
        tlat.lattice_eval_cuda(targets, sp, n_src, tabs, 2, 0.0)
    with pytest.raises(ValueError):
        tlat.k3_lanes(512)
    acc, pot = tlat.lattice_eval_cuda(targets, sp, n_src, tabs, 2, 10.0)
    assert not bool(acc.any()) and not bool(pot.any())
