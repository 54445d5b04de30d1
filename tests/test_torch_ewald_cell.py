"""The benchmark's Ewald cell (`ewald_2x64.full`: lcdm_gas.param built with
PERIODIC and without PMGRID, the periodic pure tree with its lattice
correction) on the CPU, cut to 2 x 8^3 with lattice tables of EN 16.

 * the cut cell runs through the benchmark's harness and comes out
   `correct` against the plain reference (`portbench/reference/`: the
   Ewald sum, SPH, the integrator) under the cell's own limits;
 * the same run with the lattice tables taken away (the walk's minimum
   image alone; `tools/port_studies/lattice_left_out.py`'s fault) reads
   `gravity_l2_rel` above the cell's limit;
 * the lattice pass's twin sees exactly the solver's valid pairs n_ia (so
   `lattice.roofline_pct` may count K3's pairs by n_ia), and the tables'
   build is the solver's `lattice.tables` span;
 * each step makes the host reads of its path's read sites, pinned as
   tests/test_torch_trace.py pins the open and the TreePM gas boxes.

The walk goes in batches of 32 blocks: the 2 x 8^3 tree holds fewer than
32 target blocks, so one batch walks them all, and a batch of 128 would
quadruple the twins' padded work.  The solver is asked for the tree: the
port would take its direct sum at this size.  This file imports no JAX;
the suite's conftest does, for other files, so the harness's refusal of a
run that loaded it is lifted here.
"""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "portbench"))
sys.path.insert(0, os.path.join(ROOT, "tools", "port_studies"))

import harness  # noqa: E402
from lattice_left_out import lattice_left_out  # noqa: E402

from ngravs_tpu_torch.ops import walk as twalk  # noqa: E402
from ngravs_tpu_torch.ops.solver import GravitySolver  # noqa: E402

torch.set_num_threads(1)

CELL = "ewald_2x64.full"
NSIDE, EN, BATCH = 8, 16, 32
SEED = 2 ** 31 + 17


def small_cell() -> harness.Cell:
    c = harness.Cell(CELL)
    c.config["ic"]["n_side"] = NSIDE
    c.config["port"].update(walk_batch_blocks=BATCH, ngravs_en=EN,
                            solver="tree")
    box = c.config["param"]["BoxSize"]
    for k in ("SofteningGas", "SofteningHalo"):
        c.config["param"][k] = box / NSIDE / 30
    c.workload["check"].update(grav_targets=256, gas_targets=128)
    return c


def run(cell, monkeypatch):
    monkeypatch.setattr(harness, "FORBIDDEN", ())
    with open(os.devnull, "w") as null:
        return harness.run(cell, SEED, 0.5, False, time.perf_counter(),
                           device="cpu", stream=null)


@pytest.fixture(scope="module")
def recorded():
    """One run of the cut cell through the harness, recording each step's
    change of the trace's counters, each gravity solve's n_ia and walk
    attempts, and the valid pairs of each lattice pass the solve made."""
    from ngravs_tpu_torch.integrate.runner import Simulation
    mp = pytest.MonkeyPatch()
    out = dict(steps=[], solves=[], sims=[])
    real_step, real_compute = Simulation.step, GravitySolver.compute
    real_pass = twalk.lattice_pass

    def step(self):
        out["sims"][:] = [self]
        c0 = dict(self.trace.counts)
        real_step(self)
        out["steps"].append({k: v - c0.get(k, 0)
                             for k, v in self.trace.counts.items()})

    def compute(self, *a, **kw):
        a0 = self.trace.counts.get("walk.attempts", 0)
        out["solves"].append(dict(pairs=[]))
        res = real_compute(self, *a, **kw)
        out["solves"][-1].update(n_ia=res[1], attempts=self.trace.counts[
            "walk.attempts"] - a0)
        return res

    def lattice_pass(targets, sp, n_src, tables, n_gravs, box, want_pot=True,
                     corners=None):
        g = targets["x"].shape[0] // sp.shape[0]
        valid = twalk._pair_geometry(targets, sp, slice(None), n_src, g,
                                     box)[1]
        out["solves"][-1]["pairs"].append(int(valid.sum()))
        return real_pass(targets, sp, n_src, tables, n_gravs, box, want_pot,
                         corners=corners)
    mp.setattr(Simulation, "step", step)
    mp.setattr(GravitySolver, "compute", compute)
    mp.setattr(twalk, "lattice_pass", lattice_pass)
    try:
        out["result"] = run(small_cell(), mp)
    finally:
        mp.undo()
    return out


def test_the_cut_cell_is_correct(recorded):
    res = recorded["result"]
    assert res["correct"] is True, res["check"]
    assert set(res["check"]) == {
        "gravity_l2_rel", "density_max_rel", "ngb_window_dev",
        "hydro_rms_rel", "drift_max_ulp", "kick_max_rel", "stalled_steps"}


def test_without_the_lattice_correction_gravity_fails(monkeypatch):
    cell = small_cell()
    # one warm-up step: the fault shows in the first force pass
    cell.traffic["warmup"].update(min_steps=1, stable_steps=0)
    with lattice_left_out():
        res = run(cell, monkeypatch)
    g = res["check"]["gravity_l2_rel"]
    assert res["correct"] is False
    assert g["value"] > g["limit"], g


def test_the_twins_valid_pairs_are_the_solvers_n_ia(recorded):
    sim = recorded["sims"][0]
    assert sim.solver.lattice_tables is not None
    assert sim.solver.pm is None and not sim.solver.uses_direct(sim.p.n)
    assert sim.trace.timers["lattice.tables"] > 0
    one = [s for s in recorded["solves"] if s["attempts"] == 1]
    assert len(one) >= 3
    for s in one:
        assert s["n_ia"] > 0 and sum(s["pairs"]) == s["n_ia"], s


def test_ewald_steps_pin_their_host_reads(recorded):
    steps = recorded["steps"]
    assert len(steps) >= 4
    for k, c in enumerate(steps):
        iters = c["sph.density_iters"]
        growths = c.get("sph.cap_growths", 0)
        # the general step's 3; the gravity solve's (a build's fat-leaf
        # read, three a walk attempt, the interaction count), the first
        # build's octet measure and one a walk batch for the lattice
        # twin's longest list; SPH: the active gas count, the target
        # blocking, two a density iteration, the hydro gather's overflow
        # flag; the comoving displacement constraint
        want = 3 + (c["tree.builds"] + 3 * c["walk.attempts"] + 1) \
            + (1 if k == 0 else 0) + c["walk.batches"] \
            + (1 + 2 + 2 * iters + 1) + 1
        assert want + 2 * growths <= c["host_reads"] <= want + 3 * growths
        # gravity, hydro, timeline: no PM
        assert c["syncs"] == 3
        assert "k3.lattice" not in c
    # pinned: the geometric criterion from the first step (no relative
    # bootstrap), one attempt and one batch a solve, one density
    # iteration: 3 + (1 + 3 + 1) + 1 + 1 + 6 + 1 = 17 on the first step,
    # 16 on a rebuilt tree after it
    assert steps[0]["host_reads"] == 17
    settled = [c for c in steps[1:] if c["sph.density_iters"] == 1
               and c["walk.attempts"] == 1 and c["walk.batches"] == 1
               and not c.get("sph.cap_growths")]
    assert settled and all(c["host_reads"] == 16 for c in settled)


# 12 ms of K3 over 2 solves; 1e9 pairs of 96 operations over 67 TFLOP/s
# (1.433 ms) over 12 ms
@pytest.mark.parametrize("name, want", [
    ("lattice.ms_per_solve", 6.0),
    ("lattice.roofline_pct", 100 * 96e9 / 67e12 / 0.012)])
def test_lattice_metrics_read_k3_by_name(name, want):
    """K3's time is every device operation whose name holds
    `lattice_kernel` (K1's `pairwise_kernel` is not it); nothing where K3
    is not among the largest operations."""
    read = harness.load_module("metrics", name).read
    ops = [["void (anonymous namespace)::lattice_kernel<4, false>"
            "(LatticeArgs)", 0.010],
           ["void pairwise_kernel<6>(Args)", 0.004],
           ["void (anonymous namespace)::lattice_kernel<4, true>"
            "(LatticeArgs)", 0.002]]
    prof = dict(breakdown=dict(device_ops=ops), updates=1 << 20,
                counts=dict(solves=2, n_ia=10 ** 9))
    assert read(dict(profile=prof)) == pytest.approx(want)
    prof["breakdown"]["device_ops"] = ops[1:2]
    assert read(dict(profile=prof)) is None
