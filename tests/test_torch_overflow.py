"""Walk attempts that overflow: the port against the JAX package, on the CPU.

A fresh solver's force pass with its caps cut so that its first walk
attempts overflow (the solver throws their results away, grows its caps
and walks again), on phase 13d's configuration of chip_smoke.py at
3 x 8^3: three jittered lattices a quarter cell apart, the first gas, the
three_species wiring, TreePM at PMGRID 16 (the card's 3 x 64^3 at 128),
walk batches of 16 blocks (the card's 128 would pad the twin's work
eightfold here).  The chunk cap is cut to 16 chunks a block and the
frontier caps to 32 slots a level: the first attempt overflows both
(105 chunks asked for, a level of 64 slots cut to 32).

 * every recorded K1 launch's live rows are well formed: gid -2 (a node),
   -1 (padding) or a particle; the gravity of every valid row and every
   target in range; every value finite;
 * the twin on each launch of an overflowing attempt agrees with JAX's
   Pallas kernel in interpret mode within 1e-5 of each target's sum of
   |terms|, pair counts equal;
 * the solver's accelerations after its retries equal a settled
   solver's within 1e-6 of each |a|, and JAX's GravitySolver's with the
   same cut caps within the walk tests' 1e-5 of each |a| (of the median
   |a| where a particle's own cancels below it: a lattice particle's
   short-range pull sums to 2.6% of the median, and the packages' float32
   sums differ by 2.9e-5 of it in a settled pass alike), interaction
   counts equal.

The card found K1 and the twin on either side of the TreePM cut u = 3 for
rows an ulp from it (nvcc had contracted r^2 into fused multiply-adds);
K1 now rounds r^2 once an operation, as the Pallas source writes it and
the twin computes it.  The twin's side of the cut for such rows is held
here to that rounding (test_torch_cuda.cut_pairs' rows); the card holds
K1 to the twin on the same rows.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ngravs_tpu.config import read_parameter_file as j_read
from ngravs_tpu.integrate.runner import Simulation as JSim
from ngravs_tpu.ops.pairwise_pallas import make_pairwise_kernel
from ngravs_tpu.ops.solver import GravitySolver as JSolver

from ngravs_tpu_torch.config import read_parameter_file as t_read
from ngravs_tpu_torch.integrate.runner import Simulation as TSim
from ngravs_tpu_torch.ops.pairwise import IGID, IGRAV, pairwise_eval_torch
from ngravs_tpu_torch.ops.solver import GravitySolver as TSolver

import test_torch_cuda

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

# tiny tensors: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

NSIDE = 8
RTOL_TERMS = 1e-5
CUT = dict(chunk=16, frontier=32)


@pytest.fixture(scope="module")
def boxes(tmp_path_factory):
    """The configuration read by both packages from one parameterfile,
    and each package's Simulation at its IC."""
    run_dir = str(tmp_path_factory.mktemp("overflow"))
    param = cs.write_gas_box(run_dir, ns=NSIDE, name="three", three=True)
    kw = dict(pmgrid=2 * NSIDE, n_gravs=3, wiring="three_species",
              pm_interlace=True, walk_batch_blocks=16)
    tsim = TSim(t_read(param, **kw), log_dir="", device="cpu")
    jsim = JSim(j_read(param, **kw), log_dir="")
    assert tsim.p.n == 3 * NSIDE ** 3 and tsim.solver.treepm is not None
    return tsim, jsim


def _port_solver(tsim, cut=None):
    s = TSolver(tsim.cfg, tsim.wiring, tsim.force_soft, tsim.units.G,
                hubble=tsim.units.hubble, device="cpu")
    s.fcaps.update(cut or {})
    return s


@pytest.fixture(scope="module")
def cut_pass(boxes):
    """The port's pass with the cut caps: its launches, its attempts and
    its particles after the retries."""
    tsim, _ = boxes
    solver = _port_solver(tsim, CUT)
    launched, attempts = [], []
    with cs.record_attempts(solver, launched, attempts):
        p, n_ia, _ = solver.compute(cs.all_active(tsim), tsim.ti_current,
                                    tsim.p.n)
    assert cs.overflowing(attempts) > 0 and not attempts[-1][2]
    return launched, attempts, p, n_ia


def test_overflowing_launches_hold_well_formed_rows(boxes, cut_pass):
    tsim, _ = boxes
    n, ng = tsim.p.n, tsim.cfg.n_gravs
    launched, _, _, _ = cut_pass
    for targets, sp, n_src, _, _ in launched:
        live = torch.arange(sp.shape[2])[None, :] < n_src
        gid = sp[:, IGID].view(torch.int32)
        grav = sp[:, IGRAV].view(torch.int32)
        ok_gid = (gid == -2) | (gid == -1) | ((gid >= 0) & (gid < n))
        assert bool(ok_gid[live].all())
        valid = live & (gid != -1)
        assert bool(((grav >= 0) & (grav < ng))[valid].all())
        assert bool(torch.isfinite(sp[:, :6].permute(0, 2, 1)[live]).all())
        tg = targets["gid"].reshape(-1)
        tgrav = targets["grav"].reshape(-1)
        assert bool(((tgrav >= 0) & (tgrav < ng))[tg >= 0].all())
        for k in ("x", "y", "z", "mass", "fsoft"):
            assert bool(torch.isfinite(targets[k]).all())


def test_overflowing_launches_twin_matches_pallas(boxes, cut_pass):
    _, jsim = boxes
    launched, attempts, _, _ = cut_pass
    checked = 0
    for first, end, ovf, _ in attempts:
        for targets, sp, n_src, want_pot, kw in launched[first:end]:
            if not ovf:
                continue
            nb, _, s = sp.shape
            g = targets["x"].shape[0] // nb
            jfn = make_pairwise_kernel(
                jsim.wiring, jsim.cfg.n_gravs, group=g, s_chunk=min(s, 512),
                box_size=kw["box_size"], want_pot=True,
                accumulator=kw["accumulator"],
                treepm_asmth=kw["treepm_asmth"], interpret=True)
            ja, jp, jn = (np.asarray(x) for x in jfn(
                {k: jnp.asarray(v.numpy()) for k, v in targets.items()},
                jnp.asarray(sp.numpy()), jnp.asarray(n_src.numpy())))
            ta, tp, tn, scale = pairwise_eval_torch(
                targets, sp, n_src, True, with_scale=True, **kw)
            scale = scale.numpy()
            assert np.all(np.abs(ta.numpy() - ja) <= RTOL_TERMS
                          * scale[:, :3])
            assert np.all(np.abs(tp.numpy() - jp) <= RTOL_TERMS * scale[:, 3])
            np.testing.assert_array_equal(tn.numpy(), jn)
            checked += 1
    assert checked > 0


def test_solver_after_retries_matches_a_settled_solver(boxes, cut_pass):
    tsim, _ = boxes
    _, _, p, n_ia = cut_pass
    p_s, n_s, _ = _port_solver(tsim).compute(cs.all_active(tsim),
                                             tsim.ti_current, tsim.p.n)
    amag = torch.linalg.norm(p_s.accel, dim=1)
    assert bool((torch.linalg.norm(p.accel - p_s.accel, dim=1)
                 <= 1e-6 * amag).all())
    assert n_ia == n_s


def test_solver_after_retries_matches_jax(boxes, cut_pass):
    _, jsim = boxes
    _, _, p, n_ia = cut_pass
    js = JSolver(jsim.cfg, jsim.wiring, jsim.force_soft, jsim.soft_table,
                 jsim.units.G, hubble=jsim.units.hubble)
    js.fcaps.update(CUT)
    jp = jsim.p.replace(ti_endstep=jnp.full_like(jsim.p.ti_endstep,
                                                 jsim.ti_current))
    jp, j_ia, _ = js.compute(jp, jsim.ti_current, jsim.p.n)
    ja = np.asarray(jp.accel)
    jmag = np.linalg.norm(ja, axis=1)
    assert np.all(np.linalg.norm(p.accel.numpy() - ja, axis=1)
                  <= 1e-5 * np.maximum(jmag, np.median(jmag)))
    assert n_ia == j_ia
    np.testing.assert_array_equal(p.grav_cost.numpy(),
                                  np.asarray(jp.grav_cost))


def test_twin_takes_the_cut_rows_of_one_rounding_an_operation():
    """The rows an ulp from the TreePM cut that a fused multiply-add in
    r^2 moves across it: the twin, each row alone, takes inside exactly
    the rows that r^2 rounded once an operation puts inside (the
    arithmetic K1 follows; the card holds K1 to the twin on these rows)."""
    w, kw = test_torch_cuda._three_species_kw()
    targets, sp, n_src, inside = test_torch_cuda.cut_pairs(nb=4, s=32)
    assert inside.any() and not inside.all()
    tg, one, ns = test_torch_cuda._one_row_a_block(targets, sp, n_src)
    for want_pot in (True, False):
        a, p, nia = pairwise_eval_torch(tg, one, ns, want_pot, **kw)
        hit = (a.reshape(4, 32, -1, 3) != 0).any(-1).any(-1)
        assert torch.equal(hit, torch.as_tensor(inside))
        assert bool((nia.reshape(4, 32, -1) == 1).all())
        if want_pot:
            phit = (p.reshape(4, 32, -1) != 0).any(-1)
            assert torch.equal(phit, torch.as_tensor(inside))
