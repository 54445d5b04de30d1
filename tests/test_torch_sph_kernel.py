"""The SPH passes' dispatch between K2 (`csrc/sph.cu`, CUDA tensors) and
its plain twins (CPU tensors), on the CPU:

 * the argument packing K2 takes: the `Kernel` tuple's coefficients,
   zfac and ndims for 3D and TWODIMS; the per-axis box with 0 for an open
   axis; the hydro pass's scalars (0.25 visc_const and 0.5 fac_vsic_fix
   rounded to float32 once, as torch rounds the twin's Python scalars)
   and the limiter flag; the lanes a target for each block size;
 * CPU tensors take the twins bit for bit and count no `k2.*` launch;
 * a `HydroSolver` density iteration and hydro pass on a jittered gas box
   on the CPU give exactly what the twins' unchunked blocks give;
 * the CUDA wrappers refuse, before any launch, an input they do not take.
"""

import numpy as np
import pytest
import torch

from ngravs_tpu_torch.config import SimulationConfig
from ngravs_tpu_torch.constants import (KERNEL_COEFF_1, KERNEL_COEFF_5,
                                        KERNEL_COEFF_6)
from ngravs_tpu_torch.ops import sph as S
from ngravs_tpu_torch.ops import tree as ttree
from ngravs_tpu_torch.particles import Particles, SphState
from ngravs_tpu_torch.trace import Trace

# tiny tensors: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

BOX, DEPTH, BUCKET = 10.0, 5, 16
f32 = lambda x: float(np.float32(x))


@pytest.mark.parametrize("twodims", [False, True])
def test_spline_args_pack_the_kernel_tuple(twodims):
    k = S.Kernel.twodims(4.0) if twodims else S.K3D
    a = S.spline_args(k)
    assert [a.c1, a.c2, a.c3, a.c4, a.c5, a.c6] == \
        [f32(c) for c in (k.c1, k.c2, k.c3, k.c4, k.c5, k.c6)]
    assert (a.ndims, a.zfac) == ((2, f32(0.25)) if twodims else (3, 1.0))
    scale = 5.0 / 7 if twodims else 1.0
    assert (a.c1, a.c5, a.c6) == tuple(
        f32(scale * c) for c in (KERNEL_COEFF_1, KERNEL_COEFF_5,
                                 KERNEL_COEFF_6))


@pytest.mark.parametrize("box,want", [
    (0.0, (0.0, 0.0, 0.0)), (None, (0.0, 0.0, 0.0)),
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)), (10.0, (10.0, 10.0, 10.0)),
    ((12.0, 10.0, 7.0), (12.0, 10.0, 7.0)),
    ((10.0, 0.0, 8.0), (10.0, 0.0, 8.0))])
def test_box_args_per_axis_with_zero_for_open(box, want):
    assert S.box_args(box) == want


@pytest.mark.parametrize("limiter,facs", [
    (True, (1.0, 1.0, 1.0)), (False, (1.0, 1.0, 1.0)),
    (True, (0.53, 1.7, 2.3))])
def test_hydro_args_pack_scalars_and_limiter(limiter, facs):
    fac_mu, fvf, ha2 = facs
    a = S.hydro_args(fac_mu, fvf, ha2, 0.8, limiter)
    assert (a.fac_mu, a.hubble_a2) == (f32(fac_mu), f32(ha2))
    assert a.visc == f32(0.25 * 0.8) and a.vsic == f32(0.5 * fvf)
    assert a.use_limiter == int(limiter)


def test_launch_lanes():
    assert [S.launch_lanes(g) for g in (1, 8, 32, 64, 100, 128, 256)] == \
        [8, 8, 8, 4, 2, 2, 1]
    for g in (0, 257):
        with pytest.raises(ValueError):
            S.launch_lanes(g)


def _gas_box(n_side=8, seed=3, h0=0.2):
    """A jittered periodic gas box: its tree, particles and SPH state (a
    poor first Hsml guess, so the density iteration takes several
    sweeps), all active at ti_current = 0."""
    rng = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / n_side * BOX
    pos = np.mod(g + rng.normal(0, 0.1 * BOX / n_side, g.shape), BOX)
    vel = rng.normal(0, 0.5, g.shape)
    n = len(pos)
    cfg = SimulationConfig(periodic=True, box_size=BOX, no_gravity=True,
                           des_num_ngb=33, max_num_ngb_deviation=2,
                           tree_group_size=64, tree_bucket_size=BUCKET,
                           softening=(0.01,) * 6)
    p = Particles.create(pos, vel, np.full(n, 1.0 / n), np.arange(n),
                         np.zeros(n), cfg.type_to_grav, device="cpu")
    p = p.replace(ti_begstep=torch.zeros(n, dtype=torch.int32),
                  ti_endstep=torch.full((n,), 64, dtype=torch.int32))
    sph = SphState.zeros(n, "cpu").replace(
        hsml=torch.full((n,), h0 * BOX / n_side), vel_pred=p.vel.clone(),
        entropy=torch.full((n,), 0.3))
    tree = ttree.build_tree(p.pos, p.mass, p.grav, torch.full((n,), 0.1),
                            torch.zeros(n), sph.hsml, depth=DEPTH,
                            n_gravs=1, bucket=BUCKET, box_size=BOX)
    return cfg, tree, p, sph


def _blocks_whole(fn):
    """A pass that runs its twin's blocks on every block at once."""
    if fn == "density":
        def run(tree, tgt, hsml, vpt, cands, vel_all, box_size=0.0,
                kernel=S.K3D):
            return S._density_blocks(tree, tgt, hsml, vpt, cands.cand,
                                     vel_all, box_size, kernel)
        return run

    def run(tree, tgt, cands, *fields, box_size=0.0, use_limiter=True,
            kernel=S.K3D):
        return S._hydro_blocks(tree, tgt, cands.cand, *fields, box_size,
                               use_limiter, kernel)
    return run


def _solver_step(cfg, tree, p, sph):
    solver = S.HydroSolver(cfg, None)
    with solver.trace.span("hydro"):
        dens = solver.density(tree, p, sph, 64, p.n, DEPTH, 1e-3)
        out = solver.hydro(tree, p, dens, 64, p.n, DEPTH, 1e-3, 1.0)
    return solver, out


def test_hydro_solver_step_on_cpu_is_the_twins(monkeypatch):
    cfg, tree, p, sph = _gas_box()
    solver, got = _solver_step(cfg, tree, p, sph)
    assert solver.trace.counts["sph.density_iters"] >= 3
    assert solver.trace.counts["sph.hydro_passes"] == 1
    assert solver.trace.prefixed("k2.") == {}
    monkeypatch.setattr(S, "density_pass", _blocks_whole("density"))
    monkeypatch.setattr(S, "hydro_pass", _blocks_whole("hydro"))
    _, want = _solver_step(cfg, tree, p, sph)
    for name in ("hsml", "density", "num_ngb", "pressure", "div_vel",
                 "curl_vel", "dhsml_density_factor", "hydro_accel",
                 "dt_entropy", "max_signal_vel"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert float(got.hydro_accel.abs().max()) > 0
    assert float(got.max_signal_vel.max()) > 0


def _pass_args():
    cfg, tree, p, sph = _gas_box(n_side=6, h0=0.6)
    solver = S.HydroSolver(cfg, None)
    tgt, active, safe, _ = solver._targets(tree, p, 64, p.n)
    gather = solver._gather(DEPTH, True)
    order = tree.order.long()
    hsml = torch.where(active, sph.hsml[order][safe], 0.0)
    cands = gather(tree, tgt, hsml)
    assert not bool(cands.overflow)
    vel_all = sph.vel_pred[order]
    sph = sph.replace(density=torch.ones(p.n), pressure=torch.ones(p.n),
                      dhsml_density_factor=torch.ones(p.n))
    fields, facs = solver.hydro_inputs(tree, p, sph, 1e-3, 1.0)
    return tree, tgt, hsml, vel_all[safe], cands, vel_all, fields, facs


def test_cpu_tensors_take_the_twins():
    tree, tgt, hsml, vpt, cands, vel_all, fields, facs = _pass_args()
    trace = Trace()
    with trace.span("sph"):
        got = S.density_pass(tree, tgt, hsml, vpt, cands, vel_all,
                             box_size=BOX)
        want = S.density_pass_torch(tree, tgt, hsml, vpt, cands, vel_all,
                                    box_size=BOX, block_chunk=1)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = S.hydro_pass(tree, tgt, cands, *fields, *facs, 0.8,
                           box_size=BOX)
        want = S.hydro_pass_torch(tree, tgt, cands, *fields, *facs, 0.8,
                                  box_size=BOX, block_chunk=1)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert trace.prefixed("k2.") == {}
    assert float(got[0].abs().max()) > 0


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    tree, tgt, hsml, vpt, cands, vel_all, fields, facs = _pass_args()
    for fn, args in ((S._density_cuda, (tree, tgt, hsml, vpt, cands,
                                        vel_all, BOX, S.K3D)),
                     (S._hydro_cuda, (tree, tgt, cands, *fields, *facs, 0.8,
                                      BOX, True, S.K3D))):
        with pytest.raises(ValueError, match="no SPH kernel"):
            fn(*args)
    dev = tgt.device
    ok = dict(tgt=(tgt, torch.int32, tuple(tgt.shape)))
    assert S._kernel_inputs(ok, dev)["tgt"] is tgt
    for bad in (dict(tgt=(tgt.long(), torch.int32, None)),
                dict(tgt=(tgt, torch.int32, (tgt.shape[0] + 1,))),
                dict(h=(hsml.double(), torch.float32, None))):
        with pytest.raises(ValueError):
            S._kernel_inputs(bad, dev)
    with pytest.raises(ValueError, match="n_cand"):
        S._cand_inputs(tgt, cands._replace(n_cand=None), tree)
    meta = torch.empty(tgt.shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no SPH kernel"):
        S.density_pass(tree, meta, hsml, vpt, cands, vel_all, box_size=BOX)
