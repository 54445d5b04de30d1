"""The port's multi-device tree (`ngravs_tpu_torch/parallel/tree_sharded.py`)
on gloo ranks on the CPU.

 * `reshard_by_morton` and `reshard_by_cost` hand every particle to the
   rank JAX's functions give it on `make_mesh(K)` (tests/test_parallel.py:
   129 and :279 schemes, the skewed cost), compared as integers, and the
   cost split's padding rows are inert.
 * The replicated and the LET step on 2 and 4 ranks (the :103 scheme,
   4,096 particles, geometric opening): each within rms 1e-2 of the
   port's direct sum, within rms 2e-2 of each other, the same next sync
   point.  Both walk with the port's fused walk, which stands in for the
   JAX replicated step's two-phase walk.
 * The periodic pure-tree step has the Ewald lattice pass (the :468
   scheme): the replicated step within 3e-3 of the largest |a| of the
   port's single-device solver, the LET step within rms 2e-2 of it.
 * The collisionless TreePM step (the :511 scheme): short range plus the
   slab PM within 3e-3 of the largest |a| of the single-device TreePM
   solver, the PM window advanced.
 * `slow`: the port's steps against JAX's replicated and LET steps on the
   clumped system of :587 (rms 2e-2); JAX's take minutes on the CPU.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as R  # noqa: E402

torch.set_num_threads(1)

SYSTEM_CFG = dict(
    time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
    softening=(0.05,) * 6, max_size_timestep=0.01, n_gravs=2,
    type_to_grav=(0, 0, 1, 0, 0, 0), wiring="newton_yukawa", box_size=50.0,
    walk_batch_blocks=32)


def _write(tmp_path, name, **arrays):
    path = os.path.join(str(tmp_path), name)
    np.savez(path, **arrays)
    return path


def _state(cfg_kw, pos, vel, mass, ptype, ti_endstep=0, **extra):
    """A whole particle state as {field: array} (no padding)."""
    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.interop import particles_to_numpy
    from ngravs_tpu_torch.particles import Particles
    cfg = SimulationConfig(**cfg_kw)
    n = len(pos)
    p = Particles.create(pos, vel, mass, np.arange(n), ptype,
                         cfg.type_to_grav, device="cpu")
    p = p.replace(ti_endstep=torch.full((n,), ti_endstep, dtype=torch.int32),
                  **{k: torch.as_tensor(v) for k, v in extra.items()})
    return particles_to_numpy(p)


def _system(n=4096, seed=42):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 10, (n, 3))
    vel = rng.normal(0, 0.1, (n, 3))
    ptype = rng.integers(1, 3, n)
    return pos, vel, np.full(n, 1e-3), ptype


def _rel_rms(a, ref):
    rel = np.linalg.norm(a - ref, axis=1) \
        / np.maximum(np.linalg.norm(ref, axis=1), 1e-12)
    return float(np.sqrt(np.mean(rel ** 2)))


def _by_pid(outs, key):
    pid = np.concatenate([o["pid"] for o in outs])
    val = np.concatenate([o[key] for o in outs])
    live = pid >= 0
    order = np.argsort(pid[live])
    return val[live][order]


def _port_direct(cfg_kw, arrays):
    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.constants import SOFTFAC_SPLINE
    from ngravs_tpu_torch.models.wiring import build_wiring
    from ngravs_tpu_torch.ops.direct import direct_forces
    from ngravs_tpu_torch.units import set_units
    cfg = SimulationConfig(**cfg_kw)
    t = torch.as_tensor
    fsoft = t(np.array(cfg.softening, np.float32)
              * SOFTFAC_SPLINE)[t(arrays["ptype"]).long()]
    acc, _ = direct_forces(build_wiring(cfg), t(arrays["pos"]),
                           t(arrays["mass"]), t(arrays["grav"]), fsoft,
                           want_pot=False)
    return acc.numpy() * set_units(cfg).G


def _port_solver(cfg_kw, arrays):
    """The single-device solver's forces (geometric opening; under PMGRID
    short range plus PM)."""
    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.constants import SOFTFAC_SPLINE
    from ngravs_tpu_torch.interop import particles_from_numpy
    from ngravs_tpu_torch.models.wiring import build_wiring
    from ngravs_tpu_torch.ops.solver import GravitySolver
    from ngravs_tpu_torch.units import set_units
    cfg = SimulationConfig(**cfg_kw)
    units = set_units(cfg)
    p = particles_from_numpy(arrays, "cpu")
    solver = GravitySolver(cfg, build_wiring(cfg),
                           np.array(cfg.softening) * SOFTFAC_SPLINE,
                           units.G, device="cpu")
    p2, _, _ = solver.compute(p, 0, p.n, opening="bh")
    acc = p2.accel.numpy()
    if cfg.pmgrid:
        acc = acc + solver.pm_forces(p).numpy()
    return acc


@pytest.mark.parametrize("k", [2, 4])
def test_reshard_assignment_matches_jax(k, tmp_path):
    from ngravs_tpu.config import SimulationConfig
    from ngravs_tpu.parallel.mesh import make_mesh, shard_particles
    from ngravs_tpu.parallel.tree_sharded import (reshard_by_cost,
                                                  reshard_by_morton)
    from ngravs_tpu.particles import Particles
    pos, vel, mass, ptype = _system()
    n = len(pos)
    # the synthetic skewed cost of tests/test_parallel.py:285-289
    cost = np.where(np.linalg.norm(pos - 5.0, axis=1) < 3.0, 20.0,
                    1.0).astype(np.float32)
    cfg = SimulationConfig(**SYSTEM_CFG)
    jp = Particles.create(pos, vel, mass, np.arange(n), ptype,
                          cfg.type_to_grav)
    jp = jp.replace(grav_cost=jnp.asarray(cost))
    mesh = make_mesh(k)
    j_morton = np.asarray(jax.device_get(reshard_by_morton(
        shard_particles(jp, mesh), mesh).pid))
    j_cost = np.asarray(jax.device_get(reshard_by_cost(
        jp, mesh, alloc_factor=1.6)[0].pid))

    arrays = _state(SYSTEM_CFG, pos, vel, mass, ptype, grav_cost=cost)
    outs = R.run_ranks(R.reshard, k, tmp_path,
                       _write(tmp_path, "in.npz", **arrays), 1.6)
    np.testing.assert_array_equal(
        np.concatenate([o["morton_pid"] for o in outs]), j_morton)
    np.testing.assert_array_equal(
        np.concatenate([o["cost_pid"] for o in outs]), j_cost)
    for o in outs:
        assert (o["cost_mass"][o["cost_pid"] < 0] == 0).all()


@pytest.mark.parametrize("k", [2, 4])
def test_tree_steps_match_direct_and_each_other(k, tmp_path):
    pos, vel, mass, ptype = _system()
    arrays = _state(SYSTEM_CFG, pos, vel, mass, ptype)
    outs = R.run_ranks(R.tree_steps, k, tmp_path, SYSTEM_CFG,
                       _write(tmp_path, "in.npz", **arrays), "bh",
                       ("rep", "let"), (0, True))
    ref = _port_direct(SYSTEM_CFG, arrays)
    rep, let = _by_pid(outs, "rep_acc"), _by_pid(outs, "let_acc")
    assert _rel_rms(rep, ref) < 1e-2
    assert _rel_rms(let, ref) < 1e-2
    assert _rel_rms(let, rep) < 2e-2
    metas = np.stack([o[f"{m}_meta"] for o in outs for m in ("rep", "let")])
    assert (metas[:, 0] == metas[0, 0]).all() and metas[0, 0] > 0
    assert (metas[:, 1] == len(pos)).all()


def test_periodic_puretree_steps_have_ewald(tmp_path):
    box = 1.0
    kw = dict(time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
              softening=(0.01,) * 6, max_size_timestep=0.01, periodic=True,
              box_size=box, ngravs_en=16, tree_depth=5, tree_bucket_size=16,
              tree_group_size=64, tree_block_batch=4, wiring="newton",
              walk_batch_blocks=32)
    rng = np.random.default_rng(21)
    n = 512
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    arrays = _state(kw, pos, np.zeros((n, 3)), np.full(n, 1.0 / n),
                    np.ones(n, np.int32))
    outs = R.run_ranks(R.tree_steps, 2, tmp_path, kw,
                       _write(tmp_path, "in.npz", **arrays), "bh",
                       ("rep", "let"), (0, True))
    ref = _port_solver(kw, arrays)
    rep, let = _by_pid(outs, "rep_acc"), _by_pid(outs, "let_acc")
    np.testing.assert_allclose(rep, ref, atol=3e-3 * np.abs(ref).max())
    assert _rel_rms(let, ref) < 2e-2


def test_treepm_collisionless_steps(tmp_path):
    box = 1.0
    kw = dict(time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
              softening=(0.005,) * 6, max_size_timestep=0.01, periodic=True,
              box_size=box, pmgrid=16, tree_depth=5, tree_bucket_size=16,
              tree_group_size=64, tree_block_batch=4, wiring="newton",
              walk_batch_blocks=32)
    rng = np.random.default_rng(33)
    n = 1024
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    arrays = _state(kw, pos, np.zeros((n, 3)), np.full(n, 1.0 / n),
                    np.ones(n, np.int32))
    outs = R.run_ranks(R.tree_steps, 2, tmp_path, kw,
                       _write(tmp_path, "in.npz", **arrays), "bh",
                       ("rep", "let"), (0, True))
    ref = _port_solver(kw, arrays)
    scale = np.abs(ref).max()
    for mode in ("rep", "let"):
        np.testing.assert_allclose(_by_pid(outs, f"{mode}_acc"), ref,
                                   atol=3e-3 * scale)
        meta = np.stack([o[f"{mode}_meta"] for o in outs])
        assert (meta[:, 3] > 0).all()


@pytest.mark.slow
def test_tree_steps_match_jax_replicated_and_let(tmp_path):
    """The port's replicated and LET steps against JAX's (two-phase walk
    and fused walk) on the clumped system of tests/test_parallel.py:587."""
    from ngravs_tpu.config import SimulationConfig
    from ngravs_tpu.cosmology import make_tables
    from ngravs_tpu.models.wiring import build_wiring
    from ngravs_tpu.parallel.mesh import make_mesh, shard_particles
    from ngravs_tpu.parallel.tree_sharded import (make_let_tree_step,
                                                  make_sharded_tree_step,
                                                  reshard_by_morton)
    from ngravs_tpu.particles import Particles
    from ngravs_tpu.units import set_units
    kw = dict(time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
              softening=(0.8,) * 6, max_size_timestep=0.005, periodic=False,
              box_size=1000.0, n_gravs=2, type_to_grav=(0, 1, 0, 0, 0, 0),
              wiring="newton_yukawa", tree_depth=7, err_tol_theta=0.4,
              walk_batch_blocks=32)
    rng = np.random.default_rng(11)
    n, k = 4096, 2
    centers = rng.uniform(200, 800, (6, 3))
    pos = (centers[rng.integers(0, 6, n)]
           + rng.normal(0, 25.0, (n, 3))).astype(np.float32)
    vel = rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    ptype = rng.integers(1, 3, n).astype(np.int32)
    mass = np.full(n, 1.0 / n, np.float32)

    cfg = SimulationConfig(**kw)
    units = set_units(cfg)
    wiring, tables = build_wiring(cfg), make_tables(cfg, units)
    jp = Particles.create(pos, vel, mass, np.arange(n), ptype,
                          cfg.type_to_grav)
    jp = jp.replace(ti_endstep=jnp.full((n,), 8, jnp.int32))
    mesh = make_mesh(k)
    ps = reshard_by_morton(shard_particles(jp, mesh), mesh)
    nloc = ps.pos.shape[0] // k
    jpid = np.asarray(ps.pid)
    jacc = {}
    for mode, make in (("rep", make_sharded_tree_step),
                       ("let", make_let_tree_step)):
        step = make(cfg, units, wiring, tables, mesh, n_local=nloc,
                    opening="bh")
        out, _, ovf = step(ps, 0, 8, cfg.time_begin)
        assert not bool(ovf)
        a = np.asarray(out.accel)
        jacc[mode] = a[jpid >= 0][np.argsort(jpid[jpid >= 0])]

    arrays = _state(kw, pos, vel, mass, ptype, ti_endstep=8)
    outs = R.run_ranks(R.tree_steps, k, tmp_path, kw,
                       _write(tmp_path, "in.npz", **arrays), "bh",
                       ("rep", "let"), (8, True))
    for mode in ("rep", "let"):
        got = _by_pid(outs, f"{mode}_acc")
        for jmode, ref in jacc.items():
            rms = _rel_rms(got, ref)
            print(f"port {mode} against JAX {jmode}: rms {rms:.3e}")
            assert rms < 2e-2
