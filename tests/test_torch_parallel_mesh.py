"""The port's rank mesh (`ngravs_tpu_torch/parallel/mesh.py`) on gloo ranks
on the CPU, against the JAX package's mesh on the same number of devices.

 * The collectives: tiled all_gather, all_to_all of blocks, psum / pmin /
   pmax (int32 flags), the ring both ways, for 1, 2 and 4 ranks.
 * `make_sharded_step` against JAX's on `make_mesh(K)`
   (tests/test_parallel.py:35 scheme, 4,096 particles, newton_yukawa):
   accelerations within 3e-5 of the largest |a|, the same next sync point.
 * Padding rows are inert (tests/test_parallel.py:77: 1,001 particles on
   4 ranks against the direct sum).
 * `sharded_dt_displacement` equals JAX's within 1e-6 relative on the
   comoving box of tests/test_cosmological.py.
 * `launch` runs its ranks on the card unless the CPU is asked for, over
   NCCL there and gloo on the CPU; without a card it raises.

Each rank is a spawned process (`torch_parallel_ranks`) meeting the others
at a file store in the test's tmp_path.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as R  # noqa: E402

torch.set_num_threads(1)

SYSTEM_CFG = dict(
    time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
    softening=(0.05,) * 6, max_size_timestep=0.01, n_gravs=2,
    type_to_grav=(0, 0, 1, 0, 0, 0), wiring="newton_yukawa", box_size=50.0)


def _system(n=4096, seed=42):
    """tests/test_parallel.py:20: uniform in a cube, two gravities."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 10, (n, 3))
    vel = rng.normal(0, 0.1, (n, 3))
    ptype = rng.integers(1, 3, n)
    return pos, vel, np.full(n, 1e-3), np.arange(n), ptype


def _padded_state(cfg_kw, pos, vel, mass, pid, ptype, k, tmp_path):
    """JAX's sharded particle state over make_mesh(k), as numpy arrays,
    written for the ranks; returns (path, JAX sharded particles)."""
    from ngravs_tpu.config import SimulationConfig
    from ngravs_tpu.parallel.mesh import make_mesh, shard_particles
    from ngravs_tpu.particles import Particles
    cfg = SimulationConfig(**cfg_kw)
    p = Particles.create(pos, vel, mass, pid, ptype, cfg.type_to_grav)
    ps = shard_particles(p, make_mesh(k))
    arrays = {f: np.asarray(jax.device_get(getattr(ps, f)))
              for f in type(ps).__dataclass_fields__}
    path = os.path.join(str(tmp_path), f"state_{k}.npz")
    np.savez(path, **arrays)
    return path, ps


def test_launch_runs_on_the_card_unless_the_cpu_is_asked_for():
    from ngravs_tpu_torch.parallel.mesh import default_backend, launch
    assert (default_backend("cuda"), default_backend("cpu")) == \
        ("nccl", "gloo")
    # one rank more than the cards: refused before any rank starts
    world = torch.cuda.device_count() + 1
    hint = "--backend gloo" if torch.cuda.is_available() else "--device cpu"
    with pytest.raises(RuntimeError, match=hint):
        launch(R.collectives, world)
    with pytest.raises(ValueError, match="NCCL runs on CUDA devices only"):
        launch(R.collectives, 2, device="cpu", backend="nccl")


@pytest.mark.parametrize("k", [1, 2, 4])
def test_collectives(k, tmp_path):
    outs = R.run_ranks(R.collectives, k, tmp_path)
    x = [np.arange(3, dtype=np.float32) + 10 * r for r in range(k)]
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["gather"], np.concatenate(x))
        want = np.stack([np.arange(k * 2).reshape(k, 2)[r] + 100 * j
                         for j in range(k)])
        np.testing.assert_array_equal(o["a2a"], want)
        np.testing.assert_array_equal(o["psum"], np.sum(x, axis=0))
        np.testing.assert_array_equal(o["pmin"], [5, -(k - 1)])
        np.testing.assert_array_equal(o["pmax"], [k + 4, 0])
        assert o["flag"].tolist() == [True]
        np.testing.assert_array_equal(o["up"], x[(r - 1) % k])
        np.testing.assert_array_equal(o["down"], x[(r + 1) % k])


def test_sharded_step_matches_jax(tmp_path):
    from ngravs_tpu.config import SimulationConfig
    from ngravs_tpu.cosmology import make_tables
    from ngravs_tpu.models.wiring import build_wiring
    from ngravs_tpu.parallel.mesh import make_mesh, make_sharded_step
    from ngravs_tpu.units import set_units
    k = 2
    path, ps = _padded_state(SYSTEM_CFG, *_system(), k, tmp_path)
    cfg = SimulationConfig(**SYSTEM_CFG)
    units = set_units(cfg)
    step = make_sharded_step(cfg, units, build_wiring(cfg),
                             make_tables(cfg, units), make_mesh(k))
    p_ref, min_ref = step(ps, 0, 0, cfg.time_begin)
    acc_ref = np.asarray(jax.device_get(p_ref.accel))

    outs = R.run_ranks(R.direct_step, k, tmp_path, SYSTEM_CFG, path)
    acc = np.concatenate([o["accel"] for o in outs])
    scale = np.abs(acc_ref).max()
    np.testing.assert_allclose(acc, acc_ref, atol=3e-5 * scale)
    assert {int(o["min_end"]) for o in outs} == {int(min_ref)}
    assert int(min_ref) > 0


def test_padding_particles_inert(tmp_path):
    """The port's `shard_particles` pads as JAX's does (the same padded
    length, pid -1, step ends past the horizon) and the padding changes
    no force."""
    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.constants import SOFTFAC_SPLINE
    from ngravs_tpu_torch.models.wiring import build_wiring
    from ngravs_tpu_torch.ops.direct import direct_forces
    kw = dict(time_begin=0, time_max=1.0, gravity_constant_internal=1.0,
              softening=(0.05,) * 6, wiring="newton")
    rng = np.random.default_rng(42)
    n, k = 1001, 4
    pos = rng.uniform(0, 5, (n, 3))
    _, ps = _padded_state(kw, pos, np.zeros((n, 3)), np.ones(n),
                          np.arange(n), np.ones(n), k, tmp_path)
    path = os.path.join(str(tmp_path), "unpadded.npz")
    np.savez(path, pos=pos, vel=np.zeros((n, 3)), mass=np.ones(n),
             pid=np.arange(n), ptype=np.ones(n, np.int32))
    outs = R.run_ranks(R.direct_step, k, tmp_path, kw, path)
    acc = np.concatenate([o["accel"] for o in outs])
    pid = np.concatenate([o["pid"] for o in outs])
    assert len(pid) == ps.pos.shape[0] == 1004
    np.testing.assert_array_equal(pid, np.asarray(ps.pid))
    assert (np.concatenate([o["ti_endstep"] for o in outs])[n:]
            == 2 ** 30).all()
    cfg = SimulationConfig(**kw)
    t = lambda a, d=torch.float32: torch.as_tensor(np.asarray(a), dtype=d)
    acc_ref, _ = direct_forces(build_wiring(cfg), t(pos), t(np.ones(n)),
                               t(np.zeros(n), torch.int32),
                               t(np.full(n, 0.05 * SOFTFAC_SPLINE)))
    acc_ref = acc_ref.numpy()
    scale = np.abs(acc_ref).max()
    np.testing.assert_allclose(acc[:n], acc_ref, atol=3e-5 * scale)


def test_sharded_dt_displacement_matches_jax(tmp_path):
    from jax.sharding import PartitionSpec as P
    from ngravs_tpu.parallel.mesh import (AXIS, make_mesh,
                                          sharded_dt_displacement)
    from ngravs_tpu.units import set_units
    from test_cosmological import _cosmo_box
    cfg, p, _ = _cosmo_box(n_side=8)
    k = 2
    mesh = make_mesh(k)
    from ngravs_tpu.parallel.mesh import shard_particles
    ps = shard_particles(p, mesh)
    units = set_units(cfg)
    fn = jax.jit(jax.shard_map(
        lambda q: sharded_dt_displacement(cfg, units, q, cfg.time_begin),
        mesh=mesh, in_specs=(P(AXIS),), out_specs=P(), check_vma=False))
    ref = float(fn(ps))
    assert ref < cfg.max_size_timestep       # the constraint binds
    import dataclasses
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    path = os.path.join(str(tmp_path), "box.npz")
    np.savez(path, **{f: np.asarray(jax.device_get(getattr(ps, f)))
                      for f in type(ps).__dataclass_fields__})
    outs = R.run_ranks(R.dt_displacement, k, tmp_path, kw, path)
    for o in outs:
        np.testing.assert_allclose(float(o["dt"]), ref, rtol=1e-6)
