"""The port's slab-decomposed PM (`ngravs_tpu_torch/parallel/pm_sharded.py`)
on gloo ranks on the CPU.

 * tests/test_parallel.py:154 scheme (box 100, PMGRID 32, 1,024 particles,
   a Newton / Yukawa wiring): the port's `ShardedPMSolver` on 2 and 4
   ranks against JAX's on `make_mesh(K)` and against the port's
   single-device `PMSolver`, forces within 2e-5 of the largest |a| and
   the potential within 2e-5 of the largest |pot| (:183-185).
 * The single-device solver's options, which the JAX sharded solver does
   not take: grid interlacing and the spectral gradient, against the
   port's single-device solver with the same options, same tolerance.
 * Forces repeat bit for bit (fixed-order CIC sums).
 * The difference from the single-device solver is rounding: in float64
   (both solvers, the same inputs) it drops to 1e-12 of the largest |a|,
   from the float32 readings of up to 2e-5 that the slab's 1-D FFTs and
   `rfftn` round to differently.
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

BOX, PMGRID, N = 100.0, 32, 1024


def _inputs(tmp_path):
    rng = np.random.default_rng(7)
    pos = rng.uniform(0, BOX, (N, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    grav = (rng.random(N) < 0.4).astype(np.int32)
    path = os.path.join(str(tmp_path), "pm_in.npz")
    np.savez(path, pos=pos, mass=mass, grav=grav)
    return path, pos, mass, grav


def _port_single(pos, mass, grav, dtype=torch.float32, **opts):
    from ngravs_tpu_torch.models import laws as L
    from ngravs_tpu_torch.models.wiring import GravityWiring
    from ngravs_tpu_torch.ops.pm import PMSolver
    w = GravityWiring([[L.Newtonian(), L.Newtonian()],
                       [L.Newtonian(), L.Yukawa(5.0, BOX, pmgrid=PMGRID)]])
    pm = PMSolver(w, PMGRID, BOX, 2, g_const=1.0, **opts)
    pos, mass = (torch.as_tensor(a).to(dtype) for a in (pos, mass))
    grav = torch.as_tensor(grav)
    return (pm.forces(pos, mass, grav).numpy(),
            pm.potential(pos, mass, grav).numpy())


def _check(acc, pot, acc_ref, pot_ref):
    np.testing.assert_allclose(acc, acc_ref, atol=2e-5 * np.abs(acc_ref).max())
    np.testing.assert_allclose(pot, pot_ref, atol=2e-5 * np.abs(pot_ref).max())


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_pm_matches_jax_and_single_device(k, tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ngravs_tpu.models import laws as JL
    from ngravs_tpu.models.wiring import GravityWiring as JWiring
    from ngravs_tpu.ops.pm import PMSolver as JPMSolver
    from ngravs_tpu.parallel.mesh import make_mesh
    from ngravs_tpu.parallel.pm_sharded import ShardedPMSolver as JSharded
    path, pos, mass, grav = _inputs(tmp_path)
    w = JWiring([[JL.Newtonian(), JL.Newtonian()],
                 [JL.Newtonian(), JL.Yukawa(5.0, BOX, pmgrid=PMGRID)]])
    jpm = JPMSolver(w, PMGRID, BOX, 2, g_const=1.0)
    mesh = make_mesh(k)
    sh = NamedSharding(mesh, P("shard"))
    put = lambda a: jax.device_put(jnp.asarray(a), sh)
    spm = JSharded(jpm, mesh, 2)
    acc_j = np.asarray(jax.device_get(spm.forces(put(pos), put(mass),
                                                 put(grav))))
    pot_j = np.asarray(jax.device_get(spm.potential(put(pos), put(mass),
                                                    put(grav))))

    outs = R.run_ranks(R.pm_forces, k, tmp_path, (BOX, PMGRID), path, {})
    acc = np.concatenate([o["acc"] for o in outs])
    pot = np.concatenate([o["pot"] for o in outs])
    _check(acc, pot, acc_j, pot_j)
    _check(acc, pot, *_port_single(pos, mass, grav))
    assert all(bool(o["repeat"]) for o in outs)


@pytest.mark.parametrize("opts", [dict(interlace=True),
                                  dict(gradient="spectral"),
                                  dict(interlace=True, gradient="spectral")],
                         ids=["interlaced", "spectral", "both"])
def test_sharded_pm_options_match_single_device(opts, tmp_path):
    path, pos, mass, grav = _inputs(tmp_path)
    outs = R.run_ranks(R.pm_forces, 2, tmp_path, (BOX, PMGRID), path, opts)
    acc = np.concatenate([o["acc"] for o in outs])
    pot = np.concatenate([o["pot"] for o in outs])
    _check(acc, pot, *_port_single(pos, mass, grav, **opts))
    assert all(bool(o["repeat"]) for o in outs)


def test_sharded_pm_differs_from_single_device_by_rounding_only(tmp_path):
    path, pos, mass, grav = _inputs(tmp_path)
    opts = dict(interlace=True)
    outs = R.run_ranks(R.pm_forces, 2, tmp_path, (BOX, PMGRID), path, opts,
                       "float64")
    acc = np.concatenate([o["acc"] for o in outs])
    pot = np.concatenate([o["pot"] for o in outs])
    assert acc.dtype == np.float64
    acc_ref, pot_ref = _port_single(pos, mass, grav, torch.float64, **opts)
    assert np.abs(acc - acc_ref).max() <= 1e-12 * np.abs(acc_ref).max()
    assert np.abs(pot - pot_ref).max() <= 1e-12 * np.abs(pot_ref).max()
