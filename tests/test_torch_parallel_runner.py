"""The port's multi-device runner (`ngravs_tpu_torch/parallel/runner.py`)
and `python -m ngravs_tpu_torch.run --devices K`, on gloo ranks on the CPU.

 * The slice as a whole: `DistributedSimulation` on 2 ranks against JAX's
   `DistributedSimulation(mesh=make_mesh(2))` on the 768-particle halo of
   tests/test_parallel.py:657, 4 steps: the same sync points; positions
   within 3e-4 of the extent and velocities within 1e-2 of the largest
   |v| (JAX's own bound, :582-583).  A restart file JAX's runner writes
   then resumes in the port with every array equal.
 * A restart round trip on 2 ranks: the resumed state equals the saved
   one bit for bit, and two steps continued from it equal the original
   run's (the replicated tree is built in particle-ID order, so a new
   decomposition changes no force).
 * Two identical 2-rank runs (LET, the collisionless TreePM box of :737
   at 1,024 particles) repeat bit for bit; the multi-file snapshot (one
   file a rank) reads back equal to `gather_ordered()`.
 * FLEXSTEPS and PSEUDOSYMMETRIC (:669-700) and MAKEGLASS (:703-734)
   properties on 2 ranks.
 * The command line: `--devices 2 --device cpu` ends with 0, on a
   collisionless IC and on a gas IC (whose u becomes entropy before the
   first step); the gas run's snapshot set holds the gas blocks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as R  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HALO_CFG = dict(
    time_begin=0.0, time_max=2.0, gravity_constant_internal=1.0,
    softening=(0.02,) * 6, max_size_timestep=0.02, n_gravs=1,
    type_to_grav=(0,) * 6, wiring="newton", err_tol_int_accuracy=0.02,
    walk_batch_blocks=32)


def _small_halo(n=768, seed=11):
    """tests/test_parallel.py:657: a centrally concentrated blob."""
    rng = np.random.default_rng(seed)
    r = 0.05 + 3.0 * rng.random(n) ** 3
    u = rng.normal(size=(n, 3))
    pos = 5.0 + r[:, None] * u / np.linalg.norm(u, axis=1, keepdims=True)
    vel = rng.normal(0, 0.05, (n, 3))
    return pos, vel


def _inputs(tmp_path, pos, vel, mass=None, ptype=None, name="in.npz"):
    n = len(pos)
    path = os.path.join(str(tmp_path), name)
    np.savez(path, pos=pos, vel=vel,
             mass=np.full(n, 1.0 / n) if mass is None else mass,
             pid=np.arange(n),
             ptype=np.ones(n, np.int32) if ptype is None else ptype)
    return path


def _order(o):
    return np.argsort(o["pid"])


def test_distributed_matches_jax_and_resumes_its_restart(tmp_path):
    from ngravs_tpu.config import SimulationConfig
    from ngravs_tpu.parallel.mesh import make_mesh
    from ngravs_tpu.parallel.runner import DistributedSimulation
    from ngravs_tpu.particles import Particles
    pos, vel = _small_halo()
    n = len(pos)
    cfg = SimulationConfig(**HALO_CFG)
    jp = Particles.create(pos, vel, np.full(n, 1.0 / n), np.arange(n),
                          np.ones(n, np.int32), cfg.type_to_grav)
    js = DistributedSimulation(cfg, jp, mesh=make_mesh(2), log_dir="")
    jsyncs = []
    for _ in range(4):
        js.step()
        jsyncs.append(js.ti_current)
    jg, _ = js.gather_ordered()
    restart = js.save_restart(os.path.join(str(tmp_path), "jax.npz"))

    path = _inputs(tmp_path, pos, vel)
    o = R.run_ranks(R.simulate, 2, tmp_path, HALO_CFG, path,
                    dict(steps=4))[0]
    assert o["syncs"][:, 0].tolist() == jsyncs
    oj = np.argsort(np.asarray(jg.pid))
    ext = np.ptp(np.asarray(jg.pos), axis=0).max()
    vscale = np.abs(np.asarray(jg.vel)).max()
    assert np.abs(o["pos"][_order(o)] - np.asarray(jg.pos)[oj]).max() \
        < 3e-4 * ext
    assert np.abs(o["vel"][_order(o)] - np.asarray(jg.vel)[oj]).max() \
        < 1e-2 * vscale

    r = R.run_ranks(R.simulate, 2, tmp_path, HALO_CFG, path,
                    dict(steps=0, resume_from=restart))[0]
    for k in ("pos", "vel", "accel", "ti_endstep", "ti_begstep", "pid"):
        np.testing.assert_array_equal(r[k], np.asarray(getattr(jg, k)))


def test_restart_round_trip_is_exact(tmp_path):
    pos, vel = _small_halo(seed=5)
    path = _inputs(tmp_path, pos, vel)
    rpath = os.path.join(str(tmp_path), "restart_dist.npz")
    o = R.run_ranks(R.simulate, 2, tmp_path, HALO_CFG, path,
                    dict(steps=4, restart_at=2, restart_path=rpath))[0]
    z = np.load(rpath)
    assert int(z["step_count"]) == 2 and z["p_pos"].shape == (768, 3)
    for k in ("pos", "vel", "accel", "ti_endstep", "ti_begstep", "old_acc"):
        np.testing.assert_array_equal(o[f"resumed_{k}"],
                                      o[k] if k != "old_acc"
                                      else o["orig_old_acc"])
    r = R.run_ranks(R.simulate, 2, tmp_path, HALO_CFG, path,
                    dict(steps=0, resume_from=rpath))[0]
    for k in ("pos", "vel", "ti_endstep"):
        np.testing.assert_array_equal(r[k], z[f"p_{k}"])


TREEPM_CFG = dict(
    time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
    softening=(0.2,) * 6, max_size_timestep=0.005, n_gravs=2,
    type_to_grav=(0, 0, 1, 0, 0, 0), wiring="newton_yukawa", periodic=True,
    box_size=50.0, pmgrid=32, time_bet_snapshot=0.0,
    time_of_first_snapshot=1e30, tree_depth=6, walk_batch_blocks=32,
    type_of_opening_criterion=0)


def test_let_treepm_runs_repeat_and_snapshot_reads_back(tmp_path):
    from ngravs_tpu_torch.io.gadget_format import read_snapshot_set
    rng = np.random.default_rng(9)
    n = 1024
    path = _inputs(tmp_path, rng.uniform(0, 50.0, (n, 3)),
                   rng.normal(0, 0.01, (n, 3)),
                   ptype=rng.integers(1, 3, n).astype(np.int32))
    base = os.path.join(str(tmp_path), "snap_003")
    runs = [R.run_ranks(R.simulate, 2, tmp_path, TREEPM_CFG, path,
                        dict(steps=3, use_let=True, snapshot=base))
            for _ in range(2)]
    a, b = runs[0][0], runs[1][0]
    assert a["syncs"][-1, 2] > 0                     # the PM window moved
    for k in ("pos", "vel", "accel", "accel_pm", "ti_endstep"):
        np.testing.assert_array_equal(a[k], b[k])
    assert np.abs(a["accel_pm"]).max() > 0
    assert os.path.exists(base + ".0") and os.path.exists(base + ".1")
    snap = read_snapshot_set(base)
    assert snap.header.npart.sum() == n
    o = np.argsort(snap.pid.astype(np.int64))
    np.testing.assert_array_equal(snap.pos[o], a["pos"][_order(a)])
    np.testing.assert_array_equal(snap.pid[o].astype(np.int64),
                                  np.sort(a["pid"]))


@pytest.mark.parametrize("mode", ["flexsteps", "pseudosymmetric"])
def test_distributed_special_timestep_modes(mode, tmp_path):
    pos, vel = _small_halo()
    o = R.run_ranks(R.simulate, 2, tmp_path, dict(HALO_CFG, **{mode: True}),
                    _inputs(tmp_path, pos, vel), dict(steps=6))[0]
    ends, begs = o["ti_endstep"], o["ti_begstep"]
    assert o["syncs"][-1, 0] > 0
    assert np.isfinite(o["pos"]).all() and (ends > 0).all()
    steps = ends - begs
    if mode == "flexsteps":
        # step ends off their own grid (timestep.c:196-199)
        ok = steps > 0
        assert ((ends[ok] % steps[ok]) != 0).any()
        assert 1 <= o["present"][0] <= o["present"][1]
    else:
        assert ((steps & (steps - 1)) == 0).all()
        assert np.isfinite(o["aphys_old"]).all() \
            and o["aphys_old"].max() > 0


def test_distributed_makeglass(tmp_path):
    kw = dict(HALO_CFG, make_glass=True, periodic=True, box_size=10.0,
              comoving_integration=True, omega0=1.0, omega_lambda=0.0,
              hubble_param=1.0, time_begin=0.1, time_max=0.2,
              time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
              ngravs_en=8, tree_depth=4)
    rng = np.random.default_rng(5)
    n = 512
    pos = rng.uniform(0, 10.0, (n, 3))
    o = R.run_ranks(R.simulate, 2, tmp_path, kw,
                    _inputs(tmp_path, pos, np.zeros((n, 3))),
                    dict(steps=3))[0]
    assert np.abs(o["vel"]).max() == 0.0
    assert np.isfinite(o["pos"]).all()
    assert ((o["pos"] >= 0) & (o["pos"] < 10.0)).all()
    assert np.abs(o["pos"][_order(o)] - pos).max() > 0


def _write_run(tmp_path, npart, u=None):
    from ngravs_tpu_torch.io.gadget_format import (SnapshotData,
                                                   SnapshotHeader,
                                                   write_snapshot)
    pos, vel = _small_halo(n=int(sum(npart)))
    n = len(pos)
    h = SnapshotHeader()
    h.npart = np.array(npart, np.int32)
    h.npart_total = h.npart.astype(np.uint32)
    ic = os.path.join(str(tmp_path), "halo.IC")
    write_snapshot(ic, SnapshotData(
        header=h, pos=pos.astype(np.float32), vel=vel.astype(np.float32),
        pid=np.arange(1, n + 1, dtype=np.uint32),
        mass=np.full(n, 1.0 / n, np.float32),
        ptype=np.repeat(np.arange(6, dtype=np.int32), npart), u=u))
    param = os.path.join(str(tmp_path), "halo.param")
    out = os.path.join(str(tmp_path), "out")
    with open(param, "w") as f:
        for k, v in {"InitCondFile": ic, "OutputDir": out,
                     "SnapshotFileBase": "snapshot", "ICFormat": 1,
                     "SnapFormat": 1, "TimeBegin": 0.0, "TimeMax": 0.01,
                     "TimeBetSnapshot": 0.005, "TimeOfFirstSnapshot": 0.005,
                     "TimeBetStatistics": 0.01, "ErrTolIntAccuracy": 0.02,
                     "MaxSizeTimestep": 0.005, "GravityConstantInternal": 1.0,
                     "SofteningHalo": 0.02, "SofteningGas": 0.02,
                     "TypeOfOpeningCriterion": 0}.items():
            f.write(f"{k:<28s} {v}\n")
    return param, out


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "ngravs_tpu_torch.run",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ,
                                                OMP_NUM_THREADS="1"))


def test_run_cli_devices(tmp_path):
    param, out = _write_run(tmp_path, (0, 512, 0, 0, 0, 0))
    r = _cli(param, "--devices", "2", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert "over gloo" in lines[0]
    assert lines[-1].startswith("done:")
    assert os.path.exists(os.path.join(out, "snapshot_001.1"))
    assert os.path.exists(os.path.join(out, "energy.txt"))


def test_run_cli_devices_gas(tmp_path):
    from ngravs_tpu_torch.io.gadget_format import read_snapshot_set
    param, out = _write_run(tmp_path, (256, 256, 0, 0, 0, 0),
                            u=np.ones(256, np.float32))
    r = _cli(param, "--devices", "2", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert "over gloo" in lines[0] and lines[-1].startswith("done:")
    snap = read_snapshot_set(os.path.join(out, "snapshot_001"))
    assert int(snap.header.npart[0]) == 256 and snap.header.num_files == 1
    for blk in ("u", "rho", "hsml"):
        a = getattr(snap, blk)
        assert a is not None and a.shape == (256,), blk
        assert np.isfinite(a).all() and (a > 0).all(), blk
