"""The port's multi-device runner with gas (`ngravs_tpu_torch/parallel/
runner.py`) on gloo ranks on the CPU.

 * `DistributedSimulation(entropy_is_u=True)` on 2 ranks against JAX's
   `DistributedSimulation(mesh=make_mesh(2), entropy_is_u=True)` and
   against the port's single-device `Simulation`, 6 steps of the gas +
   halo box of tests/test_parallel.py:188 (the scheme of :557): the same
   sync points, positions within 3e-4 of the box and velocities within
   1e-2 of the largest |v| (JAX's own bound).  The measured errors are
   printed.  The restart file JAX's runner then writes resumes in the port
   with every particle and gas array equal.
 * A gas restart round trip on 2 ranks (LET): the resumed state equals the
   saved one bit for bit, and two steps continued from it equal the
   original run's; the multi-file snapshot (one file a rank) reads back
   equal to `gather_ordered()`, its U, RHO and HSML blocks included.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as R  # noqa: E402
from test_parallel import _gas_halo_system  # noqa: E402
from test_torch_parallel_gas_steps import config_kw, write_state  # noqa: E402

torch.set_num_threads(1)

STEPS = 6


def _box(**changes):
    cfg, p, sph = _gas_halo_system(n_gas=512, n_halo=512)
    return dataclasses.replace(cfg, walk_batch_blocks=32, **changes), p, sph


def _port_single(cfg, p, sph):
    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.integrate.runner import Simulation
    from ngravs_tpu_torch.interop import particles_from_numpy, sph_from_numpy
    pc = particles_from_numpy({k: np.asarray(getattr(p, k))
                               for k in p.__dataclass_fields__}, "cpu")
    sc = sph_from_numpy({k: np.asarray(getattr(sph, k))
                         for k in sph.__dataclass_fields__}, "cpu")
    sim = Simulation(SimulationConfig(**config_kw(cfg)), particles=pc,
                     sph=sc, log_dir="", device="cpu")
    sim.run(max_steps=STEPS)
    return sim


def test_distributed_gas_matches_jax_single_device_and_resumes(tmp_path):
    from ngravs_tpu.parallel.mesh import make_mesh
    from ngravs_tpu.parallel.runner import DistributedSimulation
    # no re-decomposition in the 6 steps: JAX's runner sizes the shards
    # anew at each (its padding rows count, ROADMAP Queue 3) and so
    # compiles its step again
    cfg, p, sph = _box(tree_domain_update_frequency=100.0)
    js = DistributedSimulation(cfg, p, sph=sph, mesh=make_mesh(2),
                               log_dir="", entropy_is_u=True, cand_cap=1024,
                               fcap=16384)
    jsyncs = []
    for _ in range(STEPS):
        js.step()
        jsyncs.append(js.ti_current)
    jg, jgas = js.gather_ordered()
    restart = js.save_restart(os.path.join(str(tmp_path), "jax.npz"))

    path = write_state(tmp_path, p, sph)
    o = R.run_ranks(R.simulate, 2, tmp_path, config_kw(cfg), path,
                    dict(steps=STEPS, entropy_is_u=True))[0]
    single = _port_single(cfg, p, sph)
    assert o["syncs"][:, 0].tolist() == jsyncs
    assert single.ti_current == jsyncs[-1]
    box, vscale = cfg.box_size, np.abs(np.asarray(jg.vel)).max()
    oj = np.argsort(np.asarray(jg.pid))
    op = np.argsort(o["pid"])
    os_ = np.argsort(single.p.pid.numpy())
    errs = {}
    for label, pos, vel in (
            ("vs JAX", np.asarray(jg.pos)[oj], np.asarray(jg.vel)[oj]),
            ("vs single device", single.p.pos.numpy()[os_],
             single.p.vel.numpy()[os_])):
        errs[label] = (np.abs(o["pos"][op] - pos).max() / box,
                       np.abs(o["vel"][op] - vel).max() / vscale)
        assert errs[label][0] < 3e-4 and errs[label][1] < 1e-2, errs
    print("2 ranks, 6 gas steps: " + "; ".join(
        f"{k}: positions {a:.3e} of the box, velocities {b:.3e} of max|v|"
        for k, (a, b) in errs.items()))
    gas = np.asarray(jg.ptype)[oj] == 0
    rho = np.asarray(jgas.density)[oj][gas]
    print(f"  density vs JAX max rel "
          f"{np.abs(o['s_density'][op][gas] - rho).max() / rho.max():.3e}")

    r = R.run_ranks(R.simulate, 2, tmp_path, config_kw(cfg), path,
                    dict(steps=0, resume_from=restart))[0]
    for k in ("pos", "vel", "accel", "ti_endstep", "ti_begstep", "pid"):
        np.testing.assert_array_equal(r[k], np.asarray(getattr(jg, k)),
                                      err_msg=k)
    for k in jgas.__dataclass_fields__:
        np.testing.assert_array_equal(r[f"s_{k}"],
                                      np.asarray(getattr(jgas, k)),
                                      err_msg=k)


def test_gas_restart_round_trip_and_snapshot(tmp_path):
    from ngravs_tpu_torch.io.gadget_format import read_snapshot_set
    cfg, p, sph = _box()
    path = write_state(tmp_path, p, sph)
    rpath = os.path.join(str(tmp_path), "restart_dist.npz")
    base = os.path.join(str(tmp_path), "snap_004")
    o = R.run_ranks(R.simulate, 2, tmp_path, config_kw(cfg), path,
                    dict(steps=4, restart_at=2, restart_path=rpath,
                         entropy_is_u=True, use_let=True,
                         snapshot=base))[0]
    z = np.load(rpath)
    assert int(z["step_count"]) == 2 and z["s_hsml"].shape == (1024,)
    for k in ("pos", "vel", "accel", "ti_endstep", "ti_begstep"):
        np.testing.assert_array_equal(o[f"resumed_{k}"], o[k], err_msg=k)
    for k in ("entropy", "density", "hsml", "hydro_accel", "vel_pred",
              "dt_entropy", "pressure"):
        np.testing.assert_array_equal(o[f"resumed_s_{k}"], o[f"s_{k}"],
                                      err_msg=k)
    snap = read_snapshot_set(base)
    n_gas = int(snap.header.npart[0])
    assert n_gas == 512 and snap.header.npart.sum() == 1024
    o_snap = np.argsort(snap.pid.astype(np.int64))
    op = np.argsort(o["pid"])
    np.testing.assert_array_equal(snap.pos[o_snap], o["pos"][op])
    gas_pid = snap.pid[:n_gas].astype(np.int64)
    og = np.argsort(gas_pid)
    in_run = np.searchsorted(o["pid"][op], gas_pid[og])
    for blk, key in (("rho", "s_density"), ("hsml", "s_hsml")):
        np.testing.assert_array_equal(getattr(snap, blk)[og],
                                      o[key][op][in_run], err_msg=blk)
    assert np.isfinite(snap.u).all() and (snap.u > 0).all()
