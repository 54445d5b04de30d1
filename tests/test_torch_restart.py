"""Restart files and output lists of the port (`ngravs_tpu_torch/io/
restart.py`, `Simulation.save_restart` / `resume`, `run()`'s restart
writes, OutputListOn) against the JAX package, on the CPU.

 * The round trip: every array of the particle and SPH state, and every
   timeline scalar, equal after save and resume.
 * A file written by the JAX `save_restart` resumes the port, and the
   reverse, to the other package's state bit for bit.
 * A resumed gas run is bit-identical to an uninterrupted one over three
   steps.
 * A larger TimeMax on resume shifts the integer timeline by the same
   power of two as the JAX package does.
 * restartflag 1 through `run.main`; the stop file writes a restart file.
 * OutputListOn: the same output times as the JAX runner, and snapshots
   written at them.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ngravs_tpu.config import SimulationConfig as JConfig
from ngravs_tpu.integrate.runner import Simulation as JSimulation
from ngravs_tpu.particles import Particles as JParticles
from ngravs_tpu.particles import SphState as JSph

from ngravs_tpu_torch import run as trun
from ngravs_tpu_torch.config import SimulationConfig as TConfig
from ngravs_tpu_torch.config import read_parameter_file
from ngravs_tpu_torch.constants import TIMEBASE
from ngravs_tpu_torch.integrate.runner import Simulation as TSimulation
from ngravs_tpu_torch.io.gadget_format import (SnapshotData, SnapshotHeader,
                                               read_snapshot, write_snapshot)
from ngravs_tpu_torch.particles import Particles, SphState

# tiny tensors: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (a parallel run is several times slower else)
torch.set_num_threads(1)

CFG = dict(time_begin=0.0, time_max=0.1, gravity_constant_internal=1.0,
           softening=(0.05,) * 6, max_size_timestep=0.01,
           time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
           time_bet_statistics=0.0, des_num_ngb=16,
           max_num_ngb_deviation=2, tree_group_size=64, tree_bucket_size=16)
SCALARS = ("ti_current", "pm_ti_begstep", "pm_ti_endstep", "dt_displacement",
           "step_count", "snapshot_count", "num_force_updates",
           "_next_output", "_next_stats")


def _system(n=320, seed=2):
    """A clump of gas (first quarter) and halo particles."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    ptype = np.where(np.arange(n) < n // 4, 0, 1).astype(np.int32)
    u = np.where(ptype == 0, 0.4, 0.0).astype(np.float32)
    return pos, vel, np.full(n, 1.0 / n, np.float32), ptype, u


def _port_sim(cfg=None, log_dir="", **kw):
    pos, vel, mass, ptype, u = _system()
    cfg = cfg or TConfig(**CFG)
    sph = SphState.zeros(len(pos), "cpu")
    sph.entropy[:] = torch.as_tensor(u)
    p = Particles.create(pos, vel, mass, np.arange(len(pos)), ptype,
                         cfg.type_to_grav, device="cpu")
    return TSimulation(cfg, particles=p, sph=sph, log_dir=log_dir,
                       device="cpu", **kw)


def _jax_sim(cfg=None, log_dir=""):
    pos, vel, mass, ptype, u = _system()
    cfg = cfg or JConfig(**CFG)
    p = JParticles.create(pos, vel, mass, np.arange(len(pos)), ptype,
                          cfg.type_to_grav)
    return JSimulation(cfg, particles=p, sph=JSph.zeros(len(pos)).replace(
        entropy=jnp.asarray(u)), log_dir=log_dir)


def _state(sim) -> dict:
    """Every array (as numpy) and timeline scalar of either package."""
    out = {f"p_{f.name}": np.asarray(getattr(sim.p, f.name))
           for f in dataclasses.fields(sim.p)}
    out.update({f"sph_{f.name}": np.asarray(getattr(sim.sph, f.name))
                for f in dataclasses.fields(sim.sph)})
    out.update({k: getattr(sim, k) for k in SCALARS})
    return out


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_restart_round_trip(tmp_path):
    sim = _port_sim()
    sim.run(max_steps=2)
    path = sim.save_restart(str(tmp_path / "restart.npz"))
    sim.save_restart(path)                  # the first file becomes .bak
    assert (tmp_path / "restart.npz.bak").exists()
    fresh = _port_sim()
    fresh.resume(path)
    _assert_same(_state(sim), _state(fresh))
    assert fresh._forces_bootstrapped and not fresh._entropy_is_u


def test_restart_files_exchange_with_jax(tmp_path):
    js = _jax_sim()
    js.run(max_steps=2)
    ts = _port_sim()
    ts.resume(js.save_restart(str(tmp_path / "from_jax.npz")))
    _assert_same(_state(js), _state(ts))
    ts.run(max_steps=1)
    js2 = _jax_sim()
    js2.resume(ts.save_restart(str(tmp_path / "from_port.npz")))
    _assert_same(_state(ts), _state(js2))


def test_resume_is_bit_identical(tmp_path):
    whole = _port_sim()
    whole.run(max_steps=3)
    part = _port_sim()
    part.run(max_steps=1)
    path = part.save_restart(str(tmp_path / "r.npz"))
    resumed = _port_sim()
    resumed.resume(path)
    resumed.run(max_steps=2)
    _assert_same(_state(whole), _state(resumed))


def test_timemax_extension_shifts_the_timeline(tmp_path):
    sim = _port_sim()
    sim.run(max_steps=2)
    path = sim.save_restart(str(tmp_path / "r.npz"))
    longer = dict(CFG, time_max=0.35)       # 3.5x: two halvings
    ts = _port_sim(TConfig(**longer))
    ts.resume(path)
    js = _jax_sim(JConfig(**longer))
    js.resume(path)
    assert ts.ti_current == js.ti_current == sim.ti_current >> 2
    assert ts.cfg.timeline_time_max == js.cfg.timeline_time_max
    assert ts.tbi == float(js.tbi) and ts.cfg.timeline_time_max >= 0.35
    np.testing.assert_array_equal(ts.p.ti_endstep.numpy(),
                                  sim.p.ti_endstep.numpy() >> 2)
    assert ts.time == pytest.approx(sim.time, rel=1e-12)
    ts.run()
    assert 0.35 <= ts.time <= 0.35 + ts.cfg.max_size_timestep


def _gas_ic_run(tmp_path, extra=""):
    pos, vel, mass, ptype, u = _system()
    h = SnapshotHeader()
    h.npart = np.bincount(ptype, minlength=6).astype(np.int32)
    h.npart_total = h.npart.astype(np.uint32)
    ic = tmp_path / "gas.ic"
    write_snapshot(str(ic), SnapshotData(
        header=h, pos=pos, vel=vel, pid=np.arange(len(pos), dtype=np.uint32),
        mass=mass, ptype=ptype, u=u[ptype == 0]))
    out = tmp_path / "out"
    param = tmp_path / "gas.param"
    param.write_text(
        f"InitCondFile {ic}\nOutputDir {out}\nTimeBegin 0\nTimeMax 0.05\n"
        "TimeBetSnapshot 0.02\nTimeOfFirstSnapshot 0\n"
        "TimeBetStatistics 0.01\nMaxSizeTimestep 0.01\n"
        "GravityConstantInternal 1\nSofteningGas 0.05\nSofteningHalo 0.05\n"
        "DesNumNgb 16\nMaxNumNgbDeviation 2\n" + extra)
    return param, out


def test_stop_file_writes_a_restart(tmp_path):
    param, out = _gas_ic_run(tmp_path)
    sim = TSimulation(read_parameter_file(str(param)), device="cpu")
    (out / "stop").write_text("")
    assert sim.run() == 1 and sim.ti_current < TIMEBASE
    sim.close()
    assert not (out / "stop").exists()
    z = np.load(out / "restart.npz")
    assert int(z["ti_current"]) == sim.ti_current
    np.testing.assert_array_equal(z["sph_entropy"], sim.sph.entropy.numpy())


def test_restartflag_1_through_run_main(tmp_path, capsys):
    param, out = _gas_ic_run(tmp_path)
    out.mkdir()
    (out / "stop").write_text("")          # the first run stops at once
    assert trun.main([str(param), "--device", "cpu"]) == 0
    assert "done: 1 steps" in capsys.readouterr().out
    first = np.load(out / "restart.npz")
    assert trun.main([str(param), "1", "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert "final time 0.05" in said
    snaps = sorted(out.glob("snapshot_*"))
    assert len(snaps) == 3                  # t = 0.02, 0.04, final 0.05
    final = read_snapshot(str(snaps[-1]))
    assert final.u is not None and np.isfinite(final.u).all()
    assert int(first["snapshot_count"]) == 0


def test_output_list_matches_jax(tmp_path):
    times = tmp_path / "outputs.txt"
    times.write_text("0.055\n0.0\n0.013\n  0.031 0.2\n")
    kw = dict(CFG, output_list_on=True, output_list_filename=str(times))
    ts = _port_sim(TConfig(**kw), log_dir=str(tmp_path / "t"))
    js = _jax_sim(JConfig(**kw), log_dir=str(tmp_path / "j"))
    seq = []
    while ts._next_output < float("inf"):
        assert ts._next_output == js._next_output
        seq.append(ts._next_output)
        ts._advance_output_time()
        js._advance_output_time()
    assert js._next_output == float("inf") and seq == [0.013, 0.031, 0.055,
                                                       0.2]
    ts = _port_sim(TConfig(**kw), log_dir=str(tmp_path / "t2"))
    ts.run()
    got = [read_snapshot(str(p)).header.time
           for p in sorted((tmp_path / "t2").glob("snapshot_*"))]
    # the list's last time lies past TimeMax: the final snapshot (run.c:
    # 134-141) is written at TimeMax instead
    np.testing.assert_allclose(got, [0.013, 0.031, 0.055, 0.1], rtol=1e-6)
