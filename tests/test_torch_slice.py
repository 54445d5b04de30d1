"""The port's main path end to end against the JAX package's `Simulation`.

About 2k particles in two Plummer spheres, the stock N_GRAVS=2 wiring (disk
-> gravity 1), headless, stepped five sync points by each package: the
`ti_current` sequence, the active counts and the end-of-step timeline are
identical, and positions agree within 1e-5 relative.  Seed 3 with these
masses puts no particle near a timestep-bin edge: every kicked particle's
dt / Timebase_interval stays more than 1e-4 (in log2) from a power of two,
two orders above the ~1e-6 relative force differences between the
packages, so rounding cannot move a particle into another bin (the test
checks this margin; seed 4 would come within 6e-6).  Then `run.main`
drives a tiny IC from a parameterfile, the run's stop file writes a
restart file that resumes, multi-device runs raise naming their ROADMAP
item, segments advance, and the periodic pure-tree run (once refused)
runs.  Every
run here asks for the CPU by name: the port's entry points run on the
CUDA card by default and raise without one.

The second slice, the comoving periodic TreePM box with the newton_yukawa
wiring (a 2 x 8^3 collisionless version of tests/test_cosmological.py:
20-63), is started in the port from the JAX `Simulation`'s state after its
first step (`interop.simulation_from_state`) and stepped five more sync
points in both: the `ti_current` sequence, the PM window, the active
counts and `ti_endstep` are equal, positions agree within 1e-5 relative
and `accel_pm` within 1e-4 of its largest value (the two FFTs and CIC
scatter-adds sum in different orders).  Softening 5 and MaxSizeTimestep
0.1 give individual timesteps between the PM steps; the bin-edge margin is
checked as above (seed 19 keeps it above 9e-4; seed 11 would come within
5e-5).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from ngravs_tpu.config import SimulationConfig as JConfig
from ngravs_tpu.integrate.runner import Simulation as JSimulation
from ngravs_tpu.particles import Particles as JParticles
from ngravs_tpu.units import set_units as j_set_units

from ngravs_tpu_torch import run as trun
from ngravs_tpu_torch.config import SimulationConfig as TConfig
from ngravs_tpu_torch.constants import TIMEBASE
from ngravs_tpu_torch.integrate.kdk import compute_timestep_dt
from ngravs_tpu_torch.integrate.runner import Simulation as TSimulation
from ngravs_tpu_torch.integrate.timeline import timebase_interval
from ngravs_tpu_torch.interop import simulation_from_state
from ngravs_tpu_torch.io.gadget_format import (SnapshotData, SnapshotHeader,
                                               read_snapshot, write_snapshot)
from ngravs_tpu_torch.particles import Particles as TParticles

# tiny tensors: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (a parallel run is several times slower else)
torch.set_num_threads(1)


def _two_plummers(n=2000, seed=3, m_tot=300.0):
    rng = np.random.default_rng(seed)

    def plummer(k):
        x = rng.uniform(1e-3, 0.999, k)
        r = np.minimum(1.0 / np.sqrt(x ** (-2 / 3) - 1), 10.0)
        u = rng.normal(size=(k, 3))
        return r[:, None] * u / np.linalg.norm(u, axis=1, keepdims=True)

    pos = np.concatenate([plummer(n // 2) + [-3, 0, 0],
                          plummer(n - n // 2) + [3, 0, 0]]).astype(np.float32)
    vel = np.concatenate([np.tile([0.3, 0.05, 0], (n // 2, 1)),
                          np.tile([-0.3, -0.05, 0], (n - n // 2, 1))])
    vel = (vel + rng.normal(0, 0.2, (n, 3))).astype(np.float32)
    mass = np.full(n, m_tot / n, np.float32)
    ptype = np.where(rng.uniform(size=n) < 0.3, 2, 1).astype(np.int32)
    return pos, vel, mass, ptype


SLICE_CFG = dict(
    time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
    softening=(0.0, 0.05, 0.02, 0.05, 0.05, 0.05), max_size_timestep=0.01,
    time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
    time_bet_statistics=0.0, n_gravs=2, type_to_grav=(0, 0, 1, 0, 0, 0),
    wiring="newton", tree_depth=8, walk_batch_blocks=32)


@pytest.mark.parametrize("solver", ["tree", "direct"])
def test_five_steps_match_jax(solver):
    pos, vel, mass, ptype = _two_plummers()
    n = len(pos)
    jcfg = JConfig(solver=solver, **SLICE_CFG)
    tcfg = TConfig(solver=solver, **SLICE_CFG)
    js = JSimulation(jcfg, particles=JParticles.create(
        pos, vel, mass, np.arange(n), ptype, jcfg.type_to_grav), log_dir="")
    ts = TSimulation(tcfg, particles=TParticles.create(
        pos, vel, mass, np.arange(n), ptype, tcfg.type_to_grav,
        device="cpu"), log_dir="")
    active = []
    for _ in range(5):
        end = np.asarray(js.p.ti_endstep)
        active.append(int((end == end.min()).sum()))
        js.step()
        ts.step()
        assert ts.ti_current == js.ti_current
        assert ts.num_force_updates == js.num_force_updates
        np.testing.assert_array_equal(ts.p.ti_endstep.numpy(),
                                      np.asarray(js.p.ti_endstep))
        jpos = np.asarray(js.p.pos)
        assert np.abs(ts.p.pos.numpy() - jpos).max() \
            <= 1e-5 * np.abs(jpos).max()
        # the seed keeps every kicked particle off a bin edge
        kicked = ts.p.ti_begstep == ts.ti_current
        ticks = compute_timestep_dt(tcfg, ts.p, ts.dt_displacement,
                                    ts._soft_t)[kicked].double().numpy() \
            / timebase_interval(tcfg)
        assert np.abs(np.log2(ticks) - np.round(np.log2(ticks))).min() > 1e-4
    # individual timesteps: some sync points move only part of the system
    assert active[0] == n and min(active) < n
    if solver == "tree":
        assert ts.solver.uses_direct(n) is False


def _tiny_run(tmp_path, extra=""):
    rng = np.random.default_rng(4)
    npart = (0, 40, 24, 0, 0, 0)
    n = sum(npart)
    h = SnapshotHeader()
    h.npart = np.array(npart, np.int32)
    h.npart_total = h.npart.astype(np.uint32)
    ic = tmp_path / "tiny.ic"
    write_snapshot(str(ic), SnapshotData(
        header=h, pos=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        vel=rng.normal(0, 0.1, (n, 3)).astype(np.float32),
        pid=np.arange(n, dtype=np.uint32),
        mass=np.full(n, 0.1, np.float32),
        ptype=np.repeat(np.arange(6, dtype=np.int32), npart)))
    out = tmp_path / "out"
    param = tmp_path / "tiny.param"
    param.write_text(
        f"InitCondFile {ic}\nOutputDir {out}\nTimeBegin 0\nTimeMax 0.05\n"
        "TimeBetSnapshot 0.02\nTimeOfFirstSnapshot 0\n"
        "TimeBetStatistics 0.01\nMaxSizeTimestep 0.005\n"
        "GravityConstantInternal 1\nSofteningHalo 0.05\nSofteningDisk 0.05\n"
        "GravityDisk 1\n" + extra)
    return param, out, n


def test_run_main_smoke(tmp_path, capsys):
    param, out, n = _tiny_run(tmp_path)
    assert trun.main([str(param), "--device", "cpu"]) == 0
    assert "done:" in capsys.readouterr().out
    assert (tmp_path / "tiny.param-usedvalues").exists()
    snaps = sorted(out.glob("snapshot_*"))
    assert len(snaps) >= 2
    final = read_snapshot(str(snaps[-1]))
    assert final.n == n and np.isfinite(final.pos).all()
    energy = np.loadtxt(out / "energy.txt", ndmin=2)
    assert energy.shape[1] == 28 and energy.shape[0] >= 5
    assert (out / "info.txt").read_text().count("Begin Step") >= 10
    # restart from the last snapshot (restartflag 2)
    assert trun.main([str(param), "2", "--device", "cpu"]) == 0


def test_stop_file_and_unported_options(tmp_path):
    param, out, _ = _tiny_run(tmp_path)
    from ngravs_tpu_torch.config import read_parameter_file
    sim = TSimulation(read_parameter_file(str(param)), device="cpu")
    (out / "stop").write_text("")
    assert sim.run() == 1 and sim.ti_current < TIMEBASE
    sim.close()
    # the stop file writes a restart file (run.c:67-103), which resumes
    restart = np.load(out / "restart.npz")
    assert int(restart["ti_current"]) == sim.ti_current
    np.testing.assert_array_equal(restart["p_pos"], sim.p.pos.numpy())
    again = TSimulation(read_parameter_file(str(param)), device="cpu")
    again.resume()
    assert again.ti_current == sim.ti_current
    assert torch.equal(again.p.vel, sim.p.vel)
    # --devices runs ranks now (ROADMAP item 18a); a launch the machine
    # cannot carry refuses before any rank starts, naming what to ask for
    with pytest.raises(RuntimeError, match="--device cpu|--backend gloo"):
        trun.main([str(param), "--devices", "4"])
    # segments (ROADMAP item 10a) run: two calls of a segment_steps=4 run
    # advance the timeline and count their steps
    seg = TSimulation(read_parameter_file(str(param)), segment_steps=4,
                      device="cpu", log_dir="")
    seg.step()                       # the first sync point, at tick 0
    ticks = []
    for _ in range(2):
        seg.step()
        ticks.append(seg.ti_current)
    assert 0 < ticks[0] < ticks[1] and seg.step_count >= 3
    assert seg.seg_counts["segments"] >= 1
    # the periodic pure-tree run (ROADMAP item 13) runs: the lattice tables
    # are built and the steps stay inside the box
    param2, _, _ = _tiny_run(tmp_path, "PeriodicBoundariesOn 1\nBoxSize 1\n")
    periodic = TSimulation(read_parameter_file(str(param2), ngravs_en=8),
                           device="cpu", log_dir="")
    assert periodic.solver.lattice_tables is not None
    assert periodic.run(max_steps=2) == 2
    assert float(periodic.p.pos.min()) >= 0 and float(periodic.p.pos.max()) < 1


def test_entry_points_need_a_card_unless_asked(tmp_path, monkeypatch):
    """No quiet CPU fallback: without a CUDA device `Simulation(cfg)` and
    `run.main` raise and say how to ask for the CPU."""
    param, _, _ = _tiny_run(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from ngravs_tpu_torch.config import read_parameter_file
    cfg = read_parameter_file(str(param))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TSimulation(cfg)
    with pytest.raises(RuntimeError, match="--device cpu"):
        trun.main([str(param)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSimulation(cfg, device="cuda")
    assert TSimulation(cfg, device="cpu").device.type == "cpu"
    assert trun.main([str(param), "--device", "gpu"]) == 1


def _cosmo_box(n_side=8, box=10000.0, seed=19):
    """tests/test_cosmological.py:20-63 without gas: a jittered lattice of
    halo particles (type 1, gravity 0) and a second one offset by half a
    cell (type 2, gravity 1) with Omega_b / Omega0 of the mass."""
    rng = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / n_side * box
    n = len(g)
    a = np.mod(g + rng.normal(0, 0.02 * box / n_side, g.shape), box)
    b = np.mod(g + rng.normal(0, 0.02 * box / n_side, g.shape)
               + 0.5 * box / n_side, box)
    pos = np.concatenate([a, b]).astype(np.float32)
    vel = rng.normal(0, 1.0, pos.shape).astype(np.float32)
    ptype = np.concatenate([np.ones(n, np.int32), np.full(n, 2, np.int32)])
    kw = dict(comoving_integration=True, omega0=1.0, omega_lambda=0.0,
              omega_baryon=0.1, hubble_param=1.0, time_begin=0.1,
              time_max=0.2, periodic=True, box_size=box, pmgrid=16,
              softening=(5.0,) * 6, max_size_timestep=0.1,
              err_tol_int_accuracy=0.025, n_gravs=2,
              type_to_grav=(0, 0, 1, 0, 0, 0), wiring="newton_yukawa",
              tree_depth=6, tree_bucket_size=16, walk_batch_blocks=32,
              time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
              time_bet_statistics=0.0)
    units = j_set_units(JConfig(**kw))
    m_tot = 3 * units.hubble ** 2 / (8 * math.pi * units.G) * box ** 3
    mass = np.concatenate([np.full(n, 0.9 * m_tot / n),
                           np.full(n, 0.1 * m_tot / n)]).astype(np.float32)
    return kw, pos, vel, mass, ptype


def test_comoving_treepm_box_matches_jax():
    kw, pos, vel, mass, ptype = _cosmo_box()
    n = len(pos)
    jcfg = JConfig(**kw)
    js = JSimulation(jcfg, particles=JParticles.create(
        pos, vel, mass, np.arange(n), ptype, jcfg.type_to_grav), log_dir="")
    js.step()
    state = dict(
        config=dataclasses.asdict(jcfg),
        particles={f.name: np.asarray(getattr(js.p, f.name))
                   for f in dataclasses.fields(js.p)},
        ti_current=js.ti_current, dt_displacement=js.dt_displacement,
        pm_ti_begstep=js.pm_ti_begstep, pm_ti_endstep=js.pm_ti_endstep,
        step_count=js.step_count, num_force_updates=js.num_force_updates)
    ts = simulation_from_state(state, "cpu")
    assert ts.cfg == TConfig(**kw) and ts.cfg.wiring == "newton_yukawa"
    assert ts.solver.treepm is not None and not ts.solver.uses_direct(n)
    active = []
    for _ in range(5):
        js.step()
        ts.step()
        assert ts.ti_current == js.ti_current
        assert (ts.pm_ti_begstep, ts.pm_ti_endstep) == \
            (js.pm_ti_begstep, js.pm_ti_endstep)
        assert ts.num_force_updates == js.num_force_updates
        np.testing.assert_array_equal(ts.p.ti_endstep.numpy(),
                                      np.asarray(js.p.ti_endstep))
        active.append(int((ts.p.ti_begstep == ts.ti_current).sum()))
        jpos = np.asarray(js.p.pos)
        assert np.abs(ts.p.pos.numpy() - jpos).max() \
            <= 1e-5 * np.abs(jpos).max()
        jpm = np.asarray(js.p.accel_pm)
        assert np.abs(ts.p.accel_pm.numpy() - jpm).max() \
            <= 1e-4 * np.abs(jpm).max()
        # no kicked particle near a timestep-bin edge
        kicked = ts.p.ti_begstep == ts.ti_current
        ticks = compute_timestep_dt(
            ts.cfg, ts.p, ts.dt_displacement, ts._soft_t,
            ts._cosmo())[kicked].double().numpy() / timebase_interval(ts.cfg)
        assert np.abs(np.log2(ticks) - np.round(np.log2(ticks))).min() > 1e-4
    assert ts.dt_displacement == js.dt_displacement
    # PM steps (everyone active) and partial steps between them
    assert max(active) == n and min(active) < n
    assert ts.pm_ti_endstep > 0 and bool(ts.p.accel_pm.abs().max() > 0)
