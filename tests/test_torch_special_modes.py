"""The integrator's special modes in the port against the JAX package's
`Simulation`, on the CPU.

 * FLEXSTEPS (the setup of tests/test_integrator.py:179): every step the
   same `ti_current`, `ti_begstep` / `ti_endstep` and present smallest and
   largest steps, exactly; positions and velocities within 1e-5 of their
   largest magnitude.  Some step ends lie off their own step's grid.
 * PSEUDOSYMMETRIC (tests/test_integrator.py:382, the direct sweep): the
   same comparison, and `aphys_old` within 1e-5 relative.  Both packages
   draw the step's table from numpy's generator of seed 42.
 * MAKEGLASS in a periodic comoving box (tests/test_parallel.py:709-713,
   512 particles), with PMGRID 16 and without: three glass steps, positions
   within 1e-5 of the box size of JAX's, velocities exactly zero, the
   timeline equal.
 * TWODIMS (tests/test_sph.py:153) and LONG_Y (tests/test_sph.py:195),
   without gravity: the first smoothing-length guess equal to f32
   rounding (1e-6 relative), density within 1e-5 relative after the run,
   positions inside the stretched box.
 * A FLEXSTEPS restart round trip: every array and both present steps come
   back exactly, and the resumed run steps on as the original does.

Each run asks for the CPU by name.
"""


import numpy as np
import pytest
import torch

from ngravs_tpu.config import SimulationConfig as JConfig
from ngravs_tpu.integrate.runner import Simulation as JSimulation
from ngravs_tpu.io.gadget_format import (SnapshotData, SnapshotHeader,
                                         write_snapshot)
from ngravs_tpu.particles import Particles as JParticles

from ngravs_tpu_torch.config import SimulationConfig as TConfig
from ngravs_tpu_torch.integrate.runner import Simulation as TSimulation
from ngravs_tpu_torch.particles import Particles as TParticles

# tiny tensors: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (a parallel run is several times slower else)
torch.set_num_threads(1)

RTOL = 1e-5


def _pair(kw, pos=None, vel=None, mass=None, ptype=None, pid=None):
    """The JAX and the port's Simulation on the same config and state (or
    on the IC file the config names)."""
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    if pos is None:
        return (JSimulation(jcfg, log_dir=""),
                TSimulation(tcfg, log_dir="", device="cpu"))
    n = len(pos)
    pid = np.arange(n) if pid is None else pid
    js = JSimulation(jcfg, particles=JParticles.create(
        pos, vel, mass, pid, ptype, jcfg.type_to_grav), log_dir="")
    ts = TSimulation(tcfg, particles=TParticles.create(
        pos, vel, mass, pid, ptype, tcfg.type_to_grav, device="cpu"),
        log_dir="")
    return js, ts


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= RTOL * scale, f"{what}: {err} vs scale {scale}"


def _same_state(js, ts, vel_exact=False):
    assert ts.ti_current == js.ti_current
    assert ts.step_count == js.step_count
    for k in ("ti_begstep", "ti_endstep"):
        np.testing.assert_array_equal(getattr(ts.p, k).numpy(),
                                      np.asarray(getattr(js.p, k)))
    _close(ts.p.pos, js.p.pos, "pos")
    if vel_exact:
        np.testing.assert_array_equal(ts.p.vel.numpy(), np.asarray(js.p.vel))
    else:
        _close(ts.p.vel, js.p.vel, "vel")


FLEX_CFG = dict(
    time_begin=0.0, time_max=2.0, gravity_constant_internal=1.0,
    softening=(0.05,) * 6, max_size_timestep=0.02,
    err_tol_int_accuracy=0.0025, flexsteps=True,
    time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
    time_bet_statistics=0.0, wiring="newton")


def _flex_system(n=64):
    rng = np.random.default_rng(7)
    pos = rng.normal(0, 1, (n, 3))
    vel = rng.normal(0, 0.1, (n, 3))
    return pos, vel, np.full(n, 1.0 / n), np.ones(n, np.int32)


def test_flexsteps_matches_jax():
    js, ts = _pair(FLEX_CFG, *_flex_system())
    off_grid = False
    # the hierarchy opens (present_min_step < present_max_step) at step 36
    for _ in range(42):
        js.step()
        ts.step()
        _same_state(js, ts)
        assert (ts.present_min_step, ts.present_max_step) == \
            (js.present_min_step, js.present_max_step)
        assert 1 <= ts.present_min_step <= ts.present_max_step
        end = ts.p.ti_endstep.numpy()
        step = end - ts.p.ti_begstep.numpy()
        off_grid |= bool(((end % step) != 0).any())
    # FLEXSTEPS' phase grid: some end is not a multiple of its own step
    assert off_grid
    np.testing.assert_array_equal(ts.flex_grp.numpy(),
                                  np.asarray(js.flex_grp))


def _small_ic(path, npart, seed):
    """tests/test_integrator.py:_small_ic without gas."""
    rng = np.random.default_rng(seed)
    n = sum(npart)
    h = SnapshotHeader()
    h.npart = np.array(npart, np.int32)
    h.npart_total = h.npart.astype(np.uint32)
    write_snapshot(str(path), SnapshotData(
        header=h, pos=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        vel=rng.normal(0, 0.1, (n, 3)).astype(np.float32),
        pid=np.arange(n, dtype=np.uint32),
        mass=np.full(n, 0.1, np.float32),
        ptype=np.repeat(np.arange(6, dtype=np.int32), npart)))
    return str(path)


def test_pseudosymmetric_matches_jax(tmp_path):
    ic = _small_ic(tmp_path / "ic_psym", (0, 64, 0, 0, 0, 0), seed=3)
    kw = dict(init_cond_file=ic, time_begin=0.0, time_max=1.0,
              gravity_constant_internal=1.0, softening=(0.05,) * 6,
              time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
              time_bet_statistics=0.0, max_size_timestep=0.02,
              wiring="newton", pseudosymmetric=True, solver="direct",
              err_tol_int_accuracy=0.002)
    js, ts = _pair(kw)
    for _ in range(8):
        js.step()
        ts.step()
        _same_state(js, ts)
        _close(ts.p.aphys_old, js.p.aphys_old, "aphys_old")
    steps = (ts.p.ti_endstep - ts.p.ti_begstep).numpy()
    assert (steps > 0).all() and ((steps & (steps - 1)) == 0).all()
    assert float(ts.p.aphys_old.max()) > 0


def _glass_kw(pmgrid):
    """tests/test_parallel.py:_collisionless_cfg with the glass's box."""
    return dict(time_begin=0.1, time_max=0.2, gravity_constant_internal=1.0,
                softening=(0.02,) * 6, max_size_timestep=0.02, n_gravs=1,
                type_to_grav=(0,) * 6, wiring="newton",
                err_tol_int_accuracy=0.02, make_glass=True, periodic=True,
                box_size=10.0, comoving_integration=True, omega0=1.0,
                omega_lambda=0.0, hubble_param=1.0, time_bet_snapshot=0.0,
                time_of_first_snapshot=1e30, time_bet_statistics=0.0,
                pmgrid=pmgrid, solver="tree", tree_depth=4, ngravs_en=8,
                walk_batch_blocks=32)


@pytest.mark.filterwarnings("ignore:IC mass implies")
@pytest.mark.parametrize("pmgrid", [16, 0])
def test_makeglass_matches_jax(pmgrid):
    rng = np.random.default_rng(5)
    n = 512
    pos = rng.uniform(0, 10.0, (n, 3))
    js, ts = _pair(_glass_kw(pmgrid), pos, np.zeros((n, 3)),
                   np.full(n, 1.0 / n), np.ones(n, np.int32))
    for _ in range(3):
        js.step()
        ts.step()
        _same_state(js, ts, vel_exact=True)
        assert not bool(ts.p.vel.any())
        # within 1e-5 of the box size: the wrap may move a coordinate that
        # rounds to the box edge by a whole box in one package only
        d = np.abs(ts.p.pos.numpy() - np.asarray(js.p.pos))
        d = np.minimum(d, 10.0 - d)
        assert float(d.max()) <= RTOL * 10.0
    p = ts.p.pos.numpy()
    assert (p >= 0).all() and (p < 10.0).all()
    assert np.abs(p - pos).max() > 0


def _sheet_ic(path):
    """tests/test_sph.py:153: a 16 x 16 gas sheet of unit mass."""
    side = 16
    n = side * side
    g = (np.arange(side) + 0.5) / side
    xx, yy = np.meshgrid(g, g, indexing="ij")
    pos = np.stack([xx.ravel(), yy.ravel(), np.zeros(n)], 1)
    return _gas_ic(path, pos.astype(np.float32), np.zeros((n, 3), np.float32))


def _gas_ic(path, pos, vel):
    n = len(pos)
    h = SnapshotHeader()
    h.npart = np.array([n, 0, 0, 0, 0, 0], np.int32)
    h.npart_total = h.npart.astype(np.uint32)
    write_snapshot(str(path), SnapshotData(
        header=h, pos=pos, vel=vel,
        pid=np.arange(1, n + 1, dtype=np.uint32),
        mass=np.full(n, 1.0 / n, np.float32), ptype=np.zeros(n, np.int32),
        u=np.full(n, 1.0, np.float32)))
    return str(path), n


def _long_ic(path):
    """tests/test_sph.py:195: 64 gas particles in a 1 x 4 x 1 box."""
    rng = np.random.default_rng(17)
    pos = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    pos[:, 1] *= 4.0
    return _gas_ic(path, pos, rng.normal(0, 0.2, (64, 3)).astype(np.float32))


SPH_BASE = dict(time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
                time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
                time_bet_statistics=0.0, no_gravity=True, wiring="newton")
SPH_CASES = {
    "twodims": (_sheet_ic, dict(softening=(0.01,) * 6,
                                max_size_timestep=0.005, twodims=True,
                                des_num_ngb=16), 1, (1.0, 1.0, 1.0)),
    "long_y": (_long_ic, dict(softening=(0.05,) * 6, max_size_timestep=0.01,
                              periodic=True, box_size=1.0, long_y=4.0,
                              des_num_ngb=12), 3, (1.0, 4.0, 1.0)),
}


@pytest.mark.parametrize("case", list(SPH_CASES))
def test_twodims_and_long_boxes_match_jax(tmp_path, case):
    make_ic, kw, steps, box = SPH_CASES[case]
    ic, n = make_ic(tmp_path / f"ic_{case}")
    js, ts = _pair(dict(SPH_BASE, init_cond_file=ic, **kw))
    h_j = np.asarray(js.sph.hsml)
    np.testing.assert_allclose(ts.sph.hsml.numpy(), h_j, rtol=1e-6)
    assert float(ts.sph.hsml[0]) > 0
    js.run(max_steps=steps)
    ts.run(max_steps=steps)
    assert ts.ti_current == js.ti_current
    np.testing.assert_allclose(ts.sph.density.numpy()[:n],
                               np.asarray(js.sph.density)[:n], rtol=RTOL)
    _close(ts.p.pos, js.p.pos, "pos")
    p = ts.p.pos.numpy()
    if case == "long_y":
        assert (p >= 0).all() and (p < np.array(box)).all()
    else:
        assert (p[:, 2] == 0).all()


def test_flexsteps_restart_round_trip(tmp_path):
    pos, vel, mass, ptype = _flex_system()
    n = len(pos)
    cfg = TConfig(**FLEX_CFG)
    make = lambda: TSimulation(cfg, particles=TParticles.create(
        pos, vel, mass, np.arange(n), ptype, cfg.type_to_grav, device="cpu"),
        log_dir="", device="cpu")
    sim = make()
    for _ in range(6):
        sim.step()
    path = sim.save_restart(str(tmp_path / "flex_restart.npz"))
    z = np.load(path)
    assert int(z["present_min_step"]) == sim.present_min_step
    fresh = make()
    fresh.resume(path)
    for k, v in vars(sim.p).items():
        assert torch.equal(v, getattr(fresh.p, k)), k
    for k in ("ti_current", "step_count", "num_force_updates",
              "dt_displacement", "present_min_step", "present_max_step"):
        assert getattr(fresh, k) == getattr(sim, k), k
    assert torch.equal(fresh.flex_grp, sim.flex_grp)
    for _ in range(3):
        sim.step()
        fresh.step()
    assert fresh.ti_current == sim.ti_current
    assert torch.equal(fresh.p.pos, sim.p.pos)
    assert (fresh.present_min_step, fresh.present_max_step) == \
        (sim.present_min_step, sim.present_max_step)


def test_steps_longer_than_the_timeline_saturate_as_jax():
    """A timestep longer than the whole timeline (dt / TimeBase_interval
    past 2^31) saturates at TIMEBASE in the f32 -> int32 conversion, as
    XLA's does, in the step criterion, PSEUDOSYMMETRIC's predicted step
    and the PM window; a bare cast would wrap it to one tick."""
    from ngravs_tpu import units as junits
    from ngravs_tpu.constants import TIMEBASE
    from ngravs_tpu.cosmology import LinearTables as JTables
    from ngravs_tpu.integrate import kdk as jkdk
    from ngravs_tpu.integrate import timeline as jtl
    from ngravs_tpu_torch.cosmology import LinearTables as TTables
    from ngravs_tpu_torch.integrate import kdk as tkdk
    from ngravs_tpu_torch.integrate import timeline as ttl

    kw = dict(time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
              softening=(0.05,) * 6, max_size_timestep=100.0,
              err_tol_int_accuracy=0.025, pseudosymmetric=True,
              wiring="newton")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    tbi = ttl.timebase_interval(tcfg)
    # dt / tbi from 2^28 to 2^33 (the criterion dt = sqrt(2 eta eps / a));
    # the acceleration 10% below its last value predicts a step 1.12x
    # longer, so near 2^31 only the predicted step passes the int32 range
    n = 400
    ticks = 2.0 ** np.linspace(28, 33, n)
    eps = 0.05 / 2.8
    a = 2 * kw["err_tol_int_accuracy"] * eps / (ticks * tbi) ** 2
    accel = np.zeros((n, 3), np.float32)
    accel[:, 0] = a
    old = 1 << 28
    soft = np.full(6, eps, np.float32)
    rnd = np.random.default_rng(42).uniform(size=n).astype(np.float32)
    pos = np.random.default_rng(0).normal(size=(n, 3))
    args = (pos, np.zeros((n, 3)), np.full(n, 1.0 / n), np.arange(n),
            np.ones(n, np.int32))
    jp = JParticles.create(*args, jcfg.type_to_grav)
    jp = jp.replace(accel=jp.accel.at[:].set(accel),
                    aphys_old=jp.aphys_old.at[:].set(1.1 * a),
                    ti_begstep=jp.ti_begstep.at[:].set(-old),
                    ti_endstep=jp.ti_endstep.at[:].set(0))
    tp = TParticles.create(*args, tcfg.type_to_grav, device="cpu")
    tp = tp.replace(accel=torch.as_tensor(accel),
                    aphys_old=torch.as_tensor(1.1 * a, dtype=torch.float32),
                    ti_begstep=torch.full((n,), -old, dtype=torch.int32),
                    ti_endstep=torch.zeros(n, dtype=torch.int32))
    units = junits.set_units(jcfg)
    cf = jkdk.cosmo_factors(jcfg, units, 0.0)

    want = np.asarray(jkdk.compute_timestep_ticks(
        jcfg, units, jp, None, cf, 100.0, soft))
    got = tkdk.compute_timestep_ticks(tcfg, tp, 100.0,
                                      torch.as_tensor(soft)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[ticks >= 2.0 ** 29] == TIMEBASE).all()

    # PSEUDOSYMMETRIC from tick 0 (every step lands on an aligned tick):
    # the new step ends and aphys_old equal
    jq, _ = jkdk.kick(jcfg, units, jp, None, JTables(tbi), 0, 100.0, soft,
                      0.0, rnd_table=rnd)
    tq, _ = tkdk.kick(tcfg, tp, TTables(tbi), 0, 100.0,
                      torch.as_tensor(soft), rnd_table=torch.as_tensor(rnd))
    np.testing.assert_array_equal(tq.ti_endstep.numpy(),
                                  np.asarray(jq.ti_endstep))
    np.testing.assert_array_equal(tq.aphys_old.numpy(),
                                  np.asarray(jq.aphys_old))
    assert int(tq.ti_endstep.max()) == TIMEBASE

    # the PM window from a constraint of 2^32 ticks
    for ti_next, beg, end in ((0, 0, 0), (1 << 20, 0, 1 << 20)):
        want = [int(x) for x in jtl.pm_window_update(ti_next, beg, end,
                                                      2.0 ** 32 * tbi, tbi)]
        got = list(ttl.pm_window_update(ti_next, beg, end, 2.0 ** 32 * tbi,
                                        tbi))
        assert got == want, (ti_next, got, want)
        if ti_next == 0:
            assert got[3] - got[2] == TIMEBASE
