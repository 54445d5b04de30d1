"""Gas runs of the port against the JAX package's `Simulation`, on the CPU.

 * One full force pass (`compute_forces(full=True)`: gravity, the density
   iteration, the u -> A conversion and the hydro pass) for each of
   ISOTHERM_EQS, SPH_BND_PARTICLES, NOVISCOSITYLIMITER,
   ADAPTIVE_GRAVSOFT_FORGAS (with its pre-force density), InitGasTemp (an
   IC file with u = 0) and a periodic NOGRAVITY box as tests/test_sph.py
   builds it.  The particles sit mid-step (ti_begstep 0, ti_endstep =
   ti_current > 0), so the viscosity limiter is live.  SPH state within
   1e-5 relative (hydro terms within 1e-4 of their largest value: pair
   forces cancel), gravity within 5e-4 of the largest (the two direct sums
   add 600 softened terms, some of them near-coincident, in other orders).
 * The slice: the comoving TreePM + SPH box of
   tests/test_cosmological.py:_cosmo_box (2 x 8^3, newton_yukawa), one JAX
   step, then `interop.simulation_from_state` with its SPH state and five
   more sync points in each package: the same `ti_current` sequence,
   active counts, PM window and `ti_endstep`; positions within 1e-5
   relative; entropy, Hsml and density within 1e-4 relative.  No kicked
   particle sits within 1e-4 (in log2) of a timestep-bin edge (the seeds
   are chosen so: seed 8 of the open box keeps 1e-3, seed 4 came within
   5e-5).
 * An open box with gas (two Plummer spheres, 10 % gas, direct gravity),
   three steps from the same start, checked the same way.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ngravs_tpu.config import SimulationConfig as JConfig
from ngravs_tpu.integrate.runner import Simulation as JSimulation
from ngravs_tpu.particles import Particles as JParticles
from ngravs_tpu.particles import SphState as JSph

from ngravs_tpu_torch.config import SimulationConfig as TConfig
from ngravs_tpu_torch.integrate.kdk import compute_timestep_dt
from ngravs_tpu_torch.integrate.runner import Simulation as TSimulation
from ngravs_tpu_torch.integrate.timeline import timebase_interval
from ngravs_tpu_torch.interop import (particles_from_numpy, sph_from_numpy,
                                      simulation_from_state)
from ngravs_tpu_torch.io.gadget_format import (SnapshotData, SnapshotHeader,
                                               write_snapshot)

# tiny tensors: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (a parallel run is several times slower else)
torch.set_num_threads(1)

SPH_FIELDS = ("entropy", "density", "hsml", "pressure", "dt_entropy",
              "hydro_accel", "vel_pred", "div_vel", "curl_vel",
              "dhsml_density_factor", "max_signal_vel", "num_ngb")


def _np(obj, fields=None):
    fields = fields or [f.name for f in dataclasses.fields(obj)]
    return {k: np.asarray(getattr(obj, k)) for k in fields}


def _port_of(js: JSimulation, cfg_kw=None, **state):
    """The port's Simulation at the JAX run's current state."""
    return simulation_from_state(dict(
        config=dataclasses.asdict(js.cfg), particles=_np(js.p),
        sph=_np(js.sph, SPH_FIELDS), ti_current=js.ti_current,
        dt_displacement=js.dt_displacement, pm_ti_begstep=js.pm_ti_begstep,
        pm_ti_endstep=js.pm_ti_endstep, step_count=js.step_count,
        num_force_updates=js.num_force_updates, **state), "cpu")


def _gas_plummers(n=600, seed=3, gas_frac=0.1):
    """Two Plummer spheres on a collision orbit, `gas_frac` of the
    particles gas (type 0, first), the rest halo and disk."""
    rng = np.random.default_rng(seed)

    def plummer(k):
        x = rng.uniform(1e-3, 0.999, k)
        r = np.minimum(1.0 / np.sqrt(x ** (-2 / 3) - 1), 10.0)
        u = rng.normal(size=(k, 3))
        return r[:, None] * u / np.linalg.norm(u, axis=1, keepdims=True)

    pos = np.concatenate([plummer(n // 2) - [3, 0, 0],
                          plummer(n - n // 2) + [3, 0, 0]])
    vel = np.concatenate([np.tile([0.3, 0.05, 0], (n // 2, 1)),
                          np.tile([-0.3, -0.05, 0], (n - n // 2, 1))])
    vel = vel + rng.normal(0, 0.2, (n, 3))
    ptype = np.where(rng.uniform(size=n) < gas_frac, 0,
                     np.where(rng.uniform(size=n) < 0.3, 2, 1))
    order = np.argsort(ptype, kind="stable")
    return (pos[order].astype(np.float32), vel[order].astype(np.float32),
            np.full(n, 300.0 / n, np.float32), ptype[order].astype(np.int32))


OPEN_CFG = dict(
    time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
    softening=(0.05, 0.05, 0.02, 0.05, 0.05, 0.05), max_size_timestep=0.01,
    time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
    time_bet_statistics=0.0, n_gravs=2, type_to_grav=(0, 0, 1, 0, 0, 0),
    wiring="newton", des_num_ngb=24, max_num_ngb_deviation=2,
    tree_group_size=64, tree_bucket_size=16, tree_depth=8)


def _gas_box(n_side=8, box=1.0, seed=0):
    """tests/test_sph.py:34-62: a jittered lattice of equal-mass gas."""
    rng = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / n_side * box
    g = np.mod(g + rng.normal(0, 0.05 * box / n_side, g.shape), box)
    n = len(g)
    return (g.astype(np.float32), rng.normal(0, 0.1, (n, 3)).astype(
        np.float32), np.full(n, 1.0 / n, np.float32), np.zeros(n, np.int32))


def _write_ic(path, pos, vel, mass, ptype, pid, u):
    h = SnapshotHeader()
    h.npart = np.bincount(ptype, minlength=6).astype(np.int32)
    h.npart_total = h.npart.astype(np.uint32)
    write_snapshot(path, SnapshotData(
        header=h, pos=pos, vel=vel, pid=pid.astype(np.uint32), mass=mass,
        ptype=ptype, u=u))
    return path


FORCE_CASES = {
    "isotherm_eqs": dict(isotherm_eqs=True),
    "sph_bnd_particles": dict(sph_bnd_particles=True),
    "no_viscosity_limiter": dict(no_viscosity_limiter=True),
    "adaptive_gravsoft_forgas": dict(adaptive_gravsoft_forgas=True),
    "init_gas_temp": dict(init_gas_temp=1e4),
    "periodic_nogravity": dict(periodic=True, box_size=1.0, no_gravity=True,
                               des_num_ngb=40, softening=(0.02,) * 6,
                               max_size_timestep=0.005),
}


@pytest.mark.parametrize("case", list(FORCE_CASES))
def test_full_force_pass_matches_jax(case, tmp_path):
    kw = {**OPEN_CFG, **FORCE_CASES[case]}
    if case == "periodic_nogravity":
        pos, vel, mass, ptype = _gas_box()
    else:
        pos, vel, mass, ptype = _gas_plummers()
    n = len(pos)
    n_gas = int((ptype == 0).sum())
    pid = np.arange(n)
    if case == "sph_bnd_particles":
        pid[: n_gas // 4] = 0                 # ID 0: fixed wall particles
    u = np.where(np.arange(n_gas) % 3 == 0, 0.3, 0.6).astype(np.float32)
    if case == "init_gas_temp":
        u[::2] = 0.0                          # these start at InitGasTemp
        kw["init_cond_file"] = _write_ic(str(tmp_path / "gas.ic"), pos, vel,
                                         mass, ptype, pid, u)
        js = JSimulation(JConfig(**kw), log_dir="")
        ts = TSimulation(TConfig(**kw), log_dir="", device="cpu")
        assert float(ts.sph.entropy.max()) > 10 * float(u.max())
    else:
        jc = JConfig(**kw)
        u_all = np.zeros(n, np.float32)
        u_all[:n_gas] = u
        jp = JParticles.create(pos, vel, mass, pid, ptype, jc.type_to_grav)
        # VelPred = Vel, as init.c sets it
        jsph = JSph.zeros(n).replace(entropy=jnp.asarray(u_all),
                                     vel_pred=jnp.asarray(vel))
        js = JSimulation(jc, particles=jp, sph=jsph, log_dir="")
        ts = TSimulation(TConfig(**kw), particles=particles_from_numpy(
            _np(jp), "cpu"), sph=sph_from_numpy(_np(jsph, SPH_FIELDS), "cpu"),
            log_dir="", device="cpu")
    for name in ("hsml", "entropy"):
        np.testing.assert_allclose(getattr(ts.sph, name).numpy(),
                                   np.asarray(getattr(js.sph, name)),
                                   rtol=1e-5, err_msg=name)
    # mid-step: every particle's step [0, ti] ends now, so dt > 0
    ti = 1 << 20
    js.p = js.p.replace(ti_endstep=jnp.full(n, ti, jnp.int32))
    ts.p = ts.p.replace(ti_endstep=torch.full((n,), ti, dtype=torch.int32))
    js.ti_current = ts.ti_current = ti
    js.compute_forces(full=True)
    ts.compute_forces(full=True)

    ja = np.asarray(js.p.accel)
    assert np.abs(ts.p.accel.numpy() - ja).max() <= 5e-4 * np.abs(ja).max()
    gas = slice(0, n_gas)
    for name in SPH_FIELDS:
        w = np.asarray(getattr(js.sph, name))[gas]
        g = getattr(ts.sph, name).numpy()[gas]
        if name in ("hydro_accel", "dt_entropy", "div_vel", "curl_vel"):
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-30, name
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-7 * np.abs(w).max(),
                                       err_msg=name)
    assert np.abs(ts.sph.hydro_accel.numpy()[gas]).max() > 0
    assert (ts.sph.max_signal_vel.numpy()[gas] > 0).all()
    if case == "sph_bnd_particles":
        assert not ts.sph.hydro_accel[: n_gas // 4].any()
        assert not ts.sph.dt_entropy[: n_gas // 4].any()
    if case == "isotherm_eqs":
        assert not ts.sph.dt_entropy.any()
        np.testing.assert_array_equal(ts.sph.entropy.numpy()[gas], u)
    elif case == "periodic_nogravity":
        # viscous heating needs approaching pairs: vdotr + hubble_a2 r^2 < 0
        # with hubble_a2 = 1 outside comoving runs (hydra.c:81-95), which
        # the open boxes' sparse gas does not reach
        assert ts.sph.dt_entropy.numpy()[gas].max() > 0


def _off_bin_edges(ts):
    """No kicked particle within 1e-4 (in log2) of a timestep-bin edge."""
    kicked = ts.p.ti_begstep == ts.ti_current
    ticks = compute_timestep_dt(ts.cfg, ts.p, ts.dt_displacement, ts._soft_t,
                                ts._cosmo(), ts.sph)[kicked].double() \
        .numpy() / timebase_interval(ts.cfg)
    return np.abs(np.log2(ticks) - np.round(np.log2(ticks))).min() > 1e-4


def _step_both(js, ts, steps, pm=False):
    active = []
    for _ in range(steps):
        js.step()
        ts.step()
        assert ts.ti_current == js.ti_current
        if pm:
            assert (ts.pm_ti_begstep, ts.pm_ti_endstep) == \
                (js.pm_ti_begstep, js.pm_ti_endstep)
        assert ts.num_force_updates == js.num_force_updates
        np.testing.assert_array_equal(ts.p.ti_endstep.numpy(),
                                      np.asarray(js.p.ti_endstep))
        active.append(int((ts.p.ti_begstep == ts.ti_current).sum()))
        jpos = np.asarray(js.p.pos)
        assert np.abs(ts.p.pos.numpy() - jpos).max() \
            <= 1e-5 * np.abs(jpos).max()
        gas = np.asarray(js.p.ptype) == 0
        for name in ("entropy", "hsml", "density"):
            np.testing.assert_allclose(
                getattr(ts.sph, name).numpy()[gas],
                np.asarray(getattr(js.sph, name))[gas], rtol=1e-4,
                err_msg=name)
        assert _off_bin_edges(ts)
    return active


def test_gas_box_slice_matches_jax():
    import test_cosmological
    cfg, p, sph = test_cosmological._cosmo_box(n_side=8)
    # walk batches of 32 blocks (the default 128) change no result and
    # make the port's CPU walk four times faster here
    js = JSimulation(cfg.replace(walk_batch_blocks=32), particles=p, sph=sph,
                     log_dir="")
    js.step()
    ts = _port_of(js)
    n = ts.p.n
    assert ts.n_gas == n // 2 and not ts._entropy_is_u
    assert ts.solver.treepm is not None and not ts.solver.uses_direct(n)
    active = _step_both(js, ts, 5, pm=True)
    assert max(active) == n
    assert ts.pm_ti_endstep > 0 and bool(ts.p.accel_pm.abs().max() > 0)
    assert ts.dt_displacement == js.dt_displacement
    assert ts.trace.counts["sph.hydro_passes"] == 5


def test_open_box_gas_run_matches_jax():
    pos, vel, mass, ptype = _gas_plummers(n=1200, seed=8)
    n = len(pos)
    jc = JConfig(**OPEN_CFG)
    n_gas = int((ptype == 0).sum())
    u = np.zeros(n, np.float32)
    u[:n_gas] = 0.5
    jp = JParticles.create(pos, vel, mass, np.arange(n), ptype,
                           jc.type_to_grav)
    jsph = JSph.zeros(n).replace(entropy=jnp.asarray(u))
    js = JSimulation(jc, particles=jp, sph=jsph, log_dir="")
    ts = TSimulation(TConfig(**OPEN_CFG),
                     particles=particles_from_numpy(_np(jp), "cpu"),
                     sph=sph_from_numpy(_np(jsph, SPH_FIELDS), "cpu"),
                     log_dir="", device="cpu")
    assert ts.solver.uses_direct(n) and ts._entropy_is_u
    active = _step_both(js, ts, 3)
    assert active[0] == n and min(active) < n
    assert not ts._entropy_is_u
