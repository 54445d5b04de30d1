"""KDK leapfrog on the integer timeline with individual power-of-two steps.

Port of `ngravs_tpu/integrate/kdk.py`, Newtonian or comoving, with gas:
  * drift   — predict.c:31 `move_particles` (all particles), box wrap, and
              the SPH prediction of predict.c:55-76 (`predict_sph`)
  * kick    — timestep.c:24 `advance_and_find_timesteps` (active particles),
              with the hydro kick, the predicted velocity and the entropy
              update for gas
  * dt rule — timestep.c:427 `get_timestep`, criterion 0, with the
              comoving prefactors of timestep.c:48-61 and the Courant limit

  * glass   — timestep.c:85-133 under MAKEGLASS (`glass_step`)

Every operation is a masked update over whole tensors; the active set is
`ti_endstep == ti_current`.  The integer-step bookkeeping (power-of-two
floor, SYNCHRONIZATION alignment rule, midpoint kick windows) is the
reference's, and so are its variants: FLEXSTEPS' per-particle phase grid
and PSEUDOSYMMETRIC's probabilistic halving and doubling of a step.
Scalars are f32 0-d tensors computed in the JAX package's order, so both
packages put a particle in the same bin; timeline integers stay int32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..constants import SOFTFAC_SPLINE, TIMEBASE
from .timeline import pow2_floor_i32, timebase_interval


class CosmoFactors(NamedTuple):
    """Comoving prefactors at the current time (timestep.c:48-61)."""
    fac1: torch.Tensor      # 1/a^2 — converts GravAccel to physical
    fac2: torch.Tensor      # 1/a^{3 GAMMA - 2} — HydroAccel to physical
    fac3: torch.Tensor      # a^{3(1-GAMMA)/2} — signal-velocity factor
    hubble_a: torch.Tensor  # H(a)
    a3inv: torch.Tensor
    atime: torch.Tensor


def cosmo_factors(cfg, units, time_now, device="cpu") -> CosmoFactors:
    """f32 0-d tensors on `device`; all ones for Newtonian runs.
    `time_now` may be an f32 tensor (a segment's device-side time)."""
    if cfg.comoving_integration:
        a = torch.as_tensor(time_now, dtype=torch.float32, device=device)
        h2 = (cfg.omega0 / (a * a * a)
              + (1 - cfg.omega0 - cfg.omega_lambda) / (a * a)
              + cfg.omega_lambda)
        g = cfg.gamma
        return CosmoFactors(
            fac1=1.0 / (a * a), fac2=1.0 / a ** (3 * g - 2),
            fac3=a ** (3 * (1 - g) / 2.0),
            hubble_a=units.hubble * torch.sqrt(h2),
            a3inv=1.0 / (a * a * a), atime=a)
    one = torch.ones((), dtype=torch.float32, device=device)
    return CosmoFactors(one, one, one, one, one, one)


def compute_timestep_dt(cfg, p, dt_displacement: float,
                        soft_table: torch.Tensor,
                        cf: CosmoFactors | None = None,
                        sph=None) -> torch.Tensor:
    """Per-particle dt from timestep criterion 0, before the MinSizeTimestep
    floor (timestep.c:427-530): dt = sqrt(2 eta atime eps_plummer /
    |a_phys|) in dloga for comoving runs, Courant-limited for gas, clamped
    by MaxSizeTimestep and the displacement constraint.  `cf` None means
    Newtonian factors."""
    is_gas = p.ptype == 0
    if cf is None:
        acc = p.accel + p.accel_pm
        if sph is not None:
            acc = acc + torch.where(is_gas[:, None], sph.hydro_accel, 0.0)
        atime = hubble_a = None
    else:
        acc = p.accel * cf.fac1 + p.accel_pm * cf.fac1
        if sph is not None:
            acc = acc + torch.where(is_gas[:, None],
                                    sph.hydro_accel * cf.fac2, 0.0)
        atime, hubble_a = cf.atime, cf.hubble_a
    ac = torch.sqrt(torch.sum(acc * acc, dim=-1))
    ac = torch.clamp(ac, min=1.0e-30) * cfg.ngravs_timestep_scale
    eps = soft_table[p.ptype.long()]
    if cfg.adaptive_gravsoft_forgas and sph is not None:
        # gas Plummer-equivalent = Hsml/2.8 (timestep.c:497-500)
        eps = torch.where(is_gas, sph.hsml / torch.tensor(
            SOFTFAC_SPLINE, dtype=torch.float32, device=p.device), eps)
    if atime is None:
        dt = torch.sqrt(2 * cfg.err_tol_int_accuracy * eps / ac)
    else:
        dt = torch.sqrt(2 * cfg.err_tol_int_accuracy * atime * eps / ac)
    if sph is not None:
        # SPH Courant criterion (timestep.c:507-518)
        vmax = torch.clamp(sph.max_signal_vel, min=1e-30)
        if atime is None:
            dt_courant = 2 * cfg.courant_fac * sph.hsml / vmax
        else:
            dt_courant = 2 * cfg.courant_fac * atime * sph.hsml \
                / (cf.fac3 * vmax)
        dt = torch.where(is_gas & (sph.max_signal_vel > 0),
                         torch.minimum(dt, dt_courant), dt)
    if hubble_a is not None:
        dt = dt * hubble_a  # physical -> dloga
    dt = torch.clamp(dt, max=cfg.max_size_timestep)
    return torch.clamp(dt, max=dt_displacement)


def compute_timestep_ticks(cfg, p, dt_displacement: float,
                           soft_table: torch.Tensor,
                           cf: CosmoFactors | None = None,
                           sph=None) -> torch.Tensor:
    """Per-particle integer step (power-of-two), floored to MinSizeTimestep
    then to a power of two on the integer timeline (timestep.c:427-560)."""
    dt = compute_timestep_dt(cfg, p, dt_displacement, soft_table, cf, sph)
    dt = torch.clamp(dt, min=cfg.min_size_timestep)
    # a true f32 division (a Python-scalar divisor may become a multiply by
    # its reciprocal, which can round differently at a bin edge)
    tbi = torch.tensor(timebase_interval(cfg), dtype=torch.float32,
                       device=dt.device)
    # clamped before the cast: a step longer than the whole timeline
    # saturates, as XLA's conversion does, where a bare cast would wrap
    ti_step = torch.clamp(torch.clamp(dt / tbi, max=TIMEBASE)
                          .to(torch.int32), 1, TIMEBASE)
    return pow2_floor_i32(ti_step)


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def glass_step(cfg, units, p):
    """MAKEGLASS (timestep.c:85-133): reversed gravity (tree and PM)
    displaces every particle toward uniformity, the largest displacement
    clamped to the mean interparticle spacing; velocities and
    accelerations are zeroed; periodic positions wrap."""
    acc = -(p.accel + p.accel_pm)
    disp_fac = 2.0 / (3 * units.hubble ** 2)
    disp = torch.sqrt(torch.sum(acc * acc, dim=-1)) * disp_fac
    dmax = torch.amax(disp)
    rho_crit_mean = cfg.omega0 * 3 * units.hubble ** 2 \
        / (8 * math.pi * units.G)
    dmean = (p.mass[0] / _f32(max(rho_crit_mean, 1e-37), p.device)) \
        ** (1.0 / 3)
    fac = torch.where(dmax > dmean, dmean / dmax, 1.0)
    pos = p.pos + fac * acc * disp_fac
    if cfg.periodic and cfg.box_size > 0:
        pos = torch.remainder(pos, cfg.box_size)
    return p.replace(pos=pos, vel=torch.zeros_like(p.vel),
                     accel=torch.zeros_like(p.accel),
                     accel_pm=torch.zeros_like(p.accel_pm))


def _flex_align(ti_step, ti_endstep, flex):
    """FLEXSTEPS (timestep.c:196-199): a step ends on the particle's
    group-phase grid of spacing ti_step, so sync points spread out
    instead of piling up at powers of two.  `flex` = (flex_grp [N] int32,
    present_min_step, present_max_step)."""
    flex_grp, pmin_step, pmax_step = flex
    ti_grp = flex_grp % max(int(pmax_step), 1)
    ti_grp = (ti_grp // max(int(pmin_step), 1)) * int(pmin_step)
    base = ti_endstep + ti_grp
    ti_step = ((base + ti_step) // ti_step) * ti_step - base
    return torch.clamp(ti_step, min=1)


def _pseudosymmetric(cfg, p, active, ti_step, dt_displacement, soft_table,
                     cf: CosmoFactors, rnd_table):
    """PSEUDOSYMMETRIC (timestep.c:202-238), non-gas particles only: the
    physical acceleration at the end of the proposed step, predicted to
    first order; where it would give another step, THIS step halves or
    doubles with a probability that makes the step sequence
    time-symmetric on average.  Returns (ti_step, aphys_old')."""
    dev = p.device
    old_step = p.ti_endstep - p.ti_begstep
    acc_p = (p.accel + p.accel_pm) * cf.fac1
    aphys = torch.sqrt(torch.sum(acc_p * acc_p, dim=-1))
    slope = (aphys - p.aphys_old) \
        / torch.clamp(old_step, min=1).to(aphys.dtype)
    apred = aphys + slope * ti_step.to(aphys.dtype)
    eligible = (p.ptype != 0) & (old_step > 0) & active \
        & (torch.abs(apred - aphys) < 0.5 * aphys)
    # the step the predicted acceleration would give (get_timestep with
    # flag -1: the whole criterion with its clamps)
    eps = soft_table[p.ptype.long()]
    eta2 = 2 * cfg.err_tol_int_accuracy * cf.atime * eps
    ac2 = torch.clamp(apred, min=1e-30) * cfg.ngravs_timestep_scale
    dt2 = torch.sqrt(eta2 / ac2) * cf.hubble_a
    hi = _f32(min(cfg.max_size_timestep, float(dt_displacement)), dev)
    dt2 = torch.minimum(torch.clamp(dt2, min=cfg.min_size_timestep), hi)
    tbi = _f32(timebase_interval(cfg), dev)
    ti2 = pow2_floor_i32(torch.clamp(torch.clamp(dt2 / tbi, max=TIMEBASE)
                                     .to(torch.int32), 1,
                                     TIMEBASE))
    # the acceleration equivalent of dt = ti_step and 2 ti_step
    # (get_timestep's flag > 0 branch, timestep.c:475-487)
    dt_cur = ti_step.to(aphys.dtype) * tbi / cf.hubble_a
    scale = cfg.ngravs_timestep_scale
    ac_eq_s = eta2 / torch.clamp(dt_cur * dt_cur * scale, min=1e-37)
    ac_eq_g = eta2 / torch.clamp(4 * dt_cur * dt_cur * scale, min=1e-37)
    denom = aphys - p.aphys_old
    safe_den = torch.where(denom == 0, 1e-30, denom)
    base_fac = old_step.to(aphys.dtype) \
        / torch.clamp(ti_step, min=1).to(aphys.dtype) / safe_den
    prob_s = (ac_eq_s - aphys) * base_fac
    prob_g = (ac_eq_g - aphys) * base_fac
    nr = rnd_table.shape[0]
    pid = p.pid.long()
    rnd_a = rnd_table[pid % nr]
    rnd_b = rnd_table[(pid + 1) % nr]
    shrink = eligible & (ti2 < ti_step) & (prob_s < rnd_a)
    grow = eligible & (ti2 > ti_step) & (prob_g < rnd_b)
    ti_step = torch.where(shrink, ti_step // 2,
                          torch.where(grow, ti_step * 2, ti_step))
    aphys_old = torch.where(active & (p.ptype != 0), aphys, p.aphys_old)
    return torch.clamp(ti_step, min=1), aphys_old


def kick(cfg, p, tables, ti_current: int, dt_displacement: float,
         soft_table: torch.Tensor, cf: CosmoFactors | None = None,
         sph=None, min_egy_spec: float = 0.0, flex=None, rnd_table=None):
    """advance_and_find_timesteps (timestep.c:24-408) for the active set.
    Returns (particles', sph').  `p.accel` already includes G; the
    long-range PM kick is the runner's (timestep.c:350-408).
    `min_egy_spec` is the MinGasTemp floor on u (units.min_egy_spec).

    SYNCHRONIZATION mode unless `flex` = (flex_grp, present_min_step,
    present_max_step) asks for FLEXSTEPS' phase grid; under
    PSEUDOSYMMETRIC `rnd_table` is the step's table of uniform draws."""
    active = p.ti_endstep == ti_current
    ti_step = compute_timestep_ticks(cfg, p, dt_displacement, soft_table, cf,
                                     sph)

    if flex is not None:
        ti_step = _flex_align(ti_step, p.ti_endstep, flex)
    else:
        if cfg.pseudosymmetric and rnd_table is not None:
            ti_step, aphys_old = _pseudosymmetric(
                cfg, p, active, ti_step, dt_displacement, soft_table,
                cf or cosmo_factors(cfg, None, 1.0, p.device), rnd_table)
            p = p.replace(aphys_old=aphys_old)
        # SYNCHRONIZATION rule (timestep.c:240-246): a step may only grow
        # if the new end lands on an aligned tick
        old_step = p.ti_endstep - p.ti_begstep
        wants_increase = ti_step > old_step
        misaligned = ((TIMEBASE - p.ti_endstep) % ti_step) > 0
        ti_step = torch.where(wants_increase & misaligned & (old_step > 0),
                              old_step, ti_step)

    # end-of-run clamps (timestep.c:249-253)
    if ti_current == TIMEBASE:
        ti_step = torch.zeros_like(ti_step)
    ti_step = torch.clamp(ti_step, max=TIMEBASE - ti_current)

    # midpoint kick windows (timestep.c:255-271)
    tstart = (p.ti_begstep + p.ti_endstep) // 2   # midpoint of old step
    tend = p.ti_endstep + ti_step // 2            # midpoint of new step
    dt_grav = tables.gravkick_factor(tstart, tend)
    vel = p.vel + torch.where(active[:, None], p.accel * dt_grav[:, None],
                              0.0)
    new_beg = torch.where(active, p.ti_endstep, p.ti_begstep)
    new_end = torch.where(active, p.ti_endstep + ti_step, p.ti_endstep)

    if sph is not None:
        is_act_gas = active & (p.ptype == 0)
        dt_hydro = tables.hydrokick_factor(tstart, tend)
        vel = vel + torch.where(is_act_gas[:, None],
                                sph.hydro_accel * dt_hydro[:, None], 0.0)
        # predicted velocity rewound to the step start (timestep.c:113-117)
        dt_grav2 = tables.gravkick_factor(p.ti_endstep, tend)
        dt_hydro2 = tables.hydrokick_factor(p.ti_endstep, tend)
        vel_pred = vel - p.accel * dt_grav2[:, None] \
            - sph.hydro_accel * dt_hydro2[:, None]
        vel_pred = torch.where(is_act_gas[:, None], vel_pred, sph.vel_pred)
        # entropy update with the -50% floor (timestep.c:123-126)
        dt_entr = (tend - tstart).to(torch.float32) * timebase_interval(cfg)
        d_ent = sph.dt_entropy * dt_entr
        entropy = torch.where(d_ent > -0.5 * sph.entropy,
                              sph.entropy + d_ent, sph.entropy * 0.5)
        dt_entropy = sph.dt_entropy
        if min_egy_spec > 0:
            gm1 = cfg.gamma_minus1
            rho = sph.density if cf is None else sph.density * cf.a3inv
            min_entropy = min_egy_spec * gm1 \
                / torch.clamp(rho, min=1e-30) ** gm1
            floor_hit = entropy < min_entropy
            entropy = torch.where(floor_hit, min_entropy, entropy)
            dt_entropy = torch.where(floor_hit & is_act_gas, 0.0, dt_entropy)
        entropy = torch.where(is_act_gas, entropy, sph.entropy)
        sph = sph.replace(vel_pred=vel_pred, entropy=entropy,
                          dt_entropy=dt_entropy)
    return p.replace(vel=vel, ti_begstep=new_beg, ti_endstep=new_end), sph


def _gravkick1(tables, t0: int, t1: int, dev):
    it = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)
    return tables.gravkick_factor(it(t0), it(t1))[0]


def pm_kick(p, tables, tstart: int, tend: int):
    """The long-range kick of ALL particles over the PM midpoint window
    (timestep.c:350-408)."""
    return p.replace(vel=p.vel + p.accel_pm
                     * _gravkick1(tables, tstart, tend, p.device))


def pm_kick_vel_pred(p, sph, tables, ti_current: int, pm_beg: int,
                     pm_end: int):
    """The gas VelPred re-prediction after a PM kick (timestep.c:392-406):
    VelPred = Vel + GravAccel dtA + HydroAccel dtH + GravPM dtB, dtB
    rewinding to the midpoint of the new PM window [pm_beg, pm_end]."""
    mid = (p.ti_begstep + p.ti_endstep) // 2
    dt_a = tables.gravkick_factor(p.ti_begstep, ti_current) \
        - tables.gravkick_factor(p.ti_begstep, mid)
    dt_h = tables.hydrokick_factor(p.ti_begstep, ti_current) \
        - tables.hydrokick_factor(p.ti_begstep, mid)
    dt_b = -_gravkick1(tables, pm_beg, (pm_beg + pm_end) // 2, p.device)
    vp = p.vel + p.accel * dt_a[:, None] \
        + sph.hydro_accel * dt_h[:, None] + p.accel_pm * dt_b
    return sph.replace(vel_pred=torch.where((p.ptype == 0)[:, None], vp,
                                            sph.vel_pred))


def drift(p, tables, ti0: int, ti1: int):
    """move_particles (predict.c:31-104): drift ALL particles ti0 -> ti1."""
    dd = tables.drift_factor(ti0, ti1).to(p.device)
    return p.replace(pos=p.pos + p.vel * dd)


def predict_sph(cfg, p, sph, tables, ti0: int, ti1: int):
    """The SPH part of move_particles (predict.c:55-76) for ti0 -> ti1:
    predicted velocity, density and Hsml extrapolated by div v with the
    MinGasHsml floor, and the pressure re-predicted from the entropy."""
    dev = p.device
    dt_grav = tables.gravkick_factor(ti0, ti1).to(dev)
    dt_hydro = tables.hydrokick_factor(ti0, ti1).to(dev)
    dt_drift = tables.drift_factor(ti0, ti1).to(dev)
    # under PMGRID the prediction includes the long-range force
    # (predict.c:58-61)
    grav_acc = p.accel + p.accel_pm if cfg.pmgrid else p.accel
    vel_pred = sph.vel_pred + grav_acc * dt_grav + sph.hydro_accel * dt_hydro
    ex = sph.div_vel * dt_drift
    density = sph.density * torch.exp(-ex)
    hsml = sph.hsml * torch.exp(ex / 3.0)
    # MinGasHsml floor (predict.c:69-71) on gas rows only (hsml > 0)
    min_hsml = cfg.min_gas_hsml_fractional * cfg.softening[0] * 2.8
    if min_hsml > 0:
        hsml = torch.where(sph.hsml > 0, torch.clamp(hsml, min=min_hsml),
                           hsml)
    # entropy advanced from the particle's own step start to ti1
    dt_entr = (torch.tensor(ti1, dtype=torch.float32, device=dev)
               - p.ti_begstep.to(torch.float32)) * timebase_interval(cfg)
    pressure = (sph.entropy + sph.dt_entropy * dt_entr) \
        * density ** cfg.gamma
    return sph.replace(vel_pred=vel_pred, density=density, hsml=hsml,
                       pressure=pressure)


def box_wrap(cfg, p):
    """do_box_wrapping (predict.c:106-134); per-axis sizes under LONG_X/Y/Z
    (predict.c:114-122)."""
    if not cfg.periodic or cfg.box_size <= 0:
        return p
    box = torch.tensor(cfg.box_sizes, dtype=p.pos.dtype, device=p.device)
    return p.replace(pos=torch.remainder(p.pos, box))
