"""KDK leapfrog on the integer timeline with individual power-of-two steps.

Port of `ngravs_tpu/integrate/kdk.py` for collisionless runs, Newtonian or
comoving:
  * drift   — predict.c:31 `move_particles` (all particles), box wrap
  * kick    — timestep.c:24 `advance_and_find_timesteps` (active particles)
  * dt rule — timestep.c:427 `get_timestep`, criterion 0, with the
              comoving prefactors of timestep.c:48-61

Every operation is a masked update over whole tensors; the active set is
`ti_endstep == ti_current`.  The integer-step bookkeeping (power-of-two
floor, SYNCHRONIZATION alignment rule, midpoint kick windows) is the
reference's.  Scalars are f32 0-d tensors computed in the JAX package's
order, so both packages put a particle in the same bin.  Gas (SPH) and the
FLEXSTEPS / PSEUDOSYMMETRIC variants wait for later slices (ROADMAP Queue 1
items 16-17).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import TIMEBASE
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
    """f32 0-d tensors on `device`; all ones for Newtonian runs."""
    if cfg.comoving_integration:
        a = torch.tensor(time_now, dtype=torch.float32, device=device)
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
                        cf: CosmoFactors | None = None) -> torch.Tensor:
    """Per-particle dt from timestep criterion 0, before the MinSizeTimestep
    floor (timestep.c:427-530): dt = sqrt(2 eta atime eps_plummer /
    |a_phys|) in dloga for comoving runs, clamped by MaxSizeTimestep and the
    displacement constraint.  `cf` None means Newtonian factors."""
    if cf is None:
        acc = p.accel + p.accel_pm
        atime = hubble_a = None
    else:
        acc = p.accel * cf.fac1 + p.accel_pm * cf.fac1
        atime, hubble_a = cf.atime, cf.hubble_a
    ac = torch.sqrt(torch.sum(acc * acc, dim=-1))
    ac = torch.clamp(ac, min=1.0e-30) * cfg.ngravs_timestep_scale
    eps = soft_table[p.ptype.long()]
    if atime is None:
        dt = torch.sqrt(2 * cfg.err_tol_int_accuracy * eps / ac)
    else:
        dt = torch.sqrt(2 * cfg.err_tol_int_accuracy * atime * eps / ac)
        dt = dt * hubble_a  # physical -> dloga
    dt = torch.clamp(dt, max=cfg.max_size_timestep)
    return torch.clamp(dt, max=dt_displacement)


def compute_timestep_ticks(cfg, p, dt_displacement: float,
                           soft_table: torch.Tensor,
                           cf: CosmoFactors | None = None) -> torch.Tensor:
    """Per-particle integer step (power-of-two), floored to MinSizeTimestep
    then to a power of two on the integer timeline (timestep.c:427-560)."""
    dt = compute_timestep_dt(cfg, p, dt_displacement, soft_table, cf)
    dt = torch.clamp(dt, min=cfg.min_size_timestep)
    # a true f32 division (a Python-scalar divisor may become a multiply by
    # its reciprocal, which can round differently at a bin edge)
    tbi = torch.tensor(timebase_interval(cfg), dtype=torch.float32,
                       device=dt.device)
    ti_step = torch.clamp((dt / tbi).to(torch.int32), 1, TIMEBASE)
    return pow2_floor_i32(ti_step)


def kick(cfg, p, tables, ti_current: int, dt_displacement: float,
         soft_table: torch.Tensor, cf: CosmoFactors | None = None):
    """advance_and_find_timesteps (timestep.c:24-408) for the active set,
    SYNCHRONIZATION mode.  `p.accel` already includes G; the long-range
    PM kick is the runner's (timestep.c:350-408)."""
    active = p.ti_endstep == ti_current
    ti_step = compute_timestep_ticks(cfg, p, dt_displacement, soft_table, cf)

    # SYNCHRONIZATION rule (timestep.c:240-246): a step may only grow if
    # the new end lands on an aligned tick
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
    return p.replace(vel=vel, ti_begstep=new_beg, ti_endstep=new_end)


def pm_kick(p, tables, tstart: int, tend: int):
    """The long-range kick of ALL particles over the PM midpoint window
    (timestep.c:350-408)."""
    dev = p.device
    dt = tables.gravkick_factor(
        torch.tensor([tstart], dtype=torch.int32, device=dev),
        torch.tensor([tend], dtype=torch.int32, device=dev))[0]
    return p.replace(vel=p.vel + p.accel_pm * dt)


def drift(p, tables, ti0: int, ti1: int):
    """move_particles (predict.c:31-104): drift ALL particles ti0 -> ti1."""
    dd = tables.drift_factor(ti0, ti1).to(p.device)
    return p.replace(pos=p.pos + p.vel * dd)


def box_wrap(cfg, p):
    """do_box_wrapping (predict.c:106-134); per-axis sizes under LONG_X/Y/Z
    (predict.c:114-122)."""
    if not cfg.periodic or cfg.box_size <= 0:
        return p
    box = torch.tensor(cfg.box_sizes, dtype=p.pos.dtype, device=p.device)
    return p.replace(pos=torch.remainder(p.pos, box))
