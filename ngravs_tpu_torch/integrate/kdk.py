"""KDK leapfrog on the integer timeline with individual power-of-two steps.

Port of `ngravs_tpu/integrate/kdk.py` for collisionless, non-comoving runs:
  * drift   — predict.c:31 `move_particles` (all particles)
  * kick    — timestep.c:24 `advance_and_find_timesteps` (active particles)
  * dt rule — timestep.c:427 `get_timestep`, criterion 0

Every operation is a masked update over whole tensors; the active set is
`ti_endstep == ti_current`.  The integer-step bookkeeping (power-of-two
floor, SYNCHRONIZATION alignment rule, midpoint kick windows) is the
reference's.  Gas (SPH) and the FLEXSTEPS / PSEUDOSYMMETRIC variants wait
for later slices (ROADMAP Queue 1 items 16-17).
"""

from __future__ import annotations

import torch

from ..constants import TIMEBASE
from .timeline import pow2_floor_i32, timebase_interval


def compute_timestep_dt(cfg, p, dt_displacement: float,
                        soft_table: torch.Tensor) -> torch.Tensor:
    """Per-particle dt from timestep criterion 0, before the MinSizeTimestep
    floor (timestep.c:427-530): dt = sqrt(2 eta eps_plummer / |a|), clamped
    by MaxSizeTimestep and the displacement constraint."""
    acc = p.accel + p.accel_pm
    ac = torch.sqrt(torch.sum(acc * acc, dim=-1))
    ac = torch.clamp(ac, min=1.0e-30) * cfg.ngravs_timestep_scale
    eps = soft_table[p.ptype.long()]
    dt = torch.sqrt(2 * cfg.err_tol_int_accuracy * eps / ac)
    dt = torch.clamp(dt, max=cfg.max_size_timestep)
    return torch.clamp(dt, max=dt_displacement)


def compute_timestep_ticks(cfg, p, dt_displacement: float,
                           soft_table: torch.Tensor) -> torch.Tensor:
    """Per-particle integer step (power-of-two), floored to MinSizeTimestep
    then to a power of two on the integer timeline (timestep.c:427-560)."""
    dt = compute_timestep_dt(cfg, p, dt_displacement, soft_table)
    dt = torch.clamp(dt, min=cfg.min_size_timestep)
    # a true f32 division (a Python-scalar divisor may become a multiply by
    # its reciprocal, which can round differently at a bin edge)
    tbi = torch.tensor(timebase_interval(cfg), dtype=torch.float32,
                       device=dt.device)
    ti_step = torch.clamp((dt / tbi).to(torch.int32), 1, TIMEBASE)
    return pow2_floor_i32(ti_step)


def kick(cfg, p, tables, ti_current: int, dt_displacement: float,
         soft_table: torch.Tensor):
    """advance_and_find_timesteps (timestep.c:24-408) for the active set,
    SYNCHRONIZATION mode.  `p.accel` already includes G."""
    active = p.ti_endstep == ti_current
    ti_step = compute_timestep_ticks(cfg, p, dt_displacement, soft_table)

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


def drift(p, tables, ti0: int, ti1: int):
    """move_particles (predict.c:31-104): drift ALL particles ti0 -> ti1."""
    dd = tables.drift_factor(ti0, ti1).to(p.device)
    return p.replace(pos=p.pos + p.vel * dd)
