"""Global conservation diagnostics (port of
`ngravs_tpu/diagnostics/energy.py`; reference global.c:22-198,
run.c:413-433), for collisionless runs, Newtonian or comoving.

`compute_global_quantities` returns per-type kinetic and potential
energies, momentum, angular momentum, CM and mass, with velocities predicted
from each particle's half-step midpoint to the current time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import N_TYPES


class SysState(NamedTuple):
    energy_kin: torch.Tensor        # scalar
    energy_pot: torch.Tensor
    energy_int: torch.Tensor
    energy_kin_comp: torch.Tensor   # [6]
    energy_pot_comp: torch.Tensor
    energy_int_comp: torch.Tensor
    momentum: torch.Tensor          # [4] (xyz, |p|)
    ang_momentum: torch.Tensor      # [4]
    center_of_mass: torch.Tensor    # [3]
    mass_comp: torch.Tensor         # [6]

    @property
    def energy_tot(self):
        return self.energy_kin + self.energy_pot + self.energy_int


def predicted_velocities(p, tables, ti_current: int,
                         pm_window=None) -> torch.Tensor:
    """Velocities advanced from each particle's kick midpoint to ti_current
    (global.c:52-80, io.c:209-240); the PM term over the PM window
    `pm_window = (pm_ti_begstep, pm_ti_endstep)` when given, else over the
    particle's own window."""
    mid = (p.ti_begstep + p.ti_endstep) // 2
    dt_grav = tables.gravkick_factor(mid, ti_current)
    vel = p.vel + p.accel * dt_grav[:, None]
    if pm_window is None:
        return vel + p.accel_pm * dt_grav[:, None]
    pm_beg, pm_end = pm_window
    it = lambda v: torch.tensor([v], dtype=torch.int32, device=p.device)
    dt_pm = tables.gravkick_factor(it((pm_beg + pm_end) // 2),
                                   it(ti_current))[0]
    return vel + p.accel_pm * dt_pm


def compute_global_quantities(p, tables, ti_current: int, pm_window=None,
                              atime: float = 1.0) -> SysState:
    """The energy statistics; the potential energy carries a 1/a under
    comoving integration (global.c:56)."""
    vel = predicted_velocities(p, tables, ti_current, pm_window)
    m = p.mass
    v2 = torch.sum(vel * vel, dim=-1)
    onehot = torch.nn.functional.one_hot(p.ptype.long(),
                                         N_TYPES).to(m.dtype)   # [N,6]
    ekin_i = 0.5 * m * v2
    epot_i = 0.5 * m * p.potential / atime
    mom = torch.sum(m[:, None] * vel, dim=0)
    ang = torch.sum(m[:, None] * torch.linalg.cross(p.pos, vel), dim=0)
    com = torch.sum(m[:, None] * p.pos, dim=0) / torch.sum(m)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    return SysState(
        energy_kin=torch.sum(ekin_i), energy_pot=torch.sum(epot_i),
        energy_int=zero,
        energy_kin_comp=onehot.T @ ekin_i, energy_pot_comp=onehot.T @ epot_i,
        energy_int_comp=torch.zeros(N_TYPES, dtype=m.dtype, device=m.device),
        momentum=torch.cat([mom, torch.linalg.norm(mom)[None]]),
        ang_momentum=torch.cat([ang, torch.linalg.norm(ang)[None]]),
        center_of_mass=com, mass_comp=onehot.T @ m)


def format_energy_line(time: float, s: SysState) -> str:
    """One energy.txt row (run.c:419-431): time, Eint, Epot, Ekin, then
    per-type (Eint, Epot, Ekin) triplets, then per-type masses — 28 columns."""
    s = SysState(*(t.cpu() for t in s))
    cols = [time, float(s.energy_int), float(s.energy_pot), float(s.energy_kin)]
    for t in range(N_TYPES):
        cols += [float(s.energy_int_comp[t]), float(s.energy_pot_comp[t]),
                 float(s.energy_kin_comp[t])]
    cols += [float(m) for m in s.mass_comp]
    return " ".join(f"{c:.10g}" for c in cols)
