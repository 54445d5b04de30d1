"""Particle state as structure-of-arrays tensors on one device.

Port of `ngravs_tpu/particles.py`.  The reference's AoS `struct particle_data
P[]` (allvars.h:546-581) becomes a dataclass of `[N]` / `[N, 3]` tensors that
all live on the device the caller chose.  Updates are functional
(`replace`), as in the JAX package, so two simulations may start from one
`Particles` object.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SphState:
    """Per-gas-particle SPH state (reference allvars.h:587-606).

    Tensors have length N (the full particle count), as in the JAX
    package; entries of non-gas particles are unused and stay zero."""
    entropy: torch.Tensor        # entropic function A (u before the
                                 # first density pass of an IC)
    density: torch.Tensor
    hsml: torch.Tensor           # smoothing length
    pressure: torch.Tensor
    dt_entropy: torch.Tensor
    hydro_accel: torch.Tensor    # [N,3]
    vel_pred: torch.Tensor       # [N,3] predicted velocity
    div_vel: torch.Tensor
    curl_vel: torch.Tensor
    dhsml_density_factor: torch.Tensor
    max_signal_vel: torch.Tensor
    num_ngb: torch.Tensor

    replace = dataclasses.replace

    def to(self, device) -> "SphState":
        return SphState(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})

    @staticmethod
    def zeros(n: int, device) -> "SphState":
        z1 = lambda: torch.zeros(n, dtype=torch.float32, device=device)
        z3 = lambda: torch.zeros(n, 3, dtype=torch.float32, device=device)
        return SphState(entropy=z1(), density=z1(), hsml=z1(), pressure=z1(),
                        dt_entropy=z1(), hydro_accel=z3(), vel_pred=z3(),
                        div_vel=z1(), curl_vel=z1(), dhsml_density_factor=z1(),
                        max_signal_vel=z1(), num_ngb=z1())


@dataclass
class Particles:
    """Global particle state (reference allvars.h:546-581)."""
    pos: torch.Tensor          # [N,3] f32
    vel: torch.Tensor          # [N,3] f32
    mass: torch.Tensor         # [N] f32
    pid: torch.Tensor          # [N] int32 particle IDs
    ptype: torch.Tensor        # [N] int32 Gadget type 0..5
    grav: torch.Tensor         # [N] int32 gravity index (TypeToGrav[ptype])
    accel: torch.Tensor        # [N,3] gravitational acceleration (times G)
    accel_pm: torch.Tensor     # [N,3] long-range (PM) accel; zero here
    potential: torch.Tensor    # [N]
    old_acc: torch.Tensor      # [N] |accel| of previous step (relative opening)
    aphys_old: torch.Tensor    # [N] |accel| at last step (PSEUDOSYMMETRIC)
    ti_begstep: torch.Tensor   # [N] int32, integer-timeline step start
    ti_endstep: torch.Tensor   # [N] int32, integer-timeline step end
    grav_cost: torch.Tensor    # [N] f32 interaction count

    replace = dataclasses.replace

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @staticmethod
    def create(pos, vel, mass, pid, ptype, type_to_grav,
               device) -> "Particles":
        """From host arrays; IDs wrap to int32 as in the JAX package."""
        f32 = lambda a: torch.as_tensor(np.array(a, np.float32),
                                        device=device)
        i32 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32),
                                        device=device)
        pos = f32(pos)
        n = pos.shape[0]
        ptype = i32(ptype)
        t2g = i32(np.asarray(type_to_grav))
        z1 = lambda: torch.zeros(n, dtype=torch.float32, device=device)
        z3 = lambda: torch.zeros(n, 3, dtype=torch.float32, device=device)
        zi = lambda: torch.zeros(n, dtype=torch.int32, device=device)
        return Particles(
            pos=pos, vel=f32(vel).reshape(n, 3), mass=f32(mass),
            pid=i32(pid), ptype=ptype, grav=t2g[ptype.long()],
            accel=z3(), accel_pm=z3(), potential=z1(), old_acc=z1(),
            aphys_old=z1(), ti_begstep=zi(), ti_endstep=zi(),
            grav_cost=z1())
