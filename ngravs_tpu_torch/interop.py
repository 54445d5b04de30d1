"""State exchange with the JAX package, through numpy arrays only.

Every function takes or returns numpy arrays keyed by the JAX package's
field names, so a test can hand the same particle state, tree,
configuration or whole simulation state to both packages while this
package stays free of JAX.
Integer fields keep their width; f32 fields stay f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SimulationConfig
from .ops.tree import Octree
from .particles import Particles, SphState


def _from_numpy(cls, arrays: dict, device):
    return cls(**{f.name: torch.as_tensor(np.array(arrays[f.name]),
                                          device=device)
                  for f in dataclasses.fields(cls)})


def _to_numpy(obj) -> dict:
    return {f.name: getattr(obj, f.name).cpu().numpy()
            for f in dataclasses.fields(obj)}


def particles_from_numpy(arrays: dict, device) -> Particles:
    """Particles from {field: array} (every `Particles` field)."""
    return _from_numpy(Particles, arrays, device)


def particles_to_numpy(p: Particles) -> dict:
    return _to_numpy(p)


def sph_from_numpy(arrays: dict, device) -> SphState:
    """SphState from {field: array} (every `SphState` field)."""
    return _from_numpy(SphState, arrays, device)


def sph_to_numpy(sph: SphState) -> dict:
    return _to_numpy(sph)


def octree_from_numpy(arrays: dict, device) -> Octree:
    """Octree from {field: array} holding every field of the JAX package's
    `Octree` (ngravs_tpu/ops/tree.py:53-107)."""
    return Octree(**{f: torch.as_tensor(np.array(arrays[f]),
                                        device=device)
                     for f in Octree._fields})


def config_from_dict(fields: dict) -> SimulationConfig:
    """SimulationConfig from the JAX config's dataclass fields."""
    names = {f.name for f in dataclasses.fields(SimulationConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown config fields {sorted(unknown)}")
    return SimulationConfig(**fields)


def simulation_from_state(state: dict, device, log_dir: str = ""):
    """The port's `Simulation` at the point of another run's state, from
    numpy arrays and plain values:

        config            {field: value} of SimulationConfig (wiring incl.)
        particles         {field: array} of every `Particles` field
        sph               {field: array} of every `SphState` field
                          (optional; a gas run past its first force pass,
                          so the entropy field holds A, not u)
        ti_current, dt_displacement, pm_ti_begstep, pm_ti_endstep
        step_count, num_force_updates, next_output, next_stats (optional)

    The solver starts without a cached tree, so its first force pass
    builds one; that is what the source run does too once
    TreeDomainUpdateFrequency * N force updates have passed since its last
    build (any full step)."""
    from .integrate.runner import Simulation
    cfg = config_from_dict(state["config"])
    p = particles_from_numpy(state["particles"], device)
    sph = sph_from_numpy(state["sph"], device) if "sph" in state else None
    sim = Simulation(cfg, particles=p, sph=sph, log_dir=log_dir,
                     device=device)
    sim._entropy_is_u = False
    sim.ti_current = int(state["ti_current"])
    sim.dt_displacement = float(state["dt_displacement"])
    sim.pm_ti_begstep = int(state["pm_ti_begstep"])
    sim.pm_ti_endstep = int(state["pm_ti_endstep"])
    sim.step_count = int(state.get("step_count", 0))
    sim.num_force_updates = int(state.get("num_force_updates", 0))
    # OldAcc is set once any force pass ran: the relative criterion needs
    # no geometric bootstrap then (accel.c:48-52)
    sim._forces_bootstrapped = bool(np.any(
        np.asarray(state["particles"]["old_acc"]) > 0))
    if "next_output" in state:
        sim._next_output = float(state["next_output"])
    if "next_stats" in state:
        sim._next_stats = float(state["next_stats"])
    return sim
