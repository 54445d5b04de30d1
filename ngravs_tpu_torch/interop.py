"""State exchange with the JAX package, through numpy arrays only.

Every function takes or returns numpy arrays keyed by the JAX package's
field names, so a test can hand the same particle state, tree or
configuration to both packages while this package stays free of JAX.
Integer fields keep their width; f32 fields stay f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SimulationConfig
from .ops.tree import Octree
from .particles import Particles


def particles_from_numpy(arrays: dict, device) -> Particles:
    """Particles from {field: array} (every `Particles` field)."""
    return Particles(**{f.name: torch.as_tensor(
        np.array(arrays[f.name]), device=device)
        for f in dataclasses.fields(Particles)})


def particles_to_numpy(p: Particles) -> dict:
    return {f.name: getattr(p, f.name).cpu().numpy()
            for f in dataclasses.fields(Particles)}


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
