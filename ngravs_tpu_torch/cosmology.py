"""Kick/drift factor tables (port of `ngravs_tpu/cosmology.py`).

Only the non-comoving `LinearTables` is ported: every factor is
dt = (ti1 - ti0) * Timebase_interval, with both ticks rounded to f32 first
as the JAX package does.  The comoving tables (reference driftfac.c) wait
for ROADMAP Queue 1 item 15.
"""

from __future__ import annotations

import torch

from .constants import TIMEBASE


def _f32(ti) -> torch.Tensor:
    if isinstance(ti, torch.Tensor):
        return ti.to(torch.float32)
    return torch.tensor(ti, dtype=torch.float32)


class LinearTables:
    """Non-comoving stand-in: every factor is just dt = (ti1-ti0)*interval."""

    def __init__(self, timebase_interval: float):
        self.timebase_interval = timebase_interval

    def _dt(self, ti0, ti1) -> torch.Tensor:
        return (_f32(ti1) - _f32(ti0)) * self.timebase_interval

    drift_factor = _dt
    gravkick_factor = _dt
    hydrokick_factor = _dt


def make_tables(cfg, units) -> LinearTables:
    if cfg.comoving_integration:
        raise NotImplementedError(
            "comoving integration is not yet ported to ngravs_tpu_torch "
            "(ROADMAP Queue 1 item 15)")
    return LinearTables((cfg.time_max - cfg.time_begin) / TIMEBASE)
