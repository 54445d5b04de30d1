"""Integer timeline helpers (port of `ngravs_tpu/integrate/timeline.py`).

The simulated timespan [time_begin, time_max] is mapped to integer ticks
[0, TIMEBASE] (reference allvars.h:25); Newtonian runs use linear time.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import TIMEBASE


def timebase_interval(cfg) -> float:
    if cfg.comoving_integration:
        raise NotImplementedError(
            "comoving integration is not yet ported to ngravs_tpu_torch "
            "(ROADMAP Queue 1 item 15)")
    tmax = cfg.timeline_time_max or cfg.time_max
    return (tmax - cfg.time_begin) / TIMEBASE


def ti_to_time(cfg, ti):
    """Physical time at integer time ti."""
    return cfg.time_begin + np.asarray(ti, np.float64) * timebase_interval(cfg)


def time_to_ti(cfg, t) -> int:
    """Integer tick for a physical time, rounded down (run.c:206-225)."""
    return int((t - cfg.time_begin) / timebase_interval(cfg))


def pow2_floor_i32(x: torch.Tensor) -> torch.Tensor:
    """Largest power of two <= x for positive int32 tensors (exact, unlike a
    float log2 above 2^24)."""
    x = x.to(torch.int32)
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return x - (x >> 1)
