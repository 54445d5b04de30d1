"""Integer timeline helpers (port of `ngravs_tpu/integrate/timeline.py`).

The simulated timespan [time_begin, time_max] is mapped to integer ticks
[0, TIMEBASE] (reference allvars.h:25); comoving runs use log(a) spacing,
Newtonian runs linear time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import TIMEBASE


def timebase_interval(cfg) -> float:
    tmax = cfg.timeline_time_max or cfg.time_max
    if cfg.comoving_integration:
        return (math.log(tmax) - math.log(cfg.time_begin)) / TIMEBASE
    return (tmax - cfg.time_begin) / TIMEBASE


def ti_to_time(cfg, ti):
    """Physical time (or scale factor) at integer time ti."""
    tbi = timebase_interval(cfg)
    if cfg.comoving_integration:
        return cfg.time_begin * np.exp(np.asarray(ti, np.float64) * tbi)
    return cfg.time_begin + np.asarray(ti, np.float64) * tbi


def time_to_ti(cfg, t) -> int:
    """Integer tick for a physical time, rounded down (run.c:206-225)."""
    tbi = timebase_interval(cfg)
    if cfg.comoving_integration:
        return int((math.log(t) - math.log(cfg.time_begin)) / tbi)
    return int((t - cfg.time_begin) / tbi)


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


def pow2_floor(x: int) -> int:
    """Largest power of two <= x for a positive host integer (0 for 0)."""
    return 1 << (x.bit_length() - 1) if x > 0 else 0


def pm_window(ti_next: int, pm_beg: int, pm_end: int, ti_step: int):
    """Advance the PM (long-range) timeline window at a PM step
    (timestep.c:350-408) from the displacement constraint in ticks: the new
    PM step is its power-of-two floor, may only grow onto an aligned tick
    (timestep.c:357-362), and the long-range kick covers the midpoint
    window [old midpoint, new midpoint].  Host integers.  Returns (tstart,
    tend, new_beg, new_end)."""
    ti_step = pow2_floor(max(1, min(ti_step, TIMEBASE - ti_next)))
    old = pm_end - pm_beg
    if ti_step > old > 0 and (TIMEBASE - pm_end) % ti_step > 0:
        ti_step = old
    if ti_next >= TIMEBASE:
        ti_step = 0
    tstart = (pm_beg + pm_end) // 2
    tend = pm_end + ti_step // 2
    return tstart, tend, pm_end, pm_end + ti_step


def pm_window_update(ti_next: int, pm_beg: int, pm_end: int,
                     dt_disp: float, tbi: float):
    """`pm_window` with the constraint in ticks computed as the JAX
    function computes it: f32(dt_disp) / tbi in f32, truncated."""
    step = torch.tensor(dt_disp, dtype=torch.float32) \
        / torch.tensor(tbi, dtype=torch.float32)
    # saturating, as XLA's conversion is (pm_window clamps to TIMEBASE)
    step = torch.clamp(step, max=TIMEBASE)
    return pm_window(ti_next, pm_beg, pm_end, int(step.to(torch.int32)))
