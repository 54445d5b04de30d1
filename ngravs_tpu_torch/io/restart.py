"""Restart files: checkpoint and resume of the simulation state (port of
`ngravs_tpu/io/restart.py`; reference restart.c).

One compressed npz of the particle and SPH state plus the integer-timeline
and PM state, under the JAX package's key names, so each package reads the
other's file.  The tree is not saved: a resumed run builds a new one.
`.bak` rotation as restart.c:45-78.  A resume with a larger TimeMax rescales
the integer timeline by power-of-two halvings (readjust_timebase,
begrun.c:821-864): old ticks map to new ticks exactly by a right shift.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..particles import Particles, SphState

# the particle fields the JAX package writes; PSEUDOSYMMETRIC's aphys_old
# is written too and defaults to zeros when a file lacks it
_P_KEYS = ("pos", "vel", "mass", "pid", "ptype", "grav", "accel", "accel_pm",
           "potential", "old_acc", "ti_begstep", "ti_endstep", "grav_cost",
           "aphys_old")


def _default_path(sim) -> str:
    return os.path.join(sim.log_dir or ".", f"{sim.cfg.restart_file}.npz")


def save_restart(sim, path: str | None = None) -> str:
    """Write a restart file for `sim` (restart(0), restart.c:35)."""
    cfg = sim.cfg
    path = path or _default_path(sim)
    if os.path.exists(path):  # .bak rotation (restart.c:45)
        os.replace(path, path + ".bak")
    state = {f"p_{k}": getattr(sim.p, k).cpu().numpy() for k in _P_KEYS}
    if sim.sph is not None:
        for f in dataclasses.fields(SphState):
            state[f"sph_{f.name}"] = getattr(sim.sph, f.name).cpu().numpy()
    state["ti_current"] = np.int64(sim.ti_current)
    state["pm_ti_begstep"] = np.int64(sim.pm_ti_begstep)
    state["pm_ti_endstep"] = np.int64(sim.pm_ti_endstep)
    state["dt_displacement"] = np.float64(sim.dt_displacement)
    state["step_count"] = np.int64(sim.step_count)
    state["snapshot_count"] = np.int64(sim.snapshot_count)
    state["num_force_updates"] = np.int64(sim.num_force_updates)
    state["next_output"] = np.float64(sim._next_output)
    state["next_stats"] = np.float64(sim._next_stats)
    # timeline span, so a resume with a larger TimeMax can rescale the
    # integer ticks (readjust_timebase, begrun.c:821-864)
    state["time_begin"] = np.float64(cfg.time_begin)
    state["timeline_time_max"] = np.float64(cfg.timeline_time_max
                                            or cfg.time_max)
    np.savez_compressed(path + ".tmp.npz", **state)
    os.replace(path + ".tmp.npz", path)
    return path


def timeline_shift(cfg, old_tb: float, old_tmax: float):
    """(shift, timeline TimeMax) for a resume of a checkpoint whose
    timeline spans [old_tb, old_tmax] under `cfg` (readjust_timebase,
    begrun.c:821-864): the number of halvings of the tick rate that make
    the timeline cover cfg.time_max, and the end of the rescaled timeline
    (None when it stays as it was)."""
    if abs(old_tb - cfg.time_begin) > 1e-12 * max(1.0, abs(old_tb)):
        raise ValueError(f"TimeBegin may not change on resume: checkpoint "
                         f"{old_tb} vs config {cfg.time_begin}")
    shift = 0
    if cfg.time_max > old_tmax * (1 + 1e-12):
        if cfg.comoving_integration:
            old_span = math.log(old_tmax) - math.log(old_tb)
            new_span = math.log(cfg.time_max) - math.log(old_tb)
        else:
            old_span = old_tmax - old_tb
            new_span = cfg.time_max - old_tb
        while old_span * (1 << shift) < new_span * (1 - 1e-12):
            shift += 1
    if not shift and cfg.time_max >= old_tmax * (1 - 1e-12):
        return 0, None
    # a shrinking TimeMax keeps the old timeline; run() stops early
    tl_tmax = old_tmax
    if shift:
        if cfg.comoving_integration:
            tl_tmax = old_tb * math.exp(math.log(old_tmax / old_tb)
                                        * (1 << shift))
        else:
            tl_tmax = old_tb + (old_tmax - old_tb) * (1 << shift)
    return shift, tl_tmax


def load_restart(sim, path: str | None = None):
    """Resume `sim` from a restart file (restart(1)).

    Shape-defining configuration (particle counts, n_gravs, pmgrid, wiring)
    must match the checkpoint; run-control parameters may change, as the
    reference allows (begrun.c:81-128).  A larger TimeMax rescales the
    timeline (`timeline_shift`); the run then stops on Time > TimeMax
    (run.c:32)."""
    from ..cosmology import make_tables
    from ..integrate.timeline import timebase_interval
    z = np.load(path or _default_path(sim))
    dev = sim.device

    shift = 0
    if "timeline_time_max" in z.files:
        shift, tl_tmax = timeline_shift(sim.cfg, float(z["time_begin"]),
                                        float(z["timeline_time_max"]))
        if tl_tmax is not None:
            sim.cfg = sim.cfg.replace(timeline_time_max=tl_tmax)
            sim.tbi = timebase_interval(sim.cfg)
            sim.tables = make_tables(sim.cfg, sim.units)
            sim.solver.cfg = sim.cfg
            if sim.hydro is not None:
                sim.hydro.cfg = sim.cfg

    pk = {k[2:]: torch.as_tensor(z[k], device=dev) for k in z.files
          if k.startswith("p_")}
    pk.setdefault("aphys_old", torch.zeros_like(pk["old_acc"]))
    sim.p = Particles(**pk)
    if shift:
        sim.p = sim.p.replace(ti_begstep=sim.p.ti_begstep >> shift,
                              ti_endstep=sim.p.ti_endstep >> shift)
    if sim.sph is not None:
        sim.sph = SphState(**{k[4:]: torch.as_tensor(z[k], device=dev)
                              for k in z.files if k.startswith("sph_")})
    sim.ti_current = int(z["ti_current"]) >> shift
    sim.pm_ti_begstep = int(z["pm_ti_begstep"]) >> shift
    sim.pm_ti_endstep = int(z["pm_ti_endstep"]) >> shift
    sim.dt_displacement = float(z["dt_displacement"])
    sim.step_count = int(z["step_count"])
    sim.snapshot_count = int(z["snapshot_count"])
    sim.num_force_updates = int(z["num_force_updates"])
    sim._next_output = float(z["next_output"])
    sim._next_stats = float(z["next_stats"])
    sim._forces_bootstrapped = True
    sim._entropy_is_u = False
    return sim
