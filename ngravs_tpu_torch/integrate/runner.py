"""Simulation driver: the main loop (port of `ngravs_tpu/integrate/runner.py`;
reference run.c:20-141, begrun.c, init.c).

    while ti_current < TIMEBASE:
        min_glob = min(ti_endstep)            # global sync point (run.c:165)
        write any snapshots due in (ti_current, min_glob]
        drift all particles -> min_glob       # predict.c
        compute forces for the active set     # accel.c -> solver
        energy statistics if due              # global.c
        kick active set, assign new steps     # timestep.c

This slice covers collisionless, non-periodic, non-comoving runs stepped
one sync point at a time (the general `step()` of the JAX package; it has
no device-resident segments).  Features of later slices raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import math
import os
import time as _time

import numpy as np
import torch

from .. import constants as C
from ..config import SimulationConfig
from ..cosmology import make_tables
from ..diagnostics.energy import (compute_global_quantities,
                                  format_energy_line, predicted_velocities)
from ..io.gadget_format import (SnapshotData, SnapshotHeader, read_snapshot,
                                write_snapshot)
from ..models.wiring import build_wiring
from ..ops.solver import GravitySolver
from ..particles import Particles
from ..units import set_units
from .kdk import compute_timestep_dt, drift, kick
from .timeline import ti_to_time, time_to_ti, timebase_interval


def _check_supported(cfg: SimulationConfig, segment_steps: int):
    """Refuse what this slice does not run, naming the ROADMAP item."""
    todo = [
        (segment_steps != 1, "segment_steps > 1 (device-resident segments)",
         "Queue 1 item 10a"),
        (cfg.comoving_integration, "comoving integration", "Queue 1 item 15"),
        (cfg.periodic, "periodic boundaries", "Queue 1 item 13"),
        (cfg.pmgrid, "TreePM (PMGRID)", "Queue 1 item 14"),
        (cfg.force_test > 0, "FORCETEST", "Queue 1 item 12"),
        (cfg.flexsteps or cfg.pseudosymmetric or cfg.make_glass,
         "FLEXSTEPS / PSEUDOSYMMETRIC / MAKEGLASS", "Queue 1 item 17"),
        (cfg.output_list_on, "OutputListOn", "Queue 1 item 10"),
    ]
    for bad, what, item in todo:
        if bad:
            raise NotImplementedError(
                f"{what} is not yet ported to ngravs_tpu_torch "
                f"(ROADMAP {item})")


def build_snapshot_data(cfg, tables, tbi: float, p: Particles,
                        ti_current: int, time_now: float) -> SnapshotData:
    """A SnapshotData from integrator state (fill_write_buffer,
    io.c:129-351): velocities predicted to now, per-type constant masses
    lifted into the header table."""
    vel = predicted_velocities(p, tables, ti_current)
    pos, vel, mass, pid, ptype, pot = (
        t.cpu().numpy() for t in (p.pos, vel, p.mass, p.pid, p.ptype,
                                  p.potential))
    h = SnapshotHeader()
    counts = np.bincount(ptype, minlength=6).astype(np.int32)
    h.npart = counts
    h.npart_total = counts.astype(np.uint32)
    h.time = time_now
    h.box_size = cfg.box_size
    h.omega0, h.omega_lambda, h.hubble_param = \
        cfg.omega0, cfg.omega_lambda, cfg.hubble_param
    mass_tab = np.zeros(6)
    for t in range(6):
        mt = mass[ptype == t]
        if mt.size and np.all(mt == mt[0]):
            mass_tab[t] = mt[0]
    h.mass = mass_tab
    data = SnapshotData(header=h, pos=pos, vel=vel, pid=pid.astype(np.uint32),
                        mass=mass.copy(), ptype=ptype,
                        pot=pot if cfg.output_potential else None)
    if cfg.output_acceleration:
        data.accel = (p.accel + p.accel_pm).cpu().numpy().astype(np.float32)
    if cfg.output_timestep:
        # (Ti_endstep - Ti_begstep) * Timebase_interval (io.c:343-351)
        data.tstp = ((p.ti_endstep - p.ti_begstep).cpu().numpy()
                     * tbi).astype(np.float32)
    return data


def load_initial_conditions(cfg, ic_path=None, device="cpu") -> Particles:
    """read_ic (read_ic.c:31-146) for collisionless ICs."""
    snap = read_snapshot(ic_path or cfg.init_cond_file,
                         expect_format=cfg.ic_format or None)
    if int(snap.header.npart[0]) > 0:
        raise NotImplementedError(
            "gas (SPH) is not yet ported to ngravs_tpu_torch "
            "(ROADMAP Queue 1 item 16)")
    return Particles.create(snap.pos, snap.vel, snap.mass, snap.pid,
                            snap.ptype, cfg.type_to_grav, device=device)


def write_snapshot_files(cfg, path, data):
    """Route a SnapshotData to format 1/2/HDF5, single- or multi-file
    (savepositions/distribute_file, io.c:33-112)."""
    from ..io import gadget_format as gf
    if cfg.num_files_per_snapshot > 1:
        gf.write_snapshot_multi(
            path, data, cfg.num_files_per_snapshot,
            snap_format=cfg.snap_format, with_pot=cfg.output_potential,
            longids=cfg.longids,
            max_parallel=cfg.num_files_written_in_parallel or None)
    elif cfg.snap_format == 3:
        gf.write_snapshot_hdf5(path + ".hdf5", data,
                               with_pot=cfg.output_potential,
                               longids=cfg.longids)
    else:
        write_snapshot(path, data, snap_format=cfg.snap_format,
                       with_pot=cfg.output_potential, longids=cfg.longids)
    return path


class Simulation:
    """begrun() + run() equivalent on one device.

    `device`: where the particles live (default: that of `particles`, else
    CUDA when available, else the CPU).  `log_dir=""` runs headless (no log
    files); None uses cfg.output_dir, or a scratch directory."""

    def __init__(self, cfg: SimulationConfig, particles: Particles | None = None,
                 ic_path: str | None = None, log_dir: str | None = None,
                 segment_steps: int = 1, device=None):
        _check_supported(cfg, segment_steps)
        self.cfg = cfg
        self.units = set_units(cfg)
        self.wiring = build_wiring(cfg)
        self.tables = make_tables(cfg, self.units)
        self.tbi = timebase_interval(cfg)
        if device is None:
            device = particles.device if particles is not None else (
                "cuda" if torch.cuda.is_available() else "cpu")
        self.device = torch.device(device)

        # softening tables (gravtree.c:468-515): SofteningTable is the
        # Plummer-equivalent; ForceSoftening = 2.8x that
        self.soft_table = np.array(cfg.softening, np.float32)
        self.force_soft = self.soft_table * C.SOFTFAC_SPLINE
        self._soft_t = torch.as_tensor(self.soft_table, device=self.device)

        if particles is None:
            particles = load_initial_conditions(cfg, ic_path=ic_path,
                                                device=self.device)
        if bool(torch.any(particles.ptype == 0)):
            raise NotImplementedError(
                "gas (SPH) is not yet ported to ngravs_tpu_torch "
                "(ROADMAP Queue 1 item 16)")
        self.p = particles

        self.ti_current = 0
        # the displacement constraint binds only comoving runs
        # (timestep.c:596-597): here it stays MaxSizeTimestep
        self.dt_displacement = cfg.max_size_timestep
        self.num_force_updates = 0
        self.step_count = 0
        self.snapshot_count = 0
        self._forces_bootstrapped = False
        self._restart_noted = False

        # log files (begrun.c:202-255)
        self.log_dir = log_dir if log_dir is not None else cfg.output_dir
        if not self.log_dir and log_dir is None:
            from ..utils import scratch_output_dir
            self.log_dir = scratch_output_dir()
        self._logs = {}
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            for key, fname in [("info", cfg.info_file),
                               ("energy", cfg.energy_file),
                               ("cpu", cfg.cpu_file),
                               ("timings", cfg.timings_file)]:
                self._logs[key] = open(os.path.join(self.log_dir, fname), "w")

        self._next_output = self._first_output_time()
        self._next_stats = cfg.time_begin
        self.cpu_timers = {k: 0.0 for k in
                           ["total", "gravity", "drift", "timeline", "snapshot",
                            "potential", "hydro", "domain"]}
        self.solver = GravitySolver(cfg, self.wiring, self.force_soft,
                                    self.units.G, hubble=self.units.hubble)

    # ------------------------------------------------------------------
    def _first_output_time(self):
        cfg = self.cfg
        t = cfg.time_of_first_snapshot
        while t <= cfg.time_begin:
            if cfg.time_bet_snapshot <= 0:
                return float("inf")
            t += cfg.time_bet_snapshot
        return t

    def _advance_output_time(self):
        self._next_output += self.cfg.time_bet_snapshot

    def time_at(self, ti) -> float:
        return float(ti_to_time(self.cfg, ti))

    @property
    def time(self) -> float:
        return self.time_at(self.ti_current)

    def _active_info(self):
        """(number of active particles, min ti_endstep) in one fetch."""
        n_act, min_glob = torch.stack([
            torch.sum(self.p.ti_endstep == self.ti_current),
            torch.amin(self.p.ti_endstep).long()]).cpu()
        return int(n_act), int(min_glob)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def compute_forces(self):
        """compute_accelerations (accel.c:24) for the active set, gravity
        part."""
        t0 = _time.time()
        n_active, _ = self._active_info()
        if n_active == 0:
            return
        n_ia = 0
        act = self.p.ti_endstep == self.ti_current
        if self.cfg.no_gravity:
            # NOGRAVITY (gravtree.c:368-374): active particles get zero
            # gravitational acceleration
            self.p = self.p.replace(
                accel=torch.where(act[:, None], 0.0, self.p.accel),
                potential=torch.where(act, 0.0, self.p.potential))
        else:
            p_solve = self.p
            saved_endstep = None
            if self.cfg.selective_no_gravity:
                # SELECTIVE_NO_GRAVITY (gravtree.c:86-90): masked types are
                # hidden from the target gather (they stay sources)
                saved_endstep = self.p.ti_endstep
                sel = ((1 << self.p.ptype) & self.cfg.selective_no_gravity) != 0
                p_solve = self.p.replace(ti_endstep=torch.where(
                    sel, -self.p.ti_endstep - 1, self.p.ti_endstep))
            if not self._forces_bootstrapped \
                    and self.cfg.type_of_opening_criterion == 1 \
                    and not self.solver.uses_direct(self.p.n):
                # relative criterion needs OldAcc: bootstrap with the
                # geometric criterion, then recompute (accel.c:48-52)
                p_solve, _, _ = self.solver.compute(
                    p_solve, self.ti_current, n_active, opening="bh")
            self._forces_bootstrapped = True
            p_solve, n_ia, _ = self.solver.compute(p_solve, self.ti_current,
                                                   n_active)
            if saved_endstep is not None:
                p_solve = p_solve.replace(ti_endstep=saved_endstep)
            self.p = p_solve
            self._sync()
        self.num_force_updates += n_active
        dt = _time.time() - t0
        self.cpu_timers["gravity"] += dt
        if "timings" in self._logs and dt > 0:
            self._logs["timings"].write(
                f"Step {self.step_count}: forces for {n_active} particles "
                f"in {dt:.4f}s  part/sec={n_active / dt:.5g}  "
                f"ia/part={n_ia / max(n_active, 1):.1f}\n")

    def write_snapshot_now(self, path=None):
        """savepositions (io.c:33): snapshot with velocities predicted to now."""
        t0 = _time.time()
        cfg = self.cfg
        if cfg.output_potential:
            self.update_full_potential()
        data = build_snapshot_data(cfg, self.tables, float(self.tbi), self.p,
                                   self.ti_current, self.time)
        if path is None:
            out_dir = self.log_dir or cfg.output_dir
            if not out_dir:
                from ..utils import scratch_output_dir
                out_dir = getattr(self, "_tmp_out", None) or \
                    scratch_output_dir()
                self._tmp_out = out_dir
            path = os.path.join(
                out_dir, f"{cfg.snapshot_file_base}_{self.snapshot_count:03d}")
        write_snapshot_files(cfg, path, data)
        self.snapshot_count += 1
        self.cpu_timers["snapshot"] += _time.time() - t0
        return path

    def update_full_potential(self):
        """Refresh p.potential for ALL particles (compute_potential,
        potential.c:22); accelerations and OldAcc are left untouched."""
        if self.cfg.no_gravity:
            self.p = self.p.replace(potential=torch.zeros_like(self.p.potential))
            return
        p_all = self.p.replace(ti_endstep=torch.full_like(
            self.p.ti_endstep, self.ti_current))
        p2, _, _ = self.solver.compute(p_all, self.ti_current, self.p.n,
                                       want_pot=True)
        self.p = self.p.replace(potential=p2.potential)

    def energy_statistics(self):
        if self.cfg.compute_potential_energy:
            t0 = _time.time()
            self.update_full_potential()
            self.cpu_timers["potential"] += _time.time() - t0
        s = compute_global_quantities(self.p, self.tables, self.ti_current)
        if "energy" in self._logs:
            self._logs["energy"].write(format_energy_line(self.time, s) + "\n")
            self._logs["energy"].flush()
        return s

    # ------------------------------------------------------------------
    def step(self):
        """One main-loop iteration (run.c:32-132)."""
        cfg = self.cfg
        t_step0 = _time.time()

        # --- find next sync point (run.c:151-236) ---
        _, min_glob = self._active_info()

        # snapshots due strictly before the sync point
        while self._next_output <= self.time_at(min_glob) + 1e-12 \
                and self._next_output < float("inf"):
            ti_out = min(time_to_ti(cfg, self._next_output), C.TIMEBASE)
            if ti_out > self.ti_current:
                self.p = drift(self.p, self.tables, self.ti_current, ti_out)
                self.ti_current = ti_out
            self.write_snapshot_now()
            self._advance_output_time()

        # drift everyone to the sync point
        t0 = _time.time()
        if min_glob > self.ti_current:
            self.p = drift(self.p, self.tables, self.ti_current, min_glob)
        self.ti_current = min_glob
        self.cpu_timers["drift"] += _time.time() - t0

        if "info" in self._logs:
            n_act, _ = self._active_info()
            self._logs["info"].write(
                f"Begin Step {self.step_count}, Time: {self.time:.8g}, "
                f"Active: {n_act}\n")

        self.compute_forces()

        # --- statistics ---
        if cfg.time_bet_statistics > 0 and self.time >= self._next_stats:
            self.energy_statistics()
            self._next_stats += cfg.time_bet_statistics

        # --- kick + new timesteps ---
        t0 = _time.time()
        if cfg.min_size_timestep > 0 and not cfg.nostop_when_below_mintimestep:
            # stop when a particle wants dt below MinSizeTimestep
            # (timestep.c:531-556), unless NoStopBelowMinTimestep
            dtp = compute_timestep_dt(cfg, self.p, self.dt_displacement,
                                      self._soft_t)
            act = self.p.ti_endstep == self.ti_current
            mn = float(torch.amin(torch.where(act, dtp, math.inf)))
            if mn < cfg.min_size_timestep:
                raise RuntimeError(
                    f"timestep wants to be {mn:g}, below MinSizeTimestep="
                    f"{cfg.min_size_timestep:g} (timestep.c:531-556); set "
                    "NoStopBelowMinTimestep 1 to clamp instead")
        self.p = kick(cfg, self.p, self.tables, self.ti_current,
                      self.dt_displacement, self._soft_t)
        self._sync()
        self.cpu_timers["timeline"] += _time.time() - t0

        self.step_count += 1
        self.cpu_timers["total"] += _time.time() - t_step0
        if "cpu" in self._logs:
            c = self.cpu_timers
            self._logs["cpu"].write(
                f"Step {self.step_count}, Time: {self.time:.8g}\n"
                f"{c['total']:.2f} {c['gravity']:.2f} {c['hydro']:.2f} "
                f"{c['domain']:.2f} {c['potential']:.2f} {c['drift']:.2f} "
                f"{c['timeline']:.2f} {c['snapshot']:.2f}\n")

    def _interrupt_requested(self) -> str | None:
        """stop-file and CPU-limit checks (run.c:67-103)."""
        if self.log_dir and os.path.exists(os.path.join(self.log_dir, "stop")):
            os.remove(os.path.join(self.log_dir, "stop"))
            return "stop"
        if self.cfg.time_limit_cpu > 0:
            if _time.time() - self._wall_start > 0.85 * self.cfg.time_limit_cpu:
                return "cpulimit"
        return None

    def _note_no_restart(self, why: str):
        """Restart files need io/restart.py, not yet ported (ROADMAP Queue 1
        item 10): the run says so in info.txt instead of writing one."""
        if "info" in self._logs:
            self._logs["info"].write(
                f"{why}: no restart file written (restart files are not yet "
                "ported to ngravs_tpu_torch, ROADMAP Queue 1 item 10)\n")
            self._logs["info"].flush()

    def run(self, max_steps: int | None = None):
        """run() (run.c:20): loop to TimeMax.  At entry, all particles have
        ti_endstep == 0 so the first step computes forces for everyone.  A
        `stop` file in the output dir or 85% of TimeLimitCPU ends the run
        (run.c:67-103)."""
        steps = 0
        self._wall_start = getattr(self, "_wall_start", _time.time())
        last_restart = _time.time()
        while self.ti_current < C.TIMEBASE:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
            reason = self._interrupt_requested()
            if reason:
                self._note_no_restart(f"run ended ({reason})")
                break
            if self.cfg.cpu_time_bet_restart_file > 0 \
                    and _time.time() - last_restart \
                    > self.cfg.cpu_time_bet_restart_file:
                if not self._restart_noted:
                    self._note_no_restart("periodic restart due")
                    self._restart_noted = True
                last_restart = _time.time()
        if self.ti_current >= C.TIMEBASE and self._next_output < float("inf"):
            self.write_snapshot_now()  # final snapshot (run.c:134-141)
        for f in self._logs.values():
            f.flush()
        return steps

    def close(self):
        for f in self._logs.values():
            f.close()
