"""Simulation driver: the main loop (port of `ngravs_tpu/integrate/runner.py`;
reference run.c:20-141, begrun.c, init.c).

    while ti_current < TIMEBASE:
        min_glob = min(ti_endstep)            # global sync point (run.c:165)
        write any snapshots due in (ti_current, min_glob]
        drift all particles -> min_glob       # predict.c
        compute forces for the active set     # accel.c -> solver
        energy statistics if due              # global.c
        kick active set, assign new steps     # timestep.c

`step()` advances one sync point with the general step: open boxes with
the tree or the direct sweep, periodic boxes with the Ewald-corrected tree
or direct sweep, and periodic TreePM boxes (PMGRID), Newtonian or
comoving, collisionless or with SPH gas, with FORCETEST rows on request.
Under PMGRID a PM step forces a full sync (run.c:175-181), the long-range
force is computed first (accel.c:34-42), and after the short-range kick
every particle gets the long-range kick over the PM midpoint window
(timestep.c:350-408).  Gas runs the density and hydro passes
(`ops/sph.py`) after gravity on the gravity walk's tree (accel.c:60-89).
The integrator's variants run too: FLEXSTEPS, PSEUDOSYMMETRIC, MAKEGLASS
(displace instead of kicking) and TWODIMS / LONG_X/Y/Z (SPH without
gravity).  Restart files (`io/restart.py`) are written on the stop file,
at 85% of TimeLimitCPU, every CpuTimeBetRestartFile seconds and on a
crash.

With `segment_steps=K > 1` one `step()` call advances up to K sync points
of a collisionless run without the special modes, stopping before the next
snapshot or statistics time: on the direct path (headless runs) as a loop
of the general step, and on the tree/TreePM path as the JAX package's tree
segment, with the reference's tree maintenance cadence.  A segment is a
host loop over tensors on the device that reads a few scalars a step
(`seg_counts` counts them).
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
from ..ops.sph import HydroSolver
from ..ops.tree import build_tree, drift_tree, refresh_tree
from ..ops.walk import drift_walk_tables, pack_walk_tables
from ..particles import Particles, SphState
from ..units import set_units
from .kdk import box_wrap, compute_timestep_dt, compute_timestep_ticks, \
    cosmo_factors, drift, glass_step, kick, pm_kick, pm_kick_vel_pred, \
    predict_sph
from .timeline import (pm_window, pm_window_update, pow2_floor, ti_to_time,
                       time_to_ti, timebase_interval)

# tree segments re-aggregate the moments every REFRESH_EVERY steps and
# drift them in between (ngravs_tpu/integrate/runner.py:639)
REFRESH_EVERY = 8
TREE_MODES = ("drift", "refresh", "rebuild")


def build_snapshot_data(cfg, tables, tbi: float, p: Particles,
                        ti_current: int, time_now: float,
                        pm_window=None, sph: SphState | None = None,
                        n_gas: int = 0, units=None,
                        entropy_is_u: bool = False) -> SnapshotData:
    """A SnapshotData from integrator state (fill_write_buffer,
    io.c:129-351): velocities predicted to now, per-type constant masses
    lifted into the header table, entropy converted to internal energy,
    comoving->physical output factors.  Gas comes first (type order)."""
    vel = predicted_velocities(p, tables, ti_current, pm_window, sph=sph)
    if cfg.comoving_integration:
        # file vel = internal vel / a^(3/2) (io.c:239-240)
        vel = vel * time_now ** -1.5
    pos, vel, mass, pid, ptype, pot = (
        t.cpu().numpy() for t in (p.pos, vel, p.mass, p.pid, p.ptype,
                                  p.potential))
    h = SnapshotHeader()
    counts = np.bincount(ptype, minlength=6).astype(np.int32)
    h.npart = counts
    h.npart_total = counts.astype(np.uint32)
    h.time = time_now
    h.redshift = 1.0 / time_now - 1 if cfg.comoving_integration else 0.0
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
    a3inv = fac1 = fac2 = 1.0
    if cfg.comoving_integration:
        # comoving->physical factors for output (io.c:149-156)
        a3inv = 1.0 / time_now ** 3
        fac1 = 1.0 / time_now ** 2
        fac2 = 1.0 / time_now ** (3 * cfg.gamma - 2)
    gas = sph is not None and n_gas > 0
    if gas:
        ent, rho, hs, dent = (t.cpu().numpy()[:n_gas] for t in (
            sph.entropy, sph.density, sph.hsml, sph.dt_entropy))
        if entropy_is_u or cfg.isotherm_eqs:
            # density has not run yet, or IsothermEqs: the entropy field
            # holds u directly (io.c:270-271)
            data.u = ent
        else:
            # entropy -> specific internal energy (io.c:266-279)
            data.u = np.maximum(
                units.min_egy_spec,
                ent / cfg.gamma_minus1
                * np.maximum(rho * a3inv, 1e-37) ** cfg.gamma_minus1
            ).astype(np.float32)
        data.rho, data.hsml = rho, hs
        if cfg.output_change_of_entropy:
            data.dtentr = dent
    if cfg.output_acceleration:
        # physical acceleration fac1 (tree + PM) + fac2 hydro for gas
        # (io.c:311-330)
        acc = fac1 * (p.accel + p.accel_pm).cpu().numpy()
        if gas:
            acc[:n_gas] += fac2 * sph.hydro_accel.cpu().numpy()[:n_gas]
        data.accel = acc.astype(np.float32)
    if cfg.output_timestep:
        # (Ti_endstep - Ti_begstep) * Timebase_interval (io.c:343-351)
        data.tstp = ((p.ti_endstep - p.ti_begstep).cpu().numpy()
                     * tbi).astype(np.float32)
    return data


def load_initial_conditions(cfg, units, ic_path=None, device="cpu"):
    """read_ic (read_ic.c:31-146): load ICs into (Particles, SphState or
    None), with InitGasTemp defaulting and the entropy floor.  The SPH
    entropy field holds the IC internal energy u; the runner converts
    u -> A at the first force computation (init.c:170-174)."""
    snap = read_snapshot(ic_path or cfg.init_cond_file,
                         expect_format=cfg.ic_format or None)
    vel = snap.vel
    if cfg.comoving_integration:
        # comoving velocity variable: internal vel = file vel * a^(3/2)
        # (init.c:95-101)
        vel = np.asarray(vel) * cfg.time_begin ** 1.5
    particles = Particles.create(snap.pos, vel, snap.mass, snap.pid,
                                 snap.ptype, cfg.type_to_grav, device=device)
    ngas = int(snap.header.npart[0])
    if ngas == 0:
        return particles, None
    u_ic = np.zeros(ngas, np.float32) if snap.u is None \
        else np.asarray(snap.u, np.float32).copy()
    if cfg.init_gas_temp > 0:
        # read_ic.c:114-143: gas with u == 0 starts at InitGasTemp; mean
        # molecular weight assumes full ionization above 1e4 K, neutral
        # below.  Under IsothermEqs u = kT/mp with no 1/(gamma-1) or mu
        # (read_ic.c:121-132)
        u0 = ((C.BOLTZMANN / C.PROTONMASS) * cfg.init_gas_temp
              / units.unit_energy_in_cgs * units.unit_mass_in_g)
        if not cfg.isotherm_eqs:
            yhe = (1 - C.HYDROGEN_MASSFRAC) / (4 * C.HYDROGEN_MASSFRAC)
            if cfg.init_gas_temp > 1e4:
                mu = (1 + 4 * yhe) / (1 + 3 * yhe + 1)
            else:
                mu = (1 + 4 * yhe) / (1 + yhe)
            u0 = u0 / (cfg.gamma_minus1 * mu)
        u_ic = np.where(u_ic == 0, np.float32(u0), u_ic)
    # entropy floor (read_ic.c:145-146)
    u_ic = np.maximum(u_ic, units.min_egy_spec)
    sph = SphState.zeros(particles.n, device)
    sph.entropy[:ngas] = torch.as_tensor(u_ic, dtype=torch.float32)
    return particles, sph


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

    `device`: where the run lives; None means that of `particles`, else the
    CUDA card, and raises without one: the CPU is used only when asked for
    (`device="cpu"`).  `sph`: the gas state when `particles` are given (its
    entropy field holds u until the first force pass).  `log_dir=""` runs
    headless (no log files); None uses cfg.output_dir, or a scratch
    directory.  `segment_steps=K > 1` lets one `step()` call advance up to
    K sync points (the JAX package's device-resident segments)."""

    def __init__(self, cfg: SimulationConfig, particles: Particles | None = None,
                 sph: SphState | None = None, ic_path: str | None = None,
                 log_dir: str | None = None, segment_steps: int = 1,
                 device=None):
        if device is None:
            device = particles.device if particles is not None else "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: ngravs_tpu_torch runs on the GPU unless the "
                'caller asks for the CPU (Simulation(..., device="cpu"), '
                "python -m ngravs_tpu_torch.run ... --device cpu)")
        self.cfg = cfg
        self._segment_cap = max(1, int(segment_steps))
        self.units = set_units(cfg)
        self.wiring = build_wiring(cfg)
        self.tables = make_tables(cfg, self.units)
        self.tbi = timebase_interval(cfg)

        # softening tables (gravtree.c:468-515): SofteningTable is the
        # Plummer-equivalent; ForceSoftening = 2.8x that
        self.soft_table = np.array(cfg.softening, np.float32)
        self.force_soft = self.soft_table * C.SOFTFAC_SPLINE
        self._soft_t = torch.as_tensor(self.soft_table, device=self.device)

        if particles is None:
            particles, sph_ic = load_initial_conditions(
                cfg, self.units, ic_path=ic_path, device=self.device)
            if sph is None:
                sph = sph_ic
        self.p = particles
        self.sph = sph.to(self.device) if sph is not None else None
        self.n_gas = int(torch.sum(self.p.ptype == 0)) \
            if self.sph is not None else 0
        if self.n_gas > 0 and float(torch.amax(self.sph.hsml)) == 0.0:
            self._initial_hsml()
        if cfg.comoving_integration and cfg.periodic and cfg.box_size > 0:
            self._check_omega()

        self.ti_current = 0
        self.flag_fullstep = True
        # refined on full steps of comoving runs (timestep.c:596-597)
        self.dt_displacement = cfg.max_size_timestep
        # PM (long-range) integer-timeline state (timestep.c:350-408)
        self.pm_ti_begstep = 0
        self.pm_ti_endstep = 0
        self.num_force_updates = 0
        self.step_count = 0
        self.snapshot_count = 0
        self._forces_bootstrapped = False
        # the IC's entropy field holds u until the first density pass
        self._entropy_is_u = self.n_gas > 0

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
        if cfg.pmgrid:
            self.cpu_timers["pm"] = 0.0
        self.solver = GravitySolver(cfg, self.wiring, self.force_soft,
                                    self.units.G, hubble=self.units.hubble,
                                    device=self.device)
        self.hydro = HydroSolver(cfg, self.units) \
            if self.sph is not None else None
        # the segments' counts: segments run, steps, host reads of their
        # loop, cap retries, and the tree segments' steps by maintenance
        # mode (drift, refresh, rebuild)
        self.seg_counts = dict(segments=0, steps=0, host_reads=0,
                               retries=0, **{m: 0 for m in TREE_MODES})
        if cfg.pseudosymmetric:
            # a fresh 3000-entry table of draws a step, seed 42
            # (set_random_numbers, system.c:37; begrun.c:54-55)
            self._rnd_rng = np.random.default_rng(42)
        if cfg.flexsteps:
            # FLEXSTEPS state (init.c:123-129): an ID-keyed random phase a
            # particle from a 3000-entry table (get_random_number,
            # system.c:29-47)
            rnd = np.random.default_rng(42).random(3000)
            pid = self.p.pid.cpu().numpy()
            self.flex_grp = torch.as_tensor(
                (C.TIMEBASE * rnd[pid % 3000]).astype(np.int64)
                .astype(np.int32), device=self.device)
            self.present_min_step = C.TIMEBASE
            self.present_max_step = C.TIMEBASE

        if cfg.adaptive_gravsoft_forgas and self.n_gas > 0:
            # the gas gravitational softening is Hsml, so converge the
            # smoothing lengths BEFORE the first force computation, like
            # init()'s setup_smoothinglengths -> density() (init.c:159-218)
            self.sph = self.hydro.density(
                self._sph_tree(), self.p, self.sph, self.ti_current,
                self.n_gas, self.solver.depth, float(self.tbi))

    def _initial_hsml(self):
        """setup_smoothinglengths (init.c:218): the first Hsml guess from
        the mean gas interparticle separation (the box volume when
        periodic, else the gas extent; an area under TWODIMS,
        init.c:245-251)."""
        cfg = self.cfg
        gas = self.p.ptype == 0
        gpos = self.p.pos.cpu().numpy()[gas.cpu().numpy()]
        ext = gpos.max(0) - gpos.min(0)
        periodic = cfg.periodic and cfg.box_size > 0
        if cfg.twodims:
            area = float(ext[0] * ext[1] + 1e-30)
            if periodic:
                area = cfg.box_sizes[0] * cfg.box_sizes[1]
            h0 = (area * cfg.des_num_ngb
                  / (math.pi * max(self.n_gas, 1))) ** 0.5
        else:
            vol = float(np.prod(ext) + 1e-30)
            if periodic:
                bx, by, bz = cfg.box_sizes
                vol = bx * by * bz
            h0 = (3 * vol * cfg.des_num_ngb
                  / (4 * math.pi * max(self.n_gas, 1))) ** (1.0 / 3)
        self.sph = self.sph.replace(
            hsml=torch.where(gas, float(np.float32(h0)), 0.0))

    def _sph_tree(self):
        """An octree for the SPH passes when gravity built none (the direct
        sweep, NOGRAVITY, the adaptive-softening set-up)."""
        fsoft = torch.as_tensor(self.force_soft,
                                device=self.device)[self.p.ptype.long()]
        return build_tree(self.p.pos, self.p.mass, self.p.grav, fsoft,
                          self.p.old_acc, self.sph.hsml,
                          depth=self.solver.depth, n_gravs=self.cfg.n_gravs,
                          bucket=self.cfg.tree_bucket_size,
                          box_size=self.cfg.tree_box_size)

    def _check_omega(self):
        """check_omega (init.c:181-208): the box mass must match Omega0."""
        cfg, units = self.cfg, self.units
        mtot = float(torch.sum(self.p.mass.double()))
        omega = mtot / cfg.box_size ** 3 / (
            3 * units.hubble * units.hubble / (8 * math.pi * units.G))
        if abs(omega - cfg.omega0) > 1e-2 * max(cfg.omega0, 1e-10):
            import warnings
            warnings.warn(f"IC mass implies Omega0={omega:.4g} but the "
                          f"parameterfile says {cfg.omega0:.4g} (check_omega, "
                          "init.c:181-208)")

    def _pm_window_now(self):
        return ((self.pm_ti_begstep, self.pm_ti_endstep)
                if self.cfg.pmgrid else None)

    def _cosmo(self):
        """Comoving prefactors at the current time (None for Newtonian
        runs, whose factors are all one)."""
        if not self.cfg.comoving_integration:
            return None
        return cosmo_factors(self.cfg, self.units, self.time, self.device)

    def _drift_to(self, ti1: int):
        if self.sph is not None:
            self.sph = predict_sph(self.cfg, self.p, self.sph, self.tables,
                                   self.ti_current, ti1)
        self.p = box_wrap(self.cfg, drift(self.p, self.tables,
                                          self.ti_current, ti1))

    def dt_displacement_constraint(self, p=None, atime=None) -> float:
        """find_dt_displacement_constraint (timestep.c:587-651): the global
        RMS-displacement limit per type, from the minimum particle mass vs
        the component's mean cosmic density, mesh-aware under PMGRID; only
        comoving runs have it.  f32 arithmetic, as the JAX package does.
        `p` and `atime` (an f32 tensor) default to the run's particles and
        time."""
        cfg, units = self.cfg, self.units
        p = self.p if p is None else p
        f32 = lambda v: torch.tensor(v, dtype=torch.float32,
                                     device=self.device)
        dt_min = f32(cfg.max_size_timestep)
        if not cfg.comoving_integration:
            return float(dt_min)
        a = f32(self.time) if atime is None else atime
        h2 = (cfg.omega0 / (a * a * a)
              + (1 - cfg.omega0 - cfg.omega_lambda) / (a * a)
              + cfg.omega_lambda)
        hfac = units.hubble * torch.sqrt(h2) * a * a  # a^2 H(a)
        rho_fac = 3 * units.hubble ** 2 / (8 * math.pi * units.G)
        for t in range(6):
            sel = p.ptype == t
            count = torch.sum(sel)
            v2 = torch.sum(torch.where(sel[:, None], p.vel ** 2, 0.0))
            vrms = torch.sqrt(v2 / torch.clamp(count, min=1))
            min_mass = torch.amin(torch.where(sel, p.mass, math.inf))
            omega_t = cfg.omega_baryon if t == 0 \
                else cfg.omega0 - cfg.omega_baryon
            dmean = (min_mass / max(omega_t * rho_fac, 1e-37)) ** (1.0 / 3)
            if cfg.pmgrid:
                dmean = torch.clamp(
                    dmean, max=cfg.asmth * cfg.box_size / cfg.pmgrid)
            dt_t = (cfg.max_rms_displacement_fac * hfac * dmean
                    / torch.clamp(vrms, min=1e-30))
            dt_min = torch.where(count > 0, torch.minimum(dt_min, dt_t),
                                 dt_min)
        return float(dt_min)

    # ------------------------------------------------------------------
    def _first_output_time(self):
        cfg = self.cfg
        if cfg.output_list_on and cfg.output_list_filename:
            # OutputListOn: the snapshot times of OutputListFilename
            with open(cfg.output_list_filename) as f:
                self._output_list = sorted(float(x) for x in f.read().split())
            return next((t for t in self._output_list if t > cfg.time_begin),
                        float("inf"))
        self._output_list = None
        t = cfg.time_of_first_snapshot
        while t <= cfg.time_begin:
            if cfg.time_bet_snapshot <= 0:
                return float("inf")
            t += cfg.time_bet_snapshot
        return t

    def _advance_output_time(self):
        if self._output_list is not None:
            self._next_output = next(
                (t for t in self._output_list if t > self._next_output),
                float("inf"))
        else:
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

    def compute_forces(self, full: bool = False):
        """compute_accelerations (accel.c:24) for the active set: gravity,
        then the SPH density and hydro passes for active gas.  `full`
        refreshes the long-range PM force too (long_range_force,
        accel.c:34-42), as standalone full-force callers need."""
        t0 = _time.time()
        if full and self.cfg.pmgrid and not self.cfg.no_gravity:
            self.p = self.p.replace(accel_pm=self.solver.pm_forces(self.p))
        n_active, _ = self._active_info()
        if full:
            n_active = self.p.n
        if n_active == 0:
            return
        hsml = self.sph.hsml if self.sph is not None else None
        tree = None
        n_ia = 0
        act = self.p.ti_endstep == self.ti_current
        if self.cfg.no_gravity:
            # NOGRAVITY (gravtree.c:368-374): active particles get zero
            # gravitational acceleration; SPH still runs below
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
                    p_solve, self.ti_current, n_active, opening="bh",
                    hsml=hsml)
            self._forces_bootstrapped = True
            p_solve, n_ia, tree = self.solver.compute(
                p_solve, self.ti_current, n_active, hsml=hsml)
            if saved_endstep is not None:
                p_solve = p_solve.replace(ti_endstep=saved_endstep)
            self.p = p_solve
            self._sync()
        self.num_force_updates += n_active
        dt = _time.time() - t0
        self.cpu_timers["gravity"] += dt

        # --- SPH: density + smoothing lengths, then hydro (accel.c:60-89) ---
        if self.n_gas > 0:
            t1 = _time.time()
            n_gas_act = int(torch.sum(act & (self.p.ptype == 0)))
            if n_gas_act > 0:
                self._sph_forces(tree, n_gas_act)
            self._sync()
            self.cpu_timers["hydro"] += _time.time() - t1
        if "timings" in self._logs and dt > 0:
            self._logs["timings"].write(
                f"Step {self.step_count}: forces for {n_active} particles "
                f"in {dt:.4f}s  part/sec={n_active / dt:.5g}  "
                f"ia/part={n_ia / max(n_active, 1):.1f}\n")

    def _sph_forces(self, tree, n_gas_act: int):
        """density() then hydro_force() for the active gas on `tree` (the
        gravity walk's, else one built here)."""
        cfg, depth, tbi = self.cfg, self.solver.depth, float(self.tbi)
        if tree is None:
            tree = self._sph_tree()
        self.sph = self.hydro.density(tree, self.p, self.sph, self.ti_current,
                                      n_gas_act, depth, tbi)
        if self._entropy_is_u:
            # the IC carried internal energy u: convert to entropy
            # A = (gamma-1) u / rho^(gamma-1) (init.c:170-174).  Under
            # IsothermEqs the entropy variable stays u and P = u rho
            gm1 = cfg.gamma_minus1
            a3inv = 1.0 / self.time ** 3 if cfg.comoving_integration else 1.0
            s = self.sph
            if cfg.isotherm_eqs:
                ent = s.entropy
            else:
                ent = gm1 * s.entropy \
                    / torch.clamp(s.density * a3inv, min=1e-37) ** gm1
            gasm = self.p.ptype == 0
            self.sph = s.replace(
                entropy=torch.where(gasm, ent, s.entropy),
                pressure=torch.where(
                    gasm, ent * torch.clamp(s.density, min=1e-37)
                    ** cfg.gamma, s.pressure))
            self._entropy_is_u = False
        self.sph = self.hydro.hydro(tree, self.p, self.sph, self.ti_current,
                                    n_gas_act, depth, tbi, self.time)

    def write_snapshot_now(self, path=None):
        """savepositions (io.c:33): snapshot with velocities predicted to now."""
        t0 = _time.time()
        cfg = self.cfg
        if cfg.output_potential:
            self.update_full_potential()
        data = build_snapshot_data(cfg, self.tables, float(self.tbi), self.p,
                                   self.ti_current, self.time,
                                   pm_window=self._pm_window_now(),
                                   sph=self.sph, n_gas=self.n_gas,
                                   units=self.units,
                                   entropy_is_u=self._entropy_is_u)
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
        p2, _, _ = self.solver.compute(
            p_all, self.ti_current, self.p.n, want_pot=True,
            hsml=self.sph.hsml if self.sph is not None else None)
        pot = p2.potential
        if self.cfg.pmgrid:
            # long-range PM potential (potential.c:268-306)
            pot = pot + self.solver.pm.potential(self.p.pos, self.p.mass,
                                                 self.p.grav)
        self.p = self.p.replace(potential=pot)

    def energy_statistics(self):
        if self.cfg.compute_potential_energy:
            t0 = _time.time()
            self.update_full_potential()
            self.cpu_timers["potential"] += _time.time() - t0
        com = self.cfg.comoving_integration
        s = compute_global_quantities(
            self.p, self.tables, self.ti_current,
            pm_window=self._pm_window_now(),
            atime=self.time if com else 1.0, sph=self.sph, cfg=self.cfg,
            a3inv=1.0 / self.time ** 3 if com else 1.0)
        if "energy" in self._logs:
            self._logs["energy"].write(format_energy_line(self.time, s) + "\n")
            self._logs["energy"].flush()
        return s

    def _flex_steps(self, cf):
        """FLEXSTEPS' present steps before a kick (timestep.c:140-175): the
        smallest doubles on its schedule and falls to the active set's
        smallest wanted step; the largest is the displacement constraint's
        power-of-two floor.  Returns the kick's `flex` triple."""
        cfg = self.cfg
        if self.ti_current % (4 * self.present_min_step) == 0 \
                and self.present_min_step < C.TIMEBASE:
            self.present_min_step *= 2
        ticks = compute_timestep_ticks(cfg, self.p, self.dt_displacement,
                                       self._soft_t, cf, self.sph)
        act = self.p.ti_endstep == self.ti_current
        mn = int(torch.amin(torch.where(act, ticks, C.TIMEBASE)))
        self.present_min_step = min(self.present_min_step, mn)
        mx = max(1, min(int(min(self.dt_displacement, cfg.max_size_timestep)
                            / self.tbi), C.TIMEBASE))
        self.present_max_step = pow2_floor(mx)
        return (self.flex_grp, self.present_min_step, self.present_max_step)

    # ------------------------------------------------------------------
    # Segments (ngravs_tpu/integrate/runner.py:562-823, 1031-1222)
    # ------------------------------------------------------------------
    def _next_sync_info(self):
        """(next sync point, particles active there) in one fetch."""
        mn = torch.amin(self.p.ti_endstep)
        pair = torch.stack([mn, torch.sum(self.p.ti_endstep == mn)
                            .to(mn.dtype)]).cpu()
        return int(pair[0]), int(pair[1])

    def _segment_bounds(self) -> int:
        """The largest tick strictly before the next snapshot or
        statistics time (TIMEBASE when there is none)."""
        cfg = self.cfg
        t_bound = self._next_output
        if cfg.time_bet_statistics > 0:
            t_bound = min(t_bound, self._next_stats)
        if t_bound == float("inf"):
            return C.TIMEBASE
        ti_stop = min(time_to_ti(cfg, t_bound), C.TIMEBASE)
        while ti_stop > 0 and t_bound <= self.time_at(ti_stop) + 1e-12:
            ti_stop -= 1
        return ti_stop

    def _segment_kind(self) -> str | None:
        """"tree", "direct" or None: the segment this run takes
        (_try_fast_step, ngravs_tpu/integrate/runner.py:1140-1165).  The
        special modes, gas and the MinSizeTimestep stop take the general
        step; so do the direct path's logged, PMGRID and comoving runs."""
        cfg = self.cfg
        if (self._segment_cap <= 1 or cfg.make_glass or cfg.force_test > 0
                or cfg.no_gravity or cfg.selective_no_gravity
                or cfg.pseudosymmetric or cfg.flexsteps or self.n_gas > 0
                or (cfg.min_size_timestep > 0
                    and not cfg.nostop_when_below_mintimestep)):
            return None
        if not self.solver.uses_direct(self.p.n):
            return "tree" if (self._forces_bootstrapped and
                              self.ti_current < C.TIMEBASE) else None
        if cfg.pmgrid or cfg.comoving_integration or self._logs:
            return None
        return "direct"

    def _direct_segment(self):
        """Up to K general steps in one call (the direct path's segment,
        fused_multistep_fn, ngravs_tpu/integrate/runner.py:562-589): after
        the first, while the next sync point moves forward and stays at or
        before the next snapshot or statistics time.  Bit for bit the
        single steps."""
        steps = 0
        while True:
            self._general_step()
            steps += 1
            if steps >= self._segment_cap or self.ti_current >= C.TIMEBASE:
                break
            _, min_glob = self._active_info()
            self.seg_counts["host_reads"] += 1
            if min_glob > self._segment_bounds() \
                    or min_glob <= self.ti_current:
                break
        self.seg_counts["segments"] += 1
        self.seg_counts["steps"] += steps

    def _try_tree_segment(self) -> bool:
        """A segment on the tree/TreePM solver (_try_tree_segment,
        ngravs_tpu/integrate/runner.py:1046-1137).  A walk that overflows
        its caps freezes the state before that step; the caps grow to the
        measured demand and the segment resumes, at most 6 times.  An
        overflow the caps cannot cure (the octet layout) drops the octet
        caps and leaves the step to the general path, which re-measures
        them.  True if the state advanced."""
        min_glob, n_act = self._next_sync_info()
        ti_stop = self._segment_bounds()
        if min_glob > ti_stop:
            return False
        solver = self.solver
        solver.clamp_caps(self.p.n)
        for _ in range(6):
            t_seg0 = _time.time()
            steps, ovf, demand, rec, (min_glob, n_act) = self._tree_segment(
                min_glob, n_act, ti_stop)
            self._log_segment(rec, _time.time() - t_seg0)
            if not ovf:
                return steps > 0
            self.seg_counts["retries"] += 1
            caps_before = (dict(solver.fcaps), solver.octet_caps)
            solver.grow_caps(*demand)
            if (dict(solver.fcaps), solver.octet_caps) == caps_before:
                solver.octet_caps = None
                return steps > 0
        raise RuntimeError(f"tree segment caps still overflowing at "
                           f"{solver.fcaps}")

    def _tree_maintain(self, p, mode: int, tree, wt, dd):
        """The tree and packed walk tables for a segment step, on the
        reference's cadence (ngravs_tpu/integrate/runner.py:641-673): 0
        drifts them (predict.c:83-90), 1 re-aggregates the moments and
        repacks on the cached layout, 2 rebuilds."""
        cfg, solver = self.cfg, self.solver
        if mode == 0:
            return drift_tree(tree, dd), drift_walk_tables(wt, dd,
                                                           cfg.n_gravs)
        fsoft = solver.fsoft_by_type.to(self.device)[p.ptype.long()]
        aold = cfg.err_tol_force_acc * p.old_acc / solver.G
        zero_h = torch.zeros_like(p.mass)
        kw = dict(depth=solver.depth, n_gravs=cfg.n_gravs,
                  bucket=cfg.tree_bucket_size)
        layout = None
        if mode == 1:
            tree = refresh_tree(tree, p.pos, p.mass, p.grav, fsoft, aold,
                                zero_h, vel=p.vel, **kw)
            layout = (wt.slot8, wt.child_oct, wt.layout_ovf)
        else:
            tree = build_tree(p.pos, p.mass, p.grav, fsoft, aold, zero_h,
                              box_size=cfg.tree_box_size,
                              group_size=cfg.walk_group_size, vel=p.vel,
                              **kw)
        return tree, pack_walk_tables(
            tree, p.n, solver.depth, cfg.tree_bucket_size, cfg.n_gravs,
            solver.leaf_factor, accumulator=self.wiring.accumulator,
            layout=layout, octet_caps=solver.octet_caps)

    def _time_f32(self, ti: int) -> torch.Tensor:
        """The time at tick ti in f32 arithmetic, as the JAX segment
        computes it on the device (time_at_dev)."""
        f32 = lambda v: torch.tensor(v, dtype=torch.float32,
                                     device=self.device)
        tf = f32(ti) * f32(float(self.tbi))
        if self.cfg.comoving_integration:
            return f32(self.cfg.time_begin) * torch.exp(tf)
        return f32(self.cfg.time_begin) + tf

    def _tree_segment(self, min_glob: int, n_act: int, ti_stop: int):
        """Run one tree segment from the committed state and commit what
        completed (tree_multi_fn, ngravs_tpu/integrate/runner.py:739-818).
        A step: drift; PM when due; the tree by its cadence; the walk over
        the active targets; the corrections; the comoving displacement
        refresh on full steps; the kick; the PM kick and window.  The loop
        reads one stacked row of scalars a step (next sync point, its
        active count, the overflow flag, the interaction count).  Returns
        (steps, overflowed, cap demand, per-step records, (next sync
        point, active count there))."""
        cfg, solver, tables = self.cfg, self.solver, self.tables
        n = self.p.n
        walk = solver._walk(want_pot=False)
        opening = "relative" if cfg.type_of_opening_criterion == 1 else "bh"
        rebuild_every = max(1, int(cfg.tree_domain_update_frequency * n))
        comoving_dt = cfg.comoving_integration \
            and not cfg.no_pmstep_adjustment
        p = self.p
        tree, wt = self._tree_maintain(p, 2, None, None, None)
        since = since_agg = 0
        ti_cur, min_nxt, n_nxt = self.ti_current, min_glob, n_act
        pm_b, pm_e = self.pm_ti_begstep, self.pm_ti_endstep
        dt_disp = self.dt_displacement
        steps = updates = last_act = 0
        ovf = False
        chunk_dem = 0
        lvl_dem = None
        rec = []
        while (steps < self._segment_cap and min_nxt <= ti_stop
               and (steps == 0 or min_nxt > ti_cur)
               and (not cfg.pmgrid or min_nxt <= pm_e)):
            ti0, ti1 = ti_cur, min_nxt
            dd = tables.drift_factor(ti0, ti1).to(self.device)
            q = box_wrap(cfg, drift(p, tables, ti0, ti1))
            pm_step = bool(cfg.pmgrid) and ti1 == pm_e
            if pm_step:
                q = q.replace(accel_pm=solver.pm.forces(q.pos, q.mass,
                                                        q.grav))
            n_active = n_nxt
            mode = 2 if since >= rebuild_every else \
                1 if since_agg >= REFRESH_EVERY else 0
            tree1, wt1 = self._tree_maintain(q, mode, tree, wt, dd)
            since1 = (0 if mode == 2 else since) + n_active
            since_agg1 = 0 if mode > 0 else since_agg + 1
            mask = q.ti_endstep == ti1
            tgt = torch.nonzero(mask[tree1.order.long()]).squeeze(1)
            res = walk(tree1, tgt, opening_override=opening, tables=wt1)
            orig = tree1.order[tgt].long()
            q = solver._scatter(q, orig, res.acc, res.pot, want_pot=False,
                                ninteract=res.ninteract)
            time_now = self._time_f32(ti1)
            dt1 = dt_disp
            if comoving_dt and n_active == n:
                dt1 = self.dt_displacement_constraint(q, time_now)
            cf = cosmo_factors(cfg, self.units, time_now, self.device) \
                if cfg.comoving_integration else None
            q, _ = kick(cfg, q, tables, ti1, dt1, self._soft_t, cf)
            pm_b1, pm_e1 = pm_b, pm_e
            if pm_step:
                tstart, tend, pm_b1, pm_e1 = pm_window_update(
                    ti1, pm_b, pm_e, dt1, float(self.tbi))
                q = pm_kick(q, tables, tstart, tend)
            mn = torch.amin(q.ti_endstep).long()
            head = torch.cat([torch.stack([
                mn, torch.sum(q.ti_endstep == mn), res.overflow.long(),
                torch.sum(res.ninteract.long()), res.max_chunk.long()]),
                res.max_frontier.long()]).cpu()
            self.seg_counts["host_reads"] += 1
            min2, n2, ovf1, nia, mc = (int(x) for x in head[:5])
            chunk_dem = max(chunk_dem, mc)
            lvl_dem = head[5:] if lvl_dem is None \
                else torch.maximum(lvl_dem, head[5:])
            if ovf1:
                # freeze before the offending step
                ovf = True
                break
            p, tree, wt = q, tree1, wt1
            since, since_agg, dt_disp = since1, since_agg1, dt1
            pm_b, pm_e = pm_b1, pm_e1
            rec.append((ti1, n_active, nia))
            self.seg_counts[TREE_MODES[mode]] += 1
            ti_cur, min_nxt, n_nxt = ti1, min2, n2
            updates += n_active
            last_act = n_active
            steps += 1
        # commit what completed
        self.p = p
        self.ti_current = ti_cur
        self.dt_displacement = dt_disp
        self.pm_ti_begstep, self.pm_ti_endstep = pm_b, pm_e
        self.num_force_updates += updates
        self.step_count += steps
        if steps:
            self.flag_fullstep = last_act == n
        self.seg_counts["segments"] += 1
        self.seg_counts["steps"] += steps
        # the segment's trees are not the solver's cache
        solver._tree_cache = None
        demand = (chunk_dem, lvl_dem.numpy() if lvl_dem is not None
                  else np.zeros(solver.depth + 1, np.int64))
        return steps, ovf, demand, rec, (min_nxt, n_nxt)

    def _log_segment(self, rec, seconds: float):
        """A segment's info and timings lines from its per-step records
        (every_timestep_stuff, run.c:370-392; gravtree.c:408-445), the
        wall time shared evenly."""
        if not rec or not self._logs:
            return
        step0 = self.step_count - len(rec)
        per = seconds / len(rec)
        for k, (ti_k, act_k, nia_k) in enumerate(rec):
            if "info" in self._logs:
                self._logs["info"].write(
                    f"Begin Step {step0 + k}, Time: "
                    f"{self.time_at(ti_k):.8g}, Active: {act_k} "
                    "(segment)\n")
            if "timings" in self._logs:
                self._logs["timings"].write(
                    f"Step {step0 + k + 1}: forces for {act_k} particles "
                    f"in {per:.4f}s  part/sec={act_k / max(per, 1e-9):.5g}"
                    f"  ia/part={nia_k / max(act_k, 1):.1f}\n")
        for key in ("info", "timings"):
            if key in self._logs:
                self._logs[key].flush()

    # ------------------------------------------------------------------
    def step(self):
        """One main-loop iteration (run.c:32-132), or a segment of up to
        `segment_steps` of them where the run allows one
        (`_segment_kind`)."""
        kind = self._segment_kind()
        if kind == "tree" and self._try_tree_segment():
            return
        if kind == "direct":
            self._direct_segment()
            return
        self._general_step()

    def _general_step(self):
        """One main-loop iteration (run.c:32-132)."""
        cfg = self.cfg
        t_step0 = _time.time()

        # --- find next sync point (run.c:151-236) ---
        _, min_glob = self._active_info()
        if cfg.pmgrid and min_glob > self.pm_ti_endstep:
            # a PM step forces a full synchronization (run.c:175-181)
            min_glob = self.pm_ti_endstep

        # snapshots due strictly before the sync point
        while self._next_output <= self.time_at(min_glob) + 1e-12 \
                and self._next_output < float("inf"):
            ti_out = min(time_to_ti(cfg, self._next_output), C.TIMEBASE)
            if ti_out > self.ti_current:
                self._drift_to(ti_out)
                self.ti_current = ti_out
            self.write_snapshot_now()
            self._advance_output_time()

        # drift everyone to the sync point
        t0 = _time.time()
        if min_glob > self.ti_current:
            self._drift_to(min_glob)
        self.ti_current = min_glob
        self.cpu_timers["drift"] += _time.time() - t0

        n_act, _ = self._active_info()
        self.flag_fullstep = n_act == self.p.n
        if "info" in self._logs:
            self._logs["info"].write(
                f"Begin Step {self.step_count}, Time: {self.time:.8g}, "
                f"Active: {n_act}\n")

        # --- forces: long-range PM first when due (accel.c:34-42) ---
        pm_step = bool(cfg.pmgrid) and self.ti_current == self.pm_ti_endstep
        if pm_step:
            t0 = _time.time()
            self.p = self.p.replace(accel_pm=self.solver.pm_forces(self.p))
            self._sync()
            self.cpu_timers["pm"] += _time.time() - t0
        self.compute_forces()

        # --- FORCETEST: direct-sum accuracy rows (gravtree_forcetest.c:28;
        # under PMGRID only on PM steps, :46-49; off under NOGRAVITY, :34) ---
        if cfg.force_test > 0 and not cfg.no_gravity \
                and (not cfg.pmgrid or pm_step):
            from ..diagnostics.forcetest import force_test
            force_test(self)

        # --- statistics ---
        if cfg.time_bet_statistics > 0 and self.time >= self._next_stats:
            self.energy_statistics()
            self._next_stats += cfg.time_bet_statistics

        # --- MAKEGLASS (timestep.c:85-133): displace instead of kicking;
        # the active set's steps advance by MaxSizeTimestep ---
        if cfg.make_glass:
            self.p = glass_step(cfg, self.units, self.p)
            act = self.p.ti_endstep == self.ti_current
            inc = max(1, int(cfg.max_size_timestep / self.tbi))
            self.p = self.p.replace(
                ti_begstep=torch.where(act, self.p.ti_endstep,
                                       self.p.ti_begstep),
                ti_endstep=torch.where(act, self.p.ti_endstep + inc,
                                       self.p.ti_endstep))
            self.step_count += 1
            return

        # --- kick + new timesteps ---
        t0 = _time.time()
        # displacement constraint refresh on full steps (timestep.c:63-68);
        # NOPMSTEPADJUSTMENT pins it to MaxSizeTimestep
        if cfg.no_pmstep_adjustment:
            self.dt_displacement = cfg.max_size_timestep
        elif self.flag_fullstep and cfg.comoving_integration:
            self.dt_displacement = self.dt_displacement_constraint()
        cf = self._cosmo()
        if cfg.min_size_timestep > 0 and not cfg.nostop_when_below_mintimestep:
            # stop when a particle wants dt below MinSizeTimestep
            # (timestep.c:531-556), unless NoStopBelowMinTimestep
            dtp = compute_timestep_dt(cfg, self.p, self.dt_displacement,
                                      self._soft_t, cf, self.sph)
            act = self.p.ti_endstep == self.ti_current
            mn = float(torch.amin(torch.where(act, dtp, math.inf)))
            if mn < cfg.min_size_timestep:
                raise RuntimeError(
                    f"timestep wants to be {mn:g}, below MinSizeTimestep="
                    f"{cfg.min_size_timestep:g} (timestep.c:531-556); set "
                    "NoStopBelowMinTimestep 1 to clamp instead")
        variant = {}
        if cfg.flexsteps:
            variant["flex"] = self._flex_steps(cf)
        elif cfg.pseudosymmetric:
            variant["rnd_table"] = torch.as_tensor(
                self._rnd_rng.random(3000), dtype=torch.float32,
                device=self.device)
        self.p, self.sph = kick(cfg, self.p, self.tables, self.ti_current,
                                self.dt_displacement, self._soft_t, cf,
                                self.sph, self.units.min_egy_spec, **variant)
        if pm_step:
            # the long-range kick over the PM midpoint window
            # (timestep.c:350-408); the step in ticks from the
            # displacement constraint as the host computes it
            tstart, tend, self.pm_ti_begstep, self.pm_ti_endstep = \
                pm_window(self.ti_current, self.pm_ti_begstep,
                          self.pm_ti_endstep,
                          int(self.dt_displacement / self.tbi))
            self.p = pm_kick(self.p, self.tables, tstart, tend)
            if self.sph is not None:
                self.sph = pm_kick_vel_pred(
                    self.p, self.sph, self.tables, self.ti_current,
                    self.pm_ti_begstep, self.pm_ti_endstep)
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

    # ------------------------------------------------------------------
    def save_restart(self, path: str | None = None) -> str:
        """Write a restart checkpoint (restart(0), restart.c:35)."""
        from ..io.restart import save_restart
        return save_restart(self, path)

    def resume(self, path: str | None = None):
        """Resume from a restart checkpoint (RestartFlag=1)."""
        from ..io.restart import load_restart
        return load_restart(self, path)

    def _interrupt_requested(self) -> str | None:
        """stop-file and CPU-limit checks (run.c:67-103)."""
        if self.log_dir and os.path.exists(os.path.join(self.log_dir, "stop")):
            os.remove(os.path.join(self.log_dir, "stop"))
            return "stop"
        if self.cfg.time_limit_cpu > 0:
            if _time.time() - self._wall_start > 0.85 * self.cfg.time_limit_cpu:
                return "cpulimit"
        return None

    def run(self, max_steps: int | None = None):
        """run() (run.c:20): loop to TimeMax.  At entry, all particles have
        ti_endstep == 0 so the first step computes forces for everyone.

        A `stop` file in the output dir or 85% of TimeLimitCPU writes a
        restart file and returns (run.c:67-103); a restart file is also
        written every CpuTimeBetRestartFile seconds (run.c:108-125), and a
        crash dump before an exception propagates."""
        steps = 0
        self._wall_start = getattr(self, "_wall_start", _time.time())
        last_restart = _time.time()
        while self.ti_current < C.TIMEBASE:
            # after a TimeMax-extending resume the timeline covers more than
            # TimeMax; stop on Time > TimeMax like the reference (run.c:32)
            if self.cfg.timeline_time_max \
                    and self.time > self.cfg.time_max * (1 + 1e-12):
                break
            try:
                self.step()
            except Exception:
                # crash dump (dump_particles, forcetree.c:3557): the full
                # state for post-mortem before re-raising
                if self.log_dir:
                    try:
                        self.save_restart(os.path.join(
                            self.log_dir, "crash_dump.npz"))
                    except Exception:
                        pass
                raise
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
            reason = self._interrupt_requested()
            if reason:
                if self.log_dir:
                    self.save_restart()
                if reason == "cpulimit" and self.cfg.resubmit_on \
                        and self.cfg.resubmit_command:
                    # self-resubmission on the CPU-limit interruption
                    # (run.c:99-103)
                    os.system(self.cfg.resubmit_command)
                break
            if self.log_dir and self.cfg.cpu_time_bet_restart_file > 0 \
                    and _time.time() - last_restart \
                    > self.cfg.cpu_time_bet_restart_file:
                self.save_restart()
                last_restart = _time.time()
        if self.ti_current >= C.TIMEBASE and self._next_output < float("inf"):
            self.write_snapshot_now()  # final snapshot (run.c:134-141)
        for f in self._logs.values():
            f.flush()
        return steps

    def close(self):
        for f in self._logs.values():
            f.close()
