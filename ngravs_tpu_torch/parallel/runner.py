"""The multi-device main loop: the reference's run() (run.c:20-132) over
the ranks' tree or TreePM step, with or without SPH gas (port of
`ngravs_tpu/parallel/runner.py`).

Every rank runs this run loop on its shard; the host holds the integer
timeline and the counters, which every rank computes alike from the
step's reductions.  Host duties as in the reference's serial bookkeeping:

  * the sync point, drifting exactly onto snapshot times
    (find_next_sync_point_and_drift, run.c:151-236), a PM step forcing a
    full synchronisation (run.c:175-181);
  * the LET exchange's caps and the SPH ghost cap and margin, shared by
    the step variants, grown where a rank overflows them
    (allocate.c:44-76); the SPH candidate cap, grown by the rank that
    overflows it;
  * the work-weighted domain decomposition every
    TreeDomainUpdateFrequency * N * K force updates (domain.c:76), by the
    measured interaction counts;
  * snapshots (one file a rank, never gathered), energy statistics,
    FORCETEST, restart files and the info / cpu / timings logs (rank 0
    writes them), the stop file and the CPU-time limit (rank 0 decides,
    every rank follows).

With gas the steps are the full steps (`full_sharded.ReplicatedFullStep`,
`full_let_sharded.LetFullStep`) and the gas state is sharded with its
particles.  An IC whose entropy field holds the internal energy u
(`entropy_is_u`) is converted as JAX's runner converts it: the densities
of a density pass at tick 0 give A = (gamma - 1) u / rho^(gamma - 1)
(init.c:170-174), before the first step.
"""

from __future__ import annotations

import os
import time as _time
from types import SimpleNamespace

import numpy as np
import torch

from .. import constants as C
from ..cosmology import make_tables
from ..diagnostics.energy import compute_global_quantities, format_energy_line
from ..integrate.runner import build_snapshot_data, write_snapshot_files
from ..integrate.timeline import (pow2_floor, ti_to_time, time_to_ti,
                                  timebase_interval)
from ..models.wiring import build_wiring
from ..ops.solver import GravitySolver
from ..ops.sph import HydroSolver
from ..particles import Particles, SphState
from ..units import set_units
from .full_let_sharded import GHOST_CAP, GHOST_MARGIN, LetFullStep
from .full_sharded import ReplicatedFullStep
from .mesh import Mesh, gather_rows, sharded_dt_displacement, take_rows
from .tree_sharded import (LetTreeStep, ReplicatedTreeStep, decompose,
                           reshard_by_cost)


def _shared_scratch(mesh: Mesh) -> str:
    """A scratch output directory made by rank 0, named on every rank."""
    from ..utils import scratch_output_dir
    return mesh.broadcast_object(scratch_output_dir() if mesh.rank == 0
                                 else None)


class DistributedSimulation:
    """The multi-device simulation on one rank of `mesh`.

    Every rank passes the same global `particles` (type-sorted, gas first,
    as read from the ICs) and gas state `sph` (rows as `particles`; its
    entropy field holds the entropy A unless `entropy_is_u`); the
    constructor keeps this rank's block of the initial count-balanced
    decomposition.  `use_let` picks the locally-essential tree step over
    the replicated one.  `log_dir=""` runs headless; None uses
    cfg.output_dir."""

    def __init__(self, cfg, particles, sph=None, *, mesh: Mesh,
                 log_dir=None, alloc_factor: float = 1.25,
                 use_let: bool = False, entropy_is_u: bool = False):
        self.n_gas = int(torch.sum(particles.ptype == 0))
        self.has_gas = sph is not None and self.n_gas > 0
        self.cfg = cfg
        self.mesh = mesh
        self.n_dev = mesh.size
        self.device = mesh.device
        self.use_let = use_let
        self.units = set_units(cfg)
        self.wiring = build_wiring(cfg)
        self.tables = make_tables(cfg, self.units)
        self.tbi = timebase_interval(cfg)
        self.alloc_factor = alloc_factor
        # the LET exchange's caps (JAX's first expn_cap / expp_cap) and the
        # SPH ghost cap and margin, shared by the step variants
        self.let_caps = dict(expn=4096, expp=8192, ghost=GHOST_CAP,
                             margin=GHOST_MARGIN)
        self.force_soft = np.array(cfg.softening, np.float32) \
            * C.SOFTFAC_SPLINE
        # the rank's timers and counters (`Mesh.trace`)
        self.trace = mesh.trace
        self.solver = GravitySolver(cfg, self.wiring, self.force_soft,
                                    self.units.G, hubble=self.units.hubble,
                                    device=self.device, trace=self.trace)
        self.n_real = int(particles.pos.shape[0])
        # initial-order restoration key for snapshots (unique Gadget IDs)
        pid = particles.pid.cpu().numpy()
        self._pid_sorted = np.sort(pid)
        self._pid_rank = np.argsort(pid)

        self.hydro = HydroSolver(cfg, self.units, trace=self.trace) \
            if self.has_gas else None
        # the initial decomposition (no costs yet: count-balanced), on the
        # particles' bounding cube as the JAX runner makes it
        host = Particles(**{k: v.cpu() for k, v in vars(particles).items()})
        self.sph = None
        if self.has_gas:
            self.p, self.sph = decompose(host, mesh, alloc_factor=alloc_factor,
                                         sph=self._initial_hsml(host, sph))
        else:
            self.p = decompose(host, mesh, alloc_factor=alloc_factor)
        self._build_step()

        self.ti_current = 0
        self._min_end = 0        # next global sync point (run.c:165)
        # the PM (long-range) integer-timeline window (timestep.c:350-408)
        self.pm_ti_begstep = 0
        self.pm_ti_endstep = 0
        self.step_count = 0
        self.num_force_updates = 0
        self.snapshot_count = 0
        self._since_reshard = 0
        self._wall_start = _time.time()
        self.let_rows = None     # LET rows received last step (a tensor)
        self.ghost_rows = None   # SPH ghost rows received, rounds A and B

        # log_dir="" runs headless; None with no OutputDir: a scratch
        # directory (rank 0's, shared)
        self.log_dir = log_dir if log_dir is not None else cfg.output_dir
        if not self.log_dir and log_dir is None:
            self.log_dir = _shared_scratch(mesh)
        self._logs = {}
        if self.log_dir and mesh.rank == 0:
            os.makedirs(self.log_dir, exist_ok=True)
            for key, fname in [("info", cfg.info_file),
                               ("energy", cfg.energy_file),
                               ("cpu", cfg.cpu_file),
                               ("timings", cfg.timings_file)]:
                self._logs[key] = open(os.path.join(self.log_dir, fname), "w")
        # every rank takes the collective part of the logs
        self._logging = bool(self.log_dir)
        self._next_output = (cfg.time_of_first_snapshot
                             if cfg.time_bet_snapshot > 0 else float("inf"))
        self._next_stats = (cfg.time_begin if cfg.time_bet_statistics > 0
                            else float("inf"))
        # the special timestep modes' host state (as the single-device
        # runner's FLEXSTEPS / PSEUDOSYMMETRIC state)
        if cfg.pseudosymmetric:
            self._rnd_rng = np.random.default_rng(42)
        if cfg.flexsteps:
            self.present_min_step = C.TIMEBASE
            self.present_max_step = C.TIMEBASE
        if entropy_is_u and self.has_gas:
            self.convert_u_to_entropy()

    def _initial_hsml(self, p, sph):
        """The gas state on the host with the first smoothing-length guess
        where it has none, as JAX's runner makes it: the mean gas spacing
        times DesNumNgb^(1/3) over the box, else over the extent of all
        coordinates (setup_smoothinglengths, init.c:218)."""
        cfg = self.cfg
        sph = SphState(**{k: v.cpu() for k, v in vars(sph).items()})
        if float(torch.amax(sph.hsml)) > 0:
            return sph
        if cfg.periodic and cfg.box_size > 0:
            h0 = cfg.box_size * (cfg.des_num_ngb / self.n_gas) ** (1 / 3)
        else:
            ext = float(torch.amax(p.pos) - torch.amin(p.pos))
            h0 = ext * (cfg.des_num_ngb / max(self.n_gas, 1)) ** (1 / 3)
        return sph.replace(hsml=torch.where(p.ptype == 0,
                                            float(np.float32(h0)), 0.0))

    def convert_u_to_entropy(self):
        """init.c:170-174: the IC's internal energy u -> entropy A with the
        densities of a density pass at tick 0 (JAX's runner takes them from
        a throwaway step; the pass is that step's density half, which
        depends on nothing the rest of the step computes).  The converged
        smoothing lengths and densities are kept; positions and velocities
        are untouched.  Under IsothermEqs the entropy variable stays u."""
        cfg = self.cfg
        s0 = self.sph
        s_tmp = self._step_fn.density_only(self.p, s0, self.ti_current)
        gas = (self.p.ptype == 0) & (self.p.pid >= 0)
        a3inv = 1.0 / cfg.time_begin ** 3 if cfg.comoving_integration \
            else 1.0
        rho = torch.clamp(s_tmp.density, min=1e-37)
        ent = s0.entropy if cfg.isotherm_eqs else \
            cfg.gamma_minus1 * s0.entropy / (rho * a3inv) ** cfg.gamma_minus1
        self.sph = s0.replace(entropy=torch.where(gas, ent, s0.entropy),
                              hsml=s_tmp.hsml, density=s_tmp.density)

    # ------------------------------------------------------------------
    def _build_step(self):
        """Under PMGRID two variants: the PM step (the long-range force,
        the PM kick, the PM window) and the one between PM steps, which
        holds accel_pm (the reference's conditional long_range_force,
        accel.c:34-42)."""
        cfg = self.cfg
        fns = []
        gas = dict(hydro=self.hydro) if self.has_gas else {}
        for pm in ((True, False) if cfg.pmgrid else (False,)):
            kit = (cfg, self.units, self.wiring, self.tables, self.mesh)
            if self.use_let:
                make = LetFullStep if self.has_gas else LetTreeStep
                fns.append(make(*kit, pm_step=pm, solver=self.solver,
                                caps=self.let_caps, **gas))
            else:
                make = ReplicatedFullStep if self.has_gas \
                    else ReplicatedTreeStep
                fns.append(make(*kit, pm_step=pm, solver=self.solver,
                                **gas))
        if cfg.pmgrid:
            self._step_pm_fn, self._step_fn = fns
        else:
            self._step_pm_fn, self._step_fn = None, fns[0]

    def _step_sum(self, name: str):
        return sum(getattr(f, name, 0)
                   for f in (self._step_pm_fn, self._step_fn) if f)

    @property
    def cap_retries(self) -> int:
        """LET exchanges repeated after a cap overflow, so far."""
        return self._step_sum("cap_retries")

    @property
    def ghost_retries(self) -> int:
        """SPH ghost-cap growths and density reruns with a wider ghost
        margin (LET with gas), so far."""
        return self._step_sum("ghost_retries"), \
            self._step_sum("margin_retries")

    @property
    def time(self) -> float:
        return float(ti_to_time(self.cfg, self.ti_current))

    def _mode_extras(self, ti_next: int, time_next: float):
        """The step's extra inputs for the special timestep modes."""
        cfg = self.cfg
        if cfg.pseudosymmetric:
            # set_random_numbers (system.c:37): a fresh table every step
            return (torch.as_tensor(self._rnd_rng.random(3000),
                                    dtype=torch.float32, device=self.device),)
        if cfg.flexsteps:
            # the PresentMinStep doubling schedule (timestep.c:140-162),
            # refreshed after the step from the steps assigned; the
            # PresentMaxStep from the displacement constraint
            # (timestep.c:164-175)
            if (self.ti_current % (4 * self.present_min_step)) == 0 \
                    and 1 < self.present_min_step < C.TIMEBASE:
                self.present_min_step *= 2
            dt_disp = sharded_dt_displacement(cfg, self.units, self.p,
                                              time_next, self.mesh)
            mx = max(1, min(int(min(dt_disp, cfg.max_size_timestep)
                                / self.tbi), C.TIMEBASE))
            self.present_max_step = pow2_floor(mx)
            return (self.present_min_step, self.present_max_step)
        return ()

    def _flex_post_step(self):
        """PresentMinStep from the steps just assigned (timestep.c:150-162)."""
        p = self.p
        steps = torch.where((p.pid >= 0) & (p.ti_endstep > p.ti_begstep),
                            p.ti_endstep - p.ti_begstep, C.TIMEBASE)
        mn = self.mesh.pmin(torch.amin(steps).reshape(1))
        self.present_min_step = min(self.present_min_step, int(mn[0]))

    # ------------------------------------------------------------------
    def step(self):
        """One main-loop iteration (run.c:32-132)."""
        cfg = self.cfg
        t0 = _time.time()
        ti_next = self._min_end
        if cfg.pmgrid and ti_next > self.pm_ti_endstep:
            # a PM step forces a full synchronisation (run.c:175-181)
            ti_next = self.pm_ti_endstep
        # drift exactly onto a pending snapshot time (run.c:206-225)
        if self._next_output < float("inf"):
            ti_out = time_to_ti(cfg, self._next_output)
            if self.ti_current < ti_out < ti_next:
                ti_next = ti_out
        pm_due = bool(cfg.pmgrid) and ti_next == self.pm_ti_endstep
        time_next = float(ti_to_time(cfg, ti_next))
        mode_extra = self._mode_extras(ti_next, time_next)
        fn = self._step_pm_fn if pm_due else self._step_fn
        extra = ((self.pm_ti_begstep, self.pm_ti_endstep) if pm_due
                 else ()) + tuple(mode_extra)
        res = fn(self.p, self.ti_current, ti_next, time_next, *extra,
                 sph=self.sph)
        self.let_rows = getattr(fn, "rows_received", None)
        self.ghost_rows = list(getattr(fn, "ghost_rows", [])) or None
        self.p, self.sph = res.p, res.sph
        self.ti_current = ti_next
        self._min_end = res.min_end
        if cfg.flexsteps:
            self._flex_post_step()
        if pm_due:
            self.pm_ti_begstep, self.pm_ti_endstep = res.pm_beg, res.pm_end
        n_act = res.n_active
        self.num_force_updates += n_act
        self._since_reshard += n_act
        self.step_count += 1

        # FORCETEST: direct-sum rows on the gathered state
        # (gravtree_forcetest.c:28; under PMGRID on PM steps, :46-49)
        if cfg.force_test > 0 and not cfg.no_gravity \
                and (not cfg.pmgrid or pm_due):
            self.force_test()
        wrote_snapshot = False
        while self._next_output < float("inf") \
                and self.time >= self._next_output - 1e-12:
            self.write_snapshot_now()
            self._next_output += cfg.time_bet_snapshot
            wrote_snapshot = True
        if self.time >= self._next_stats - 1e-12:
            self.energy_statistics()
            self._next_stats += cfg.time_bet_statistics

        # the work-weighted re-decomposition (domain.c:76)
        if self._since_reshard > cfg.tree_domain_update_frequency \
                * self.n_real * self.n_dev:
            self.domain_decomposition()
        if self._logging:
            self._write_step_logs(t0, n_act, wrote_snapshot)

    def _write_step_logs(self, t0: float, n_act: int, wrote_snapshot: bool):
        """info / cpu / timings lines (run.c:370-392, gravtree.c:408-445):
        throughput, interactions a particle, and the work-load balance from
        the measured interaction counts of each rank."""
        live = self.p.pid >= 0
        wl = self.mesh.all_gather(torch.stack([
            torch.sum(torch.where(live, self.p.grav_cost, 0.0)),
            torch.sum(live).to(torch.float32)])[None]).cpu().numpy()
        if self.mesh.rank != 0:
            return
        dt_step = _time.time() - t0
        step = self.step_count - 1
        self._logs["info"].write(
            f"Begin Step {step}, Time: {self.time:.8g}, Systemstep: "
            f"{dt_step:.3g}{', Snapshot' if wrote_snapshot else ''}\n")
        self._logs["info"].flush()
        self._logs["cpu"].write(f"Step {step}, Time: {self.time:g}, CPUs: "
                                f"{self.n_dev}\n{dt_step:.2f}\n")
        tot = wl[:, 0].sum()
        bal = wl[:, 0].max() * self.n_dev / max(tot, 1e-30)
        pbal = wl[:, 1].max() * self.n_dev / max(wl[:, 1].sum(), 1)
        self._logs["timings"].write(
            f"Step= {step}  t= {self.time:g}  parts= {self.n_real}  "
            f"active= {n_act}\npart/sec= {n_act / max(dt_step, 1e-9):.6g}  "
            f"ia/part= {tot / max(self.n_real, 1):.6g}\n"
            f"work-load balance: {bal:.4g}  particle-load balance: "
            f"{pbal:.4g}\n\n")
        self._logs["timings"].flush()

    def force_test(self, fraction=None, write=True):
        """gravity_forcetest (gravtree_forcetest.c:28) over the ranks: the
        state gathered and fed, on rank 0, to the single-device direct-sum
        oracle and forcetest.txt writer (Ewald-corrected when periodic,
        even under PMGRID, begrun.c:47-49).  `fraction` replaces
        cfg.force_test; without `write` no forcetest.txt row is written.
        Returns its rows on rank 0, None on the others."""
        from ..diagnostics.forcetest import force_test as _ft
        p, sph = self.gather_ordered()
        if self.mesh.rank != 0:
            return None
        shim = SimpleNamespace(
            cfg=self.cfg, p=p.to(self.device),
            sph=sph.to(self.device) if sph is not None else None,
            wiring=self.wiring,
            units=self.units, force_soft=self.force_soft,
            solver=self.solver, ti_current=self.ti_current,
            step_count=self.step_count, log_dir=self.log_dir)
        return _ft(shim, fraction=fraction, write=write)

    def domain_decomposition(self):
        """Re-split by measured work (domain_Decomposition, domain.c:62)."""
        kw = dict(alloc_factor=self.alloc_factor,
                  box=self.cfg.box_size if self.cfg.periodic else 0.0)
        if self.has_gas:
            self.p, self.sph = reshard_by_cost(self.p, self.mesh,
                                               sph=self.sph, **kw)
        else:
            self.p = reshard_by_cost(self.p, self.mesh, **kw)
        self._since_reshard = 0

    def _original_rows(self, pid: np.ndarray) -> np.ndarray:
        """The initial (type-sorted) row of each particle ID."""
        return self._pid_rank[np.searchsorted(self._pid_sorted, pid)]

    def _control(self, last_restart: float):
        """Rank 0's stop / CPU-limit / periodic-restart decision, shared by
        every rank (one pmax)."""
        flags = [0, 0, 0]
        if self.mesh.rank == 0:
            stop = os.path.join(self.log_dir, "stop") if self.log_dir else ""
            if stop and os.path.exists(stop):
                os.remove(stop)
                flags[0] = 1
            if self.cfg.time_limit_cpu > 0 and _time.time() \
                    - self._wall_start > 0.85 * self.cfg.time_limit_cpu:
                flags[1] = 1
            if self.log_dir and self.cfg.cpu_time_bet_restart_file > 0 \
                    and _time.time() - last_restart \
                    > self.cfg.cpu_time_bet_restart_file:
                flags[2] = 1
        out = self.mesh.pmax(torch.tensor(flags, dtype=torch.int32,
                                          device=self.device)).cpu()
        return [bool(x) for x in out]

    def run(self, max_steps: int | None = None):
        """run() (run.c:20): loop to TimeMax.  A `stop` file in the output
        directory or 85% of TimeLimitCPU writes a restart file and returns
        (run.c:67-103); a restart file is also written every
        CpuTimeBetRestartFile seconds (run.c:108-125), and each rank a
        crash dump before an exception propagates.  Returns the number of
        steps."""
        steps = 0
        last_restart = _time.time()
        while self.ti_current < C.TIMEBASE:
            if self.time > self.cfg.time_max * (1 + 1e-12):
                break
            try:
                self.step()
            except Exception:
                if self.log_dir:
                    try:
                        self.write_crash_dump()
                    except Exception:
                        pass
                raise
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
            stop, cpulimit, periodic = self._control(last_restart)
            if stop or cpulimit:
                if self._logging:
                    self.save_restart()
                if cpulimit and self.mesh.rank == 0 and self.cfg.resubmit_on \
                        and self.cfg.resubmit_command:
                    # self-resubmission (run.c:99-103)
                    os.system(self.cfg.resubmit_command)
                break
            if periodic:
                self.save_restart()
                last_restart = _time.time()
        if self.ti_current >= C.TIMEBASE \
                and self._next_output < float("inf"):
            self.write_snapshot_now()   # the final snapshot (run.c:134-141)
        for f in self._logs.values():
            f.flush()
        return steps

    def close(self):
        for f in self._logs.values():
            f.close()
        self._logs = {}

    # ------------------------------------------------------------------
    def gather_ordered(self):
        """The whole state on every rank, on the host, padding dropped, in
        the original (type-sorted) row order by particle ID.  Returns
        (Particles, SphState or None)."""
        pf = gather_rows(self.mesh, self.p)
        pf = Particles(**{k: v.cpu() for k, v in vars(pf).items()})
        live = np.nonzero(pf.pid.numpy() >= 0)[0]
        perm = torch.as_tensor(np.empty(self.n_real, np.int64))
        perm[self._original_rows(pf.pid.numpy()[live])] = \
            torch.as_tensor(live)
        sph = None
        if self.sph is not None:
            sf = gather_rows(self.mesh, self.sph)
            sph = take_rows(SphState(**{k: v.cpu()
                                        for k, v in vars(sf).items()}), perm)
        return take_rows(pf, perm), sph

    def _snapshot_path(self, path):
        """The snapshot path, the same on every rank; never the working
        directory (a headless run writes into a scratch directory)."""
        if path is not None:
            return path
        out_dir = self.log_dir
        if not out_dir:
            out_dir = getattr(self, "_tmp_out", None) or _shared_scratch(
                self.mesh)
            self._tmp_out = out_dir
        base = self.cfg.snapshot_file_base
        return os.path.join(out_dir, f"{base}_{self.snapshot_count:03d}")

    def write_snapshot_now(self, path=None):
        """savepositions (io.c:33).  With several ranks each writes one file
        of a num_files = K set from its own rows, never gathering the
        whole state (io.c:94-112); one rank writes the gathered state."""
        path = self._snapshot_path(path)
        if self.n_dev > 1:
            self._write_snapshot_sharded(path)
        else:
            p, sph = self.gather_ordered()
            data = build_snapshot_data(
                self.cfg, self.tables, float(self.tbi), p, self.ti_current,
                self.time, pm_window=self._pm_window(), sph=sph,
                n_gas=self.n_gas if sph is not None else 0, units=self.units)
            write_snapshot_files(self.cfg, path, data)
        self.snapshot_count += 1
        return path

    def _pm_window(self):
        return (self.pm_ti_begstep, self.pm_ti_endstep) \
            if self.cfg.pmgrid else None

    def _write_snapshot_sharded(self, path: str):
        """Member `path.k` of a num_files = K Gadget set from rank k's live
        rows, type-sorted, with the set's totals and per-particle masses
        (a per-file mass table could disagree when a type is absent on
        some rank); `read_snapshot_set` reassembles it."""
        from ..io.gadget_format import write_snapshot, write_snapshot_hdf5
        cfg = self.cfg
        p = self.p
        live = torch.nonzero(p.pid >= 0).squeeze(1)
        ptype = p.ptype[live]
        totals = self.mesh.psum(torch.bincount(
            ptype.long(), minlength=6).to(torch.int32)).cpu().numpy()
        order = live[torch.sort(ptype, stable=True).indices]
        pk = Particles(**{k: v[order].cpu() for k, v in vars(p).items()})
        sk = None if self.sph is None else SphState(
            **{k: v[order].cpu() for k, v in vars(self.sph).items()})
        data = build_snapshot_data(cfg, self.tables, float(self.tbi), pk,
                                   self.ti_current, self.time,
                                   pm_window=self._pm_window(), sph=sk,
                                   n_gas=int(torch.sum(pk.ptype == 0)),
                                   units=self.units)
        data.header.npart_total = totals.astype(np.uint32)
        data.header.num_files = self.n_dev
        data.header.mass = np.zeros(6)
        k = self.mesh.rank
        if cfg.snap_format == 3:
            write_snapshot_hdf5(f"{path}.{k}.hdf5", data,
                                with_pot=cfg.output_potential,
                                longids=cfg.longids)
        else:
            write_snapshot(f"{path}.{k}", data, snap_format=cfg.snap_format,
                           with_pot=cfg.output_potential,
                           longids=cfg.longids)
        self.mesh.barrier()

    def energy_statistics(self):
        """The energy.txt line (run.c:413-433) from the gathered state."""
        p, sph = self.gather_ordered()
        com = self.cfg.comoving_integration
        s = compute_global_quantities(
            p.to(self.device), self.tables, self.ti_current,
            pm_window=self._pm_window(), atime=self.time if com else 1.0,
            sph=sph.to(self.device) if sph is not None else None,
            cfg=self.cfg,
            a3inv=1.0 / self.time ** 3 if com else 1.0)
        if "energy" in self._logs:
            self._logs["energy"].write(format_energy_line(self.time, s)
                                       + "\n")
            self._logs["energy"].flush()
        return s

    def save_restart(self, path: str | None = None) -> str:
        """Restart dump (restart.c:35): the gathered state (the gas state
        under `s_` keys) and the timeline, under the JAX runner's keys,
        written by rank 0."""
        p, sph = self.gather_ordered()
        if path is None:
            path = os.path.join(self.log_dir or ".", "restart_dist.npz")
        if self.mesh.rank == 0:
            if os.path.exists(path):
                os.replace(path, path + ".bak")  # .bak rotation (restart.c:45)
            payload = {f"p_{k}": v.numpy() for k, v in vars(p).items()}
            if sph is not None:
                payload.update({f"s_{k}": v.numpy()
                                for k, v in vars(sph).items()})
            np.savez(path, **self._scalars(), **payload)
        self.mesh.barrier()
        return path

    def _scalars(self) -> dict:
        """The timeline and counters of a restart file."""
        return dict(ti_current=self.ti_current, min_end=self._min_end,
                    step_count=self.step_count,
                    num_force_updates=self.num_force_updates,
                    snapshot_count=self.snapshot_count,
                    next_output=self._next_output,
                    next_stats=self._next_stats,
                    pm_ti_begstep=self.pm_ti_begstep,
                    pm_ti_endstep=self.pm_ti_endstep)

    def write_crash_dump(self) -> str:
        """dump_particles (forcetree.c:3557) on this rank alone: its live
        rows, their gas state and the timeline to `crash_dump.<rank>.npz`
        under log_dir, with no collective (a rank that failed would never
        join one).  `read_crash_dump` puts the rank files together."""
        live = torch.nonzero(self.p.pid >= 0).squeeze(1)
        payload = {f"p_{k}": v[live].cpu().numpy()
                   for k, v in vars(self.p).items()}
        if self.sph is not None:
            payload.update({f"s_{k}": v[live].cpu().numpy()
                            for k, v in vars(self.sph).items()})
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir,
                            f"crash_dump.{self.mesh.rank}.npz")
        np.savez(path, rank=self.mesh.rank, n_ranks=self.n_dev,
                 **self._scalars(), **payload)
        return path

    def resume(self, path: str | None = None):
        """Exact continuation from a restart dump (RestartFlag=1), this
        package's or the JAX runner's: the state and the timeline; the
        decomposition is made anew, the tree rebuilt."""
        from ..interop import (particles_from_numpy, read_distributed_restart,
                               sph_from_numpy)
        if path is None:
            path = os.path.join(self.log_dir or ".", "restart_dist.npz")
        z = read_distributed_restart(path)
        if (z["sph"] is not None) != self.has_gas:
            raise ValueError(f"{path}: the restart file's gas state does "
                             "not match this run's")
        p = particles_from_numpy(z["particles"], "cpu")
        kw = dict(alloc_factor=self.alloc_factor,
                  box=self.cfg.box_size if self.cfg.periodic else 0.0)
        if self.has_gas:
            self.p, self.sph = decompose(
                p, self.mesh, sph=sph_from_numpy(z["sph"], "cpu"), **kw)
        else:
            self.p = decompose(p, self.mesh, **kw)
        s = z["scalars"]
        self.ti_current = int(s["ti_current"])
        self._min_end = int(s["min_end"])
        if "pm_ti_begstep" in s:
            self.pm_ti_begstep = int(s["pm_ti_begstep"])
            self.pm_ti_endstep = int(s["pm_ti_endstep"])
        self.step_count = int(s["step_count"])
        self.num_force_updates = int(s["num_force_updates"])
        self.snapshot_count = int(s["snapshot_count"])
        self._next_output = float(s["next_output"])
        self._next_stats = float(s["next_stats"])
        self._since_reshard = 0
        return self


def read_crash_dump(log_dir: str) -> dict:
    """The rank files of a multi-device crash dump put together in
    particle-ID order, in `interop.read_distributed_restart`'s layout:
    {"particles": {field: array}, "sph": {field: array} or None,
    "scalars": {name: value}}."""
    zs = [np.load(os.path.join(log_dir, f)) for f in os.listdir(log_dir)
          if f.startswith("crash_dump.") and f.endswith(".npz")]
    if not zs:
        raise FileNotFoundError(f"no crash dump in {log_dir}")
    n_ranks = int(zs[0]["n_ranks"])
    if sorted(int(z["rank"]) for z in zs) != list(range(n_ranks)):
        raise ValueError(f"{log_dir}: crash dump files of ranks "
                         f"{sorted(int(z['rank']) for z in zs)}, not of "
                         f"all {n_ranks}")
    cat = lambda key: np.concatenate([z[key] for z in zs])
    order = np.argsort(cat("p_pid"), kind="stable")
    keys = zs[0].files
    parts = {k[2:]: cat(k)[order] for k in keys if k.startswith("p_")}
    sph = {k[2:]: cat(k)[order] for k in keys if k.startswith("s_")} or None
    scalars = {k: zs[0][k][()] for k in keys
               if not k.startswith(("p_", "s_")) and k not in ("rank",
                                                               "n_ranks")}
    return {"particles": parts, "sph": sph, "scalars": scalars}
