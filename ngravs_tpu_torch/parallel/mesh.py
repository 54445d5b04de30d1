"""The rank mesh: collectives, sharded particle arrays, the data-parallel
direct step (port of `ngravs_tpu/parallel/mesh.py`).

The reference's MPI machinery (SURVEY.md §2.2) as the JAX package maps it
onto a 1-D device mesh, here onto `torch.distributed` ranks:

  reference mechanism                     -> here
  ------------------------------------------------------------------
  one MPI rank per process                -> one process per rank
                                             (`launch`, spawn start method)
  Peano-Hilbert domain decomposition      -> each rank owns n_local rows
                                             (equal capacity, inert padding)
  export/import of remote particles       -> `Mesh.all_gather` of the
                                             source set
  MPI_Allreduce(min Ti_endstep)           -> `Mesh.pmin`
  (run.c:165)

Every collective the package uses is a method of `Mesh` and nowhere else.
NCCL takes device tensors; gloo moves host memory, so under gloo a CUDA
tensor is copied to the host before each collective and back after (the
backend is fixed at launch).  Flags and counts travel as int32, never as
bool.  The rank's trace (`Mesh.trace`, `ngravs_tpu_torch/trace.py`) counts
the calls (`mesh.calls`) and the bytes each rank sends (`mesh.bytes`).
"""

from __future__ import annotations

import dataclasses
import math
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..constants import SOFTFAC_SPLINE, TIMEBASE
from ..integrate.kdk import cosmo_factors, drift, box_wrap, kick
from ..integrate.timeline import timebase_interval
from ..ops.direct import ParticleSlice, pairwise_forces
from ..trace import Trace

INERT_ENDSTEP = 2 ** 30     # padding rows are never active
COLLECTIVE_TIMEOUT_S = 600  # a collective waiting this long for a rank fails


class Mesh:
    """This rank's place in the run: rank, world size, device, backend,
    and the rank's trace (its timers and counters, shared by the steps and
    solvers of the rank).

    The collectives replace the JAX package's axis primitives:
    `all_gather` (tiled `lax.all_gather`), `all_to_all` (tiled
    `lax.all_to_all` of equal blocks), `psum` / `pmin` / `pmax`
    (`lax.psum` ...) and `ring` (a `lax.ppermute` ring)."""

    def __init__(self, rank: int, size: int, device, backend: str):
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.trace = Trace()

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """t as the backend moves it: contiguous, bool as int32, on the
        host under gloo."""
        if t.dtype == torch.bool:
            t = t.to(torch.int32)
        if self.backend == "gloo" and t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        self.trace.count("mesh.calls")
        self.trace.count("mesh.bytes", t.numel() * t.element_size())
        return t

    def _home(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if like.dtype == torch.bool:
            t = t != 0
        return t.to(like.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t concatenated along axis 0 in rank order."""
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w)
        return self._home(torch.cat(parts), t)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t: [size, ...] blocks, block j sent to rank j; returns [size, ...]
        with block i received from rank i."""
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all needs {self.size} blocks, got "
                             f"{t.shape[0]}")
        w = self._wire(t)
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w)
        return self._home(out, t)

    def _reduce(self, t, op):
        w = self._wire(t).clone()
        dist.all_reduce(w, op=op)
        return self._home(w, t)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def ring(self, t: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Send t to rank (r + shift) % size; return what rank
        (r - shift) % size sent (a `ppermute` ring).  An all_to_all with
        zero splits except the neighbours', so a 1-rank ring sends to
        itself without a deadlocking send/recv pair."""
        w = self._wire(t).reshape(-1)
        n = w.shape[0]
        ins = [0] * self.size
        outs = [0] * self.size
        ins[(self.rank + shift) % self.size] = n
        outs[(self.rank - shift) % self.size] = n
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, outs, ins)
        return self._home(out.reshape(t.shape), t)

    def broadcast_object(self, obj):
        """Rank 0's picklable `obj` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self):
        dist.barrier()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device: str, rank: int) -> torch.device:
    """Rank r's device: cuda:(r mod cards), so cuda:r under NCCL (one card
    a rank, `check_launch`) and shared cards under gloo; else the CPU."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def check_launch(world: int, device: str, backend: str):
    """Refuse a launch the backend cannot carry before any rank starts."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if device == "cpu" and backend == "nccl":
        raise ValueError("NCCL runs on CUDA devices only: use gloo with "
                         "--device cpu")
    if device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: ngravs_tpu_torch runs on the GPU unless "
                "the caller asks for the CPU (--device cpu)")
        n = torch.cuda.device_count()
        if backend == "nccl" and world > n:
            raise RuntimeError(
                f"--devices {world} over NCCL needs {world} cards, {n} "
                "visible; pass --backend gloo to let ranks share cards")


def init_mesh(rank: int, world: int, backend: str, device: str,
              init_method: str) -> Mesh:
    """Join the process group and return this rank's mesh."""
    import datetime
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, init_method=init_method, rank=rank,
              world_size=world,
              timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return Mesh(rank, world, dev, backend)


def _rank_main(rank, fn, world, backend, device, init_method, threads,
               args):
    if threads:
        torch.set_num_threads(threads)
    mesh = init_mesh(rank, world, backend, device, init_method)
    try:
        fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def default_backend(device: str) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "gloo" if device == "cpu" else "nccl"


def launch(fn, world: int, device: str = "cuda", backend: str | None = None,
           init_method: str | None = None, args=(), threads: int = 0):
    """Run fn(mesh, *args) in `world` new processes (spawn start method: a
    process that touched CUDA cannot fork), one a rank, and wait for all.
    The ranks run on the card unless `device` is "cpu"; the backend is
    `default_backend(device)` unless named.  A rank that raises fails the
    launch and stops the others.  Without `init_method` the ranks meet at
    tcp://localhost on a free port."""
    import torch.multiprocessing as mp
    backend = backend or default_backend(device)
    check_launch(world, device, backend)
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    # the ranks all run on this host: gloo connects them over the loopback
    # interface, not over whatever interface the host name resolves to
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    mp.start_processes(_rank_main, args=(fn, world, backend, device,
                                         init_method, threads, tuple(args)),
                       nprocs=world, join=True, start_method="spawn")


# --------------------------------------------------------------------------
# row packing: a dataclass of [n] / [n, k] tensors as one [n, W] f32 block,
# int32 fields by bit pattern, so a whole shard moves in one collective
# --------------------------------------------------------------------------

def pack_rows(obj) -> torch.Tensor:
    cols = []
    for f in dataclasses.fields(obj):
        a = getattr(obj, f.name)
        a = a.reshape(a.shape[0], -1)
        if a.dtype == torch.int32:
            a = a.view(torch.float32)
        elif a.dtype != torch.float32:
            raise TypeError(f"{f.name}: {a.dtype} cannot be packed")
        cols.append(a)
    return torch.cat(cols, dim=1)


def unpack_rows(like, rows: torch.Tensor):
    """The dataclass of `like`'s type and field shapes from packed rows."""
    kw = {}
    c = 0
    for f in dataclasses.fields(like):
        a = getattr(like, f.name)
        w = int(np.prod(a.shape[1:])) if a.dim() > 1 else 1
        blk = rows[:, c:c + w].contiguous()
        if a.dtype == torch.int32:
            blk = blk.view(torch.int32)
        kw[f.name] = blk.reshape((rows.shape[0],) + tuple(a.shape[1:]))
        c += w
    return type(like)(**kw)


def gather_rows(mesh: Mesh, obj):
    """All ranks' rows of a dataclass of tensors, in rank order."""
    return unpack_rows(obj, mesh.all_gather(pack_rows(obj)))


def take_rows(obj, idx):
    return type(obj)(**{f.name: getattr(obj, f.name)[idx]
                        for f in dataclasses.fields(obj)})


def shard_particles(p, mesh: Mesh):
    """This rank's shard of the global particles `p` (every rank holds the
    same `p`): N padded to a multiple of the mesh size with massless rows
    of pid -1 whose step ends past the horizon, then the rank's contiguous
    n_local rows, on the rank's device."""
    n = p.pos.shape[0]
    size = mesh.size
    pad = (-n) % size
    if pad:
        def _pad(a):
            return torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]),
                                             dtype=a.dtype,
                                             device=a.device)])
        p = type(p)(**{f.name: _pad(getattr(p, f.name))
                       for f in dataclasses.fields(p)})
        p.ti_endstep[n:] = INERT_ENDSTEP
        p.pid[n:] = -1
    nloc = (n + pad) // size
    sl = slice(mesh.rank * nloc, (mesh.rank + 1) * nloc)
    return type(p)(**{f.name: getattr(p, f.name)[sl].to(mesh.device)
                      for f in dataclasses.fields(p)})


def sharded_dt_displacement(cfg, units, p, atime, mesh: Mesh) -> float:
    """find_dt_displacement_constraint (timestep.c:587-651) with the
    cross-rank reductions: the global RMS-displacement timestep limit a
    type, mesh-aware under PMGRID; MaxSizeTimestep when not comoving
    (timestep.c:596-597).  f32 arithmetic, in the JAX function's order;
    one psum and one pmin."""
    dev = p.pos.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    dt_min = f32(cfg.max_size_timestep)
    if not cfg.comoving_integration:
        return float(dt_min)
    a = torch.as_tensor(atime, dtype=torch.float32, device=dev)
    h2 = (cfg.omega0 / (a * a * a)
          + (1 - cfg.omega0 - cfg.omega_lambda) / (a * a)
          + cfg.omega_lambda)
    hfac = units.hubble * torch.sqrt(h2) * a * a          # a^2 H(a)
    rho_fac = 3 * units.hubble ** 2 / (8 * math.pi * units.G)
    live = p.pid >= 0
    sels = [(p.ptype == t) & live for t in range(6)]
    sums = mesh.psum(torch.stack(
        [torch.sum(s).to(torch.float32) for s in sels]
        + [torch.sum(torch.where(s[:, None], p.vel ** 2, 0.0))
           for s in sels]))
    mins = mesh.pmin(torch.stack(
        [torch.amin(torch.where(s, p.mass, math.inf)) for s in sels]))
    for t in range(6):
        count, v2, min_mass = sums[t], sums[6 + t], mins[t]
        vrms = torch.sqrt(v2 / torch.clamp(count, min=1))
        omega_t = cfg.omega_baryon if t == 0 \
            else cfg.omega0 - cfg.omega_baryon
        dmean = (min_mass / max(omega_t * rho_fac, 1e-37)) ** (1. / 3)
        if cfg.pmgrid:
            dmean = torch.clamp(dmean,
                                max=cfg.asmth * cfg.box_size / cfg.pmgrid)
        dt_t = (cfg.max_rms_displacement_fac * hfac * dmean
                / torch.clamp(vrms, min=1e-30))
        dt_min = torch.where(count > 0, torch.minimum(dt_min, dt_t), dt_min)
    return float(dt_min)


def make_mode_kick(cfg, units, tables, soft_table, mesh: Mesh):
    """The kick of a step, honouring the reference's special timestep
    modes.  Returns (kick_fn(p, sph, ti_next, dt_disp, time_next, extras)
    -> (p, sph), the number of extra inputs a step takes).  With gas (`sph`
    not None) the kick is also the hydro kick, the entropy update with the
    MinGasTemp floor and the Courant criterion (`kdk.kick`):

      * SYNCHRONIZATION (default) — `kdk.kick`, no extras
      * FLEXSTEPS (timestep.c:196) — extras (present_min_step,
        present_max_step); each particle's phase from the ID-keyed seed-42
        table (system.c:29-47), the same on any rank count
      * PSEUDOSYMMETRIC (timestep.c:202-238) — extras (rnd_table[3000],),
        a fresh table a step from the runner
      * MAKEGLASS (timestep.c:85-133) — no extras; the reversed-gravity
        displacement with the global largest-displacement clamp (pmax),
        then a MaxSizeTimestep advance of the active set; the gas state
        is returned unchanged
    """
    dev = mesh.device
    tbi = timebase_interval(cfg)
    n_extras = 0
    flextab = None
    if cfg.flexsteps:
        n_extras = 2
        r42 = np.random.default_rng(42).random(3000)
        flextab = torch.as_tensor((TIMEBASE * r42).astype(np.int64)
                                  .astype(np.int32), device=dev)
    elif cfg.pseudosymmetric:
        n_extras = 1
    glass_ticks = max(1, int(cfg.max_size_timestep / tbi)) \
        if cfg.make_glass else 0

    def cf_at(time_next):
        return cosmo_factors(cfg, units, time_next, dev) \
            if cfg.comoving_integration else None

    def kick_fn(p, sph, ti_next, dt_disp, time_next, extras):
        if cfg.make_glass:
            acc = -(p.accel + p.accel_pm)
            disp_fac = 2.0 / (3 * units.hubble ** 2)
            disp = torch.linalg.norm(acc, dim=-1) * disp_fac
            live = p.pid >= 0
            dmax = torch.amax(torch.where(live, disp, 0.0))
            sums = torch.stack([torch.sum(torch.where(live, p.mass, 0.0)),
                                torch.sum(live.to(torch.float32))])
            dmax, (msum, ncnt) = mesh.pmax(dmax), mesh.psum(sums)
            rho_crit = (cfg.omega0 * 3 * units.hubble ** 2
                        / (8 * np.pi * units.G))
            dmean = (msum / torch.clamp(ncnt, min=1)
                     / max(rho_crit, 1e-37)) ** (1.0 / 3)
            fac = torch.where(dmax > dmean,
                              dmean / torch.clamp(dmax, min=1e-37), 1.0)
            pos = p.pos + fac * acc * disp_fac
            if cfg.periodic and cfg.box_size > 0:
                pos = torch.remainder(pos, cfg.box_size)
            act = p.ti_endstep == ti_next
            return p.replace(
                pos=pos, vel=torch.zeros_like(p.vel),
                accel=torch.zeros_like(p.accel),
                accel_pm=torch.zeros_like(p.accel_pm),
                ti_begstep=torch.where(act, p.ti_endstep, p.ti_begstep),
                ti_endstep=torch.where(act, p.ti_endstep + glass_ticks,
                                       p.ti_endstep)), sph
        variant = {}
        if cfg.flexsteps:
            pmin_step, pmax_step = extras
            variant["flex"] = (flextab[(p.pid % 3000).long()],
                               int(pmin_step), int(pmax_step))
        elif cfg.pseudosymmetric:
            variant["rnd_table"] = extras[0]
        return kick(cfg, p, tables, ti_next, dt_disp, soft_table,
                    cf_at(time_next), sph=sph,
                    min_egy_spec=units.min_egy_spec, **variant)

    return kick_fn, n_extras


def make_sharded_step(cfg, units, wiring, tables, mesh: Mesh,
                      chunk: int = 512):
    """A data-parallel direct step over the mesh: drift all ->
    all_gather the sources -> pair sums on the local targets -> kick.

    Returns step(p, ti_current, ti_next, time_next) -> (p, min_endstep)
    on the rank's shard.  Every particle is treated as active for the
    forces (the flat-force regime), as in the JAX package."""
    box = cfg.box_size if cfg.periodic else 0.0
    dev = mesh.device
    fsoft_by_type = torch.as_tensor(
        np.array(cfg.softening, np.float32) * SOFTFAC_SPLINE, device=dev)
    soft_table = torch.as_tensor(np.array(cfg.softening, np.float32),
                                 device=dev)
    G = units.G

    def step(p, ti_current, ti_next, time_next):
        nloc = p.pos.shape[0]
        gid = mesh.rank * nloc + torch.arange(nloc, dtype=torch.int32,
                                              device=dev)
        gid = torch.where(p.pid >= 0, gid, -1)
        # drift all local particles to the sync point (predict.c:31)
        p = box_wrap(cfg, drift(p, tables, ti_current, ti_next)) \
            if box > 0 else drift(p, tables, ti_current, ti_next)
        fsoft = fsoft_by_type[p.ptype.long()]
        # source replication (the export/import replacement)
        rows = mesh.all_gather(torch.cat([
            p.pos, p.mass[:, None], fsoft[:, None],
            p.grav.view(torch.float32)[:, None],
            gid.view(torch.float32)[:, None]], dim=1))
        src = ParticleSlice(pos=rows[:, 0:3], mass=rows[:, 3],
                            fsoft=rows[:, 4],
                            grav=rows[:, 5].contiguous().view(torch.int32),
                            gid=rows[:, 6].contiguous().view(torch.int32))
        tgt = ParticleSlice(pos=p.pos, mass=p.mass, grav=p.grav,
                            fsoft=fsoft, gid=gid)
        acc, pot = pairwise_forces(wiring, tgt, src, box=box, chunk=chunk)
        acc = acc * G
        p = p.replace(accel=acc, potential=pot * G,
                      old_acc=torch.linalg.norm(acc, dim=-1))
        # kick the active set (timestep.c): local, masked
        cf = cosmo_factors(cfg, units, time_next, dev) \
            if cfg.comoving_integration else None
        p, _ = kick(cfg, p, tables, ti_next, cfg.max_size_timestep,
                    soft_table, cf)
        min_end = mesh.pmin(torch.amin(p.ti_endstep).reshape(1))[0]
        return p, min_end

    return step

