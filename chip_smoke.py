"""Drive the PyTorch port on one NVIDIA GPU and hold its kernel to its twin.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

 1. the card: `nvidia-smi` name and power limit, torch and CUDA versions;
    no CUDA device -> exit 1 with no result;
 2. build: nvcc compiles `ngravs_tpu_torch/csrc/pairwise.cu` (sm_90a) into
    `build/`;
 3. kernel: K1a (`ops/pairwise.py:pairwise_eval`) against its plain twin
    `pairwise_eval_torch` on the card at the fused walk's shapes (B=128
    blocks of G=64 targets, S=4096 source rows, ragged n_src), potential
    on and off: acc and pot within 1e-5 of each target's sum of |terms|
    (the two sum in different orders), pair counts equal; median times;
 4. main path: a synthetic GalaxyCollision-shaped IC (60k particles of
    types 1-5 as BASELINE.md counts them, two Plummer spheres on a
    collision orbit, disk -> gravity 1) written in format 1 with its
    parameterfile, run as `read_parameter_file(...,
    direct_crossover=1000, tree_depth=12)` -> `Simulation(cfg)` ->
    `run(max_steps=...)`; then one full tree force pass checked against the
    direct sweep on the card (rms relative error < 5e-3), for finite forces
    and for the momentum rate |sum m a| / sum |m a| < 1e-3, and timed with
    the kernel and with the twin substituted; then K1a against the twin
    again, on the inputs of that pass's largest launch (the main path's own
    shapes and data), with the tolerance of phase 3.

The line before the last is a JSON object with the kernel's numbers; the
last line is {"ok": true, "device": {...}}.  Every time printed is from this
run, on the card named above it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B, G, S = 128, 64, 4096          # the fused walk's pair-kernel shapes
RTOL_TERMS = 1e-5                # of each target's sum of |terms|
MAIN_STEPS = 200
# BASELINE.md:54 — GalaxyCollision.IC per-type counts (no gas)
NPART = (0, 10000, 20000, 10000, 10000, 10000)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median of `reps` CUDA-event timings of fn(), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


# --------------------------------------------------------------------------
# phase 3: the kernel against its twin
# --------------------------------------------------------------------------

def kernel_inputs(dev, seed: int = 0):
    """Walk-shaped pair-kernel inputs: per block G targets in a small cell,
    sources that are particles of the block (self pairs), other particles,
    node rows (gid -2) and padding (gid -1), with softening lengths that
    put pairs on both sides of r = h; rows past n_src hold garbage the
    kernel must not read."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-50, 50, (B, 1, 3))
    tpos = (centre + rng.normal(0, 0.5, (B, G, 3))).astype(np.float32)
    tgid = np.arange(B * G, dtype=np.int32).reshape(B, G)
    spos = (centre + rng.normal(0, 2.0, (B, S, 3))).astype(np.float32)
    sgid = rng.integers(0, B * G, (B, S)).astype(np.int32)
    kind = rng.uniform(size=(B, S))
    sgid[kind < 0.1] = -1
    sgid[(kind >= 0.1) & (kind < 0.3)] = -2
    self_rows = (kind >= 0.3) & (kind < 0.35)
    sgid[self_rows] = tgid[np.nonzero(self_rows)[0],
                           rng.integers(0, G, self_rows.sum())]
    n_src = rng.integers(1, S, B).astype(np.int32)
    n_src[:4] = (0, S, 256, 1)
    live = np.arange(S)[None, :] < n_src[:, None]
    sp = np.zeros((B, 8, S), np.float32)
    sp[:, 0:3] = spos.transpose(0, 2, 1)
    sp[:, 3] = rng.uniform(0.5, 2.0, (B, S))
    sp[:, 4] = rng.uniform(0.1, 1.0, (B, S))
    sp[:, 5] = 1.0
    sp[:, 6] = np.zeros((B, S), np.int32).view(np.float32)
    sp[:, 7] = sgid.view(np.float32)
    sp[:, 0][~live] = np.nan                 # garbage past n_src
    col = lambda a, dt=np.float32: torch.as_tensor(
        np.ascontiguousarray(a, dt).reshape(B * G, 1), device=dev)
    targets = dict(x=col(tpos[..., 0]), y=col(tpos[..., 1]),
                   z=col(tpos[..., 2]), mass=col(rng.uniform(0.5, 2, (B, G))),
                   grav=col(np.zeros((B, G)), np.int32),
                   fsoft=col(rng.uniform(0.1, 1.0, (B, G))),
                   gid=col(tgid, np.int32))
    return (targets, torch.as_tensor(sp, device=dev),
            torch.as_tensor(n_src.reshape(B, 1), device=dev))


def term_scales(targets, sp, n_src):
    """Per target: sum over valid pairs of |fac*dx|, |fac*dy|, |fac*dz| and
    |pot term| — the scale of each sum for the tolerance."""
    from ngravs_tpu_torch.models.laws import Newtonian
    from ngravs_tpu_torch.ops.pairwise import FMASS, FSOFT, FX, FY, FZ, IGID
    law = Newtonian()
    nb, _, s = sp.shape
    g = targets["x"].shape[0] // nb
    col = lambda k: targets[k].reshape(nb, g, 1)
    out = torch.zeros(nb * g, 4, device=sp.device)
    for c0 in range(0, s, 512):
        cs = slice(c0, c0 + 512)
        sgid = sp[:, IGID, cs].view(torch.int32)[:, None, :]
        live = (torch.arange(c0, min(c0 + 512, s),
                             device=sp.device)[None, None, :]
                < n_src.reshape(nb, 1, 1))
        valid = live & (sgid != -1) & (sgid != col("gid"))
        d = [sp[:, None, a, cs] - col(k) for a, k in ((FX, "x"), (FY, "y"),
                                                     (FZ, "z"))]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        r = torch.sqrt(r2)
        h = torch.maximum(col("fsoft"), sp[:, None, FSOFT, cs])
        sm = sp[:, None, FMASS, cs]
        fac = law.force_factor(None, sm, r2, r, h, 1)
        pot = law.potential_factor(None, sm, r2, r, h, 1)
        out += torch.stack(
            [torch.where(valid, (fac * d[a]).abs(), 0.).sum(-1)
             for a in range(3)]
            + [torch.where(valid, pot.abs(), 0.).sum(-1)],
            dim=-1).reshape(nb * g, 4)
    return out


def check_kernel(label: str, targets, sp, n_src, modes):
    """K1a against its twin on the same inputs, for each want_pot in
    `modes`: acc and pot within RTOL_TERMS of each target's sum of |terms|,
    pair counts equal; median times.  Returns {want_pot: numbers}."""
    from ngravs_tpu_torch.ops.pairwise import (pairwise_eval,
                                               pairwise_eval_torch)
    scale = term_scales(targets, sp, n_src)
    report = {}
    for want_pot in modes:
        acc, pot, nia = pairwise_eval(targets, sp, n_src, want_pot)
        torch.cuda.synchronize()
        acc_t, pot_t, nia_t = pairwise_eval_torch(targets, sp, n_src,
                                                  want_pot)
        if not (torch.isfinite(acc).all() and torch.isfinite(pot).all()):
            raise AssertionError(f"{label}: K1a returned non-finite values")
        err_a = (acc - acc_t).abs()
        if bool((err_a > RTOL_TERMS * scale[:, :3]).any()):
            raise AssertionError(f"{label}: K1a acc off by "
                                 f"{float(err_a.max())} (want_pot={want_pot})")
        err_p = (pot - pot_t).abs()
        if want_pot and bool((err_p > RTOL_TERMS * scale[:, 3]).any()):
            raise AssertionError(f"{label}: K1a pot off by "
                                 f"{float(err_p.max())}")
        if not torch.equal(nia, nia_t):
            raise AssertionError(f"{label}: K1a pair counts differ from "
                                 "the twin")
        ms = cuda_ms(lambda: pairwise_eval(targets, sp, n_src, want_pot), 20)
        plain_ms = cuda_ms(lambda: pairwise_eval_torch(targets, sp, n_src,
                                                       want_pot), 5)
        pairs = int(torch.sum(nia_t))
        report[want_pot] = dict(max_abs_err=float(err_a.max()), ms=ms,
                                plain_ms=plain_ms)
        print(f"{label} want_pot={want_pot} {tuple(sp.shape)}: "
              f"max|dacc|={float(err_a.max()):.3g} (max|acc| "
              f"{float(acc_t.abs().max()):.4g}) max|dpot|="
              f"{float(err_p.max()):.3g} pairs={pairs} K1a {ms:.3f} ms "
              f"({pairs / ms / 1e6:.3f} Gpair/s), twin {plain_ms:.3f} ms",
              flush=True)
    return report


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------

def plummer(rng, k: int, a: float, m: float, g_int: float):
    """k positions/velocities of a Plummer sphere (scale a, mass m) cut at
    10 a, with isotropic Gaussian velocities of the local dispersion."""
    x = rng.uniform(1e-3, 0.999, k)
    r = np.minimum(a / np.sqrt(x ** (-2.0 / 3.0) - 1.0), 10 * a)
    u = rng.normal(size=(k, 3))
    pos = r[:, None] * u / np.linalg.norm(u, axis=1, keepdims=True)
    sigma = np.sqrt(g_int * m / (6.0 * np.sqrt(r * r + a * a)))
    return pos, rng.normal(size=(k, 3)) * sigma[:, None]


def write_galaxy_collision(run_dir: str, seed: int = 7) -> str:
    """Two 30k Plummer galaxies (1e12 Msun, a = 10 kpc each) 100 kpc apart,
    closing at 300 km/s with a 20 kpc impact parameter; returns the
    parameterfile path."""
    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.io.gadget_format import (SnapshotData,
                                                   SnapshotHeader,
                                                   write_snapshot)
    from ngravs_tpu_torch.units import set_units
    g_int = set_units(SimulationConfig()).G
    rng = np.random.default_rng(seed)
    m_gal, a = 100.0, 10.0
    n = sum(NPART)
    ptype = np.repeat(np.arange(6, dtype=np.int32), NPART)
    gal = np.zeros(n, np.int64)
    for t in range(6):           # each type split evenly between galaxies
        idx = np.nonzero(ptype == t)[0]
        gal[idx[len(idx) // 2:]] = 1
    pos = np.zeros((n, 3))
    vel = np.zeros((n, 3))
    for k, (off, v) in enumerate((([-50.0, -10.0, 0.0], [150.0, 0, 0]),
                                  ([50.0, 10.0, 0.0], [-150.0, 0, 0]))):
        sel = gal == k
        p, w = plummer(rng, int(sel.sum()), a, m_gal, g_int)
        pos[sel] = p + off
        vel[sel] = w + v
    h = SnapshotHeader()
    h.npart = np.array(NPART, np.int32)
    h.npart_total = h.npart.astype(np.uint32)
    h.mass = np.array([0.0] + [m_gal * 2 / n] * 5)
    ic = os.path.join(run_dir, "GalaxyCollision.IC")
    write_snapshot(ic, SnapshotData(
        header=h, pos=pos.astype(np.float32), vel=vel.astype(np.float32),
        pid=np.arange(1, n + 1, dtype=np.uint32),
        mass=np.full(n, m_gal * 2 / n, np.float32), ptype=ptype))
    # Configuration.reference-shaped parameters (BASELINE.md:49-56)
    params = {
        "InitCondFile": ic, "OutputDir": run_dir,
        "SnapshotFileBase": "snapshot", "ICFormat": 1, "SnapFormat": 1,
        "TimeBegin": 0.0, "TimeMax": 2.0, "TimeBetSnapshot": 0.01,
        "TimeOfFirstSnapshot": 0.0, "TimeBetStatistics": 0.05,
        "ErrTolIntAccuracy": 0.025, "MaxSizeTimestep": 0.01,
        "ErrTolTheta": 0.5, "TypeOfOpeningCriterion": 1,
        "ErrTolForceAcc": 0.005, "TreeDomainUpdateFrequency": 0.1,
        "SofteningHalo": 1.0, "SofteningDisk": 0.4, "SofteningBulge": 0.8,
        "SofteningStars": 1.0, "SofteningBndry": 1.0,
        "GravityGas": 0, "GravityHalo": 0, "GravityDisk": 1,
        "GravityBulge": 0, "GravityStars": 0, "GravityBndry": 0,
    }
    path = os.path.join(run_dir, "galaxy_collision.param")
    with open(path, "w") as f:
        for k, v in params.items():
            f.write(f"{k:<28s} {v}\n")
    return path


def all_active(sim):
    """The particles with every one of them active at the current time."""
    return sim.p.replace(ti_endstep=torch.full_like(sim.p.ti_endstep,
                                                    sim.ti_current))


def pass_solver(sim):
    """A solver of its own for whole force passes at the current state, its
    caps settled by one untimed pass; the run's solver is left as it is.
    Each pass updates every particle, more than TreeDomainUpdateFrequency
    * N, so the next pass rebuilds the tree."""
    from ngravs_tpu_torch.ops.solver import GravitySolver
    solver = GravitySolver(sim.cfg, sim.wiring, sim.force_soft, sim.units.G,
                           hubble=sim.units.hubble)
    solver.compute(all_active(sim), sim.ti_current, sim.p.n)
    return solver


def full_force_pass(sim, solver, pair_eval):
    """One tree force pass (build + walk + scatter) on every particle at the
    current state with `pair_eval` as the walk's pair evaluation; returns
    (G-scaled accelerations, seconds)."""
    solver.pair_eval = pair_eval
    p_all = all_active(sim)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2, _, _ = solver.compute(p_all, sim.ti_current, sim.p.n)
    torch.cuda.synchronize()
    return p2.accel, time.perf_counter() - t0


def profile_pass(sim, solver, card: str):
    """Where a force pass's time goes: one full pass under torch.profiler
    (CUDA kernel count and device time, K1a's share), the tree build alone
    (CUDA events), then five more steps of the run on the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ngravs_tpu_torch.ops.pairwise import pairwise_eval
    from ngravs_tpu_torch.ops.tree import build_tree
    solver.pair_eval = pairwise_eval
    p_all = all_active(sim)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.compute(p_all, sim.ti_current, sim.p.n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    k1a = [e for e in kern if "pairwise_newton" in e.key]
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    k1a_ms = sum(dev_us(e) for e in k1a) / 1e3
    if busy_ms > 0:
        print(f"profiled pass [{card}]: {wall_ms:.1f} ms wall (profiler "
              f"on), {sum(e.count for e in kern)} CUDA kernels, device busy "
              f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.1%} of the wall); "
              f"K1a {sum(e.count for e in k1a)} launches, {k1a_ms:.2f} ms "
              f"({k1a_ms / busy_ms:.1%} of device time)", flush=True)
    else:
        print(f"profiled pass [{card}]: {wall_ms:.1f} ms wall; device time "
              "not measured (the profiler recorded none)", flush=True)
    p = sim.p
    fsoft = torch.as_tensor(sim.force_soft, device=p.pos.device)[
        p.ptype.long()]
    aold = sim.cfg.err_tol_force_acc * p.old_acc / sim.units.G
    build_ms = cuda_ms(lambda: build_tree(
        p.pos, p.mass, p.grav, fsoft, aold, torch.zeros_like(p.mass),
        depth=solver.depth, n_gravs=sim.cfg.n_gravs,
        bucket=sim.cfg.tree_bucket_size,
        group_size=sim.cfg.walk_group_size), 5)
    steps = []
    for _ in range(5):
        n0 = sim.num_force_updates
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        steps.append(f"{sim.num_force_updates - n0} active "
                     f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    print(f"tree build [{card}]: {build_ms:.2f} ms (median of 5, CUDA "
          f"events); next steps (host clock): " + ", ".join(steps),
          flush=True)


def main_path(dev, card: str):
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    from ngravs_tpu_torch.ops.direct import direct_forces
    from ngravs_tpu_torch.ops.pairwise import (pairwise_eval,
                                               pairwise_eval_torch)
    run_dir = os.path.join(ROOT, "build", "chip_smoke_run")
    os.makedirs(run_dir, exist_ok=True)
    cfg = read_parameter_file(write_galaxy_collision(run_dir),
                              direct_crossover=1000, tree_depth=12)
    sim = Simulation(cfg, device=dev)
    if sim.p.n != 60000 or sim.solver.uses_direct(sim.p.n):
        raise AssertionError("the main path must walk the tree at 60k")

    pairwise_eval.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = sim.run(max_steps=MAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pairwise_eval.launches
    if launches <= 0:
        raise AssertionError("the main path launched K1a no time")
    if not bool(torch.isfinite(sim.p.accel).all()):
        raise AssertionError("non-finite forces on the main path")
    rate = sim.num_force_updates / wall
    print(f"main path [{card}]: {steps} steps to t={sim.time:.6g}, "
          f"{sim.num_force_updates} particle-steps in {wall:.2f} s = "
          f"{rate:.1f} particle-steps/s, K1a launches {launches}, tree "
          f"depth {sim.solver.depth}, walk caps {sim.solver.fcaps}; host "
          f"seconds by phase: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sim.cpu_timers.items()),
          flush=True)

    # one full tree force pass at the final state, against the direct
    # sweep; it keeps each K1a launch's inputs for the kernel check below
    launched = []

    def recording_eval(targets, sp, n_src, want_pot):
        launched.append((targets, sp, n_src, want_pot))
        return pairwise_eval(targets, sp, n_src, want_pot)

    solver = pass_solver(sim)
    acc_t, _ = full_force_pass(sim, solver, recording_eval)
    p = sim.p
    fsoft = torch.as_tensor(sim.force_soft, device=dev)[p.ptype.long()]
    acc_d, _ = direct_forces(sim.wiring, p.pos, p.mass, p.grav, fsoft,
                             chunk=1024, want_pot=False)
    acc_d = acc_d * sim.units.G
    rel = torch.linalg.norm(acc_t - acc_d, dim=1) \
        / torch.clamp(torch.linalg.norm(acc_d, dim=1), min=1e-12)
    rms = float(torch.sqrt(torch.mean(rel * rel)))
    ma = p.mass[:, None] * acc_t
    mom_rate = float(torch.linalg.norm(ma.sum(0)) / ma.abs().sum())
    if not bool(torch.isfinite(acc_t).all()):
        raise AssertionError("non-finite forces in the full pass")
    if not rms < 5e-3:
        raise AssertionError(f"tree vs direct rms error {rms}")
    if not mom_rate < 1e-3:
        raise AssertionError(f"momentum rate {mom_rate}")
    # kernel, twin, twin, kernel: compare within one call, in turns
    k1, tw1, tw2, k2 = (full_force_pass(sim, solver, pe)[1] for pe in
                        (pairwise_eval, pairwise_eval_torch,
                         pairwise_eval_torch, pairwise_eval))
    pass_s, twin_s = (k1 + k2) / 2, (tw1 + tw2) / 2
    print(f"force pass [{card}]: {p.n} targets, rms rel err vs direct "
          f"{rms:.3e} (max {float(rel.max()):.3e}), momentum rate "
          f"{mom_rate:.2e}; K1a pass {pass_s * 1e3:.1f} ms "
          f"({k1 * 1e3:.1f}, {k2 * 1e3:.1f}), twin pass "
          f"{twin_s * 1e3:.1f} ms ({tw1 * 1e3:.1f}, {tw2 * 1e3:.1f})",
          flush=True)
    profile_pass(sim, solver, card)
    sim.close()
    # the main path's own shapes and data: the batch with the most sources
    targets, sp, n_src, want_pot = max(launched,
                                       key=lambda a: int(a[2].sum()))
    report = check_kernel("kernel (main-path batch)", targets, sp, n_src,
                          (want_pot,))
    return launches, report[want_pot]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from ngravs_tpu_torch.ops import pairwise
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)

    t0 = time.perf_counter()
    pairwise.build_library(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    synthetic = check_kernel("kernel (synthetic)", *kernel_inputs(dev),
                             (False, True))
    launches, main_batch = main_path(dev, card)

    print(json.dumps({"kernels": [{
        "name": "K1a pairwise_newton",
        "route": "cuda",
        "source": "ngravs_tpu_torch/csrc/pairwise.cu",
        "replaces": "ngravs_tpu/ops/pairwise_pallas.py:53",
        "launches": launches,
        "max_abs_err": max([main_batch["max_abs_err"]]
                           + [k["max_abs_err"] for k in synthetic.values()]),
        "ms": main_batch["ms"],
        "plain_ms": main_batch["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
