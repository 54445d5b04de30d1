"""Drive the PyTorch port on one NVIDIA GPU and hold its kernel to its twin.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

 1. the card: `nvidia-smi` name and power limit, torch and CUDA versions;
    no CUDA device -> exit 1 with no result;
 2. build: nvcc compiles `ngravs_tpu_torch/csrc/pairwise.cu` (sm_90a) into
    `build/`; the host compiler builds the lattice-table generator;
 3. kernel: every K1 instance (`ops/pairwise.py:pairwise_eval`) against its
    plain twin `pairwise_eval_torch` on the card at the fused walk's shapes
    (B=128 blocks of G=64 targets, S=4096 source rows, ragged n_src, NaN
    garbage past n_src), potential on and off: K1a (one Newton law), K1b
    (newton_yukawa), K1bcd (newton_yukawa and three_species in a periodic
    TreePM box) and K1b+count (bam with the accumulator).  acc and pot
    within 1e-5 of each target's sum of |terms| (the two sum in different
    orders), pair counts equal, two launches bit-identical; the launch plan
    (`launch_plan`: lanes P, cluster C, tile, stages, shared memory),
    median times and the bound;
 4. slice 1, the open-box path: a synthetic GalaxyCollision-shaped IC (60k
    particles of types 1-5 as BASELINE.md counts them, two Plummer spheres
    on a collision orbit, disk -> gravity 1) written in format 1 with its
    parameterfile, run as `read_parameter_file(..., direct_crossover=1000,
    tree_depth=12)` -> `Simulation(cfg)` -> `run(max_steps=30)`; then one
    full tree force pass checked against the direct sweep on the card (rms
    relative error < 5e-3), for finite forces and for the momentum rate
    |sum m a| / sum |m a| < 1e-3, timed with the kernel and with the twin
    substituted, profiled; then K1a against the twin on the inputs of that
    pass's largest launch, with its n_src spread (max / mean) and pair
    rate;
 5. slice 2, the comoving periodic TreePM box: 2 x 64^3 particles on
    jittered lattices (examples/cosmological_box.py:53-69, its gas made a
    second collisionless species), Omega0 0.3, OmegaLambda 0.7, OmegaBaryon
    0.04, BoxSize 50000 kpc/h, PMGRID 128 with interlacing, newton_yukawa
    wiring, written as a format-1 IC and parameterfile and run as
    `read_parameter_file(..., pmgrid=128, n_gravs=2,
    wiring="newton_yukawa", pm_interlace=True)` -> `Simulation(cfg)` ->
    `run(max_steps=3)` with FORCETEST on 2,048 particles (2^-8 of them)
    on each PM step: K1 (the TreePM multi-law instance) and PM must run,
    forces finite, every step's FORCETEST rms relative error < 2.5e-2;
    then one full TreePM pass (PM + short-range walk)
    on every particle, checked on 2,048 sampled targets against the
    periodic direct sum with the Ewald lattice correction (rms relative
    error < 2.5e-2), timed with the kernel and with the twin, PM alone
    timed, profiled; then the run repeats bit for bit (the tree's moments
    and PM's mass assignment are fixed-order sums): two full force passes
    from one state, and three steps continued against the same three
    steps resumed from a restart file; the tree build and one CIC
    assignment timed in turns against the atomic `index_add_` they
    replaced; then K1 against the twin on that pass's largest launch, as
    for slice 1;
 6. slice 3, the gas box: the scheme of examples/cosmological_box.py:53-73
    at the box path's cosmology and width, 2 x 64^3 particles, type 0 gas
    (gravity 0, OmegaBaryon / Omega0 of the mass, IC u = 1 (km/s)^2)
    and type 1 dark matter (gravity 1) half a cell off, DesNumNgb 33 +- 3,
    run as `read_parameter_file(..., pmgrid=128, n_gravs=2,
    wiring="newton_yukawa", pm_interlace=True)` -> `Simulation(cfg)` and
    GAS_STEPS steps of `run(max_steps=1)`, each printed with its density
    iterations, candidate cap and gravity, hydro and PM seconds; K1 (the
    TreePM multi-law instance) must run.  Gates: the weighted neighbour
    count of 99.9 % of the gas within DesNumNgb +- MaxNumNgbDeviation, the
    median gas density within 5 % of the mean, the hydro momentum rate
    below 1e-3 on each axis, entropy finite and positive, every gas
    particle's signal velocity positive; the density and hydro passes of
    64 sampled target blocks on the card and on the CPU from one tree and
    state (candidate lists equal, sums within 1e-5 of each target's sum
    of |terms|, the terms being the pass's own one candidate at a time);
    `save_restart` and `resume` into a fresh `Simulation` give every array
    back bit for bit.  Then one step profiled (K1's, the density passes'
    and the hydro pass's shares of device time) and K1 against the twin
    on that step's largest launch;
 7. slice 4a, the periodic pure-tree (Ewald) box: slice 2's IC, cosmology,
    softening and newton_yukawa wiring without PMGRID, the geometric
    opening criterion (theta 0.5), `run(max_steps=3)` with FORCETEST on
    2,048 particles each step: K1 (the periodic multi-law instance, K1bc)
    must run beside the lattice pass; every step's FORCETEST rms relative
    error < 0.25 (the reference walk's error on this near-uniform IC; see
    RMS_EWALD), momentum rate < 1e-3; every
    K1 launch of a full pass within 1e-5 of its sum of |terms| of the
    twin; the pass for the targets of an eighth of the box profiled (the
    `lattice_pass` range's share of device time); K1 against the twin on
    its largest launch;
 8. slice 4b, the TreePM box with the tabulated transition: slice 2's box
    with the yukawa preset (a NoneLaw diagonal, so no closed form: every
    pair takes the tabulated evaluation and K1 is not launched), PMGRID
    128 interlaced, relative opening, `run(max_steps=3)` with FORCETEST on
    the PM steps: rms relative error < 3e-2 (tests/test_treepm.py:223),
    momentum rate < 1e-3; the run's largest tabulated evaluation on the
    card against the CPU within 1e-5 of each target's sum of |terms|.

The line before the last is the card's name and power limit, the one
before it a JSON object with every K1 instance's numbers; the last line is
{"ok": true, "device": {...}}.  Every time printed is from this run, on the
card named above it.
"""

from __future__ import annotations

import json
import math
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
MAIN_STEPS = 30                  # slice 1's path
# BASELINE.md:54 — GalaxyCollision.IC per-type counts (no gas)
NPART = (0, 10000, 20000, 10000, 10000, 10000)
# the box path
BOX_NSIDE = 64                   # 2 x 64^3 particles
BOX_SIZE = 50000.0               # kpc/h
BOX_PMGRID = 128
BOX_STEPS = 3
ORACLE_TARGETS = 2048
# the gas path
GAS_STEPS = 3
GAS_SAMPLE_BLOCKS = 64
DES_NGB, NGB_DEV = 33, 3
RMS_TREE, RMS_TREEPM = 5e-3, 2.5e-2
# FORCETEST: 2^-8 of 2 x 64^3 particles = 2,048 rows a step.  rms gates:
# the TreePM band of tests/test_treepm.py:223 for the tabulated box (the
# box path keeps RMS_TREEPM).  The Ewald box's is 0.25, not the 1e-2 of
# tests/test_lattice.py:100, whose particles are uniform random: on two
# jittered lattices the net force is small against each node's pull, and
# the geometric criterion at theta 0.5 leaves a relative error of 0.2 in
# the JAX walk and the port's alike
# (tests/test_torch_lattice_walk.py::test_ewald_error_on_a_jittered_
# lattice_is_the_references), while the walk without its lattice pass
# errs by more than 1
FORCETEST_FRAC = 2.0 ** -8
FORCETEST_ROWS = 2048
RMS_EWALD, RMS_TABULATED = 0.25, 3e-2
MOMENTUM_RATE = 1e-3
# the port's torch.profiler ranges (not kernels)
RANGES = ("sph_density", "sph_hydro", "lattice_pass")
# slices 4a (periodic pure tree, Ewald) and 4b (tabulated TreePM)
EWALD_STEPS = 3
TAB_STEPS = 3
# synthetic K1 instances: label -> (wiring, n_gravs, periodic, TreePM,
# accumulator); the synthetic box is SYN_BOX wide, TreePM at PMGRID 32
SYN_BOX = 100.0
K1_CASES = {
    "newton_yukawa": ("newton_yukawa", 2, False, False, False),
    "newton_yukawa periodic TreePM": ("newton_yukawa", 2, True, True, False),
    "three_species periodic TreePM": ("three_species", 3, True, True, False),
    "bam accumulator": ("bam", 2, False, False, True),
}
# the card's peaks: dense fp32 rate and memory rate, H100 SXM at 700 W
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# operations per valid pair, counted from csrc/pairwise.cu on the r >= h
# branch: each add, multiply, divide, sqrt, exp, atan, rint, min, max and
# compare one, an FMA two.  BASE: displacement, r^2, sqrt, h, the branch
# and the three accumulations; PERIODIC: three minimum images; LAW[kind]:
# (force, potential) of the law without TreePM; TPM_U: u and the cut;
# TPM[kind]: (sf, sp) of the closed-form truncation for pairs with u < 3.
OPS_BASE, OPS_PERIODIC, OPS_TPM_U = 17, 12, 2
OPS_LAW = {0: (0, 0), 1: (6, 5), 2: (6, 5), 3: (13, 5), 4: (18, 8),
           5: (30, 15), 6: (30, 15), 7: (30, 15)}
OPS_TPM = {1: (23, 17), 3: (67, 22), 4: (104, 49)}


T_START = time.perf_counter()


def stamp(what: str):
    """The seconds since the script started, after `what`."""
    print(f"elapsed {time.perf_counter() - T_START:.0f} s: {what}",
          flush=True)


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

def case_wiring(case: str):
    """The wiring and the pair-evaluation keywords of a synthetic case."""
    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.models.wiring import build_wiring
    name, ng, periodic, treepm, acc = K1_CASES[case]
    cfg = SimulationConfig(n_gravs=ng, type_to_grav=(0, 0, 1, 0, 0, 0),
                           wiring=name, box_size=SYN_BOX, periodic=periodic,
                           pmgrid=32 if treepm else 0, ngravs_accumulator=acc)
    w = build_wiring(cfg)
    return w, dict(wiring=w, box_size=SYN_BOX if periodic else 0.0,
                   accumulator=acc,
                   treepm_asmth=1.25 * SYN_BOX / 32 if treepm else 0.0)


def kernel_inputs(dev, seed: int = 0, n_gravs: int = 1, box: float = 0.0,
                  count: bool = False):
    """Walk-shaped pair-kernel inputs: per block G targets in a small cell,
    sources that are particles of the block (self pairs), other particles,
    node rows (gid -2) and padding (gid -1), with softening lengths that
    put pairs on both sides of r = h; rows past n_src hold garbage the
    kernel must not read.  In a box (`box` > 0) the sources spread over a
    fifth of it and wrap, so minimum images and the TreePM cut both occur;
    `n_gravs` > 1 draws gravities, `count` node counts 1-8."""
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
    sp[:, 3] = rng.uniform(0.5, 2.0, (B, S))
    sp[:, 4] = rng.uniform(0.1, 1.0, (B, S))
    sp[:, 5] = 1.0
    sgrav = np.zeros((B, S), np.int32)
    tgrav = np.zeros((B, G), np.int32)
    if box > 0:
        centre = rng.uniform(0, box, (B, 1, 3))
        tpos = np.mod(centre + rng.normal(0, 0.5, (B, G, 3)), box) \
            .astype(np.float32)
        spos = np.mod(centre + rng.normal(0, 0.2 * box, (B, S, 3)), box) \
            .astype(np.float32)
    if n_gravs > 1:
        sgrav = rng.integers(0, n_gravs, (B, S)).astype(np.int32)
        tgrav = rng.integers(0, n_gravs, (B, G)).astype(np.int32)
    if count:
        sp[:, 5] = np.where(sgid == -2, rng.integers(1, 9, (B, S)), 1)
    sp[:, 0:3] = spos.transpose(0, 2, 1)
    sp[:, 6] = sgrav.view(np.float32)
    sp[:, 7] = sgid.view(np.float32)
    sp[:, 0][~live] = np.nan                 # garbage past n_src
    col = lambda a, dt=np.float32: torch.as_tensor(
        np.ascontiguousarray(a, dt).reshape(B * G, 1), device=dev)
    targets = dict(x=col(tpos[..., 0]), y=col(tpos[..., 1]),
                   z=col(tpos[..., 2]), mass=col(rng.uniform(0.5, 2, (B, G))),
                   grav=col(tgrav, np.int32),
                   fsoft=col(rng.uniform(0.1, 1.0, (B, G))),
                   gid=col(tgid, np.int32))
    return (targets, torch.as_tensor(sp, device=dev),
            torch.as_tensor(n_src.reshape(B, 1), device=dev))


def term_scales(targets, sp, n_src, wiring=None, box_size=0.0,
                accumulator=None, treepm_asmth=0.0):
    """Per target: the sums over valid pairs of |fac*dx|, |fac*dy|,
    |fac*dz| and |pot term| (the scale of each sum, for the tolerance).
    Also the operations the kernel needs on these inputs (potential off,
    on), from the OPS tables: each valid pair by its law and, under TreePM,
    by whether it lies inside the cut."""
    from ngravs_tpu_torch.models.laws import Newtonian
    from ngravs_tpu_torch.ops.pairwise import (FCOUNT, FMASS, FSOFT, FX, FY,
                                               FZ, IGID, IGRAV, law_entry,
                                               law_factors)
    groups = wiring.unique_laws() if wiring is not None \
        else [(Newtonian(), [(0, 0)])]
    use_count = (wiring is not None and wiring.accumulator) \
        if accumulator is None else accumulator
    inv2a = 0.5 / treepm_asmth if treepm_asmth > 0 else 0.0
    nb, _, s = sp.shape
    g = targets["x"].shape[0] // nb
    col = lambda k: targets[k].reshape(nb, g, 1)
    out = torch.zeros(nb * g, 4, device=sp.device)
    ops = [0.0, 0.0]
    for c0 in range(0, s, 512):
        cs = slice(c0, c0 + 512)
        sgid = sp[:, IGID, cs].view(torch.int32)[:, None, :]
        live = (torch.arange(c0, min(c0 + 512, s),
                             device=sp.device)[None, None, :]
                < n_src.reshape(nb, 1, 1))
        valid = live & (sgid != -1) & (sgid != col("gid")) & (col("gid") >= 0)
        d = [sp[:, None, a, cs] - col(k) for a, k in ((FX, "x"), (FY, "y"),
                                                     (FZ, "z"))]
        if box_size > 0:
            d = [x - box_size * torch.round(x * (1.0 / box_size)) for x in d]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        r = torch.sqrt(r2)
        h = torch.maximum(col("fsoft"), sp[:, None, FSOFT, cs])
        sm = sp[:, None, FMASS, cs]
        n = sp[:, None, FCOUNT, cs] if use_count else 1.0
        sg = sp[:, IGRAV, cs].view(torch.int32)[:, None, :]
        fac = torch.zeros_like(r)
        pot = torch.zeros_like(r)
        base = float(valid.sum()) * (
            OPS_BASE + (OPS_PERIODIC if box_size > 0 else 0)
            + (OPS_TPM_U if inv2a else 0))
        ops = [ops[0] + base, ops[1] + base]
        for law, slots in groups:
            mk = torch.zeros_like(valid)
            for i, j in slots:
                mk = mk | ((col("grav") == i) & (sg == j))
            f, p = law_factors(law, col("mass"), sm, r2, r, h, n, True, inv2a)
            fac, pot = torch.where(mk, f, fac), torch.where(mk, p, pot)
            kind = law_entry(law)[0]
            lf, lp = OPS_LAW[kind]
            npair = float((mk & valid).sum())
            if inv2a:
                npair = float((mk & valid & (r * inv2a < 3.0)).sum())
                tf, tp = OPS_TPM.get(kind, (0, 0))
                lf, lp = lf + tf, lp + tp
            ops[0] += npair * lf
            ops[1] += npair * (lf + lp)
        out += torch.stack(
            [torch.where(valid, (fac * x).abs(), 0.).sum(-1) for x in d]
            + [torch.where(valid, pot.abs(), 0.).sum(-1)],
            dim=-1).reshape(nb * g, 4)
    return out, ops


def kernel_bound(targets, sp, n_src, flags, ops: float):
    """(bound_ms, bound_by): the larger of the operations over the FP32
    peak and the bytes the call must move over the memory rate (targets
    and live source rows read once, outputs written once)."""
    from ngravs_tpu_torch.ops.pairwise import F_COUNT, F_MULTI, F_POT
    bg = targets["x"].shape[0]
    rows = 6 + (1 if flags & F_MULTI else 0) + (1 if flags & F_COUNT else 0)
    nbytes = (7 * 4 * bg + 4 * rows * float(n_src.sum()) + 4 * n_src.numel()
              + bg * (12 + 4 + (4 if flags & F_POT else 0)))
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def same_bits(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def check_kernel(label: str, targets, sp, n_src, modes, kw=None):
    """K1 against its twin on the same inputs, for each want_pot in
    `modes`: acc and pot within RTOL_TERMS of each target's sum of |terms|,
    pair counts equal, a second launch bit-identical to the first; median
    times, the bound and the launch plan.  `kw`: the pair evaluation's
    wiring keywords.  Returns {want_pot: numbers}."""
    from ngravs_tpu_torch.ops.pairwise import (instance_flags, instance_name,
                                               launch_plan, pairwise_eval,
                                               pairwise_eval_torch)
    kw = kw or {}
    scale, ops = term_scales(targets, sp, n_src, **kw)
    report = {}
    for want_pot in modes:
        flags = instance_flags(want_pot=want_pot, **kw)
        name = instance_name(flags)
        plan = launch_plan(targets["x"].shape[0] // sp.shape[0], sp.shape[2],
                           flags)
        acc, pot, nia = pairwise_eval(targets, sp, n_src, want_pot, **kw)
        again = pairwise_eval(targets, sp, n_src, want_pot, **kw)
        torch.cuda.synchronize()
        if not same_bits((acc, pot, nia), again):
            raise AssertionError(f"{label}: {name} gave other bits on a "
                                 "second launch")
        acc_t, pot_t, nia_t = pairwise_eval_torch(targets, sp, n_src,
                                                  want_pot, **kw)
        if not (torch.isfinite(acc).all() and torch.isfinite(pot).all()):
            raise AssertionError(f"{label}: {name} returned non-finite "
                                 "values")
        err_a = (acc - acc_t).abs()
        if bool((err_a > RTOL_TERMS * scale[:, :3]).any()):
            raise AssertionError(f"{label}: {name} acc off by "
                                 f"{float(err_a.max())}")
        err_p = (pot - pot_t).abs()
        if want_pot and bool((err_p > RTOL_TERMS * scale[:, 3]).any()):
            raise AssertionError(f"{label}: {name} pot off by "
                                 f"{float(err_p.max())}")
        if not torch.equal(nia, nia_t):
            raise AssertionError(f"{label}: {name} pair counts differ from "
                                 "the twin")
        ms = cuda_ms(lambda: pairwise_eval(targets, sp, n_src, want_pot,
                                           **kw), 20)
        plain_ms = cuda_ms(lambda: pairwise_eval_torch(targets, sp, n_src,
                                                       want_pot, **kw), 5)
        pairs = int(torch.sum(nia_t))
        bound_ms, bound_by = kernel_bound(targets, sp, n_src, flags,
                                          ops[1 if want_pot else 0])
        report[want_pot] = dict(name=name, max_abs_err=float(err_a.max()),
                                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, plan=plan._asdict())
        print(f"{label}: {name} {tuple(sp.shape)} plan P={plan.lanes} "
              f"C={plan.cluster} tile={plan.tile} stages={plan.stages} "
              f"smem={plan.smem} B: bit-identical twice, max|dacc|="
              f"{float(err_a.max()):.3g} (max|acc| "
              f"{float(acc_t.abs().max()):.4g}) max|dpot|="
              f"{float(err_p.max()):.3g} pairs={pairs} kernel {ms:.3f} ms "
              f"({pairs / ms / 1e6:.3f} Gpair/s), twin {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} "
              f"({ops[1 if want_pot else 0] / pairs:.1f} ops a pair)",
              flush=True)
    return report


def record_launches(pairwise_eval, launched):
    """A pair evaluation that keeps each launch's inputs in `launched`."""
    def recording_eval(targets, sp, n_src, want_pot, **kw):
        launched.append((targets, sp, n_src, want_pot, kw))
        return pairwise_eval(targets, sp, n_src, want_pot, **kw)
    return recording_eval


def largest_launch(launched):
    """The recorded launch (targets, sp, n_src, want_pot, kw) with the most
    sources."""
    return max(launched, key=lambda a: int(a[2].sum()))


def check_largest_launch(label: str, launched):
    """K1 against the twin on the inputs of the launch with the most
    sources (a path's own shapes and data), with its n_src spread."""
    targets, sp, n_src, want_pot, kw = largest_launch(launched)
    ns = n_src.double()
    print(f"{label}: largest of {len(launched)} launches, {sp.shape[0]} "
          f"blocks, n_src max {int(ns.max())} / mean {float(ns.mean()):.1f}"
          f" = spread {float(ns.max() / ns.mean()):.2f}", flush=True)
    return check_kernel(label, targets, sp, n_src, (want_pot,),
                        kw)[want_pot]


# --------------------------------------------------------------------------
# shared by both paths
# --------------------------------------------------------------------------

def write_param(path: str, params: dict) -> str:
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
                           hubble=sim.units.hubble, device=sim.device)
    solver.compute(all_active(sim), sim.ti_current, sim.p.n)
    return solver


def full_force_pass(sim, solver, pair_eval):
    """One tree force pass (build + walk + scatter) on every particle at the
    current state with `pair_eval` as the walk's pair evaluation; returns
    (G-scaled accelerations, seconds).  Under TreePM it is the short-range
    part."""
    solver.pair_eval = pair_eval
    p_all = all_active(sim)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2, _, _ = solver.compute(p_all, sim.ti_current, sim.p.n)
    torch.cuda.synchronize()
    return p2.accel, time.perf_counter() - t0


def timed_passes(sim, solver, card: str, label: str):
    """kernel, twin, twin, kernel: the two compared within one call, in
    turns.  Returns the kernel pass's mean seconds."""
    from ngravs_tpu_torch.ops.pairwise import (pairwise_eval,
                                               pairwise_eval_torch)
    k1, tw1, tw2, k2 = (full_force_pass(sim, solver, pe)[1] for pe in
                        (pairwise_eval, pairwise_eval_torch,
                         pairwise_eval_torch, pairwise_eval))
    print(f"{label} [{card}]: kernel pass {(k1 + k2) / 2 * 1e3:.1f} ms "
          f"({k1 * 1e3:.1f}, {k2 * 1e3:.1f}), twin pass "
          f"{(tw1 + tw2) / 2 * 1e3:.1f} ms ({tw1 * 1e3:.1f}, "
          f"{tw2 * 1e3:.1f})", flush=True)
    solver.pair_eval = pairwise_eval
    return (k1 + k2) / 2


def profile_pass(sim, solver, card: str, label: str, with_pm: bool = False,
                 ranges=(), slab: float = 1.0):
    """Where a force pass's time goes: one full pass (and, `with_pm`, the
    PM forces) under torch.profiler: CUDA kernel count and device time,
    K1's share, and the device time under each named range of `ranges`.
    `slab` < 1 makes the targets only the particles with x below that
    fraction of the box (fewer blocks: the profiler's own processing of a
    300k-kernel pass takes minutes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ngravs_tpu_torch.ops.pairwise import pairwise_eval
    solver.pair_eval = pairwise_eval
    p_all = all_active(sim)
    if slab < 1:
        p_all = p_all.replace(ti_endstep=torch.where(
            sim.p.pos[:, 0] < slab * sim.cfg.box_size, p_all.ti_endstep,
            p_all.ti_endstep + 1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.compute(p_all, sim.ti_current, sim.p.n)
        if with_pm:
            solver.pm_forces(sim.p)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # kernels only: a record_function range has a device-side event too
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in RANGES]
    k1 = [e for e in kern if "pairwise_kernel" in e.key]
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    k1_ms = sum(dev_us(e) for e in k1) / 1e3
    shares = "".join(
        f"; {k} " + (f"{v:.2f} ms ({v / busy_ms:.1%} of device time)"
                     if v > 0 else "not measured (no device time under it)")
        for k, v in ((k, range_ms(prof, k)) for k in ranges))
    if busy_ms > 0:
        print(f"{label} [{card}]: {wall_ms:.1f} ms wall (profiler on), "
              f"{sum(e.count for e in kern)} CUDA kernels, device busy "
              f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.1%} of the wall); "
              f"K1 {sum(e.count for e in k1)} launches, {k1_ms:.2f} ms "
              f"({k1_ms / busy_ms:.1%} of device time){shares}", flush=True)
    else:
        print(f"{label} [{card}]: {wall_ms:.1f} ms wall; device time not "
              "measured (the profiler recorded none)", flush=True)


def range_ms(prof, name: str) -> float:
    """Device time of the kernels launched under the torch.profiler range
    `name`, from the host-side range events (key_averages merges them
    with the range's own device-side span, which would count it twice)."""
    from torch.autograd import DeviceType
    return sum(getattr(e, "device_time_total", 0.0) for e in prof.events()
               if e.name == name and e.device_type == DeviceType.CPU) / 1e3


def run_path(sim, steps: int):
    """Drive `sim.run` with every K1 count set to 0 just before; returns
    (steps, wall seconds, {instance: launches})."""
    from ngravs_tpu_torch.ops import pairwise
    pairwise.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sim.run(max_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return n, wall, dict(pairwise.pairwise_eval.counts)


def forcetest_steps(path: str):
    """forcetest.txt rows by step: [(ti, rows, rms, max)] of the relative
    error |a_tree - a_direct| / |a_direct| (columns of
    gravtree_forcetest.c:294-312, printed with six digits)."""
    rows = np.loadtxt(path, ndmin=2)
    if rows.shape[1] != 12:
        raise AssertionError(f"forcetest.txt rows have {rows.shape[1]} "
                             "columns, not 12")
    out = []
    for ti in np.unique(rows[:, 1]):
        r = rows[rows[:, 1] == ti]
        d = np.linalg.norm(r[:, 5:8], axis=1)
        rel = np.linalg.norm(r[:, 8:11] - r[:, 5:8], axis=1) \
            / np.maximum(d, 1e-300)
        out.append((int(ti), len(r), float(np.sqrt(np.mean(rel ** 2))),
                    float(rel.max())))
    return out


def check_forcetest(label: str, path: str, card: str, rms_gate: float,
                    min_steps: int, max_steps: int):
    """Every step's FORCETEST rows: at least FORCETEST_ROWS, rms within
    `rms_gate`, on min_steps to max_steps steps."""
    per = forcetest_steps(path)
    print(f"{label} FORCETEST [{card}]: " + "; ".join(
        f"ti {ti}: {n} rows, rms rel err {rms:.3e} (max {mx:.3e})"
        for ti, n, rms, mx in per), flush=True)
    if not min_steps <= len(per) <= max_steps:
        raise AssertionError(f"{label}: FORCETEST ran on {len(per)} steps, "
                             f"not {min_steps}-{max_steps}")
    for ti, n, rms, _ in per:
        if n < FORCETEST_ROWS or not rms <= rms_gate:
            raise AssertionError(f"{label}: FORCETEST at ti {ti}: {n} rows, "
                                 f"rms {rms} (gate {rms_gate})")


def momentum_rate(mass, acc) -> float:
    ma = mass[:, None] * acc
    return float(torch.linalg.norm(ma.sum(0)) / ma.abs().sum())


def check_every_launch(label: str, launched):
    """Each recorded K1 launch against the twin on its own inputs: acc and
    pot within RTOL_TERMS of each target's sum of |terms|, pair counts
    equal.  Returns the largest |acc| difference."""
    from ngravs_tpu_torch.ops.pairwise import (instance_name, instance_flags,
                                               pairwise_eval,
                                               pairwise_eval_torch)
    worst = 0.0
    names = set()
    for targets, sp, n_src, want_pot, kw in launched:
        scale, _ = term_scales(targets, sp, n_src, **kw)
        acc, pot, nia = pairwise_eval(targets, sp, n_src, want_pot, **kw)
        acc_t, pot_t, nia_t = pairwise_eval_torch(targets, sp, n_src,
                                                  want_pot, **kw)
        err = (acc - acc_t).abs()
        bad = bool((err > RTOL_TERMS * scale[:, :3]).any()) or (
            want_pot and bool(((pot - pot_t).abs()
                               > RTOL_TERMS * scale[:, 3]).any()))
        if bad or not torch.equal(nia, nia_t):
            raise AssertionError(f"{label}: a K1 launch disagrees with the "
                                 "twin")
        worst = max(worst, float(err.max()))
        names.add(instance_name(instance_flags(want_pot=want_pot, **kw)))
    print(f"{label}: all {len(launched)} K1 launches "
          f"({', '.join(sorted(names))}) within {RTOL_TERMS:g} of their "
          f"sums of |terms| of the twin, pair counts equal, max|dacc| "
          f"{worst:.3g}", flush=True)
    return worst


# --------------------------------------------------------------------------
# phase 4: slice 1, the open-box GalaxyCollision path
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
    return write_param(os.path.join(run_dir, "galaxy_collision.param"), {
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
    })


def galaxy_path(dev, card: str):
    """Slice 1's path; its K1 launch count and the inputs of every launch
    of its final full pass."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    from ngravs_tpu_torch.ops.direct import direct_forces
    from ngravs_tpu_torch.ops.pairwise import pairwise_eval
    run_dir = os.path.join(ROOT, "build", "chip_smoke_run")
    os.makedirs(run_dir, exist_ok=True)
    cfg = read_parameter_file(write_galaxy_collision(run_dir),
                              direct_crossover=1000, tree_depth=12)
    sim = Simulation(cfg, device=dev)
    if sim.p.n != sum(NPART) or sim.solver.uses_direct(sim.p.n):
        raise AssertionError("the main path must walk the tree at 60k")

    steps, wall, counts = run_path(sim, MAIN_STEPS)
    launches = sum(counts.values())
    if counts.get("K1a", 0) <= 0:
        raise AssertionError(f"slice 1's path launched K1a no time: {counts}")
    if not bool(torch.isfinite(sim.p.accel).all()):
        raise AssertionError("non-finite forces on the main path")
    rate = sim.num_force_updates / wall
    print(f"main path [{card}]: {steps} steps to t={sim.time:.6g}, "
          f"{sim.num_force_updates} particle-steps in {wall:.2f} s = "
          f"{rate:.1f} particle-steps/s, K1 launches {counts}, tree "
          f"depth {sim.solver.depth}, walk caps {sim.solver.fcaps}; host "
          f"seconds by phase: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sim.cpu_timers.items()),
          flush=True)

    # one full tree force pass at the final state, against the direct
    # sweep; it keeps each launch's inputs for the kernel check below
    launched = []
    solver = pass_solver(sim)
    acc_t, _ = full_force_pass(sim, solver,
                               record_launches(pairwise_eval, launched))
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
    if not rms < RMS_TREE:
        raise AssertionError(f"tree vs direct rms error {rms}")
    if not mom_rate < 1e-3:
        raise AssertionError(f"momentum rate {mom_rate}")
    print(f"force pass [{card}]: {p.n} targets, rms rel err vs direct "
          f"{rms:.3e} (max {float(rel.max()):.3e}), momentum rate "
          f"{mom_rate:.2e}", flush=True)
    timed_passes(sim, solver, card, "force pass")
    profile_pass(sim, solver, card, "profiled pass")
    sim.close()
    return launches, launched


# --------------------------------------------------------------------------
# phase 5: slice 2, the comoving periodic TreePM box
# --------------------------------------------------------------------------

def write_cosmo_box(run_dir: str, seed: int = 42) -> str:
    """2 x BOX_NSIDE^3 particles on jittered lattices (jitter 2% of the
    spacing; examples/cosmological_box.py:53-69): species A (type 1, halo,
    gravity 0) carries (Omega0 - OmegaBaryon) / Omega0 of the box mass,
    species B (type 2, disk, gravity 1) the rest and sits half a cell off.
    Masses match Omega0 (check_omega); file velocities are Gadget's
    (internal = file * a^1.5).  Returns the parameterfile path."""
    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.io.gadget_format import (SnapshotData,
                                                   SnapshotHeader,
                                                   write_snapshot)
    from ngravs_tpu_torch.units import set_units
    omega0, omega_b, box, ns = 0.3, 0.04, BOX_SIZE, BOX_NSIDE
    units = set_units(SimulationConfig(comoving_integration=True))
    rng = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(*[np.arange(ns)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / ns * box
    n = len(g)
    a = np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape), box)
    b = np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape)
               + 0.5 * box / ns, box)
    m_tot = omega0 * 3 * units.hubble ** 2 / (8 * math.pi * units.G) \
        * box ** 3
    m_a = (omega0 - omega_b) / omega0 * m_tot / n
    m_b = omega_b / omega0 * m_tot / n
    h = SnapshotHeader()
    h.npart = np.array([0, n, n, 0, 0, 0], np.int32)
    h.npart_total = h.npart.astype(np.uint32)
    h.mass = np.array([0.0, m_a, m_b, 0.0, 0.0, 0.0])
    h.time, h.redshift, h.box_size = 0.1, 9.0, box
    h.omega0, h.omega_lambda, h.hubble_param = omega0, 0.7, 0.7
    ic = os.path.join(run_dir, "cosmo_box.IC")
    write_snapshot(ic, SnapshotData(
        header=h, pos=np.concatenate([a, b]).astype(np.float32),
        vel=rng.normal(0, 1.0, (2 * n, 3)).astype(np.float32),
        pid=np.arange(1, 2 * n + 1, dtype=np.uint32),
        mass=np.repeat(np.array([m_a, m_b], np.float32), n),
        ptype=np.repeat(np.array([1, 2], np.int32), n)))
    soft = box / ns / 30
    return write_param(os.path.join(run_dir, "cosmo_box.param"), {
        "InitCondFile": ic, "OutputDir": run_dir,
        "SnapshotFileBase": "snapshot", "ICFormat": 1, "SnapFormat": 1,
        "ComovingIntegrationOn": 1, "PeriodicBoundariesOn": 1,
        "Omega0": omega0, "OmegaLambda": 0.7, "OmegaBaryon": omega_b,
        "HubbleParam": 0.7, "BoxSize": box,
        "TimeBegin": 0.1, "TimeMax": 1.0, "TimeBetSnapshot": 0.5,
        "TimeOfFirstSnapshot": 0.5, "TimeBetStatistics": 0.05,
        "ErrTolIntAccuracy": 0.025, "MaxSizeTimestep": 0.02,
        "ErrTolTheta": 0.5, "TypeOfOpeningCriterion": 1,
        "ErrTolForceAcc": 0.005, "TreeDomainUpdateFrequency": 0.1,
        "SofteningHalo": soft, "SofteningDisk": soft,
        "GravityGas": 0, "GravityHalo": 0, "GravityDisk": 1,
        "GravityBulge": 0, "GravityStars": 0, "GravityBndry": 0,
    })


def box_path(dev, card: str):
    """Slice 2's path; its K1 launch count and the inputs of every launch
    of its final short-range pass."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    from ngravs_tpu_torch.ops import lattice
    from ngravs_tpu_torch.ops.direct import direct_forces
    from ngravs_tpu_torch.ops.pairwise import pairwise_eval
    from ngravs_tpu_torch.ops.pm import PMSolver
    run_dir = os.path.join(ROOT, "build", "chip_smoke_box")
    os.makedirs(run_dir, exist_ok=True)
    # Gadget's plain CIC mesh aliases on a near-uniform lattice; the
    # interlaced mesh halves that error (printed below for both)
    cfg = read_parameter_file(write_cosmo_box(run_dir), pmgrid=BOX_PMGRID,
                              n_gravs=2, wiring="newton_yukawa",
                              pm_interlace=True, force_test=FORCETEST_FRAC)
    ft_path = os.path.join(run_dir, "forcetest.txt")
    if os.path.exists(ft_path):
        os.remove(ft_path)
    lattice.last_generator = None
    t0 = time.perf_counter()
    sim = Simulation(cfg, device=dev)
    init_s = time.perf_counter() - t0
    tables_by = lattice.last_generator or "from the cache"
    n = sim.p.n
    if n != 2 * BOX_NSIDE ** 3 or sim.solver.treepm is None \
            or sim.solver.uses_direct(n):
        raise AssertionError("the box path must run TreePM at 2 x 64^3")

    steps, wall, counts = run_path(sim, BOX_STEPS)
    launches = sum(counts.values())
    k1bcd = sum(v for k, v in counts.items() if k.startswith("K1bcd"))
    if k1bcd <= 0:
        raise AssertionError(f"the box path never launched the TreePM "
                             f"multi-law K1 instance: {counts}")
    p = sim.p
    if not (bool(p.accel_pm.abs().max() > 0) and sim.pm_ti_endstep > 0):
        raise AssertionError("PM never ran on the box path")
    for k in ("pos", "vel", "accel", "accel_pm"):
        if not bool(torch.isfinite(getattr(p, k)).all()):
            raise AssertionError(f"non-finite {k} on the box path")
    print(f"box path [{card}]: {steps} steps to a={sim.time:.6g}, "
          f"{sim.num_force_updates} particle-steps in {wall:.2f} s = "
          f"{sim.num_force_updates / wall:.1f} particle-steps/s, K1 "
          f"launches {counts}, PM window ({sim.pm_ti_begstep}, "
          f"{sim.pm_ti_endstep}), tree depth {sim.solver.depth}, walk caps "
          f"{sim.solver.fcaps}, set-up {init_s:.1f} s (FORCETEST's lattice "
          f"tables EN={cfg.ngravs_en} {tables_by}); host seconds by phase: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sim.cpu_timers.items()),
          flush=True)
    # FORCETEST runs on the PM steps (gravtree_forcetest.c:46-49)
    check_forcetest("box path", ft_path, card, RMS_TREEPM, 1, steps)
    stamp("box path run")

    # one full TreePM pass at the final state: the short-range walk and PM
    # on every particle, against the periodic direct sum with the lattice
    # correction on sampled targets
    launched = []
    solver = pass_solver(sim)
    acc_sr, _ = full_force_pass(sim, solver,
                                record_launches(pairwise_eval, launched))
    acc_pm = solver.pm_forces(p)
    tot = acc_sr + acc_pm
    if not bool(torch.isfinite(tot).all()):
        raise AssertionError("non-finite forces in the full TreePM pass")
    t0 = time.perf_counter()
    tabs = lattice.build_lattice_tables(sim.wiring, cfg.ngravs_en,
                                        cfg.box_size, device=dev)
    tab_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    idx = torch.as_tensor(np.sort(rng.choice(n, ORACLE_TARGETS,
                                             replace=False)).astype(np.int32),
                          device=dev)
    fsoft = torch.as_tensor(sim.force_soft, device=dev)[p.ptype.long()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc_d, _ = direct_forces(sim.wiring, p.pos, p.mass, p.grav, fsoft,
                             tgt_idx=idx, box=cfg.box_size, chunk=32,
                             want_pot=False, lattice_tables=tabs)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    acc_d = acc_d * sim.units.G
    norm_d = torch.clamp(torch.linalg.norm(acc_d, dim=1), min=1e-30)

    def rel_err(acc):
        rel = torch.linalg.norm(acc[idx.long()] - acc_d, dim=1) / norm_d
        return float(torch.sqrt(torch.mean(rel * rel))), float(rel.max())

    rms, mx = rel_err(tot)
    plain_pm = PMSolver(sim.wiring, cfg.pmgrid, cfg.box_size, cfg.n_gravs,
                        sim.units.G, asmth_cells=cfg.asmth,
                        gradient=cfg.pm_gradient, interlace=False,
                        device=dev)
    rms_plain, _ = rel_err(acc_sr + plain_pm.forces(p.pos, p.mass, p.grav))
    rms_sr, _ = rel_err(acc_sr)
    ma = p.mass[:, None] * tot
    mom_rate = float(torch.linalg.norm(ma.sum(0)) / ma.abs().sum())
    print(f"TreePM pass [{card}]: {ORACLE_TARGETS} sampled targets vs the "
          f"periodic direct sum with the lattice correction (tables "
          f"EN={cfg.ngravs_en}, {lattice.last_generator or 'cached'}, "
          f"{tab_s:.1f} s; oracle {oracle_s:.1f} s): rms rel err {rms:.3e} "
          f"(max {mx:.3e}); without interlacing {rms_plain:.3e}; short "
          f"range alone {rms_sr:.3e}; momentum rate {mom_rate:.2e} (not "
          "gated)", flush=True)
    if not rms < RMS_TREEPM:
        raise AssertionError(f"TreePM vs Ewald direct rms error {rms}")
    stamp("box path TreePM pass against the Ewald sum")
    pass_s = timed_passes(sim, solver, card, "TreePM short-range pass")
    pm_ms = cuda_ms(lambda: solver.pm_forces(p), 5)
    print(f"PM forces [{card}]: {pm_ms:.2f} ms (median of 5, CUDA events, "
          f"PMGRID {cfg.pmgrid}, interlaced, 2 source gravities); full "
          f"TreePM pass about {pass_s * 1e3 + pm_ms:.1f} ms", flush=True)
    profile_pass(sim, solver, card, "profiled TreePM pass", with_pm=True)
    stamp("box path timed and profiled passes")
    check_reproducible(sim, solver, cfg, dev, card, run_dir)
    return launches, launched


def check_reproducible(sim, solver, cfg, dev, card: str, run_dir: str):
    """Runs on the card repeat bit for bit (the tree's moments and PM's
    mass assignment are fixed-order sums): two full force passes (tree
    build, walk, PM) from one state; two three-step runs from one state,
    the run continued and the same steps resumed from a restart file
    written at that state.  Then the tree build and one CIC assignment
    timed in turns with the fixed-order sums and with the plain atomic
    `index_add_` they replaced."""
    from ngravs_tpu_torch.integrate.runner import Simulation
    from ngravs_tpu_torch.ops import pm as tpm
    from ngravs_tpu_torch.ops import tree as ttree
    from ngravs_tpu_torch.ops.pairwise import pairwise_eval
    bits = lambda t: t.contiguous().view(torch.int32)
    same = lambda a, b: torch.equal(bits(a), bits(b))
    p = sim.p
    passes = []
    for _ in range(2):
        acc, _ = full_force_pass(sim, solver, pairwise_eval)
        passes.append((acc, solver.pm_forces(p)))
    if not (same(passes[0][0], passes[1][0])
            and same(passes[0][1], passes[1][1])):
        raise AssertionError("two force passes from one state differ")

    # the continued run and two resumed ones; FORCETEST is off for these
    # steps (it reads the state and changes none of it)
    path = sim.save_restart(os.path.join(run_dir, "box_restart.npz"))
    quiet = cfg.replace(force_test=0.0)
    sim.cfg = quiet
    fresh = Simulation(quiet, device=dev, log_dir="")
    fresh.resume(path)
    runs = [sim, fresh]
    t0 = time.perf_counter()
    for r in runs:
        r.run(max_steps=3)
    torch.cuda.synchronize()
    fields = ("pos", "vel", "accel", "accel_pm", "old_acc", "ti_endstep")
    if fresh.ti_current != sim.ti_current or not all(
            same(getattr(fresh.p, f), getattr(sim.p, f)) for f in fields):
        raise AssertionError("the resumed run differs from the continued "
                             "run")
    print(f"reproducible [{card}]: two full force passes (tree build, walk, "
          f"PM) bit-identical; 3 steps continued and the same 3 resumed "
          f"from the restart file: every array bit-identical ({fields}; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    # the fixed-order sums against the atomic index_add_, in turns
    plain = lambda out, idx, src: out.index_add_(0, idx, src)
    fixed = ttree.fixed_order_index_add
    fsoft = torch.as_tensor(sim.force_soft, device=dev)[p.ptype.long()]
    build = lambda: ttree.build_tree(
        p.pos, p.mass, p.grav, fsoft, p.old_acc, depth=solver.depth,
        n_gravs=cfg.n_gravs, bucket=cfg.tree_bucket_size,
        box_size=cfg.box_size, group_size=cfg.walk_group_size, vel=p.vel)
    cic = lambda: tpm.cic_assign(p.pos, p.mass, cfg.pmgrid, cfg.box_size)
    times = {"fixed": [], "plain": []}
    repeat = {}
    try:
        for mode in ("fixed", "plain", "plain", "fixed"):
            ttree.fixed_order_index_add = tpm.fixed_order_index_add = \
                fixed if mode == "fixed" else plain
            times[mode].append((cuda_ms(build, 5), cuda_ms(cic, 5)))
            t1, t2 = build(), build()
            repeat[mode] = same(t1.node_cm, t2.node_cm) \
                and same(cic(), cic())
    finally:
        ttree.fixed_order_index_add = tpm.fixed_order_index_add = fixed
    mean = lambda m, i: sum(t[i] for t in times[m]) / 2
    print(f"fixed-order sums [{card}]: tree build {mean('fixed', 0):.2f} ms "
          f"(plain index_add_ {mean('plain', 0):.2f} ms), one CIC assignment "
          f"{mean('fixed', 1):.3f} ms (plain {mean('plain', 1):.3f} ms), "
          f"medians of 5 in turns fixed, plain, plain, fixed; two builds "
          f"and assignments bit-identical: fixed {repeat['fixed']}, plain "
          f"{repeat['plain']}", flush=True)
    if not repeat["fixed"]:
        raise AssertionError("the fixed-order sums differ between two runs")
    for r in runs:
        r.close()


# --------------------------------------------------------------------------
# phase 6: slice 3, the gas box (TreePM + SPH)
# --------------------------------------------------------------------------

def write_gas_box(run_dir: str, seed: int = 42) -> str:
    """2 x BOX_NSIDE^3 particles on jittered lattices (jitter 2% of the
    spacing; examples/cosmological_box.py:53-73): gas (type 0, gravity 0)
    with OmegaBaryon / Omega0 of the box mass and IC internal energy u = 1
    (km/s)^2, dark matter (type 1, gravity 1) half a cell off.  Masses
    match Omega0; file velocities are Gadget's.  Returns the
    parameterfile path."""
    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.io.gadget_format import (SnapshotData,
                                                   SnapshotHeader,
                                                   write_snapshot)
    from ngravs_tpu_torch.units import set_units
    omega0, omega_b, box, ns = 0.3, 0.04, BOX_SIZE, BOX_NSIDE
    units = set_units(SimulationConfig(comoving_integration=True))
    rng = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(*[np.arange(ns)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / ns * box
    n = len(g)
    gas = np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape), box)
    dm = np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape)
                + 0.5 * box / ns, box)
    m_tot = omega0 * 3 * units.hubble ** 2 / (8 * math.pi * units.G) \
        * box ** 3
    m_gas = omega_b / omega0 * m_tot / n
    m_dm = (omega0 - omega_b) / omega0 * m_tot / n
    h = SnapshotHeader()
    h.npart = np.array([n, n, 0, 0, 0, 0], np.int32)
    h.npart_total = h.npart.astype(np.uint32)
    h.mass = np.array([m_gas, m_dm, 0.0, 0.0, 0.0, 0.0])
    h.time, h.redshift, h.box_size = 0.1, 9.0, box
    h.omega0, h.omega_lambda, h.hubble_param = omega0, 0.7, 0.7
    ic = os.path.join(run_dir, "gas_box.IC")
    write_snapshot(ic, SnapshotData(
        header=h, pos=np.concatenate([gas, dm]).astype(np.float32),
        vel=rng.normal(0, 1.0, (2 * n, 3)).astype(np.float32),
        pid=np.arange(1, 2 * n + 1, dtype=np.uint32),
        mass=np.repeat(np.array([m_gas, m_dm], np.float32), n),
        ptype=np.repeat(np.array([0, 1], np.int32), n),
        u=np.ones(n, np.float32)))
    soft = box / ns / 30
    return write_param(os.path.join(run_dir, "gas_box.param"), {
        "InitCondFile": ic, "OutputDir": run_dir,
        "SnapshotFileBase": "snapshot", "ICFormat": 1, "SnapFormat": 1,
        "ComovingIntegrationOn": 1, "PeriodicBoundariesOn": 1,
        "Omega0": omega0, "OmegaLambda": 0.7, "OmegaBaryon": omega_b,
        "HubbleParam": 0.7, "BoxSize": box,
        "TimeBegin": 0.1, "TimeMax": 1.0, "TimeBetSnapshot": 0.5,
        "TimeOfFirstSnapshot": 0.5, "TimeBetStatistics": 0.05,
        "ErrTolIntAccuracy": 0.025, "MaxSizeTimestep": 0.02,
        "ErrTolTheta": 0.5, "TypeOfOpeningCriterion": 1,
        "ErrTolForceAcc": 0.005, "TreeDomainUpdateFrequency": 0.1,
        "DesNumNgb": DES_NGB, "MaxNumNgbDeviation": NGB_DEV,
        "SofteningGas": soft, "SofteningHalo": soft,
        "GravityGas": 0, "GravityHalo": 1, "GravityDisk": 0,
        "GravityBulge": 0, "GravityStars": 0, "GravityBndry": 0,
    })


def pair_term_scales(fn, tgt, cand, per_target=()):
    """Per target and output, the sum over candidates of |that pair's
    term|: the pass `fn` on one candidate column at a time (the target
    blocks repeated S times), so each term is the pass's own."""
    from ngravs_tpu_torch.ops.sph import SphCandidates
    nb, s = cand.shape
    rep = lambda a: a.repeat_interleave(s, dim=0)
    outs = fn(rep(tgt), SphCandidates(cand.reshape(nb * s, 1), None, None,
                                      None), *[rep(a) for a in per_target])
    return [o.reshape(nb, s, *o.shape[1:]).abs().sum(1) for o in outs]


def check_sph_passes(sim, card: str):
    """The density and hydro passes of GAS_SAMPLE_BLOCKS sampled target
    blocks (all gas active) on the card and on the CPU from one tree and
    state: candidate lists equal, each output within RTOL_TERMS of its
    target's sum of |terms| (max_signal_vel, a maximum, within 1e-6
    relative)."""
    from ngravs_tpu_torch.ops import sph as S
    from ngravs_tpu_torch.ops.tree import Octree
    hs, cfg, depth = sim.hydro, sim.cfg, sim.solver.depth
    tree = sim._sph_tree()
    p = all_active(sim)
    tgt_all = hs._blocks(tree, p, sim.ti_current, sim.n_gas)
    live = torch.nonzero(tgt_all[:, 0] >= 0).squeeze(1).cpu().numpy()
    rows = np.sort(np.random.default_rng(5).choice(
        live, GAS_SAMPLE_BLOCKS, replace=False))
    tgt = tgt_all[torch.as_tensor(rows, device=tgt_all.device)]
    cpu_tree = Octree(*(t.cpu() for t in tree))
    order = tree.order.long()
    safe = tgt.clamp(min=0).long()
    hsml_t = torch.where(tgt >= 0, sim.sph.hsml[order][safe], 0.0)
    vel_all = sim.sph.vel_pred[order]
    box = cfg.box_sizes
    worst = {}

    def gather(pairs, radius):
        while True:
            g = S.make_sph_gather(depth, cfg.tree_bucket_size, hs.cand_cap,
                                  box_size=box, group_size=hs.group,
                                  pairs=pairs)
            on_card = g(tree, tgt, radius)
            if not bool(on_card.overflow):
                break
            hs.cand_cap *= 2
        on_cpu = g(cpu_tree, tgt.cpu(), radius.cpu())
        for name in ("cand", "n_cand", "overflow", "max_cand"):
            if not torch.equal(getattr(on_card, name).cpu(),
                               getattr(on_cpu, name)):
                raise AssertionError(f"SPH gather (pairs={pairs}): {name} "
                                     "differs between the card and the CPU")
        return on_card, on_cpu

    def compare(label, got, want, scales, maxed=()):
        for i, (g, w, sc) in enumerate(zip(got, want, scales)):
            err = (g.cpu() - w).abs()
            if i in maxed:
                bad = err > 1e-6 * w.abs()
            else:
                bad = err > RTOL_TERMS * sc.cpu() + 1e-30
            if bool(bad.any()):
                raise AssertionError(f"{label} output {i}: card vs CPU off "
                                     f"by {float(err.max())}")
            worst[f"{label}[{i}]"] = float(err.max())

    cd, cc = gather(False, hsml_t)
    dens = lambda tr, vel: lambda tg, c, h, v: S.density_pass(
        tr, tg, h, v, c, vel, box_size=box)
    got = dens(tree, vel_all)(tgt, cd, hsml_t, vel_all[safe])
    want = dens(cpu_tree, vel_all.cpu())(tgt.cpu(), cc, hsml_t.cpu(),
                                         vel_all[safe].cpu())
    compare("density", got, want, pair_term_scales(
        dens(tree, vel_all), tgt, cd.cand, (hsml_t, vel_all[safe])))

    fields, facs = hs.hydro_inputs(tree, p, sim.sph, float(sim.tbi),
                                   sim.time)
    hd, hc = gather(True, fields[0][safe])
    hyd = lambda tr, fl: lambda tg, c: S.hydro_pass(
        tr, tg, c, *fl, *facs, cfg.art_bulk_visc_const, box_size=box,
        use_limiter=not cfg.no_viscosity_limiter)
    got = hyd(tree, fields)(tgt, hd)
    want = hyd(cpu_tree, [f.cpu() for f in fields])(tgt.cpu(), hc)
    compare("hydro", got, want, pair_term_scales(hyd(tree, fields), tgt,
                                                 hd.cand), maxed=(2,))
    print(f"SPH passes [{card}]: {GAS_SAMPLE_BLOCKS} sampled blocks of "
          f"{hs.group} targets, S = {cd.cand.shape[1]} (density, "
          f"{int(cd.max_cand)} max) and {hd.cand.shape[1]} (hydro, "
          f"{int(hd.max_cand)} max): candidate lists equal on the card and "
          f"the CPU; max |card - CPU| "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f", each within {RTOL_TERMS:g} of its sum of |terms|",
          flush=True)


def profile_gas_step(sim, card: str, launched):
    """One gas step under torch.profiler: CUDA kernels, the device's busy
    share, and K1's, the density passes' and the hydro pass's shares of
    device time (the `sph_density` / `sph_hydro` ranges).  The step's K1
    launches are kept in `launched`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ngravs_tpu_torch.ops.pairwise import pairwise_eval
    sim.solver.pair_eval = record_launches(pairwise_eval, launched)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(max_steps=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sim.solver.pair_eval = pairwise_eval
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    events = prof.key_averages()
    # kernels only: a record_function range has a device-side event too
    kern = [e for e in events
            if e.device_type == DeviceType.CUDA and e.key not in RANGES]
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    k1_ms = sum(dev_us(e) for e in kern if "pairwise_kernel" in e.key) / 1e3
    rng_ms = {k: range_ms(prof, k) for k in ("sph_density", "sph_hydro")}
    if busy_ms <= 0:
        print(f"profiled gas step [{card}]: {wall_ms:.1f} ms wall; device "
              "time not measured (the profiler recorded none)", flush=True)
        return
    shares = ", ".join(
        f"{k} {v:.2f} ms ({v / busy_ms:.1%})" if v > 0
        else f"{k} not measured (no device time under the range)"
        for k, v in rng_ms.items())
    print(f"profiled gas step [{card}]: {wall_ms:.1f} ms wall (profiler "
          f"on), {sum(e.count for e in kern)} CUDA kernels, device busy "
          f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.1%} of the wall); K1 "
          f"{k1_ms:.2f} ms ({k1_ms / busy_ms:.1%} of device time); "
          f"{shares}", flush=True)


def gas_path(dev, card: str):
    """Slice 3's path; its K1 launch count and the inputs of every K1
    launch of its profiled step."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    from ngravs_tpu_torch.ops import pairwise
    run_dir = os.path.join(ROOT, "build", "chip_smoke_gas")
    os.makedirs(run_dir, exist_ok=True)
    cfg = read_parameter_file(write_gas_box(run_dir), pmgrid=BOX_PMGRID,
                              n_gravs=2, wiring="newton_yukawa",
                              pm_interlace=True)
    sim = Simulation(cfg, device=dev)
    n, n_gas = sim.p.n, sim.n_gas
    if n_gas != BOX_NSIDE ** 3 or n != 2 * n_gas \
            or sim.solver.treepm is None or sim.solver.uses_direct(n):
        raise AssertionError("the gas path must run TreePM + SPH at "
                             "2 x 64^3")

    pairwise.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GAS_STEPS):
        before = dict(sim.cpu_timers, **sim.hydro.counts)
        sim.run(max_steps=1)
        d = {k: v - before[k] for k, v in dict(sim.cpu_timers,
                                               **sim.hydro.counts).items()}
        print(f"gas step {sim.step_count} [{card}]: a={sim.time:.6g}, "
              f"{d['density_iters']} density iterations, cand_cap "
              f"{sim.hydro.cand_cap}, gravity {d['gravity']:.2f} s, hydro "
              f"{d['hydro']:.2f} s, PM {d['pm']:.2f} s, step "
              f"{d['total']:.2f} s", flush=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(pairwise.pairwise_eval.counts)
    launches = sum(counts.values())
    if sum(v for k, v in counts.items() if k.startswith("K1bcd")) <= 0:
        raise AssertionError(f"the gas path never launched the TreePM "
                             f"multi-law K1 instance: {counts}")
    print(f"gas path [{card}]: {GAS_STEPS} steps to a={sim.time:.6g}, "
          f"{sim.num_force_updates} particle-steps in {wall:.2f} s = "
          f"{sim.num_force_updates / wall:.1f} particle-steps/s, K1 "
          f"launches {counts}, SPH passes {sim.hydro.counts}, PM window "
          f"({sim.pm_ti_begstep}, {sim.pm_ti_endstep}); host seconds by "
          "phase: " + ", ".join(f"{k} {v:.2f}"
                                for k, v in sim.cpu_timers.items()),
          flush=True)

    # the gates on the state after the steps
    s, gas = sim.sph, slice(0, n_gas)
    wngb = s.num_ngb[gas]
    in_window = float(((wngb - DES_NGB).abs() <= NGB_DEV).double().mean())
    rho_mean = float(sim.p.mass[gas].double().sum()) / cfg.box_size ** 3
    rho_med = float(s.density[gas].double().median())
    ma = sim.p.mass[gas, None] * s.hydro_accel[gas]
    mom = (ma.sum(0).abs() / ma.abs().sum(0).clamp(min=1e-30)).tolist()
    ent, msv = s.entropy[gas], s.max_signal_vel[gas]
    print(f"gas state [{card}]: weighted neighbours within {DES_NGB} +- "
          f"{NGB_DEV} for {in_window:.5%} of the gas (range "
          f"{float(wngb.min()):.3f}-{float(wngb.max()):.3f}); median "
          f"density / mean {rho_med / rho_mean:.5f}; hydro momentum rate "
          f"{', '.join(f'{m:.2e}' for m in mom)}; entropy "
          f"{float(ent.min()):.4g}-{float(ent.max()):.4g}; signal velocity "
          f"{float(msv.min()):.4g}-{float(msv.max()):.4g}", flush=True)
    if not in_window >= 0.999:
        raise AssertionError(f"neighbour counts in the window for only "
                             f"{in_window:.4%} of the gas")
    if not abs(rho_med / rho_mean - 1) < 0.05:
        raise AssertionError(f"median gas density {rho_med} vs mean "
                             f"{rho_mean}")
    if not max(mom) < 1e-3:
        raise AssertionError(f"hydro momentum rate {mom}")
    if not (bool(torch.isfinite(ent).all()) and float(ent.min()) > 0):
        raise AssertionError("entropy not finite and positive")
    if not float(msv.min()) > 0:
        raise AssertionError("a gas particle has no signal velocity")
    for k in ("pos", "vel", "accel", "accel_pm"):
        if not bool(torch.isfinite(getattr(sim.p, k)).all()):
            raise AssertionError(f"non-finite {k} on the gas path")

    check_sph_passes(sim, card)

    # restart files: save after the steps, resume into a fresh Simulation
    t0 = time.perf_counter()
    path = sim.save_restart(os.path.join(run_dir, "gas_restart.npz"))
    fresh = Simulation(cfg, device=dev, log_dir="")
    fresh.resume(path)
    for obj, other in ((sim.p, fresh.p), (sim.sph, fresh.sph)):
        for k, v in vars(obj).items():
            if not torch.equal(v, getattr(other, k)):
                raise AssertionError(f"restart round trip changed {k}")
    for k in ("ti_current", "pm_ti_begstep", "pm_ti_endstep",
              "dt_displacement", "step_count", "num_force_updates"):
        if getattr(sim, k) != getattr(fresh, k):
            raise AssertionError(f"restart round trip changed {k}")
    print(f"restart [{card}]: {os.path.getsize(path) / 2**20:.1f} MiB, "
          f"saved and resumed into a fresh Simulation in "
          f"{time.perf_counter() - t0:.1f} s; every array equal", flush=True)
    fresh.close()
    del fresh

    launched = []
    profile_gas_step(sim, card, launched)
    sim.close()
    return launches, launched


# --------------------------------------------------------------------------
# phase 7: slice 4a, the periodic pure-tree (Ewald) box
# --------------------------------------------------------------------------

def ewald_path(dev, card: str):
    """Slice 4a's path: the box path's IC, cosmology, softening and
    newton_yukawa wiring without PMGRID, the geometric opening criterion
    (theta 0.5), EWALD_STEPS steps with FORCETEST.  Returns its K1 launch
    count, the inputs of every launch of a full pass after the steps, and
    the largest |acc| difference of those launches from the twin."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    from ngravs_tpu_torch.ops import lattice
    from ngravs_tpu_torch.ops.pairwise import pairwise_eval
    run_dir = os.path.join(ROOT, "build", "chip_smoke_ewald")
    os.makedirs(run_dir, exist_ok=True)
    ft_path = os.path.join(run_dir, "forcetest.txt")
    if os.path.exists(ft_path):
        os.remove(ft_path)
    # the geometric criterion: on a near-uniform lattice without a mesh
    # |a_old| is tiny, and the relative one opens almost every node
    cfg = read_parameter_file(write_cosmo_box(run_dir), n_gravs=2,
                              wiring="newton_yukawa", solver="tree",
                              type_of_opening_criterion=0,
                              force_test=FORCETEST_FRAC)
    lattice.last_generator = None
    t0 = time.perf_counter()
    sim = Simulation(cfg, device=dev)
    init_s = time.perf_counter() - t0
    n = sim.p.n
    if n != 2 * BOX_NSIDE ** 3 or sim.solver.pm is not None \
            or sim.solver.lattice_tables is None or sim.solver.uses_direct(n):
        raise AssertionError("slice 4a must walk the periodic tree with the "
                             "lattice pass at 2 x 64^3")
    steps, wall, counts = run_path(sim, EWALD_STEPS)
    launches = sum(counts.values())
    if sum(v for k, v in counts.items() if k.startswith("K1bc")) <= 0:
        raise AssertionError(f"slice 4a never launched the periodic "
                             f"multi-law K1 instance: {counts}")
    for k in ("pos", "vel", "accel"):
        if not bool(torch.isfinite(getattr(sim.p, k)).all()):
            raise AssertionError(f"non-finite {k} on slice 4a")
    mom = momentum_rate(sim.p.mass, sim.p.accel)
    print(f"Ewald path [{card}]: {steps} steps to a={sim.time:.6g}, "
          f"{sim.num_force_updates} particle-steps in {wall:.2f} s = "
          f"{sim.num_force_updates / wall:.1f} particle-steps/s (FORCETEST "
          f"included), K1 launches {counts}, set-up {init_s:.1f} s (lattice "
          f"tables EN={cfg.ngravs_en} "
          f"{lattice.last_generator or 'from the cache'}), tree depth "
          f"{sim.solver.depth}, walk caps {sim.solver.fcaps}, momentum rate "
          f"{mom:.2e}; host seconds by phase: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sim.cpu_timers.items()),
          flush=True)
    check_forcetest("Ewald path", ft_path, card, RMS_EWALD, steps, steps)
    if not mom < MOMENTUM_RATE:
        raise AssertionError(f"slice 4a momentum rate {mom}")
    stamp("Ewald path run")

    launched = []
    solver = pass_solver(sim)
    stamp("Ewald path: a solver of its own")
    full_force_pass(sim, solver, record_launches(pairwise_eval, launched))
    stamp("Ewald path: a pass recorded")
    worst = check_every_launch("Ewald pass", launched)
    stamp("Ewald path: every launch against the twin")
    # the targets of an eighth of the box: the profiler's processing of a
    # whole pass (321k kernels) took about 200 s on the H100's host
    profile_pass(sim, solver, card, "profiled Ewald pass (x < box/8)",
                 ranges=("lattice_pass",), slab=0.125)
    sim.close()
    return launches, launched, worst


# --------------------------------------------------------------------------
# phase 8: slice 4b, the TreePM box with the tabulated transition
# --------------------------------------------------------------------------

def tabulated_term_scales(targets, sp, n_src, wiring, box_size, sr_ftab,
                          sr_ptab, asmth):
    """Per target, the sums over valid pairs of |fac*dx|, |fac*dy|,
    |fac*dz| and |pot term| of the tabulated evaluation."""
    from ngravs_tpu_torch.ops import walk as twalk
    from ngravs_tpu_torch.ops.pairwise import FCOUNT, FMASS, FSOFT, IGRAV
    from ngravs_tpu_torch.ops.shortrange import (longrange_force_factor,
                                                 longrange_pot_factor)
    nb, _, s = sp.shape
    g = targets["x"].shape[0] // nb
    ng, ntab = wiring.n_gravs, int(sr_ftab.shape[-1])
    out = torch.zeros(nb * g, 4, device=sp.device)
    for sl in twalk._block_chunks(nb, s, g, None):
        spc = sp[sl]
        col, valid, d = twalk._pair_geometry(targets, spc, sl, n_src, g,
                                             box_size)
        tg = col("grav")
        sg = spc[:, IGRAV, :].view(torch.int32)[:, None, :]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        r = torch.sqrt(r2)
        h = torch.maximum(col("fsoft"), spc[:, None, FSOFT, :])
        sm = spc[:, None, FMASS, :]
        cnt = spc[:, None, FCOUNT, :] if wiring.accumulator else 1.0
        pair = tg * ng + sg
        lr, inside = longrange_force_factor(
            sr_ftab.reshape(ng * ng, ntab), asmth, ntab, r, pair)
        lrp, _ = longrange_pot_factor(sr_ptab.reshape(ng * ng, ntab), asmth,
                                      ntab, r, pair)
        fac = torch.zeros_like(r)
        pot = torch.zeros_like(r)
        for law, slots in wiring.unique_laws():
            mk = torch.zeros_like(valid)
            for i, j in slots:
                mk = mk | ((tg == i) & (sg == j))
            fac = torch.where(mk, law.force_factor_tpm(col("mass"), sm, r2, r,
                                                       h, cnt, lr), fac)
            pot = torch.where(mk, law.potential_factor_tpm(
                col("mass"), sm, r2, r, h, cnt, lrp), pot)
        ok = valid & inside
        rows = torch.arange(nb * g, device=sp.device).reshape(nb, g)[sl]
        out[rows.reshape(-1)] = torch.stack(
            [torch.where(ok, (fac * x).abs(), 0.).sum(-1) for x in d]
            + [torch.where(ok, pot.abs(), 0.).sum(-1)],
            dim=-1).reshape(-1, 4)
    return out


def tabulated_path(dev, card: str):
    """Slice 4b's path: the box path's IC with the yukawa preset (a NoneLaw
    diagonal: no closed-form truncation, so every pair takes the tabulated
    transition and K1 is not launched), PMGRID 128 interlaced, the
    relative criterion, TAB_STEPS steps with FORCETEST on the PM steps;
    then the largest tabulated evaluation of the run again on the card and
    on the CPU."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    from ngravs_tpu_torch.ops import walk as twalk
    run_dir = os.path.join(ROOT, "build", "chip_smoke_tab")
    os.makedirs(run_dir, exist_ok=True)
    ft_path = os.path.join(run_dir, "forcetest.txt")
    if os.path.exists(ft_path):
        os.remove(ft_path)
    cfg = read_parameter_file(write_cosmo_box(run_dir), pmgrid=BOX_PMGRID,
                              n_gravs=2, wiring="yukawa", pm_interlace=True,
                              force_test=FORCETEST_FRAC)
    sim = Simulation(cfg, device=dev)
    n = sim.p.n
    laws = sim.wiring.unique_laws()
    if n != 2 * BOX_NSIDE ** 3 or sim.solver.treepm is None \
            or all(law.kernel_shortrange() is not None for law, _ in laws):
        raise AssertionError("slice 4b must run TreePM with a law that has "
                             "no closed-form truncation at 2 x 64^3")
    # keep the inputs of the evaluation with the most sources
    evals = {"calls": 0, "largest": None, "rows": -1}
    tab_eval = twalk.tabulated_pair_eval

    def recording(targets, sp, n_src, want_pot, **kw):
        evals["calls"] += 1
        rows = int(n_src.sum())
        if rows > evals["rows"]:
            evals["rows"] = rows
            evals["largest"] = (targets, sp, n_src, want_pot, kw)
        return tab_eval(targets, sp, n_src, want_pot, **kw)

    twalk.tabulated_pair_eval = recording
    try:
        steps, wall, counts = run_path(sim, TAB_STEPS)
    finally:
        twalk.tabulated_pair_eval = tab_eval
    if counts or evals["calls"] == 0:
        raise AssertionError(f"slice 4b must evaluate every pair with the "
                             f"tabulated transition: K1 {counts}, tabulated "
                             f"evaluations {evals['calls']}")
    p = sim.p
    if not (bool(p.accel_pm.abs().max() > 0) and sim.pm_ti_endstep > 0):
        raise AssertionError("PM never ran on slice 4b")
    for k in ("pos", "vel", "accel", "accel_pm"):
        if not bool(torch.isfinite(getattr(p, k)).all()):
            raise AssertionError(f"non-finite {k} on slice 4b")
    mom = momentum_rate(p.mass, p.accel + p.accel_pm)
    print(f"tabulated TreePM path [{card}]: {steps} steps to "
          f"a={sim.time:.6g}, {sim.num_force_updates} particle-steps in "
          f"{wall:.2f} s = {sim.num_force_updates / wall:.1f} "
          f"particle-steps/s (FORCETEST included), {evals['calls']} "
          f"tabulated evaluations, K1 launches {counts}, PM window "
          f"({sim.pm_ti_begstep}, {sim.pm_ti_endstep}), momentum rate "
          f"{mom:.2e}; host seconds by phase: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sim.cpu_timers.items()),
          flush=True)
    check_forcetest("tabulated TreePM path", ft_path, card, RMS_TABULATED,
                    1, steps)
    if not mom < MOMENTUM_RATE:
        raise AssertionError(f"slice 4b momentum rate {mom}")

    # the largest evaluation on the card against the CPU
    targets, sp, n_src, want_pot, kw = evals["largest"]
    evals.clear()
    got = tab_eval(targets, sp, n_src, want_pot, **kw)
    ms = cuda_ms(lambda: tab_eval(targets, sp, n_src, want_pot, **kw), 3)
    cpu = lambda t: t.cpu() if torch.is_tensor(t) else t
    kw_c = {k: cpu(v) for k, v in kw.items()}
    t_c = {k: v.cpu() for k, v in targets.items()}
    t0 = time.perf_counter()
    want = tab_eval(t_c, sp.cpu(), n_src.cpu(), want_pot, **kw_c)
    cpu_s = time.perf_counter() - t0
    scale = tabulated_term_scales(t_c, sp.cpu(), n_src.cpu(),
                                  **{k: v for k, v in kw_c.items()})
    err_a = (got[0].cpu() - want[0]).abs()
    err_p = (got[1].cpu() - want[1]).abs()
    if bool((err_a > RTOL_TERMS * scale[:, :3]).any()) or (
            want_pot and bool((err_p > RTOL_TERMS * scale[:, 3]).any())) \
            or not torch.equal(got[2].cpu(), want[2]):
        raise AssertionError("the tabulated evaluation on the card differs "
                             "from the CPU's")
    print(f"tabulated evaluation [{card}]: the largest of the run "
          f"({tuple(sp.shape)}, {int(n_src.sum())} source rows, "
          f"{int(want[2].sum())} pairs) on the card and on the CPU: within "
          f"{RTOL_TERMS:g} of each target's sum of |terms| (max|dacc| "
          f"{float(err_a.max()):.3g}), pair counts equal; {ms:.2f} ms on the "
          f"card (median of 3), {cpu_s:.2f} s on the CPU", flush=True)
    sim.close()


# --------------------------------------------------------------------------

def kernel_entry(name: str, launches: int, nums: dict, errs) -> dict:
    return {"name": name, "route": "cuda",
            "source": "ngravs_tpu_torch/csrc/pairwise.cu",
            "replaces": "ngravs_tpu/ops/pairwise_pallas.py:53",
            "launches": launches,
            "max_abs_err": max(errs),
            "ms": nums["ms"], "plain_ms": nums["plain_ms"],
            "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
            "library_ms": None, "plan": nums["plan"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from ngravs_tpu_torch.ops import lattice, pairwise
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)

    t0 = time.perf_counter()
    pairwise.build_library(verbose=True)
    t1 = time.perf_counter()
    native = lattice.build_native() is not None
    print(f"build: pair kernel {t1 - t0:.1f} s; lattice-table generator "
          f"{'native' if native else 'numpy (no host compiler)'} "
          f"{time.perf_counter() - t1:.1f} s", flush=True)

    # phase 3: every instance on synthetic walk-shaped inputs
    synthetic = {"K1a": check_kernel("kernel (synthetic)",
                                     *kernel_inputs(dev), (False, True))}
    for i, case in enumerate(K1_CASES):
        w, kw = case_wiring(case)
        inputs = kernel_inputs(dev, seed=10 + i, n_gravs=w.n_gravs,
                               box=kw["box_size"], count=kw["accumulator"])
        synthetic[case] = check_kernel(f"kernel (synthetic, {case})",
                                       *inputs, (False, True), kw)

    stamp("build and synthetic K1 instances")
    # phases 4-8: the five paths, each with its counts from 0
    launches1, launched = galaxy_path(dev, card)
    galaxy_batch = check_largest_launch("kernel (main-path batch)", launched)
    stamp("slice 1")
    launches2, launched = box_path(dev, card)
    box_batch = check_largest_launch("kernel (box-path batch)", launched)
    stamp("slice 2 (box path, reproducibility)")
    launches3, launched = gas_path(dev, card)
    gas_batch = check_largest_launch("kernel (gas-path batch)", launched)
    stamp("slice 3 (gas)")
    launches4, launched, ewald_err = ewald_path(dev, card)
    ewald_batch = check_largest_launch("kernel (Ewald-path batch)", launched)
    del launched
    stamp("slice 4a (Ewald)")
    tabulated_path(dev, card)
    stamp("slice 4b (tabulated TreePM)")

    entries = [kernel_entry("K1a (slice 1 path, open box, one Newton law)",
                            launches1, galaxy_batch,
                            [galaxy_batch["max_abs_err"]]
                            + [r["max_abs_err"]
                               for r in synthetic["K1a"].values()]),
               kernel_entry(f"{box_batch['name']} (box path, newton_yukawa "
                            "periodic TreePM)", launches2, box_batch,
                            [box_batch["max_abs_err"]]),
               kernel_entry(f"{gas_batch['name']} (gas path, newton_yukawa "
                            "periodic TreePM + SPH)", launches3, gas_batch,
                            [gas_batch["max_abs_err"]]),
               kernel_entry(f"{ewald_batch['name']} (slice 4a path, "
                            "newton_yukawa periodic pure tree, beside the "
                            "lattice pass)", launches4, ewald_batch,
                            [ewald_batch["max_abs_err"], ewald_err])]
    path_counts = {box_batch["name"]: launches2 + launches3}
    for case, rep in synthetic.items():
        for want_pot, r in rep.items():
            entries.append(kernel_entry(
                f"{r['name']} ({case}, synthetic)",
                launches1 if r["name"] == "K1a"
                else path_counts.get(r["name"], 0),
                r, [r["max_abs_err"]]))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
