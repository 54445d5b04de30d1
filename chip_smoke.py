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
    (newton_yukawa), K1c and K1cd (one Newton law in a periodic box,
    without and with TreePM), K1bcd (newton_yukawa and three_species in a
    periodic TreePM box) and K1b+count (bam with the accumulator).  acc
    and pot within 1e-5 of each target's sum of |terms| (the two sum in
    different orders), pair counts equal, two launches bit-identical; the
    launch plan (`launch_plan`: lanes P, cluster C, tile, stages, shared
    memory), median times (20 launches, the twin's 3) and the bound;
 4. slice 1, the open-box path: a synthetic GalaxyCollision-shaped IC (60k
    particles of types 1-5 as BASELINE.md counts them, two Plummer spheres
    on a collision orbit, disk -> gravity 1) written in format 1 with its
    parameterfile, run as `read_parameter_file(..., direct_crossover=1000,
    tree_depth=12)` -> `Simulation(cfg)` -> `run(max_steps=10)`; then one
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
    `run(max_steps=BOX_STEPS)` with FORCETEST on 2,048 particles (2^-8
    of them) on each PM step: K1 (the TreePM multi-law instance) and PM must run,
    forces finite, every step's FORCETEST rms relative error < 2.5e-2;
    then one full TreePM pass (PM + short-range walk)
    on every particle, checked on 2,048 sampled targets against the
    periodic direct sum with the Ewald lattice correction (rms relative
    error < 2.5e-2), timed with the kernel and with the twin, PM alone
    timed, the pass for an eighth of the box profiled; then the run
    repeats bit for bit (the tree's moments and PM's mass assignment are
    fixed-order sums): two full force passes from one state, and
    REPRO_STEPS steps continued against the same resumed from a restart
    file;
    the tree build and one CIC assignment timed in turns against the
    atomic `index_add_` they replaced; then K1 against the twin on that
    pass's largest launch, as for slice 1;
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
    back bit for bit.  Then one force computation for the particles of an
    eighth of the box profiled (K1's, the density passes' and the hydro
    pass's shares of device time) and K1 against the twin on its largest
    launch;
 7. slice 4a, the periodic pure-tree (Ewald) box: slice 2's IC, cosmology,
    softening and newton_yukawa wiring without PMGRID, the geometric
    opening criterion (theta 0.5), `run(max_steps=EWALD_STEPS)` with
    FORCETEST on 2,048 particles each step: K1 (the periodic multi-law instance, K1bc)
    must run beside the lattice pass, K3 once a walk batch; every step's
    FORCETEST rms relative error < 0.25 (the reference walk's error on
    this near-uniform IC; see RMS_EWALD), momentum rate < 1e-3; every K1
    launch of a fresh solver's settling pass, the walk attempts that
    overflowed included, within 1e-5 of its sum of |terms| of the twin,
    and every K3 launch of it as the walk received it and launched again
    with the potential off and on (`K3 [...]` times its largest against
    the twin); the pass for the targets of a sixteenth of the box
    profiled (K3's share of device time); K1
    against the twin on its largest launch;
 8. slice 4b, the TreePM box with the tabulated transition: slice 2's box
    with the yukawa preset (a NoneLaw diagonal, so no closed form: every
    pair takes the tabulated evaluation and K1 is not launched), PMGRID
    128 interlaced, relative opening, `run(max_steps=TAB_STEPS)` with
    FORCETEST on the PM steps: rms relative error < 3e-2 (tests/test_treepm.py:223),
    momentum rate < 1e-3; the run's largest tabulated evaluation on the
    card against the CPU within 1e-5 of each target's sum of |terms|;
 9. (run after phase 4, while the lattice tables are made) segments
    (`Simulation(cfg, segment_steps=K)`) against single stepping from the
    same IC, in lockstep (the single-stepped run catches up after
    each `step()` call of the segmented one): slice 1's open box for 16
    sync points in segments of up to 16, and the box path's TreePM box
    (FORCETEST off) for 3 sync points, the last two one segment.  Gates:
    the same sync points (and PM window); positions over the extent and
    velocities over their largest magnitude within the CPU test's
    tolerance; on the box every ti_endstep and the force updates equal,
    on the open box at most 1e-4 of the particles in another timestep bin,
    each first within 1e-3 (log2) of a bin edge; K1 launched; one full walk
    from the last drift step's tables (node CMs and source rows drifted
    since their re-aggregation) with an rms error < 5e-3 against the
    direct sweep.  Both rates, the segments' counts and the host syncs a
    segment step (CUDA's sync debug mode) are printed;
10. the integrator's special modes: (a) MAKEGLASS, 64^3 particles uniform
    at random in the box path's box (Omega0 1, OmegaLambda 0) with the
    stock all-Newton wiring and PMGRID 128 interlaced, 5 glass steps:
    velocities zero, positions in the box, the reversed forces finite,
    the counts-in-cells variance on 32^3 cells (mean 8) below its start
    (printed each step), K1cd launched and its largest launch against the
    twin; (b) FLEXSTEPS and PSEUDOSYMMETRIC on slice 1's IC, 5 steps
    each: step ends off their own grid and 1 <= present_min_step <=
    present_max_step; every step a power of two and aphys_old finite and
    positive somewhere; K1a launched, forces finite; (c) TWODIMS with
    LONG_X 2, NOGRAVITY: a periodic 256 x 128 gas sheet, 3 steps, the
    median density within 5% of the mean, 99.9% of the gas within
    DesNumNgb +- MaxNumNgbDeviation, no K1;
11. multi-device runs over torch.distributed (`parallel.runner.
    DistributedSimulation`), one process a rank spawned by
    `parallel.mesh.launch`: 1 rank over NCCL on cuda:0, then 2 ranks over
    gloo sharing the card, each with the replicated and the LET step on
    slice 1's 60k open box (DIST_STEPS steps) and slice 2's 2 x 64^3
    TreePM box (DIST_BOX_STEPS steps, FORCETEST on each PM step).  Gates:
    every rank launches K1 (K1a, K1bcd); on rank 0 each instance's
    largest launch of the run (by source rows) against the twin, as for
    the other paths; the open box's last step's forces (every particle's)
    within rms 5e-3 of the direct sweep and within rms 2e-2 of the
    single-device solver's pass on the same state, momentum rate < 1e-3,
    the sync points advancing, two 2-rank runs bit-identical; the box's
    FORCETEST rms < 2.5e-2 on each PM step, its timeline and PM window
    equal to phase 5's single-device run at the same step, the slab PM
    within 2e-5 of max|a| of the single-device PM in float32 and within
    1e-10 with both in float64, the 2-rank multi-file snapshot read back equal to
    `gather_ordered()` and a restart round trip bit for bit.  Printed
    beside each: particle-steps/s (and the single device's), the K1
    launches by rank, the host syncs of a step, the bytes each rank sends
    in collectives in a step, the LET rows received.  The kernels line
    has an entry of its own for each instance, IC and step of phase 11.
    Phases 11 and 12 share one launch a world size (phase 11's
    configurations, then phase 12's).  After both, `python -m
    ngravs_tpu_torch.run <param> --devices 2 --backend gloo` on a short
    open-box run must end with 0 (beside phase 12's run of the command
    line: the two start at once);
12. multi-device gas: slice 3's gas box (phase 6's IC, FORCETEST on each
    PM step, u turned into entropy by a density pass before the first
    step, from phase 6's first smoothing length) through
    `DistributedSimulation` with the replicated and the LET full step
    (`parallel/full_sharded.py`, `parallel/full_let_sharded.py`), on 1
    rank over NCCL and 2 ranks over gloo sharing the card, DIST_GAS_STEPS
    steps each.  Gates: every rank launches K1bcd, rank 0's largest launch
    of each configuration against the twin; FORCETEST rms < 2.5e-2 on each
    PM step; the timeline equal to phase 6's; the first step against phase
    6's first step (density and Hsml within 2e-3 relative, the hydro
    acceleration within 3e-3 of its largest |a|, gravity within rms 2e-2);
    phase 6's gas-state gates on the last state; the first steps of two
    2-rank replicated runs bit-identical; the 2-rank multi-file snapshot
    (U, RHO and HSML included) equal to `gather_ordered()` and a restart
    round trip bit for bit.  Printed beside each: particle-steps/s (and
    phase 6's), the ghost rows each rank receives in rounds A and B, the
    LET gravity rows, density iterations, cand_cap, the ghost-cap growths
    and margin reruns, host syncs, collective bytes and the SPH passes'
    seconds of the last step.  Then a 2-step `--devices 2 --backend gloo`
    gas run through the command line, beside phase 11's, (the scheme at 2 x 32^3, periodic
    pure tree: a parameterfile cannot ask for PMGRID) must end with 0 and
    write a snapshot with its gas blocks;
13. the law matrix: four configurations, each with its K1 counts from 0
    and its K1 instance required in them, every K1 launch of one full
    force pass after its steps against the twin (within 1e-5 of each
    target's sum of |terms|, pair counts equal; in (c) and (d) the pass
    is a fresh solver's settling pass, the walk attempts that overflowed
    included, and if no pass checked so far overflowed, (d) runs one
    with its chunk cap cut so that it does) and its largest launch
    timed, momentum rate < 1e-3: (a) `newton_yukawa` (BASELINE config 2)
    on slice 1's IC, LAW_STEPS steps, K1b; (b) `bam` with
    NGRAVS_ACCUMULATOR, the halo (type 1) BAM dark matter and the rest
    baryons, the geometric criterion, LAW_STEPS steps, K1b+count; (a) and
    (b) hold one full tree pass to the direct sweep with the same wiring,
    rms by gravity < 5e-3, and (b) the same pass with the accumulator off
    to a larger rms on the BAM targets; (c) the stock Newton law in slice
    4a's periodic pure-tree box, EWALD_STEPS steps, K1c, FORCETEST rms
    < 0.25; (d) `three_species` (BASELINE config 5) in slice 3's gas box
    with a third lattice (type 2, gravity 2), 3 x 64^3, PMGRID 128
    interlaced, LAW_BOX_STEPS steps, K1bcd at N_GRAVS=3, FORCETEST rms <
    2.5e-2 and slice 3's gas-state gates; PM's nine pair rounds and the
    SPH passes timed;
14. the potential, inside each path after its steps, on its final state:
    the K1 counts from 0, one `sim.update_full_potential()` (the walk with
    the potential, plus PM's potential under PMGRID), which must launch
    the path's K1 instance with the potential: K1a/pot (slice 1), K1b/pot
    (13a), K1b+count/pot (13b), K1bc/pot (slice 4a), K1c/pot (13c),
    K1bcd/pot (slice 2) and K1cd/pot (the glass box); slice 4b, which
    launches no K1, runs the tabulated potential.  The potential finite,
    one energy.txt line (`energy_statistics`) with a finite Epot, every
    K1 launch of the pass against the twin (pot included) and the largest
    timed.  Against the direct sum in float64: on the open boxes the rms
    over each gravity's particles of |dpot| / |pot_direct| < 1e-3 (13b's
    BAM targets printed); in the periodic boxes the sum with the lattice
    correction on 2,048 targets, per gravity d = pot - pot_direct, mean(d)
    printed and rms(d - mean d) / rms(pot_direct) below the path's bound
    (RMS_POT_*: 1.5 times the JAX package's value on the CPU, see there).
    Phase 11's 2-rank LET box runs with OutputPotential: every rank
    launches K1bcd/pot, the first step's gathered potential meets the box
    path's periodic bound, and the multi-file snapshot's POT block reads
    back equal to `gather_ordered()`.

`python3 chip_smoke.py --phases 6,12` runs the named phases alone (phase
12 needs phase 6's run).  The line before the last is the card's name and
power limit, the one before it a JSON object with every K1 instance's
numbers (phases 11 and 12: one per instance, IC and step); the last line is
{"ok": true, "device": {...}}.  Every time printed is from this run, on the
card named above it.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B, G, S = 128, 64, 4096          # the fused walk's pair-kernel shapes
RTOL_TERMS = 1e-5                # of each target's sum of |terms|
OVERFLOW_CHUNK_CAP = 64          # 13d's cut pass when none overflowed
SCALE_SLICE = 4096               # sources a slice in term_scales
MAIN_STEPS = 10                  # slice 1's path
SEG_STEPS = 16                   # phase 9a's sync points
# BASELINE.md:54 — GalaxyCollision.IC per-type counts (no gas)
NPART = (0, 10000, 20000, 10000, 10000, 10000)
# the box path
BOX_NSIDE = 64                   # 2 x 64^3 particles
BOX_SIZE = 50000.0               # kpc/h
BOX_PMGRID = 128
BOX_STEPS = 1
ORACLE_TARGETS = 2048
REPRO_STEPS = 1                  # the restart's bit-for-bit check
# the gas path
GAS_STEPS = 2
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
# the port's torch.profiler ranges (its trace's spans, not kernels)
RANGE_PREFIX = "ngravs."
# slices 4a (periodic pure tree, Ewald) and 4b (tabulated TreePM)
EWALD_STEPS = 1
TAB_STEPS = 1
# phase 9: segments of up to SEG_CAP sync points against single stepping;
# the TreePM box over BOX_SEG_STEPS sync points.  The tolerance is the CPU
# test's (tests/test_torch_segments.py): 2e-3 on an extent of 4 and a
# largest |v| of 0.1876.  On the open box a drift step's tables (sources
# moved with the velocities of their last re-aggregation) and a rebuilt
# tree give forces that differ by up to 1.4e-2 of |a| (segment_study.py:
# seeds 7, 8 and 9, caps 4 and 16), and dt ~ |a|^-1/2 moves log2 dt by
# 0.72x that: a particle whose kick lies within SEG_EDGE (log2) of a
# timestep-bin edge may take the other bin (the study: within 2.5e-3).  The
# study saw 1-9 such particles at a comparison; the gate is SEG_FLIPS of N.
# The segment's largest force error against the direct sweep over the run
# may exceed the single run's by SEG_FORCE_MAX (the study: at most 1.05x);
# a walk from drifted tables has its largest error below MAX_TREE (the
# study: drifted 8.6e-3 to 1.6e-2, trees rebuilt there 4.5e-3 to 3.8e-2)
SEG_CAP, BOX_SEG_STEPS = 16, 3
SEG_DPOS, SEG_DVEL = 2e-3 / 4, 2e-3 / 0.1876
SEG_FLIPS, SEG_EDGE = 5e-4, 1e-2
SEG_FORCE_MAX, MAX_TREE = 1.5, 0.1
# phase 10: MAKEGLASS at 64^3 (counts in 32^3 cells, mean 8), FLEXSTEPS and
# PSEUDOSYMMETRIC on slice 1's IC, a TWODIMS LONG_X 2 gas sheet
GLASS_NSIDE, GLASS_CELLS, GLASS_STEPS = 64, 32, 5
MODE_STEPS = 5
SHEET_NX, SHEET_NY, SHEET_STEPS = 256, 128, 3
SHEET_NGB, SHEET_NGB_DEV = 20, 2
# phase 11: multi-device runs, 1 rank over NCCL and 2 over gloo on the one
# card.  A pass on 2 ranks against the single-device pass: RMS_DIST, JAX's
# LET-against-replicated bound (tests/test_parallel.py:643); the slab PM
# against the single-device PM: PM_SHARDED_TOL of max|a|
# (tests/test_parallel.py:183); both in float64: PM_F64_TOL (the float32
# difference is the FFTs' rounding; tests/test_torch_parallel_pm.py reads
# 1e-12 on the CPU)
DIST_STEPS, DIST_BOX_STEPS = 3, 1
# phase 12: multi-device gas on slice 3's box, DIST_GAS_STEPS steps; the
# first step against phase 6's within JAX's own bounds
# (tests/test_parallel.py:261-264): density and Hsml rtol 2e-3, hydro 3e-3
# of its largest |a|, gravity rms RMS_DIST
DIST_GAS_STEPS = 1
CLI_NSIDE = 32
RMS_DIST, PM_SHARDED_TOL, PM_F64_TOL = 2e-2, 2e-5, 1e-10
DIST_DEVICE, DIST_LAUNCHES = "cuda", ((1, "nccl"), (2, "gloo"))
# phase 13: the law matrix.  13a newton_yukawa and 13b bam with the
# accumulator on slice 1's IC, LAW_STEPS steps each; 13c the stock wiring
# in slice 4a's box (EWALD_STEPS steps) and 13d three species with gas in a
# TreePM box, LAW_BOX_STEPS steps
LAW_STEPS, LAW_BOX_STEPS = 2, 1
# phase 14: update_full_potential on each path's final state against the
# direct sum (float64).  Open boxes: the rms over each gravity's particles
# of |dpot| / |pot_direct| below RMS_POT_OPEN (the JAX bound,
# tests/test_tree.py:84; 13b's BAM targets below RMS_TREE, the bound of
# their forces).  Periodic boxes, on ORACLE_TARGETS targets against the sum
# with the lattice correction: per gravity d = pot - pot_direct, gated by
# rms(d - mean d) / rms(pot_direct).  The mean is removed because the JAX
# package has it too (tests/test_torch_potential.py: the port's mean
# equals JAX's): a constant a gravity, the long-range part's self term
# under TreePM, the Madelung term of a comoving box.  The bounds come from
# the JAX package on the CPU (tools/port_studies/potential_bounds.py, the
# same IC and settings at 2 x NSIDE^3, PMGRID 2 NSIDE; the measure depends
# on NSIDE alone): on the near-uniform lattices the pure-tree and the
# tabulated boxes' measure grows with NSIDE (the potential is a small
# remainder of the lattice's terms, the walk's far-field error is not),
# so each bound is 1.5 times the largest of three estimates of the value
# at side 64: the largest value measured (over gravities and sides), the
# side-32 value times its ratio to the side-16 one (64 is the next
# doubling), and the largest side's value carried to 64 by the power law
# through the running maxima at the two largest sides.  JAX's values, the
# larger gravity's, by side (--card-density; glass 20 without it):
#   box (slice 2)    12: 4.527e-4  16: 5.108e-4  32: 3.805e-4
#   tab (slice 4b)   12: 2.673e-9  16: 4.986e-8  24: 8.618e-7  32: 2.064e-6
#   ewald (4a)       12: 7.465e-3  16: 2.308e-2  20: 3.306e-2  24: 4.074e-3
#                    32: 4.956e-2  40: 7.177e-2
#   stock (13c)      12: 3.424e-2  16: 1.336e-1  20: 2.869e-1  24: 4.304e-2
#                    32: 8.275e-1  40: 1.891
#   glass (10a)      16: 2.268e-3  20: 2.335e-3  32: 2.306e-3


def _carried(v_a: float, v_b: float, side_a: int, side_b: int) -> float:
    """v_b carried from side_b to side 64 by the power law through
    (side_a, v_a) and (side_b, v_b)."""
    return v_b * (64 / side_b) ** (math.log(v_b / v_a)
                                   / math.log(side_b / side_a))


RMS_POT_OPEN = 1e-3
RMS_POT_BOX = 1.5 * 5.108e-4                        # the largest, side 16
RMS_POT_TABULATED = 1.5 * 2.064e-6 * 2.064e-6 / 4.986e-8   # 16 -> 32
RMS_POT_EWALD = {
    "newton_yukawa": 1.5 * _carried(4.956e-2, 7.177e-2, 32, 40),
    "newton": 1.5 * _carried(8.275e-1, 1.891, 32, 40)}
RMS_POT_GLASS = 1.5 * 2.306e-3 * 2.306e-3 / 2.268e-3       # 16 -> 32
# synthetic K1 instances: label -> (wiring, n_gravs, periodic, TreePM,
# accumulator); the synthetic box is SYN_BOX wide, TreePM at PMGRID 32
SYN_BOX = 100.0
K1_CASES = {
    "newton periodic": ("newton", 1, True, False, False),
    "newton periodic TreePM": ("newton", 1, True, True, False),
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
# phase 14's kernel entries, /pot launches by instance and seconds
PHASE14 = {"entries": [], "counts": {}, "seconds": 0.0}
# the single-device runs' numbers phase 11 compares with (phases 4 and 5)
SINGLE = {}
# the K1 launches of overflowing walk attempts held to the twin so far
OVERFLOW_CHECKED = {"launches": 0}
# K3's entries (slice 4a, phase 13c)
K3_ENTRIES = []


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
    cfg = SimulationConfig(n_gravs=ng,
                           type_to_grav=(0, 0, min(1, ng - 1), 0, 0, 0),
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
    by whether it lies inside the cut (counting them reads the card back a
    few times a slice of sources)."""
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
    for c0 in range(0, s, SCALE_SLICE):
        cs = slice(c0, c0 + SCALE_SLICE)
        sgid = sp[:, IGID, cs].view(torch.int32)[:, None, :]
        live = (torch.arange(c0, min(c0 + SCALE_SLICE, s),
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
                                                       want_pot, **kw), 3)
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


def record_largest(pairwise_eval, largest):
    """A pair evaluation that keeps in `largest`, per instance, a copy of
    the inputs (targets, sp, n_src, want_pot, kw) of its launch with the
    most source rows: sp's shape, known on the host, so recording reads
    nothing back from the card."""
    from ngravs_tpu_torch.ops.pairwise import instance_flags, instance_name

    def recording_eval(targets, sp, n_src, want_pot, **kw):
        name = instance_name(instance_flags(want_pot=want_pot, **kw))
        if name not in largest or sp.numel() > largest[name][1].numel():
            largest[name] = ({k: v.clone() for k, v in targets.items()},
                             sp.clone(), n_src.clone(), want_pot, kw)
        return pairwise_eval(targets, sp, n_src, want_pot, **kw)
    return recording_eval


def largest_launch(launched):
    """The recorded launch (targets, sp, n_src, want_pot, kw) with the most
    sources."""
    return max(launched, key=lambda a: int(a[2].sum()))


def check_largest_launch(label: str, launched):
    """K1 against the twin on the inputs of the launch with the most
    sources (a path's own shapes and data), with its n_src spread."""
    return check_launch_inputs(label, *largest_launch(launched),
                               len(launched))


def check_launch_inputs(label: str, targets, sp, n_src, want_pot, kw,
                        of: int):
    """K1 against the twin on one recorded launch's inputs, the largest
    of `of`, with its n_src spread."""
    ns = n_src.double()
    print(f"{label}: largest of {of} launches, {sp.shape[0]} "
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


def pass_solver(sim, cfg=None, wiring=None, launched=None, attempts=None):
    """A solver of its own for whole force passes at the current state, its
    caps settled by one pass; the run's solver is left as it is.  Each
    pass updates every particle, more than TreeDomainUpdateFrequency * N,
    so the next pass rebuilds the tree.  `cfg` and `wiring` replace the
    run's (phase 13b: the accumulator off).  With `launched` and
    `attempts` the settling pass records every K1 launch, those of
    attempts that overflowed and were thrown away included
    (`record_attempts`)."""
    from ngravs_tpu_torch.ops.solver import GravitySolver
    solver = GravitySolver(cfg or sim.cfg, wiring or sim.wiring,
                           sim.force_soft, sim.units.G,
                           hubble=sim.units.hubble, device=sim.device)
    if launched is None:
        solver.compute(all_active(sim), sim.ti_current, sim.p.n)
    else:
        with record_attempts(solver, launched, attempts):
            solver.compute(all_active(sim), sim.ti_current, sim.p.n)
    return solver


class record_attempts:
    """Within the block, `solver`'s K1 launches go to `launched` (as
    `record_launches`) and each walk attempt of its passes appends
    (first launch, end, overflowed, octet layout overflowed) to
    `attempts`: the solver throws an overflowing attempt's results away,
    grows its caps and walks again (`GravitySolver.compute`)."""

    def __init__(self, solver, launched, attempts):
        self.solver, self.launched, self.attempts = solver, launched, attempts

    def __enter__(self):
        solver, launched, attempts = self.solver, self.launched, self.attempts
        walk = type(solver)._walk
        self.pair_eval = solver.pair_eval
        solver.pair_eval = record_launches(solver.pair_eval, launched)

        def tagged_walk(want_pot):
            fn = walk(solver, want_pot)

            def run(*a, **kw):
                first = len(launched)
                res = fn(*a, **kw)
                attempts.append((first, len(launched), bool(res.overflow),
                                 bool(res.layout_ovf)))
                return res
            return run
        solver._walk = tagged_walk
        return self

    def __exit__(self, *exc):
        del self.solver._walk
        self.solver.pair_eval = self.pair_eval
        return False


def overflowing(attempts) -> int:
    """The recorded launches of the walk attempts that overflowed."""
    return sum(end - first for first, end, ovf, _ in attempts if ovf)


def settled_launches(launched, attempts):
    """The launches of the last walk attempt, the one whose results the
    solver kept."""
    first, end = attempts[-1][:2]
    return launched[first:end]


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
                 slab: float = 1.0):
    """Where a force pass's time goes: one full pass (and, `with_pm`, the
    PM forces) under torch.profiler: CUDA kernel count and device time,
    K1's share and, where the pass launched it, K3's (by kernel name: the
    profiler charged K3's launch through ctypes nothing of its device
    time to the `ngravs.walk.lattice` range around it).
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
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(RANGE_PREFIX)]
    k1 = [e for e in kern if "pairwise_kernel" in e.key]
    k3 = [e for e in kern if "lattice_kernel" in e.key]
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    k1_ms = sum(dev_us(e) for e in k1) / 1e3
    k3_ms = sum(dev_us(e) for e in k3) / 1e3
    shares = (f"; K3 {sum(e.count for e in k3)} launches, {k3_ms:.2f} ms "
              f"({k3_ms / max(busy_ms, 1e-9):.1%} of device time)"
              if k3 else "")
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


def k1_since(trace, before=None) -> dict:
    """K1's launches by instance in `trace` (`sim.trace`) since `before`,
    an earlier `instance_counts(trace)`."""
    from ngravs_tpu_torch.ops.pairwise import instance_counts
    before = before or {}
    return {k: v - before.get(k, 0)
            for k, v in instance_counts(trace).items()
            if v > before.get(k, 0)}


def run_path(sim, steps: int):
    """Drive `sim.run`; returns (steps, wall seconds, {instance: launches
    in the run})."""
    from ngravs_tpu_torch.ops.pairwise import instance_counts
    before = instance_counts(sim.trace)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sim.run(max_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return n, wall, k1_since(sim.trace, before)


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


def rel_errs(acc, acc_d):
    """|a - a_direct| / |a_direct| per particle (no floor above f32's
    normal range: a BAM target's pull is about 5e-6 of a baryon's on phase
    13b's IC)."""
    return torch.linalg.norm(acc - acc_d, dim=1) \
        / torch.clamp(torch.linalg.norm(acc_d, dim=1), min=1e-30)


def instance_launches(label: str, counts: dict, instance: str) -> int:
    """The launches of K1 instance `instance` (potential on or off) in a
    path's counts; none is an AssertionError."""
    n = sum(v for k, v in counts.items() if k.split("/")[0] == instance)
    if n <= 0:
        raise AssertionError(f"{label} never launched {instance}: {counts}")
    return n


def compare_launch(targets, sp, n_src, want_pot, kw):
    """K1 against the twin on one launch's inputs: acc and pot within
    RTOL_TERMS of each target's sum of |terms| (the twin's own terms),
    each value finite where the twin's is, pair counts equal.  Returns
    (the largest |acc| difference, the targets that fail [B*G] bool, a
    dict of both sides' outputs and the scales)."""
    from ngravs_tpu_torch.ops.pairwise import (pairwise_eval,
                                               pairwise_eval_torch)
    acc, pot, nia = pairwise_eval(targets, sp, n_src, want_pot, **kw)
    acc_t, pot_t, nia_t, scale = pairwise_eval_torch(
        targets, sp, n_src, want_pot, with_scale=True, **kw)
    err = (acc - acc_t).abs()
    bad = torch.any((err > RTOL_TERMS * scale[:, :3])
                    | (torch.isfinite(acc) != torch.isfinite(acc_t)), dim=1)
    if want_pot:
        bad |= ((pot - pot_t).abs() > RTOL_TERMS * scale[:, 3]) \
            | (torch.isfinite(pot) != torch.isfinite(pot_t))
    bad |= nia != nia_t
    return float(torch.nan_to_num(err, nan=0.0).max()), bad, dict(
        acc=acc, acc_t=acc_t, pot=pot, pot_t=pot_t, nia=nia, nia_t=nia_t,
        scale=scale)


def pair_terms(targets, sp, n_src, t: int, want_pot, kw, kernel: bool):
    """Target t's term from each of its block's first n_src source rows,
    each row evaluated alone: by the twin, or with `kernel` by K1 (each
    row a block of its own, the target in its 8 slots, the row padded to 4
    columns with gid -1).  Returns acc [n, 3], pot [n] and the pair counts
    [n]."""
    from ngravs_tpu_torch.ops.pairwise import (IGID, pairwise_eval,
                                               pairwise_eval_torch)
    nb = sp.shape[0]
    b = t // (targets["x"].shape[0] // nb)
    n = int(n_src[b])
    width, group = (4, 8) if kernel else (1, 1)
    one = torch.zeros(n, 8, width, dtype=torch.float32, device=sp.device)
    one[:, :, 0] = sp[b, :, :n].T
    one.view(torch.int32)[:, IGID, 1:] = -1
    tg = {k: v[t].reshape(1, 1).expand(n * group, 1).contiguous()
          for k, v in targets.items()}
    ns = torch.ones(n, 1, dtype=torch.int32, device=sp.device)
    fn = pairwise_eval if kernel else pairwise_eval_torch
    acc, pot, nia = fn(tg, one, ns, want_pot, **kw)
    return (acc.reshape(n, group, 3)[:, 0], pot.reshape(n, group)[:, 0],
            nia.reshape(n, group)[:, 0])


def describe_rows(targets, sp, n_src, t: int, want_pot, kw):
    """Target t's source rows, each evaluated alone by K1 and by the twin
    (`pair_terms`): their sums, then the rows of the largest terms and of
    the largest differences between the two."""
    from ngravs_tpu_torch.ops.pairwise import (FCOUNT, FMASS, FSOFT, IGID,
                                               IGRAV)
    b = t // (targets["x"].shape[0] // sp.shape[0])
    fmt = lambda v: "[" + ", ".join(f"{float(x):.7g}" for x in v) + "]"
    ka, kp, kn = pair_terms(targets, sp, n_src, t, want_pot, kw, True)
    ta, tp, tn = pair_terms(targets, sp, n_src, t, want_pot, kw, False)
    print(f"  row by row: K1 sums to acc {fmt(ka.sum(0))} pairs "
          f"{int(kn.sum())}, the twin to {fmt(ta.sum(0))} pairs "
          f"{int(tn.sum())}", flush=True)
    pos = torch.stack([targets[k][t, 0] for k in ("x", "y", "z")])
    blk = sp[b]
    sgid = blk[IGID].view(torch.int32)
    sgrav = blk[IGRAV].view(torch.int32)

    box = kw.get("box_size", 0.0)

    def rows(order, what):
        for q in order.tolist():
            d = blk[0:3, q] - pos
            if box > 0:
                d = d - box * torch.round(d * (1.0 / box))
            print(f"  {what} row {q}: gid {int(sgid[q])} grav "
                  f"{int(sgrav[q])} pos {fmt(blk[0:3, q])} mass "
                  f"{float(blk[FMASS, q]):.7g} soft {float(blk[FSOFT, q]):.7g}"
                  f" count {float(blk[FCOUNT, q]):.7g} |d| "
                  f"{float(torch.linalg.norm(d)):.7g}; K1 {fmt(ka[q])} "
                  f"{float(kp[q]):.7g} ({int(kn[q])}), twin {fmt(ta[q])} "
                  f"{float(tp[q]):.7g} ({int(tn[q])})", flush=True)
    k = min(5, len(ta))
    rows(torch.topk(torch.nan_to_num(ta.abs().sum(1), nan=1e30), k).indices,
         "largest term")
    diff = torch.nan_to_num((ka - ta).abs().sum(1) + (kp - tp).abs(),
                            nan=1e30) + (kn != tn) * 1e30
    rows(torch.topk(diff, k).indices, "largest K1 - twin")


def report_disagreement(label: str, i: int, launch, bad, out, tag: str,
                        save_dir: str, whole: bool = True) -> str:
    """Print what a launch that disagrees with the twin holds: its plan,
    the failing targets, and for the worst of them its block and row,
    n_src and S, the kernel's, the twin's and the scale's values, and the
    source rows of the largest terms and of the largest differences
    between K1 and the twin evaluating each row alone.  Saves the launch's
    inputs and outputs to `save_dir` (without `whole`, those of the blocks
    that disagree only, `blocks` naming them).  Returns a one-line
    summary."""
    from ngravs_tpu_torch.ops.pairwise import (instance_flags, instance_name,
                                               launch_plan)
    targets, sp, n_src, want_pot, kw = launch
    nb, _, s = sp.shape
    g = targets["x"].shape[0] // nb
    flags = instance_flags(want_pot=want_pot, **kw)
    plan = launch_plan(g, s, flags)
    scale = out["scale"]
    err = torch.cat([(out["acc"] - out["acc_t"]).abs(),
                     (out["pot"] - out["pot_t"]).abs()[:, None]], dim=1)
    ratio = torch.nan_to_num(err / scale.clamp(min=1e-30), nan=1e30)
    ratio = torch.where(bad[:, None], ratio, -1.0)
    if not want_pot:
        ratio[:, 3] = -1.0
    t = int(torch.argmax(ratio.amax(dim=1)))
    b, row = divmod(t, g)
    nbad = torch.nonzero(bad).squeeze(1)
    head = (f"{label}: launch {i} ({tag}) of {instance_name(flags)} "
            f"{tuple(sp.shape)} plan {plan._asdict()}: {len(nbad)} targets "
            f"in {len(torch.unique(nbad // g))} blocks disagree; worst "
            f"block {b} row {t - b * g} (gid {int(targets['gid'][t])}, grav "
            f"{int(targets['grav'][t])}), n_src {int(n_src[b])} of S {s}")
    print(head, flush=True)
    fmt = lambda v: "[" + ", ".join(f"{float(x):.7g}" for x in v) + "]"
    print(f"  kernel acc {fmt(out['acc'][t])} pot {float(out['pot'][t]):.7g}"
          f" pairs {int(out['nia'][t])}; twin acc {fmt(out['acc_t'][t])} pot"
          f" {float(out['pot_t'][t]):.7g} pairs {int(out['nia_t'][t])}; sums"
          f" of |terms| {fmt(scale[t])}", flush=True)
    if int(n_src[b]) > 0:
        describe_rows(targets, sp, n_src, t, want_pot, kw)
    os.makedirs(save_dir, exist_ok=True)
    slug = "".join(c if c.isalnum() else "_" for c in label)
    path = os.path.join(save_dir, f"k1_disagreement_{slug}_{i}.pt")
    blocks = torch.arange(nb, device=sp.device) if whole \
        else torch.unique(nbad // g)
    rows_of = (blocks[:, None] * g
               + torch.arange(g, device=sp.device)[None, :]).reshape(-1)
    cpu = lambda v, sel=rows_of: v[sel].detach().cpu()
    torch.save(dict(label=label, launch=i, tag=tag, plan=plan._asdict(),
                    blocks=blocks.cpu(),
                    targets={k: cpu(v) for k, v in targets.items()},
                    sp=cpu(sp, blocks), n_src=cpu(n_src, blocks),
                    want_pot=want_pot,
                    kw={k: v for k, v in kw.items() if k != "wiring"},
                    wiring=kw.get("wiring"), bad=cpu(bad),
                    out={k: cpu(v) for k, v in out.items()}), path)
    print(f"  inputs saved to {path}", flush=True)
    return (f"{head}; kernel acc {fmt(out['acc'][t])}, twin "
            f"{fmt(out['acc_t'][t])}, sums of |terms| {fmt(scale[t])}; "
            f"inputs in {path}")


def check_every_launch(label: str, launched, attempts=None):
    """Each recorded K1 launch against the twin on its own inputs
    (`compare_launch`).  `attempts` (`record_attempts`) tags each launch
    with its walk attempt; the line counts the launches of attempts that
    overflowed.  A launch that disagrees is described and its inputs saved
    under build/, then raises.  Returns the largest |acc| difference."""
    from ngravs_tpu_torch.ops.pairwise import instance_name, instance_flags
    tags = ["settled pass"] * len(launched)
    for k, (first, end, ovf, lovf) in enumerate(attempts or ()):
        what = (f"attempt {k + 1}, " + ("overflowed" + (
            ", octet layout" if lovf else "") if ovf else "settled"))
        tags[first:end] = [what] * (end - first)
    worst = 0.0
    names = set()
    for i, launch in enumerate(launched):
        targets, sp, n_src, want_pot, kw = launch
        err, bad, out = compare_launch(targets, sp, n_src, want_pot, kw)
        if bool(bad.any()):
            raise AssertionError("a K1 launch disagrees with the twin: "
                                 + report_disagreement(
                                     label, i, launch, bad, out, tags[i],
                                     os.path.join(ROOT, "build")))
        worst = max(worst, err)
        names.add(instance_name(instance_flags(want_pot=want_pot, **kw)))
    ovf = overflowing(attempts or ())
    OVERFLOW_CHECKED["launches"] += ovf
    print(f"{label}: all {len(launched)} K1 launches "
          f"({', '.join(sorted(names))}; {ovf} of them from walk attempts "
          f"that overflowed, {sum(1 for a in attempts or () if a[2])} of "
          f"{len(attempts or ())}) within {RTOL_TERMS:g} of their sums of "
          f"|terms| of the twin, pair counts equal, max|dacc| {worst:.3g}",
          flush=True)
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


def write_galaxy_collision(run_dir: str, seed: int = 7,
                           npart=NPART) -> str:
    """Two 30k Plummer galaxies (1e12 Msun, a = 10 kpc each) 100 kpc apart,
    closing at 300 km/s with a 20 kpc impact parameter (`npart`: other
    per-type counts, the same two galaxies); returns the parameterfile
    path."""
    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.io.gadget_format import (SnapshotData,
                                                   SnapshotHeader,
                                                   write_snapshot)
    from ngravs_tpu_torch.units import set_units
    g_int = set_units(SimulationConfig()).G
    rng = np.random.default_rng(seed)
    m_gal, a = 100.0, 10.0
    n = sum(npart)
    ptype = np.repeat(np.arange(6, dtype=np.int32), npart)
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
    h.npart = np.array(npart, np.int32)
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
    SINGLE["open"] = dict(rate=rate)
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
    rel = rel_errs(acc_t, acc_d)
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
    potential_pass(sim, card, "slice 1", "K1a/pot",
                   {"open": {0: RMS_POT_OPEN, 1: RMS_POT_OPEN}})
    sim.close()
    return launches, launched


def prebuild_lattice_tables():
    """The lattice tables of slice 2's box and wiring at its EN into the
    table cache, timed; every periodic path then loads them (the cache
    keys a table by law and EN, not by box)."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.models.wiring import build_wiring
    from ngravs_tpu_torch.ops import lattice
    run_dir = os.path.join(ROOT, "build", "chip_smoke_tables")
    os.makedirs(run_dir, exist_ok=True)
    cfg = read_parameter_file(write_cosmo_box(run_dir), n_gravs=2,
                              wiring="newton_yukawa")
    t0 = time.perf_counter()
    lattice.build_lattice_tables(build_wiring(cfg), cfg.ngravs_en,
                                 cfg.box_size)
    print(f"lattice tables EN={cfg.ngravs_en} (Newton, Yukawa): "
          f"{lattice.last_generator or 'from the cache'}, "
          f"{time.perf_counter() - t0:.1f} s on the host, beside phases "
          "3, 4 and 9", flush=True)


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

    # each step's timeline, for phase 11's runs of fewer steps
    syncs = []
    one_step = sim.step

    def step_and_record():
        one_step()
        syncs.append([sim.ti_current, sim.pm_ti_begstep, sim.pm_ti_endstep])
    sim.step = step_and_record
    steps, wall, counts = run_path(sim, BOX_STEPS)
    del sim.step
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
    SINGLE["box"] = dict(rate=sim.num_force_updates / wall, syncs=syncs)
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
    idx = oracle_targets(n, dev)
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
    SINGLE["box"]["pm_ms"] = pm_ms
    print(f"PM forces [{card}]: {pm_ms:.2f} ms (median of 5, CUDA events, "
          f"PMGRID {cfg.pmgrid}, interlaced, 2 source gravities); full "
          f"TreePM pass about {pass_s * 1e3 + pm_ms:.1f} ms", flush=True)
    # the targets of an eighth of the box: the profiler's processing of a
    # whole pass (179k kernels) took about 85 s on the H100's host
    profile_pass(sim, solver, card, "profiled TreePM pass (x < box/8)",
                 with_pm=True, slab=0.125)
    stamp("box path timed and profiled passes")
    potential_pass(sim, card, "slice 2 box", "K1bcd/pot",
                   {"periodic": RMS_POT_BOX})
    check_reproducible(sim, solver, cfg, dev, card, run_dir)
    return launches, launched


def check_reproducible(sim, solver, cfg, dev, card: str, run_dir: str):
    """Runs on the card repeat bit for bit (the tree's moments and PM's
    mass assignment are fixed-order sums): two full force passes (tree
    build, walk, PM) from one state; two REPRO_STEPS-step runs from one
    state, the run continued and the same steps resumed from a restart file
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
        r.run(max_steps=REPRO_STEPS)
    torch.cuda.synchronize()
    fields = ("pos", "vel", "accel", "accel_pm", "old_acc", "ti_endstep")
    if fresh.ti_current != sim.ti_current or not all(
            same(getattr(fresh.p, f), getattr(sim.p, f)) for f in fields):
        raise AssertionError("the resumed run differs from the continued "
                             "run")
    print(f"reproducible [{card}]: two full force passes (tree build, walk, "
          f"PM) bit-identical; {REPRO_STEPS} step(s) continued and the same "
          f"resumed "
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

def write_gas_box(run_dir: str, seed: int = 42, ns: int | None = None,
                  name: str = "gas_box", three: bool = False) -> str:
    """2 x ns^3 particles on jittered lattices (jitter 2% of the
    spacing; examples/cosmological_box.py:53-73): gas (type 0, gravity 0)
    with OmegaBaryon / Omega0 of the box mass and IC internal energy u = 1
    (km/s)^2, dark matter (type 1, gravity 1) half a cell off.  `three`
    adds a third lattice a quarter cell off (type 2, gravity 2) and splits
    the dark matter's mass evenly between types 1 and 2 (phase 13d).
    Masses match Omega0; file velocities are Gadget's.  Returns the
    parameterfile path."""
    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.io.gadget_format import (SnapshotData,
                                                   SnapshotHeader,
                                                   write_snapshot)
    from ngravs_tpu_torch.units import set_units
    omega0, omega_b, box = 0.3, 0.04, BOX_SIZE
    ns = ns or BOX_NSIDE
    units = set_units(SimulationConfig(comoving_integration=True))
    rng = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(*[np.arange(ns)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / ns * box
    n = len(g)
    gas = np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape), box)
    dm = [np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape)
                 + 0.5 * box / ns, box)]
    if three:
        dm.append(np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape)
                         + 0.25 * box / ns, box))
    k = 1 + len(dm)
    m_tot = omega0 * 3 * units.hubble ** 2 / (8 * math.pi * units.G) \
        * box ** 3
    m_gas = omega_b / omega0 * m_tot / n
    m_dm = (omega0 - omega_b) / omega0 * m_tot / n / len(dm)
    h = SnapshotHeader()
    h.npart = np.array([n] * k + [0] * (6 - k), np.int32)
    h.npart_total = h.npart.astype(np.uint32)
    h.mass = np.array([m_gas] + [m_dm] * len(dm) + [0.0] * (6 - k))
    h.time, h.redshift, h.box_size = 0.1, 9.0, box
    h.omega0, h.omega_lambda, h.hubble_param = omega0, 0.7, 0.7
    ic = os.path.join(run_dir, f"{name}.IC")
    write_snapshot(ic, SnapshotData(
        header=h, pos=np.concatenate([gas] + dm).astype(np.float32),
        vel=rng.normal(0, 1.0, (k * n, 3)).astype(np.float32),
        pid=np.arange(1, k * n + 1, dtype=np.uint32),
        mass=np.repeat(np.array([m_gas] + [m_dm] * len(dm), np.float32), n),
        ptype=np.repeat(np.arange(k, dtype=np.int32), n),
        u=np.ones(n, np.float32)))
    soft = box / ns / 30
    return write_param(os.path.join(run_dir, f"{name}.param"), {
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
        **({"SofteningDisk": soft} if three else {}),
        "GravityGas": 0, "GravityHalo": 1, "GravityDisk": 2 if three else 0,
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
    blocks (all gas active) from one tree and state: K2 on the card
    against its twin on the card and on the CPU (candidate lists equal on
    the card and the CPU, each output within RTOL_TERMS of its target's sum
    of |terms|, max_signal_vel, a maximum, within 1e-6 relative), each
    kernel's launch counted (`k2.density`, `k2.hydro`); then each kernel
    timed over every block (`time_sph_kernels`), and one of its timed
    outputs held to one of its twin's the same way.  Returns, a pass, the
    timing's numbers and the largest |K2 - twin| of the pass's checks."""
    from ngravs_tpu_torch.ops import sph as S
    from ngravs_tpu_torch.ops.tree import Octree
    from ngravs_tpu_torch.trace import Trace
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

    def gather(pairs, radius, tg=tgt, cpu=True):
        while True:
            g = S.make_sph_gather(depth, cfg.tree_bucket_size, hs.cand_cap,
                                  box_size=box, group_size=hs.group,
                                  pairs=pairs)
            on_card = g(tree, tg, radius)
            if not bool(on_card.overflow):
                break
            hs.cand_cap *= 2
        if not cpu:
            return on_card
        on_cpu = g(cpu_tree, tg.cpu(), radius.cpu())
        for name in ("cand", "n_cand", "overflow", "max_cand"):
            if not torch.equal(getattr(on_card, name).cpu(),
                               getattr(on_cpu, name)):
                raise AssertionError(f"SPH gather (pairs={pairs}): {name} "
                                     "differs between the card and the CPU")
        return on_card, on_cpu

    def compare(label, got, want, scales, maxed=()):
        for i, (g, w, sc) in enumerate(zip(got, want, scales)):
            err = (g.cpu() - w.cpu()).abs()
            if i in maxed:
                bad = ~(err <= 1e-6 * w.cpu().abs())
            else:
                bad = ~(err <= RTOL_TERMS * sc.cpu() + 1e-30)
            if bool(bad.any()):
                raise AssertionError(f"{label} output {i} off by "
                                     f"{float(err.max())}")
            key = f"{label}[{i}]"
            worst[key] = max(worst.get(key, 0.0), float(err.max()))

    def compare_all(label, fn, tg, cands, per_target, got, want, maxed=()):
        """`compare` over every block, the term scales in chunks of
        GAS_SAMPLE_BLOCKS blocks."""
        for b0 in range(0, tg.shape[0], GAS_SAMPLE_BLOCKS):
            sl = slice(b0, b0 + GAS_SAMPLE_BLOCKS)
            compare(label, [g[sl] for g in got], [w[sl] for w in want],
                    pair_term_scales(fn, tg[sl], cands.cand[sl],
                                     tuple(a[sl] for a in per_target)),
                    maxed)

    trace = Trace()
    cd, cc = gather(False, hsml_t)
    dens = lambda fn, tr, vel: lambda tg, c, h, v: fn(
        tr, tg, h, v, c, vel, box_size=box)
    with trace.span("check"):
        got = dens(S.density_pass, tree, vel_all)(tgt, cd, hsml_t,
                                                  vel_all[safe])
    twin = dens(S.density_pass_torch, tree, vel_all)
    scales = pair_term_scales(twin, tgt, cd.cand, (hsml_t, vel_all[safe]))
    compare("density K2 vs card twin", got,
            twin(tgt, cd, hsml_t, vel_all[safe]), scales)
    compare("density K2 vs CPU twin", got, dens(
        S.density_pass_torch, cpu_tree, vel_all.cpu())(
            tgt.cpu(), cc, hsml_t.cpu(), vel_all[safe].cpu()), scales)

    fields, facs = hs.hydro_inputs(tree, p, sim.sph, float(sim.tbi),
                                   sim.time)
    hd, hc = gather(True, fields[0][safe])
    hyd = lambda fn, tr, fl: lambda tg, c: fn(
        tr, tg, c, *fl, *facs, cfg.art_bulk_visc_const, box_size=box,
        use_limiter=not cfg.no_viscosity_limiter)
    with trace.span("check"):
        got = hyd(S.hydro_pass, tree, fields)(tgt, hd)
    twin = hyd(S.hydro_pass_torch, tree, fields)
    scales = pair_term_scales(twin, tgt, hd.cand)
    compare("hydro K2 vs card twin", got, twin(tgt, hd), scales,
            maxed=(2,))
    compare("hydro K2 vs CPU twin", got, hyd(
        S.hydro_pass_torch, cpu_tree, [f.cpu() for f in fields])(
            tgt.cpu(), hc), scales, maxed=(2,))
    if trace.prefixed("k2.") != {"density": 1, "hydro": 1}:
        raise AssertionError(f"the SPH passes on the card did not launch K2 "
                             f"once each: {trace.prefixed('k2.')}")
    print(f"SPH passes [{card}]: {GAS_SAMPLE_BLOCKS} sampled blocks of "
          f"{hs.group} targets, S = {cd.cand.shape[1]} (density, "
          f"{int(cd.max_cand)} max) and {hd.cand.shape[1]} (hydro, "
          f"{int(hd.max_cand)} max): candidate lists equal on the card and "
          f"the CPU; K2 launches {trace.prefixed('k2.')}; max |K2 - twin| "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f", each within {RTOL_TERMS:g} of its sum of |terms|",
          flush=True)

    radius = torch.where(tgt_all >= 0, sim.sph.hsml[order][
        tgt_all.clamp(min=0).long()], 0.0)
    cands = gather(False, radius, tgt_all, cpu=False)
    safe_all = tgt_all.clamp(min=0).long()
    per_target = (radius, vel_all[safe_all])
    timed = {}
    timed["density"], got, want = time_sph_kernels(
        "density", card, tree, tgt_all, cands, box,
        lambda fn: dens(fn, tree, vel_all), per_target, fields[0])
    compare_all("density K2 vs card twin, every block",
                dens(S.density_pass_torch, tree, vel_all), tgt_all, cands,
                per_target, got, want)
    cands = gather(True, fields[0][safe_all], tgt_all, cpu=False)
    timed["hydro"], got, want = time_sph_kernels(
        "hydro", card, tree, tgt_all, cands, box,
        lambda fn: hyd(fn, tree, fields), (), fields[0])
    compare_all("hydro K2 vs card twin, every block",
                hyd(S.hydro_pass_torch, tree, fields), tgt_all, cands, (),
                got, want, maxed=(2,))
    every = {k: v for k, v in worst.items() if "every block" in k}
    print(f"SPH passes [{card}], every block: {tgt_all.shape[0]} blocks; "
          "max |K2 - twin| " + ", ".join(f"{k} {v:.3g}"
                                         for k, v in every.items())
          + f", each within {RTOL_TERMS:g} of its sum of |terms|",
          flush=True)
    return {name: dict(nums, max_abs_err=max(
        v for k, v in worst.items() if k.startswith(name)))
        for name, nums in timed.items()}


# the fewest operations (each add, multiply, divide, sqrt, rint, min, max
# and compare one) K2's passes take, counted from csrc/sph.cu: a candidate
# of a target (displacement, r^2, the cut; PERIODIC the three minimum-image
# tests), a pair inside the kernel (density: sqrt, u, W and dW, the five
# sums; hydro: sqrt, both dW, the signal velocity, the viscosity with its
# limiter, the force and entropy sums); and the bytes of each particle's
# fields and each output row, read or written once
OPS_SPH_SLOT = {"density": 9, "hydro": 11}
OPS_SPH_PERIODIC = 3
OPS_SPH_PAIR = {"density": 48, "hydro": 70}
BYTES_SPH_PARTICLE = {"density": 28, "hydro": 60}
BYTES_SPH_TARGET = {"density": 4 + 16 + 12 + 28, "hydro": 4 + 20}
# K2's launches timed, and the twin's
K2_REPS, K2_TWIN_REPS = 5, 1


def sph_pair_counts(tree, tgt, cands, box, hsml_all, pairs: bool):
    """(candidate slots of valid targets, pairs inside the kernel) of one
    pass over every block: density r < h_i, hydro r < h_i or r < h_j (not
    self), as r^2 against h^2, in chunks of blocks."""
    slots = inside = 0
    nb, s = cands.cand.shape
    step = max(1, (1 << 26) // (tgt.shape[1] * s))
    for b0 in range(0, nb, step):
        t = tgt[b0:b0 + step]
        c = cands.cand[b0:b0 + step]
        live = (t >= 0)[:, :, None] & (c >= 0)[:, None, :]
        tp = tree.pos_s[t.clamp(min=0).long()]
        cp = tree.pos_s[c.clamp(min=0).long()]
        d = tp[:, :, None, :] - cp[:, None, :, :]
        for a, b in enumerate(box):
            if b > 0:
                d[..., a] -= b * torch.round(d[..., a] / b)
        r2 = (d * d).sum(-1)
        h_i = hsml_all[t.clamp(min=0).long()][:, :, None]
        near = r2 < h_i * h_i
        if pairs:
            h_j = hsml_all[c.clamp(min=0).long()][:, None, :]
            near = (near | (r2 < h_j * h_j)) & (t[:, :, None] != c[:, None, :])
        slots += int(live.sum())
        inside += int((near & live).sum())
    return slots, inside


def time_sph_kernels(name: str, card: str, tree, tgt, cands, box, pass_,
                     per_target, hsml_all):
    """One pass over every block of the gas (the cell's shapes): K2's time
    (median of K2_REPS launches, CUDA events) against its twin's on the
    card and against its bound, max(operations / PEAK_FP32, bytes /
    PEAK_BYTES), with the mean n_cand / S.  `pass_(fn)` is the pass through
    `fn`, taking (targets, candidates, *per_target).  Returns the numbers
    of the pass's kernel entry, and the last timed outputs of K2 and of its
    twin."""
    from ngravs_tpu_torch.ops import sph as S
    nb, s = cands.cand.shape
    kernel = S.density_pass if name == "density" else S.hydro_pass
    twin = S.density_pass_torch if name == "density" else S.hydro_pass_torch
    outs = {}

    def run(fn):
        outs[fn] = pass_(fn)(tgt, cands, *per_target)
    ms = cuda_ms(lambda: run(kernel), K2_REPS)
    twin_ms = cuda_ms(lambda: run(twin), K2_TWIN_REPS)
    slots, inside = sph_pair_counts(tree, tgt, cands, box, hsml_all,
                                    name == "hydro")
    periodic = sum(1 for b in box if b > 0) > 0
    ops = slots * (OPS_SPH_SLOT[name] + OPS_SPH_PERIODIC * periodic) \
        + inside * OPS_SPH_PAIR[name]
    n_targets = int((tgt >= 0).sum())
    nbytes = tree.mass_s.shape[0] * BYTES_SPH_PARTICLE[name] \
        + 4 * int(cands.n_cand.sum()) + n_targets * BYTES_SPH_TARGET[name]
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    fill = float(cands.n_cand.float().mean()) / s
    print(f"K2 {name} [{card}]: {nb} blocks of {tgt.shape[1]} targets "
          f"({n_targets} live), S = {s}, mean n_cand / S = {fill:.3f}, "
          f"{slots} candidate slots, {inside} pairs inside; kernel "
          f"{ms:.3f} ms (median of {K2_REPS}), twin {twin_ms:.1f} ms, bound "
          f"{bound:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}"
          f"), {100 * bound / ms:.2f}% of it; twin / kernel "
          f"{twin_ms / ms:.0f}x", flush=True)
    nums = {"ms": ms, "plain_ms": twin_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "plan": {"lanes": S.launch_lanes(tgt.shape[1]), "fill": fill}}
    return nums, outs[kernel], outs[twin]


def sph_entry(name: str, launches: int, nums: dict) -> dict:
    """K2's entry for the {"kernels": ...} line: the gas path's launches of
    the pass, and `check_sph_passes`' numbers for it."""
    return {"name": f"K2 {name} (gas path, all gas blocks)", "route": "cuda",
            "source": "ngravs_tpu_torch/csrc/sph.cu",
            "replaces": f"ngravs_tpu/ops/sph.py {name}_pass (no Pallas "
                        "kernel)",
            "launches": launches, "max_abs_err": nums["max_abs_err"],
            "ms": nums["ms"], "plain_ms": nums["plain_ms"],
            "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
            "library_ms": None, "plan": nums["plan"]}


def profile_gas_step(sim, card: str, launched):
    """One gas force computation (gravity, the density iteration and the
    hydro pass) for the particles of an eighth of the box (x < box/8:
    the profiler's processing of a whole step's 227k kernels took most of
    a minute and a half on the H100's host) under torch.profiler: CUDA
    kernels, the device's busy share, and K1's, the density passes' and
    the hydro pass's shares of device time (the `ngravs.sph.density` /
    `ngravs.sph.hydro` ranges).  Its K1 launches are kept in `launched`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ngravs_tpu_torch.ops.pairwise import pairwise_eval
    p0 = sim.p
    sim.p = p0.replace(ti_endstep=torch.where(
        p0.pos[:, 0] < 0.125 * sim.cfg.box_size, sim.ti_current,
        torch.clamp(p0.ti_endstep, min=sim.ti_current + 1)))
    sim.solver.pair_eval = record_launches(pairwise_eval, launched)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.compute_forces()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sim.solver.pair_eval = pairwise_eval
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    events = prof.key_averages()
    # kernels only: a record_function range has a device-side event too
    kern = [e for e in events
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(RANGE_PREFIX)]
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    k1_ms = sum(dev_us(e) for e in kern if "pairwise_kernel" in e.key) / 1e3
    rng_ms = {k: range_ms(prof, RANGE_PREFIX + k)
              for k in ("sph.density", "sph.hydro")}
    if busy_ms <= 0:
        print(f"profiled gas force pass (x < box/8) [{card}]: {wall_ms:.1f} "
              "ms wall; device "
              "time not measured (the profiler recorded none)", flush=True)
        return
    shares = ", ".join(
        f"{k} {v:.2f} ms ({v / busy_ms:.1%})" if v > 0
        else f"{k} not measured (no device time under the range)"
        for k, v in rng_ms.items())
    print(f"profiled gas force pass (x < box/8) [{card}]: {wall_ms:.1f} "
          f"ms wall (profiler "
          f"on), {sum(e.count for e in kern)} CUDA kernels, device busy "
          f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.1%} of the wall); K1 "
          f"{k1_ms:.2f} ms ({k1_ms / busy_ms:.1%} of device time); "
          f"{shares}", flush=True)


def check_gas_state(sim, card: str, label: str = "gas state"):
    """Slice 3's gates on the gas after a run: the weighted neighbour
    count of 99.9 % of the gas within DES_NGB +- NGB_DEV, the median
    density within 5 % of the mean, the hydro momentum rate below 1e-3 an
    axis, entropy finite and positive, every signal velocity positive, the
    particles' state finite."""
    cfg, n_gas = sim.cfg, sim.n_gas
    s, gas = sim.sph, slice(0, n_gas)
    wngb = s.num_ngb[gas]
    in_window = float(((wngb - DES_NGB).abs() <= NGB_DEV).double().mean())
    rho_mean = float(sim.p.mass[gas].double().sum()) / cfg.box_size ** 3
    rho_med = float(s.density[gas].double().median())
    ma = sim.p.mass[gas, None] * s.hydro_accel[gas]
    mom = (ma.sum(0).abs() / ma.abs().sum(0).clamp(min=1e-30)).tolist()
    ent, msv = s.entropy[gas], s.max_signal_vel[gas]
    print(f"{label} [{card}]: weighted neighbours within {DES_NGB} +- "
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
            raise AssertionError(f"non-finite {k}: {label}")


def gas_path(dev, card: str):
    """Slice 3's path; its K1 launch count, the inputs of every K1 launch
    of its profiled force computation, and K2's kernel entries."""
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

    # phase 12 starts its runs from this run's first smoothing length and
    # holds their first step to this run's
    h0 = float(sim.sph.hsml[0])
    first_path = os.path.join(run_dir, "first_step.npz")
    syncs = []
    k1_before = pairwise.instance_counts(sim.trace)
    sph_before = dict(sim.trace.counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(GAS_STEPS):
        before = dict(sim.cpu_timers, **sim.trace.counts)
        sim.run(max_steps=1)
        syncs.append([sim.ti_current, sim.pm_ti_begstep, sim.pm_ti_endstep])
        if k == 0:
            t_save = time.perf_counter()
            np.savez(first_path, pid=sim.p.pid.cpu().numpy(),
                     accel=(sim.p.accel + sim.p.accel_pm).cpu().numpy(),
                     **{f: getattr(sim.sph, f)[:n_gas].cpu().numpy()
                        for f in ("density", "hsml", "hydro_accel")})
            t0 += time.perf_counter() - t_save
        d = {k: v - before.get(k, 0)
             for k, v in dict(sim.cpu_timers, **sim.trace.counts).items()}
        print(f"gas step {sim.step_count} [{card}]: a={sim.time:.6g}, "
              f"{d.get('sph.density_iters', 0)} density iterations, cand_cap "
              f"{sim.hydro.cand_cap}, gravity {d['gravity']:.2f} s, hydro "
              f"{d['hydro']:.2f} s, PM {d['pm']:.2f} s, step "
              f"{d['total']:.2f} s", flush=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = k1_since(sim.trace, k1_before)
    launches = sum(counts.values())
    if sum(v for k, v in counts.items() if k.startswith("K1bcd")) <= 0:
        raise AssertionError(f"the gas path never launched the TreePM "
                             f"multi-law K1 instance: {counts}")
    SINGLE["gas"] = dict(rate=sim.num_force_updates / wall, syncs=syncs,
                         h0=h0, first=first_path)
    k2, sph_counts = ({k[len(pre):]: v - sph_before.get(k, 0)
                       for k, v in sim.trace.counts.items()
                       if k.startswith(pre)} for pre in ("k2.", "sph."))
    if k2.get("density", 0) != sph_counts.get("density_iters") \
            or k2.get("hydro", 0) != sph_counts.get("hydro_passes"):
        raise AssertionError(f"the gas path's SPH passes did not all go "
                             f"through K2: {k2} against {sph_counts}")
    print(f"gas path [{card}]: {GAS_STEPS} steps to a={sim.time:.6g}, "
          f"{sim.num_force_updates} particle-steps in {wall:.2f} s = "
          f"{sim.num_force_updates / wall:.1f} particle-steps/s, K1 "
          f"launches {counts}, SPH passes {sph_counts}, K2 launches {k2}, "
          f"PM window "
          f"({sim.pm_ti_begstep}, {sim.pm_ti_endstep}); host seconds by "
          "phase: " + ", ".join(f"{k} {v:.2f}"
                                for k, v in sim.cpu_timers.items()),
          flush=True)

    check_gas_state(sim, card)
    sph_entries = [sph_entry(name, k2.get(name, 0), nums)
                   for name, nums in check_sph_passes(sim, card).items()]

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
    return launches, launched, sph_entries


# --------------------------------------------------------------------------
# phase 7: slice 4a, the periodic pure-tree (Ewald) box
# --------------------------------------------------------------------------

def ewald_path(dev, card: str, wiring: str = "newton_yukawa",
               label: str = "Ewald path", instance: str = "K1bc",
               profile: bool = True):
    """Slice 4a's path: the box path's IC, cosmology, softening and
    `wiring` without PMGRID, the geometric opening criterion (theta 0.5),
    EWALD_STEPS steps with FORCETEST; then every K1 launch of a fresh
    solver's settling pass against the twin, the walk attempts that
    overflowed included.  Returns its K1 launch count, the inputs of the
    settled attempt's launches, and the largest |acc| difference of the
    pass's launches from the twin.  Phase 13c runs it with the
    stock wiring (one Newton law: K1c).  Then phase 14 on the final state
    (the instance with the potential, RMS_POT_EWALD[wiring])."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    from ngravs_tpu_torch.ops import lattice
    run_dir = os.path.join(ROOT, "build", "chip_smoke_ewald_" + wiring)
    os.makedirs(run_dir, exist_ok=True)
    ft_path = os.path.join(run_dir, "forcetest.txt")
    if os.path.exists(ft_path):
        os.remove(ft_path)
    # the geometric criterion: on a near-uniform lattice without a mesh
    # |a_old| is tiny, and the relative one opens almost every node
    cfg = read_parameter_file(write_cosmo_box(run_dir), n_gravs=2,
                              wiring=wiring, solver="tree",
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
    instance_launches(label, counts, instance)
    for k in ("pos", "vel", "accel"):
        if not bool(torch.isfinite(getattr(sim.p, k)).all()):
            raise AssertionError(f"non-finite {k}: {label}")
    mom = momentum_rate(sim.p.mass, sim.p.accel)
    print(f"{label} [{card}]: {steps} steps to a={sim.time:.6g}, "
          f"{sim.num_force_updates} particle-steps in {wall:.2f} s = "
          f"{sim.num_force_updates / wall:.1f} particle-steps/s (FORCETEST "
          f"included), K1 launches {counts}, set-up {init_s:.1f} s (lattice "
          f"tables EN={cfg.ngravs_en} "
          f"{lattice.last_generator or 'from the cache'}), tree depth "
          f"{sim.solver.depth}, walk caps {sim.solver.fcaps}, momentum rate "
          f"{mom:.2e}; host seconds by phase: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sim.cpu_timers.items()),
          flush=True)
    check_forcetest(label, ft_path, card, RMS_EWALD, steps, steps)
    if not mom < MOMENTUM_RATE:
        raise AssertionError(f"{label}: momentum rate {mom}")
    stamp(f"{label} run")

    k3 = sim.trace.counts.get("k3.lattice", 0)
    if k3 != sim.trace.counts.get("walk.batches", 0) or k3 == 0:
        raise AssertionError(f"{label}: {k3} K3 launches in "
                             f"{sim.trace.counts.get('walk.batches', 0)} "
                             "walk batches")
    launched, attempts, lattice_launched = [], [], []
    with record_lattice(lattice_launched):
        solver = pass_solver(sim, launched=launched, attempts=attempts)
    stamp(f"{label}: the settling pass recorded")
    worst = check_every_launch(f"{label} settling pass", launched, attempts)
    if len(lattice_launched) != len(launched):
        raise AssertionError(f"{label}: {len(lattice_launched)} K3 launches "
                             f"beside {len(launched)} of K1")
    K3_ENTRIES.append(lattice_entry(label, k3, check_every_lattice_launch(
        f"{label} settling pass", lattice_launched, attempts, card)))
    del lattice_launched
    stamp(f"{label}: every launch against the twin")
    if profile:
        # the targets of a sixteenth of the box: the profiler's processing
        # of a whole pass (321k kernels) took about 200 s on the H100's host
        profile_pass(sim, solver, card, "profiled Ewald pass (x < box/16)",
                     slab=0.0625)
    potential_pass(sim, card, label, instance + "/pot",
                   {"periodic": RMS_POT_EWALD[wiring]})
    sim.close()
    return launches, settled_launches(launched, attempts), worst


# K3, the lattice pass on the card (csrc/lattice.cu): the fewest
# operations a valid pair takes without the potential (each add, multiply,
# compare, absolute value and rounding one; portbench/lattice_roofline.py
# holds the benchmark's frozen copy), and its timed repetitions
OPS_LATTICE = 96
K3_REPS, K3_TWIN_REPS = 5, 1


class record_lattice:
    """Within the block, every lattice pass the walk makes keeps its inputs
    and its outputs in `launched`: (targets, sp, n_src, tables, n_gravs,
    box, want_pot, acc, pot).  The walk launches K3 once a batch, beside
    K1, so `record_attempts`' launch ranges index these too."""

    def __init__(self, launched):
        self.launched = launched

    def __enter__(self):
        from ngravs_tpu_torch.ops import walk as twalk
        self.real = real = twalk.lattice_pass

        def recording(targets, sp, n_src, tables, n_gravs, box, want_pot=True,
                      corners=None):
            acc, pot = real(targets, sp, n_src, tables, n_gravs, box,
                            want_pot, corners=corners)
            self.launched.append((targets, sp, n_src, tables, n_gravs, box,
                                  want_pot, acc, pot))
            return acc, pot
        twalk.lattice_pass = recording
        return self

    def __exit__(self, *exc):
        from ngravs_tpu_torch.ops import walk as twalk
        twalk.lattice_pass = self.real
        return False


def lattice_terms(targets, sp, n_src, tables, n_gravs: int, box: float):
    """The twin's sums (acc [B*G, 3], pot [B*G]) of one lattice pass and,
    per target, its valid pairs and the sums of |term| of the three force
    components and the potential ([B*G, 4]), on the tensors' device."""
    from ngravs_tpu_torch.ops import lattice as tlat
    from ngravs_tpu_torch.ops import walk as twalk
    from ngravs_tpu_torch.ops.pairwise import FMASS, IGRAV
    nb, _, s = sp.shape
    g = targets["x"].shape[0] // nb
    corners = tlat.corner_table(tables)
    acc, pot = twalk.lattice_pass_torch(targets, sp, n_src, tables, n_gravs,
                                        box, True, corners=corners)
    scale = torch.zeros(nb, g, 4, device=sp.device)
    pairs = torch.zeros(nb, g, dtype=torch.int64, device=sp.device)
    fac_intp = 2 * (tables.shape[1] - 1) / box
    for sl in twalk._block_chunks(nb, s, g, None):
        spc = sp[sl]
        col, valid, d = twalk._pair_geometry(targets, spc, sl, n_src, g, box)
        pidx = col("grav") * n_gravs \
            + spc[:, IGRAV, :].view(torch.int32)[:, None, :]
        fc = tlat.lattice_correction(tables, fac_intp, *d, pidx, corners)
        sm = spc[:, None, FMASS, :]
        scale[sl] = torch.stack([torch.where(valid, (sm * f).abs(), 0.0)
                                 .sum(-1) for f in fc], dim=-1)
        pairs[sl] = valid.sum(-1)
    return acc, pot, scale.reshape(nb * g, 4), pairs.reshape(nb * g)


def check_every_lattice_launch(label: str, launched, attempts=None,
                               card: str = "") -> dict:
    """Each recorded K3 launch (`record_lattice`) against the twin on its
    own inputs: its output as the walk received it, and K3 launched again
    with the potential on and off, each component within RTOL_TERMS of its
    target's sum of |terms|.  `attempts` (`record_attempts`, whose launch
    ranges index K3's launches too) counts those of attempts that
    overflowed.  Then the largest launch timed, K3 against the twin.
    Raises on a launch that disagrees; returns the largest's numbers."""
    from ngravs_tpu_torch.ops import walk as twalk
    from ngravs_tpu_torch.ops.lattice import k3_lanes, lattice_eval_cuda
    worst, pairs_of = 0.0, []
    for i, (targets, sp, n_src, tables, ng, box, want_pot, acc, pot) \
            in enumerate(launched):
        t_acc, t_pot, scale, pairs = lattice_terms(targets, sp, n_src,
                                                   tables, ng, box)
        pairs_of.append(int(pairs.sum()))
        outs = [(f"the walk's (potential {'on' if want_pot else 'off'})",
                 acc, pot if want_pot else None)]
        for on in (False, True):
            a2, p2 = lattice_eval_cuda(targets, sp, n_src, tables, ng, box,
                                       on)
            outs.append((f"again (potential {'on' if on else 'off'})", a2,
                         p2 if on else None))
        tol = RTOL_TERMS * scale + 1e-30
        for what, a, p in outs:
            d = (a - t_acc).abs()
            bad = d > tol[:, :3]
            if p is not None:
                bad = torch.cat([bad, ((p - t_pot).abs() > tol[:, 3])[:, None]],
                                dim=1)
            if bool(bad.any()):
                rows = torch.nonzero(bad.any(dim=1)).squeeze(1)[:5].tolist()
                pots = "" if p is None else (
                    f"; potential kernel {p[rows].tolist()}, twin "
                    f"{t_pot[rows].tolist()}")
                raise AssertionError(
                    f"{label}: K3 launch {i} ({what}) disagrees with the twin "
                    f"on targets {rows}: kernel {a[rows].tolist()}, twin "
                    f"{t_acc[rows].tolist()}{pots}; sums of |terms| "
                    f"{scale[rows].tolist()}")
            worst = max(worst, float(d.max()) if d.numel() else 0.0)
    ovf = overflowing(attempts or ())
    print(f"{label}: all {len(launched)} K3 launches ({ovf} of them from walk "
          f"attempts that overflowed), potential off and on, within "
          f"{RTOL_TERMS:g} of their sums of |terms| of the twin; "
          f"{sum(pairs_of)} valid pairs; max|dacc| {worst:.3g}", flush=True)
    # the largest launch timed: K3 against the twin, in turns
    big = max(range(len(launched)), key=pairs_of.__getitem__)
    targets, sp, n_src, tables, ng, box = launched[big][:6]
    pairs = pairs_of[big]
    ms = cuda_ms(lambda: twalk.lattice_pass(targets, sp, n_src, tables, ng,
                                            box, False), K3_REPS)
    twin_ms = cuda_ms(lambda: twalk.lattice_pass_torch(
        targets, sp, n_src, tables, ng, box, False), K3_TWIN_REPS)
    bound = pairs * OPS_LATTICE / PEAK_FP32 * 1e3
    nb = sp.shape[0]
    print(f"K3 [{card}] {label}, largest launch: {nb} blocks of "
          f"{targets['x'].shape[0] // nb} targets, S = {sp.shape[2]}, "
          f"{pairs} valid pairs; kernel {ms:.3f} ms (median of {K3_REPS}), "
          f"twin {twin_ms:.1f} ms, bound {bound:.4f} ms (operations), "
          f"{100 * bound / ms:.2f}% of it; twin / kernel "
          f"{twin_ms / ms:.0f}x", flush=True)
    return {"ms": ms, "plain_ms": twin_ms, "bound_ms": bound,
            "bound_by": "operations", "max_abs_err": worst,
            "plan": {"lanes": k3_lanes(targets["x"].shape[0] // nb),
                     "pairs": pairs}}


def lattice_entry(label: str, launches: int, nums: dict) -> dict:
    """K3's entry for the {"kernels": ...} line."""
    return {"name": f"K3 lattice pass ({label})", "route": "cuda",
            "source": "ngravs_tpu_torch/csrc/lattice.cu",
            "replaces": "ngravs_tpu/ops/walk.py lattice pass (no Pallas "
                        "kernel)",
            "launches": launches, "max_abs_err": nums["max_abs_err"],
            "ms": nums["ms"], "plain_ms": nums["plain_ms"],
            "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
            "library_ms": None, "plan": nums["plan"]}


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
    potential_pass(sim, card, "tabulated TreePM path", None,
                   {"periodic": RMS_POT_TABULATED})
    sim.close()


# --------------------------------------------------------------------------
# phase 9: segments against single stepping
# --------------------------------------------------------------------------

def count_host_syncs(fn):
    """fn() with CUDA's sync debug mode on: the number of operations that
    made the host wait for the card."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def drive(sim, steps: int):
    """`step()` until `steps` sync points; returns (calls, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls = 0
    while sim.step_count < steps:
        sim.step()
        calls += 1
    torch.cuda.synchronize()
    return calls, time.perf_counter() - t0


def bin_edge_distance(sim) -> torch.Tensor:
    """Each particle's distance in log2 from a timestep-bin edge: its
    wanted dt over the timebase interval, from the state of its last
    kick (the step is the power-of-two floor of that ratio)."""
    from ngravs_tpu_torch.integrate.kdk import compute_timestep_dt
    dt = compute_timestep_dt(sim.cfg, sim.p, sim.dt_displacement,
                             sim._soft_t, sim._cosmo()).double()
    lg = torch.log2(dt / sim.tbi)
    return (lg - torch.round(lg)).abs()


def direct_rel_err(sim, idx) -> torch.Tensor:
    """Relative error of the stored accelerations of particles `idx`
    against the direct sweep at the current positions (right for particles
    whose forces were computed at this sync point)."""
    from ngravs_tpu_torch.ops.direct import direct_forces
    p = sim.p
    fsoft = torch.as_tensor(sim.force_soft, device=p.device)[p.ptype.long()]
    acc_d, _ = direct_forces(sim.wiring, p.pos, p.mass, p.grav, fsoft,
                             tgt_idx=idx.to(torch.int32), chunk=1024,
                             want_pot=False)
    acc_d = acc_d * sim.units.G
    return torch.linalg.norm(p.accel[idx] - acc_d, dim=1) \
        / torch.clamp(torch.linalg.norm(acc_d, dim=1), min=1e-30)


def record_tree_modes(sim):
    """Wrap `sim._tree_maintain` to record each segment step's tree mode
    (0 drift, 1 refresh, 2 rebuild; the call that builds a segment's first
    tree passes no tree and is not a step), and the state, tree and tables
    of the last drift step.  Returns (modes, [state, (tree, tables)])."""
    modes, drifted = [], []
    maintain = sim._tree_maintain

    def spy(p, mode, tree, wt, dd):
        out = maintain(p, mode, tree, wt, dd)
        if tree is not None:
            modes.append(mode)
            if mode == 0:
                drifted[:] = [p, out]
        return out
    sim._tree_maintain = spy
    return modes, drifted


def compare_state(single, seg, with_pm: bool, near, flipped,
                  forces: bool) -> dict:
    """Two runs at one sync point: the timeline (and PM window), the
    particles whose step histories parted (another ti_endstep or
    ti_begstep: another bin now, or since the last comparison) and the
    least bin-edge distance of their kicks in the single run since the
    runs last agreed on them (`near`, updated by the caller),
    positions over the extent and velocities over their largest magnitude,
    and (`forces`, for an open box) the forces of the particles that both
    runs kicked here: each run's error against the direct sweep, the runs'
    relative difference, and the particle where that difference is
    largest (|a| over the median |a|, whether it was ever in another
    bin)."""
    same = (single.step_count, single.ti_current) == \
        (seg.step_count, seg.ti_current)
    if with_pm:
        same = same and (single.pm_ti_begstep, single.pm_ti_endstep) == \
            (seg.pm_ti_begstep, seg.pm_ti_endstep)
    parted = (single.p.ti_endstep != seg.p.ti_endstep) \
        | (single.p.ti_begstep != seg.p.ti_begstep)
    diff = torch.nonzero(parted).squeeze(1)
    flipped[diff] = True
    ext = float((single.p.pos.amax(0) - single.p.pos.amin(0)).max())
    r = dict(sync=seg.step_count, same=same, n_diff=int(diff.numel()),
             edge=float(near[diff].max()) if diff.numel() else 0.0,
             dpos=float((single.p.pos - seg.p.pos).abs().max()) / ext,
             dvel=float((single.p.vel - seg.p.vel).abs().max())
             / float(single.p.vel.abs().max()))
    kicked = (single.p.ti_begstep == single.ti_current) \
        & (seg.p.ti_begstep == seg.ti_current)
    idx = torch.nonzero(kicked).squeeze(1)
    r["n_kicked"] = int(idx.numel()) if forces else 0
    if r["n_kicked"]:
        e1, e2 = direct_rel_err(single, idx), direct_rel_err(seg, idx)
        a1, a2 = single.p.accel[idx], seg.p.accel[idx]
        amag = torch.linalg.norm(a1, dim=1)
        dacc = torch.linalg.norm(a1 - a2, dim=1) \
            / torch.clamp(amag, min=1e-30)
        k = int(torch.argmax(dacc))
        r.update(
            err_single=(float(torch.sqrt(torch.mean(e1 * e1))),
                        float(e1.max())),
            err_seg=(float(torch.sqrt(torch.mean(e2 * e2))), float(e2.max())),
            dacc=float(dacc[k]),
            worst=dict(particle=int(idx[k]),
                       a_over_median=float(amag[k] / torch.median(amag)),
                       ever_flipped=bool(flipped[idx[k]]),
                       err_single=float(e1[k]), err_seg=float(e2[k])))
    # the largest difference over all particles, whenever computed
    amag_all = torch.linalg.norm(single.p.accel, dim=1)
    d_all = torch.linalg.norm(single.p.accel - seg.p.accel, dim=1) \
        / torch.clamp(amag_all, min=1e-30)
    k = int(torch.argmax(d_all))
    r["dacc_all"] = (float(d_all[k]), dict(
        particle=k, same_kick=bool(single.p.ti_begstep[k]
                                   == seg.p.ti_begstep[k]),
        ever_flipped=bool(flipped[k]),
        a_over_median=float(amag_all[k] / torch.median(amag_all))))
    return r


def segment_pair(label: str, make, steps: int, cap: int, card: str,
                 with_pm: bool, exact: bool, gates: bool = True):
    """A run with `segment_steps=cap` and the same IC single-stepped, in
    lockstep: after each `step()` call of the segmented run the single one
    catches up to the same sync point, one sync point a `step()`, and the
    two are compared (`compare_state`).  Gates at every comparison: the
    same sync points (and PM window); positions over the extent and
    velocities over their largest magnitude within the CPU test's
    tolerance (SEG_DPOS, SEG_DVEL); on an open box (not `with_pm`), on the
    particles both runs kicked there, the segment's forces against the
    direct sweep with an rms below RMS_TREE, and over the run a largest
    error within SEG_FORCE_MAX of the single run's.  `exact`: every
    particle's ti_endstep and ti_begstep and the force updates equal too.
    Otherwise a particle may take another timestep bin when the tree
    maintenance moves its force across a bin edge: at most SEG_FLIPS of N
    with parted histories at a comparison, and each of them, whenever
    seen, had a kick within SEG_EDGE (log2) of an edge in the single run
    since the two runs last agreed on it.  A particle that parts and
    rejoins (the same last kick again) between two comparisons shows
    only in positions and velocities.  Prints both
    rates, the segments' counts, the tree modes and the host syncs a
    segment step (a third run's first segment, under CUDA's sync debug
    mode).  `gates=False` prints every comparison and raises on none.
    Returns the segmented run, its K1 counts, the state, tree and tables
    of its last drift step, and the comparisons."""
    from ngravs_tpu_torch.ops import pairwise
    seg, single = make(cap), make(1)
    modes, drifted = record_tree_modes(seg)
    n = seg.p.n
    near = torch.full((n,), math.inf, dtype=torch.float64,
                      device=seg.p.pos.device)
    flipped = torch.zeros(n, dtype=torch.bool, device=seg.p.pos.device)
    wall_b = wall_a = 0.0
    calls = 0
    k1_before = pairwise.instance_counts(seg.trace)
    rows = []
    while seg.step_count < steps:
        k, w = drive(seg, seg.step_count + 1)
        calls, wall_b = calls + k, wall_b + w
        while single.step_count < seg.step_count:
            wall_a += drive(single, single.step_count + 1)[1]
            kicked = single.p.ti_begstep == single.ti_current
            near = torch.where(kicked, torch.minimum(near,
                                                     bin_edge_distance(single)),
                               near)
        r = compare_state(single, seg, with_pm, near, flipped,
                          not with_pm)
        rows.append(r)
        if not gates:
            print(f"{label} cap {cap} comparison: {r}", flush=True)
        bad = not r["same"] or r["dpos"] > SEG_DPOS or r["dvel"] > SEG_DVEL
        if r["n_kicked"]:
            bad = bad or not r["err_seg"][0] < RMS_TREE
        if exact:
            bad = bad or r["n_diff"] or \
                single.num_force_updates != seg.num_force_updates
        else:
            bad = bad or r["n_diff"] > SEG_FLIPS * n or r["edge"] > SEG_EDGE
        if bad and gates:
            raise AssertionError(
                f"{label}: at sync point {seg.step_count}: {r}; force "
                f"updates {single.num_force_updates} single vs "
                f"{seg.num_force_updates} segmented")
        # a particle the runs agree on starts a new history
        agree = (single.p.ti_endstep == seg.p.ti_endstep) \
            & (single.p.ti_begstep == seg.p.ti_begstep)
        near = torch.where(agree, math.inf, near)
    counts = k1_since(seg.trace, k1_before)
    probe = make(cap)
    probe.step()
    before = probe.step_count
    syncs = count_host_syncs(probe.step)
    per_step = syncs / max(probe.step_count - before, 1)
    probe.close()
    with_kicks = [r for r in rows if r["n_kicked"]]
    worst = max(with_kicks, key=lambda r: r["dacc"]) if with_kicks else None
    print(f"{label} [{card}]: {seg.step_count} sync points to "
          f"t={seg.time:.6g}; segmented {seg.num_force_updates} particle-"
          f"steps in {wall_b:.2f} s = {seg.num_force_updates / wall_b:.1f} "
          f"particle-steps/s over {calls} step() calls "
          f"({seg.trace.prefixed('segment.')}), "
          f"single-stepped {single.num_force_updates} in {wall_a:.2f} s = "
          f"{single.num_force_updates / wall_a:.1f} particle-steps/s; host "
          f"syncs a segment step {per_step:.1f} ({syncs} in a segment of "
          f"{probe.step_count - before} steps; the loop's own reads "
          f"{seg.trace.counts.get('segment.host_reads', 0)} in "
          f"{seg.trace.counts.get('segment.steps', 0)} "
          f"steps); K1 launches segmented {counts}; tree modes (drift, "
          f"refresh, build) "
          + "".join("dfb"[m] for m in modes), flush=True)
    print(f"{label} vs single stepping [{card}]: {len(rows)} comparisons, "
          f"the same sync points{' and PM window' if with_pm else ''} at "
          f"each; step histories parted for at most "
          f"{max(r['n_diff'] for r in rows)} particles at a comparison "
          f"({int(flipped.sum())} ever), their least bin-edge distance "
          f"since agreeing at most "
          f"{max(r['edge'] for r in rows):.3e} (log2); max|dpos| / extent "
          f"{max(r['dpos'] for r in rows):.3e}, max|dvel| / max|v| "
          f"{max(r['dvel'] for r in rows):.3e}" + (
              f"; forces of the particles kicked at a comparison vs "
              f"direct, rms / max, segmented "
              f"{max(r['err_seg'][0] for r in with_kicks):.3e} / "
              f"{max(r['err_seg'][1] for r in with_kicks):.3e}, single "
              f"{max(r['err_single'][0] for r in with_kicks):.3e} / "
              f"{max(r['err_single'][1] for r in with_kicks):.3e}; largest "
              f"relative force difference between the runs "
              f"{worst['dacc']:.3e} at sync point {worst['sync']} "
              f"({worst['worst']})" if worst else "")
          + f"; over every particle, the accelerations perhaps from "
          f"different kicks, largest relative difference "
          f"{max(r['dacc_all'][0] for r in rows):.3e} "
          f"({max(rows, key=lambda r: r['dacc_all'][0])['dacc_all'][1]})",
          flush=True)
    single.close()
    if with_kicks and gates and max(r["err_seg"][1] for r in with_kicks) \
            > SEG_FORCE_MAX * max(r["err_single"][1] for r in with_kicks):
        raise AssertionError(f"{label}: the segment's largest force error "
                             "exceeds SEG_FORCE_MAX x the single run's")
    return seg, counts, drifted, rows


def drifted_pass(sim, drifted, card: str, gates: bool = True):
    """One full walk from the last drift-mode step's tree and packed
    tables (the state mid-cadence: node CMs and source rows drifted since
    their last re-aggregation) and one from a tree rebuilt at the same
    positions, each against the direct sweep there.  Gates: the drifted
    pass's rms below RMS_TREE and its largest error below MAX_TREE
    (`gates=False`: none).  Returns both (rms, max)
    pairs."""
    from ngravs_tpu_torch.ops.direct import direct_forces
    p, (tree, wt) = drifted
    solver = sim.solver
    walk = solver._walk(want_pot=False)
    opening = "relative" if sim.cfg.type_of_opening_criterion == 1 else "bh"
    fsoft = torch.as_tensor(sim.force_soft, device=p.device)[p.ptype.long()]
    acc_d, _ = direct_forces(sim.wiring, p.pos, p.mass, p.grav, fsoft,
                             chunk=1024, want_pot=False)
    acc_d = acc_d * solver.G
    errs = []
    for t, w in ((tree, wt), sim._tree_maintain(p, 2, None, None, None)):
        res = walk(t, torch.arange(p.n, device=p.device),
                   opening_override=opening, tables=w)
        if bool(res.overflow):
            raise AssertionError("the drifted-tables pass overflowed")
        acc = torch.empty_like(p.accel)
        acc[t.order.long()] = res.acc * solver.G
        rel = torch.linalg.norm(acc - acc_d, dim=1) \
            / torch.clamp(torch.linalg.norm(acc_d, dim=1), min=1e-12)
        errs.append((float(torch.sqrt(torch.mean(rel * rel))),
                     float(rel.max())))
    (rms, mx), (rms_b, mx_b) = errs
    print(f"drifted-tables pass [{card}]: {p.n} targets from the segment's "
          f"last drift step, rel err vs direct rms {rms:.3e} max {mx:.3e}; "
          f"a tree rebuilt there rms {rms_b:.3e} max {mx_b:.3e}",
          flush=True)
    if gates and (not rms < RMS_TREE or not mx < MAX_TREE):
        raise AssertionError(f"drifted-tables pass: rms {rms}, max {mx} "
                             f"against the rebuilt tree's {mx_b}")
    return errs


def open_box_segments(dev, card: str, seed: int = 7, cap: int = SEG_CAP,
                      gates: bool = True):
    """Phase 9a: slice 1's open box (IC seed `seed`) with segments of up to
    `cap` sync points against single stepping over SEG_STEPS sync points,
    then the drifted-tables pass.  Returns the comparisons."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    run_dir = os.path.join(ROOT, "build", "chip_smoke_segments", str(seed))
    os.makedirs(run_dir, exist_ok=True)
    cfg = read_parameter_file(write_galaxy_collision(run_dir, seed),
                              direct_crossover=1000, tree_depth=12)
    make_galaxy = lambda k: Simulation(
        cfg, device=dev, segment_steps=k,
        log_dir=os.path.join(run_dir, f"galaxy_{k}"))
    seg, counts, drifted, rows = segment_pair(
        f"segments, open box (seed {seed}, cap {cap})", make_galaxy,
        SEG_STEPS, cap, card, False, False, gates)
    if counts.get("K1a", 0) <= 0 or not drifted:
        raise AssertionError("the open box's segments launched no K1a or "
                             "took no drift step")
    errs = drifted_pass(seg, drifted, card, gates)
    seg.close()
    return rows, errs


def segment_paths(dev, card: str):
    """Phase 9: slice 1's open box and the box path's TreePM box, each
    segmented and single-stepped from the same IC."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    open_box_segments(dev, card)
    stamp("phase 9a (open-box segments)")

    run_dir = os.path.join(ROOT, "build", "chip_smoke_segments")
    box_dir = os.path.join(run_dir, "box")
    os.makedirs(box_dir, exist_ok=True)
    box_cfg = read_parameter_file(write_cosmo_box(box_dir),
                                  pmgrid=BOX_PMGRID, n_gravs=2,
                                  wiring="newton_yukawa", pm_interlace=True)
    make_box = lambda cap: Simulation(
        box_cfg, device=dev, segment_steps=cap,
        log_dir=os.path.join(box_dir, f"run_{cap}"))
    # the first sync point is a general step, the next two one segment
    seg, counts, _, _ = segment_pair("segments, TreePM box", make_box,
                                     BOX_SEG_STEPS, BOX_SEG_STEPS - 1, card,
                                     True, True)
    if sum(v for k, v in counts.items() if k.startswith("K1bcd")) <= 0:
        raise AssertionError("the box's segments launched no K1bcd")
    stamp("phase 9b (TreePM-box segments)")


# --------------------------------------------------------------------------
# phase 10: the integrator's special modes
# --------------------------------------------------------------------------

def write_glass_box(run_dir: str, seed: int = 5) -> str:
    """GLASS_NSIDE^3 particles uniform at random in the box path's box
    (Omega0 1, OmegaLambda 0: tests/test_parallel.py:709-713), all of type
    1 (gravity 0, the stock all-Newton wiring); returns the
    parameterfile."""
    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.io.gadget_format import (SnapshotData,
                                                   SnapshotHeader,
                                                   write_snapshot)
    from ngravs_tpu_torch.units import set_units
    box, n = BOX_SIZE, GLASS_NSIDE ** 3
    units = set_units(SimulationConfig(comoving_integration=True))
    rng = np.random.default_rng(seed)
    m = 3 * units.hubble ** 2 / (8 * math.pi * units.G) * box ** 3 / n
    h = SnapshotHeader()
    h.npart = np.array([0, n, 0, 0, 0, 0], np.int32)
    h.npart_total = h.npart.astype(np.uint32)
    h.mass = np.array([0.0, m, 0.0, 0.0, 0.0, 0.0])
    h.time, h.redshift, h.box_size = 0.1, 9.0, box
    h.omega0, h.omega_lambda, h.hubble_param = 1.0, 0.0, 0.7
    ic = os.path.join(run_dir, "glass.IC")
    write_snapshot(ic, SnapshotData(
        header=h, pos=rng.uniform(0, box, (n, 3)).astype(np.float32),
        vel=np.zeros((n, 3), np.float32),
        pid=np.arange(1, n + 1, dtype=np.uint32),
        mass=np.full(n, m, np.float32), ptype=np.ones(n, np.int32)))
    soft = box / BOX_NSIDE / 30
    return write_param(os.path.join(run_dir, "glass.param"), {
        "InitCondFile": ic, "OutputDir": run_dir,
        "SnapshotFileBase": "snapshot", "ICFormat": 1, "SnapFormat": 1,
        "ComovingIntegrationOn": 1, "PeriodicBoundariesOn": 1,
        "Omega0": 1.0, "OmegaLambda": 0.0, "OmegaBaryon": 0.0,
        "HubbleParam": 0.7, "BoxSize": box,
        "TimeBegin": 0.1, "TimeMax": 0.2, "TimeBetSnapshot": 0.5,
        "TimeOfFirstSnapshot": 0.5, "TimeBetStatistics": 0.5,
        "ErrTolIntAccuracy": 0.025, "MaxSizeTimestep": 0.02,
        "ErrTolTheta": 0.5, "TypeOfOpeningCriterion": 1,
        "ErrTolForceAcc": 0.005, "TreeDomainUpdateFrequency": 0.1,
        "SofteningHalo": soft,
    })


def cic_variance(pos, box: float, cells: int) -> float:
    """Variance of the particle counts in cells^3 equal cells."""
    idx = torch.clamp((pos / box * cells).long(), 0, cells - 1)
    flat = (idx[:, 0] * cells + idx[:, 1]) * cells + idx[:, 2]
    counts = torch.bincount(flat, minlength=cells ** 3).double()
    return float(counts.var(unbiased=False))


def glass_path(dev, card: str):
    """Phase 10a: MAKEGLASS in the periodic comoving TreePM box; its K1
    counts and the inputs of every K1 launch."""
    import ngravs_tpu_torch.integrate.runner as runner
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.ops.pairwise import pairwise_eval
    run_dir = os.path.join(ROOT, "build", "chip_smoke_glass")
    os.makedirs(run_dir, exist_ok=True)
    cfg = read_parameter_file(write_glass_box(run_dir), pmgrid=BOX_PMGRID,
                              pm_interlace=True, make_glass=1)
    sim = runner.Simulation(cfg, device=dev)
    n, box = sim.p.n, cfg.box_size
    if n != GLASS_NSIDE ** 3 or sim.solver.treepm is None \
            or len(sim.wiring.unique_laws()) != 1:
        raise AssertionError("the glass path must run one-law TreePM at "
                             "64^3")
    launched = []
    sim.solver.pair_eval = record_launches(pairwise_eval, launched)
    forces = []
    displace = runner.glass_step

    def spy(cfg_, units, p):
        a = p.accel + p.accel_pm
        forces.append((bool(torch.isfinite(a).all()),
                       float(a.norm(dim=1).max())))
        return displace(cfg_, units, p)
    runner.glass_step = spy
    try:
        var = [cic_variance(sim.p.pos, box, GLASS_CELLS)]
        steps, wall, counts = 0, 0.0, {}
        for _ in range(GLASS_STEPS):
            k, w, c = run_path(sim, 1)
            steps, wall = steps + k, wall + w
            counts = {key: counts.get(key, 0) + c.get(key, 0)
                      for key in set(counts) | set(c)}
            var.append(cic_variance(sim.p.pos, box, GLASS_CELLS))
    finally:
        runner.glass_step = displace
    p = sim.p
    inside = bool(((p.pos >= 0) & (p.pos < box)).all())
    print(f"glass path [{card}]: {steps} glass steps of {n} particles in "
          f"{wall:.2f} s, K1 launches {counts}, PM window "
          f"({sim.pm_ti_begstep}, {sim.pm_ti_endstep}), ti {sim.ti_current};"
          f" counts-in-cells variance on {GLASS_CELLS}^3 (mean "
          f"{n / GLASS_CELLS ** 3:g}) by step: "
          + ", ".join(f"{v:.4f}" for v in var)
          + "; max |reversed force| by step: "
          + ", ".join(f"{f:.4g}" for _, f in forces)
          + f"; velocities zero {not bool(p.vel.any())}, positions in "
          f"[0, box) {inside}", flush=True)
    if counts.get("K1cd", 0) <= 0:
        raise AssertionError(f"the glass path never launched K1cd: {counts}")
    if bool(p.vel.any()) or not inside or not all(ok for ok, _ in forces) \
            or len(forces) != GLASS_STEPS:
        raise AssertionError("glass gates: velocities, positions or forces")
    if not var[-1] < var[0]:
        raise AssertionError(f"the glass did not smooth: variance {var}")
    potential_pass(sim, card, "glass path", "K1cd/pot",
                   {"periodic": RMS_POT_GLASS})
    sim.close()
    return sum(counts.values()), launched


def special_mode_runs(dev, card: str):
    """Phase 10b: FLEXSTEPS and PSEUDOSYMMETRIC on slice 1's IC."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    run_dir = os.path.join(ROOT, "build", "chip_smoke_modes")
    os.makedirs(run_dir, exist_ok=True)
    param = write_galaxy_collision(run_dir)
    for mode in ("flexsteps", "pseudosymmetric"):
        cfg = read_parameter_file(param, direct_crossover=1000, tree_depth=12,
                                  **{mode: True})
        sim = Simulation(cfg, device=dev,
                         log_dir=os.path.join(run_dir, mode))
        steps, wall, counts = run_path(sim, MODE_STEPS)
        p = sim.p
        end = p.ti_endstep.long()
        step = end - p.ti_begstep.long()
        finite = all(bool(torch.isfinite(getattr(p, k)).all())
                     for k in ("pos", "vel", "accel"))
        line = (f"{mode} [{card}]: {steps} steps to t={sim.time:.6g}, "
                f"{sim.num_force_updates} particle-steps in {wall:.2f} s, K1 "
                f"launches {counts}, forces finite {finite}")
        if mode == "flexsteps":
            off = int(((end % step) != 0).sum())
            line += (f"; step ends off their own grid {off}; present steps "
                     f"{sim.present_min_step} <= {sim.present_max_step}")
            ok = off > 0 and 1 <= sim.present_min_step \
                <= sim.present_max_step
        else:
            pow2 = bool(((step > 0) & ((step & (step - 1)) == 0)).all())
            a_old = p.aphys_old
            line += (f"; every step a power of two {pow2}; aphys_old "
                     f"finite {bool(torch.isfinite(a_old).all())}, max "
                     f"{float(a_old.max()):.4g}")
            ok = pow2 and bool(torch.isfinite(a_old).all()) \
                and float(a_old.max()) > 0
        print(line, flush=True)
        if not (ok and finite and counts.get("K1a", 0) > 0):
            raise AssertionError(f"{mode} gates failed")
        sim.close()


def write_sheet(run_dir: str, seed: int = 9) -> str:
    """A 2-D gas sheet: SHEET_NX x SHEET_NY particles on a jittered grid
    of a periodic LONG_X 2 box (BoxSize 1), u = 1; returns the
    parameterfile."""
    from ngravs_tpu_torch.io.gadget_format import (SnapshotData,
                                                   SnapshotHeader,
                                                   write_snapshot)
    nx, ny = SHEET_NX, SHEET_NY
    n = nx * ny
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    d = 2.0 / nx
    pos = np.zeros((n, 3))
    pos[:, 0] = (gx.ravel() + 0.5) * d
    pos[:, 1] = (gy.ravel() + 0.5) * d
    pos[:, :2] += rng.normal(0, 0.05 * d, (n, 2))
    pos[:, 0] = np.mod(pos[:, 0], 2.0)
    pos[:, 1] = np.mod(pos[:, 1], 1.0)
    h = SnapshotHeader()
    h.npart = np.array([n, 0, 0, 0, 0, 0], np.int32)
    h.npart_total = h.npart.astype(np.uint32)
    ic = os.path.join(run_dir, "sheet.IC")
    write_snapshot(ic, SnapshotData(
        header=h, pos=pos.astype(np.float32),
        vel=rng.normal(0, 0.01, (n, 3)).astype(np.float32) * [1, 1, 0],
        pid=np.arange(1, n + 1, dtype=np.uint32),
        mass=np.full(n, 2.0 / n, np.float32), ptype=np.zeros(n, np.int32),
        u=np.ones(n, np.float32)))
    return write_param(os.path.join(run_dir, "sheet.param"), {
        "InitCondFile": ic, "OutputDir": run_dir,
        "SnapshotFileBase": "snapshot", "ICFormat": 1, "SnapFormat": 1,
        "PeriodicBoundariesOn": 1, "BoxSize": 1.0,
        "TimeBegin": 0.0, "TimeMax": 1.0, "TimeBetSnapshot": 1.0,
        "TimeOfFirstSnapshot": 1.0, "TimeBetStatistics": 1.0,
        "ErrTolIntAccuracy": 0.025, "MaxSizeTimestep": 0.001,
        "GravityConstantInternal": 1.0, "DesNumNgb": SHEET_NGB,
        "MaxNumNgbDeviation": SHEET_NGB_DEV, "SofteningGas": 0.001,
    })


def sheet_path(dev, card: str):
    """Phase 10c: TWODIMS with LONG_X 2, NOGRAVITY, a periodic gas sheet."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    from ngravs_tpu_torch.ops import pairwise
    run_dir = os.path.join(ROOT, "build", "chip_smoke_sheet")
    os.makedirs(run_dir, exist_ok=True)
    cfg = read_parameter_file(write_sheet(run_dir), twodims=True,
                              long_x=2.0, no_gravity=True)
    sim = Simulation(cfg, device=dev)
    n = sim.n_gas
    h0 = float(sim.sph.hsml[0])
    steps, wall, counts = run_path(sim, SHEET_STEPS)
    s = sim.sph
    wngb = s.num_ngb[:n]
    in_window = float(((wngb - SHEET_NGB).abs()
                       <= SHEET_NGB_DEV).double().mean())
    sigma = float(sim.p.mass[:n].double().sum()) / (2.0 * 1.0)
    med = float(s.density[:n].double().median())
    p = sim.p.pos
    inside = bool(((p[:, 0] >= 0) & (p[:, 0] < 2) & (p[:, 1] >= 0)
                   & (p[:, 1] < 1) & (p[:, 2] == 0)).all())
    print(f"2-D sheet [{card}]: {n} gas particles, first Hsml guess "
          f"{h0:.5g}, {steps} steps in {wall:.2f} s, K1 launches {counts}; "
          f"weighted neighbours within {SHEET_NGB} +- {SHEET_NGB_DEV} for "
          f"{in_window:.5%} of the gas (range {float(wngb.min()):.3f}-"
          f"{float(wngb.max()):.3f}); median density / mean {med / sigma:.5f};"
          f" inside the 2 x 1 sheet {inside}", flush=True)
    if counts or n != SHEET_NX * SHEET_NY:
        raise AssertionError("the sheet must run SPH alone")
    if not (in_window >= 0.999 and abs(med / sigma - 1) < 0.05 and inside):
        raise AssertionError("2-D sheet gates failed")
    sim.close()


# --------------------------------------------------------------------------
# phase 11: multi-device runs over torch.distributed
# --------------------------------------------------------------------------

def rewrite_param(path: str, out: str, **changes) -> str:
    """A copy of a parameterfile with some tags changed."""
    with open(path) as f:
        params = dict(line.split(None, 1) for line in f if line.strip())
    params = {k: v.strip() for k, v in params.items()}
    params.update({k: str(v) for k, v in changes.items()})
    return write_param(out, params)


def dist_config(job: dict):
    from ngravs_tpu_torch.config import read_parameter_file
    if job["kind"] == "open":
        return read_parameter_file(job["param"], direct_crossover=1000,
                                   tree_depth=12)
    return read_parameter_file(job["param"], pmgrid=BOX_PMGRID, n_gravs=2,
                               wiring="newton_yukawa", pm_interlace=True,
                               force_test=FORCETEST_FRAC,
                               output_potential=job.get("pot", False))


def dist_sim(mesh, job: dict, log_dir: str):
    from ngravs_tpu_torch.integrate.runner import load_initial_conditions
    from ngravs_tpu_torch.parallel.runner import DistributedSimulation
    from ngravs_tpu_torch.units import set_units
    cfg = dist_config(job)
    p, _ = load_initial_conditions(cfg, set_units(cfg), device="cpu")
    os.makedirs(log_dir, exist_ok=True)
    return DistributedSimulation(cfg, p, mesh=mesh, log_dir=log_dir,
                                 use_let=job["let"])


def dist_drive(mesh, sim, steps: int, label: str, after=None):
    """`steps` steps with the K1 counts and the collective statistics from
    0, the last step under CUDA's sync debug mode; rank 0 keeps the inputs
    of each K1 instance's largest launch and then holds K1 to its twin on
    them (after the counts are read).  `after(k)` runs after step k, its
    time not counted.  Returns the rank's numbers."""
    from ngravs_tpu_torch.ops import pairwise
    largest = {}
    if mesh.rank == 0:
        sim.solver.pair_eval = record_largest(pairwise.pairwise_eval,
                                              largest)
    k1_before = pairwise.instance_counts(sim.trace)
    syncs = []
    wall = 0.0
    for k in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if k == steps - 1:
            before = dict(sim.trace.counts)
            sph_s = sim.trace.timers.get("sph", 0.0)
            host_syncs = count_host_syncs(sim.step)
            d = {k: v - before.get(k, 0) for k, v in sim.trace.counts.items()}
            coll = {"calls": d.get("mesh.calls", 0),
                    "bytes": d.get("mesh.bytes", 0)}
            sph_s = sim.trace.timers.get("sph", 0.0) - sph_s
            iters = {k[4:]: v for k, v in d.items() if k.startswith("sph.")}
        else:
            sim.step()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        syncs.append(sim.ti_current)
        if after is not None:
            after(k)
    counts = k1_since(sim.trace, k1_before)
    sim.solver.pair_eval = pairwise.pairwise_eval
    k1 = {}
    for name, launch in largest.items():
        nums = check_launch_inputs(f"kernel ({label}, {name} largest "
                                   "launch)", *launch, counts.get(name, 0))
        nums["rows"] = launch[1].numel()
        k1[name] = nums
    del largest
    rows = sim.let_rows
    p = sim.p
    return dict(
        counts=counts, k1=k1, wall=wall,
        updates=sim.num_force_updates, syncs=syncs,
        timeline=[sim.ti_current, sim.pm_ti_begstep, sim.pm_ti_endstep],
        host_syncs=host_syncs, bytes=coll["bytes"], calls=coll["calls"],
        let_rows=int(rows) if rows is not None else None,
        cap_retries=sim.cap_retries, sph_s=sph_s, last_counts=iters,
        finite=all(bool(torch.isfinite(getattr(p, k)).all())
                   for k in ("pos", "vel", "accel", "accel_pm")))


def dist_pass_checks(sim, dev):
    """Rank 0: the last step's force pass against the direct sweep and
    against the single-device solver's pass on the same state.  The
    distributed step computes every particle's force every step, at the
    positions it leaves them (its kick moves only velocities)."""
    from ngravs_tpu_torch.ops.direct import direct_forces
    from ngravs_tpu_torch.ops.solver import GravitySolver
    pg, _ = sim.gather_ordered()
    if sim.mesh.rank != 0:
        return {}
    p = pg.to(dev)
    acc = p.accel + p.accel_pm
    solver = GravitySolver(sim.cfg, sim.wiring, sim.force_soft, sim.units.G,
                           hubble=sim.units.hubble, device=dev)
    p_all = p.replace(ti_endstep=torch.zeros_like(p.ti_endstep))
    solver.compute(p_all, 0, p.n)
    single = solver.compute(p_all, 0, p.n)[0].accel
    fsoft = torch.as_tensor(sim.force_soft, device=dev)[p.ptype.long()]
    acc_d, _ = direct_forces(sim.wiring, p.pos, p.mass, p.grav, fsoft,
                             chunk=1024, want_pot=False)
    acc_d = acc_d * sim.units.G

    def rms(a, ref):
        rel = torch.linalg.norm(a - ref, dim=1) \
            / torch.clamp(torch.linalg.norm(ref, dim=1), min=1e-12)
        return float(torch.sqrt(torch.mean(rel * rel)))
    return dict(rms_direct=rms(acc, acc_d), rms_single=rms(acc, single),
                single_direct=rms(single, acc_d),
                momentum=momentum_rate(p.mass, acc),
                finite=bool(torch.isfinite(acc).all()))


def dist_potential(sim, dev) -> dict:
    """Rank 0: the gathered potential of the last step on ORACLE_TARGETS
    targets against the periodic direct sum with the lattice correction
    (phase 14's periodic rule).  Every rank gathers."""
    from ngravs_tpu_torch.ops import lattice
    pg, _ = sim.gather_ordered()
    if sim.mesh.rank != 0:
        return {}
    p, cfg = pg.to(dev), sim.cfg
    tabs = lattice.build_lattice_tables(sim.wiring, cfg.ngravs_en,
                                        cfg.box_size, device=dev)
    idx = oracle_targets(p.n, dev)
    pot_d = potential_oracle(sim.wiring, sim.force_soft, sim.units.G, p,
                             idx, cfg.box_size, tabs)
    return dict(pot_errs=periodic_pot_errors(
        p.potential[idx.long()], pot_d, p.grav[idx.long()], cfg.n_gravs),
        pot_finite=bool(torch.isfinite(p.potential).all()))


def dist_open(mesh, job: dict, run_dir: str):
    """11a on one rank: DIST_STEPS steps, one force pass checked; with
    `repeat`, the same run again, bit for bit."""
    dev = mesh.device
    sim = dist_sim(mesh, job, os.path.join(run_dir, job["name"]))
    out = dist_drive(mesh, sim, DIST_STEPS, job["name"])
    out.update(dist_pass_checks(sim, dev))
    if job.get("repeat"):
        again = dist_sim(mesh, job, os.path.join(run_dir,
                                                 job["name"] + "_again"))
        for _ in range(DIST_STEPS):
            again.step()
        a, _ = sim.gather_ordered()
        b, _ = again.gather_ordered()
        out["repeat"] = all(torch.equal(getattr(a, k), getattr(b, k))
                            for k in ("pos", "vel", "accel", "ti_endstep"))
        again.close()
    sim.close()
    return out


def dist_box(mesh, job: dict, run_dir: str):
    """11b on one rank: DIST_BOX_STEPS steps with FORCETEST; with `pm`
    the slab PM against the single-device PM; with `files` the multi-file
    snapshot and a restart round trip."""
    from ngravs_tpu_torch.io.gadget_format import read_snapshot_set
    dev = mesh.device
    log_dir = os.path.join(run_dir, job["name"])
    ft = os.path.join(log_dir, "forcetest.txt")
    if mesh.rank == 0 and os.path.exists(ft):
        os.remove(ft)
    sim = dist_sim(mesh, job, log_dir)
    pot = {}

    def first_step_potential(k):
        # phase 14 on ranks: the first step's (every particle active)
        # gathered potential under the periodic rule
        if k == 0 and job.get("pot"):
            pot.update(dist_potential(sim, dev))
    out = dist_drive(mesh, sim, DIST_BOX_STEPS, job["name"],
                     after=first_step_potential)
    out.update(pot)
    out["forcetest"] = forcetest_steps(ft) if mesh.rank == 0 else []
    if job.get("pm"):
        spm = sim._step_pm_fn.pm_sharded
        p = sim.p
        mass = torch.where(p.pid >= 0, p.mass, 0.0)
        ms = cuda_ms(lambda: spm.forces(p.pos, mass, p.grav), 3)
        # float32 as the run computes it, then both solvers in float64 on
        # the same state: what is left there is not rounding
        for dt, key in ((torch.float32, "pm_err"), (torch.float64,
                                                    "pm_err64")):
            pos, m = p.pos.to(dt), mass.to(dt)
            acc = spm.forces(pos, m, p.grav)
            rows = mesh.all_gather(torch.cat(
                [acc, pos, m[:, None], p.grav.to(dt)[:, None]], dim=1))
            if mesh.rank == 0:
                single = sim.solver.pm
                args = (rows[:, 3:6].contiguous(), rows[:, 6].contiguous(),
                        rows[:, 7].to(torch.int32))
                ref = single.forces(*args)
                out[key] = float((rows[:, 0:3] - ref).abs().max()
                                 / ref.abs().max())
                if dt == torch.float32:
                    out["pm_ms"] = ms
                    out["pm_single_ms"] = cuda_ms(
                        lambda: single.forces(*args), 3)
    if job.get("files"):
        base = sim.write_snapshot_now(os.path.join(log_dir, "dist_snap"))
        pg, _ = sim.gather_ordered()
        if mesh.rank == 0:
            snap = read_snapshot_set(base)
            o = np.argsort(snap.pid.astype(np.int64))
            out["snapshot_equal"] = bool(
                np.array_equal(snap.pos[o], pg.pos.numpy())
                and np.array_equal(snap.pid[o].astype(np.int64),
                                   pg.pid.numpy().astype(np.int64) + 0)
                and np.array_equal(snap.mass[o], pg.mass.numpy()))
            if job.get("pot"):
                out["pot_block_equal"] = bool(
                    snap.pot is not None
                    and np.array_equal(snap.pot[o], pg.potential.numpy()))
        path = sim.save_restart(os.path.join(log_dir, "restart_dist.npz"))
        again = dist_sim(mesh, job, log_dir + "_resumed")
        again.resume(path)
        qg, _ = again.gather_ordered()
        out["restart_equal"] = all(
            torch.equal(getattr(pg, f), getattr(qg, f))
            for f in vars(pg)) and (again.ti_current, again.pm_ti_begstep,
                                    again.pm_ti_endstep) == (
            sim.ti_current, sim.pm_ti_begstep, sim.pm_ti_endstep)
        again.close()
    sim.close()
    return out


def dist_rank(mesh, out: str, jobs, run_dir: str):
    """One rank of a phase-11 launch: every job in order, its numbers to
    `out.<rank>.json`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    t0 = time.perf_counter()
    x = mesh.all_gather(torch.ones(4, device=mesh.device))
    if mesh.rank == 0:
        print(f"  {mesh.size} rank(s) over {mesh.backend} met: first "
              f"collective {time.perf_counter() - t0:.2f} s, sum "
              f"{float(x.sum())}", flush=True)
    for job in jobs:
        fn = {"open": dist_open, "box": dist_box, "gas": gas_job}[job["kind"]]
        t0 = time.perf_counter()
        res[job["name"]] = fn(mesh, job, run_dir)
        # the ranks share the card: hand the job's cached memory back
        gc.collect()
        torch.cuda.empty_cache()
        if mesh.rank == 0:
            print(f"  {job['name']}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    with open(f"{out}.{mesh.rank}.json", "w") as f:
        json.dump(dict(res, device=str(mesh.device), backend=mesh.backend),
                  f)


def dist_launch(world: int, backend: str, jobs, run_dir: str, tag: str):
    from ngravs_tpu_torch.parallel.mesh import launch
    out = os.path.join(run_dir, tag)
    for r in range(world):
        if os.path.exists(f"{out}.{r}.json"):
            os.remove(f"{out}.{r}.json")
    t0 = time.perf_counter()
    launch(dist_rank, world, backend=backend, device=DIST_DEVICE,
           args=(out, jobs, run_dir))
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(f"{out}.{r}.json") as f:
            ranks.append(json.load(f))
    return ranks, wall


def dist_jobs(world: int, open_param: str, box_param: str) -> list:
    """Phase 11's configurations for one launch of `world` ranks: the 60k
    open box and the 2 x 64^3 TreePM box, replicated and LET."""
    return [
        dict(name=f"open_rep_{world}", kind="open", param=open_param,
             let=False, repeat=world == 2),
        dict(name=f"open_let_{world}", kind="open", param=open_param,
             let=True),
        dict(name=f"box_rep_{world}", kind="box", param=box_param,
             let=False, pm=True),
        dict(name=f"box_let_{world}", kind="box", param=box_param,
             let=True, files=world == 2, pot=world == 2)]


def gas_dist_jobs(world: int, param: str) -> list:
    """Phase 12's configurations for one launch of `world` ranks: slice
    3's gas box, replicated and LET, from phase 6's first step."""
    single = SINGLE["gas"]
    common = dict(kind="gas", param=param, h0=single["h0"],
                  first=single["first"])
    return [dict(common, name=f"gas_rep_{world}", let=False,
                 repeat=world == 2),
            dict(common, name=f"gas_let_{world}", let=True,
                 files=world == 2)]


def command_lines(card: str, runs):
    """`python -m ngravs_tpu_torch.run <param> --devices 2 --backend gloo`
    for each (label, param, check) of `runs`, all started at once (their
    ranks share the card; each is gated on its exit code and `check(stdout
    lines)`, not timed against anything).  Each run's output goes to files
    beside its parameterfile."""
    procs = []
    t0 = time.perf_counter()
    for label, param, check in runs:
        base = os.path.splitext(param)[0]
        out, err = open(base + ".out", "w+"), open(base + ".err", "w+")
        procs.append((label, check, out, err, subprocess.Popen(
            [sys.executable, "-m", "ngravs_tpu_torch.run", param,
             "--devices", "2", "--backend", "gloo", "--device",
             DIST_DEVICE], cwd=ROOT, stdout=out, stderr=err, text=True)))
    ends = {}
    try:
        while len(ends) < len(procs):
            for i, (*_, proc) in enumerate(procs):
                if i not in ends and proc.poll() is not None:
                    ends[i] = time.perf_counter() - t0
            if time.perf_counter() - t0 > 600:
                raise AssertionError("a --devices 2 run took over 600 s")
            time.sleep(0.2)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for i, (label, check, out, err, proc) in enumerate(procs):
        out.seek(0)
        err.seek(0)
        lines = out.read().strip().splitlines()
        errs = err.read()
        out.close()
        err.close()
        print(f"{label} [{card}]: exit {proc.returncode} in {ends[i]:.1f} s "
              f"({len(procs)} started at once); " + " | ".join(lines[-3:]),
              flush=True)
        if proc.returncode != 0 or not lines or "over gloo" not in lines[0] \
                or not check(lines):
            raise AssertionError(f"the {label} run failed:\n"
                                 + "\n".join(lines[-10:]) + errs[-3000:])


def distributed_runs(card: str, phases) -> dict:
    """Phases 11 and 12 (those of `phases`) in one launch a world size: 1
    rank over NCCL, then 2 ranks over gloo sharing the card, each running
    phase 11's configurations (`dist_jobs`) and then phase 12's
    (`gas_dist_jobs`) through `DistributedSimulation`; then each phase's
    `--devices 2` command line, the two at once.  Returns each
    configuration's numbers by rank."""
    run_dir = os.path.join(ROOT, "build", "chip_smoke_dist")
    gas_dir = os.path.join(ROOT, "build", "chip_smoke_dist_gas")
    os.makedirs(run_dir, exist_ok=True)
    os.makedirs(gas_dir, exist_ok=True)
    open_param = write_galaxy_collision(run_dir)
    box_param = write_cosmo_box(run_dir)
    gas_param = write_gas_box(gas_dir) if 12 in phases else None
    results = {}
    for world, backend in DIST_LAUNCHES:
        jobs = (dist_jobs(world, open_param, box_param)
                if 11 in phases else []) \
            + (gas_dist_jobs(world, gas_param) if 12 in phases else [])
        ranks, _ = dist_launch(world, backend, jobs, run_dir,
                               f"launch_{world}")
        stamp(f"phases {', '.join(map(str, sorted(phases)))}, {world} "
              f"rank(s) over {backend}")
        for job in jobs:
            per = [r[job["name"]] for r in ranks]
            results[job["name"]] = per
            if job["kind"] == "gas":
                report_gas_job(job, per, world, backend, card)
            else:
                report_dist_job(job, per, world, backend, card)
    runs = []
    if 11 in phases:
        # the mpirun -n 2 analog on a short open-box run
        short = rewrite_param(open_param, os.path.join(run_dir, "cli.param"),
                              TimeMax=0.002, TimeBetSnapshot=0.001,
                              TimeOfFirstSnapshot=0.001,
                              MaxSizeTimestep=0.0005,
                              OutputDir=os.path.join(run_dir, "cli"))
        runs.append(("--devices 2 --backend gloo", short,
                     lambda lines: lines[-1].startswith("done:")))
    if 12 in phases:
        # the gas scheme at 2 x CLI_NSIDE^3 (a parameterfile cannot ask
        # for PMGRID: a periodic pure-tree box), 2 steps, a snapshot after
        # the first
        small = write_gas_box(gas_dir, ns=CLI_NSIDE, name="cli_gas_box")
        short = rewrite_param(small, os.path.join(gas_dir, "cli.param"),
                              TimeMax=0.1 * (1 + 1e-6), TimeBetSnapshot=0.5,
                              TimeOfFirstSnapshot=0.1,
                              OutputDir=os.path.join(gas_dir, "cli"))
        runs.append(("gas --devices 2 --backend gloo", short,
                     lambda lines: lines[-1].startswith("done: 2 steps")))
    command_lines(card, runs)
    if 12 in phases:
        from ngravs_tpu_torch.io.gadget_format import read_snapshot_set
        snap = read_snapshot_set(os.path.join(gas_dir, "cli",
                                              "snapshot_000"))
        if not (snap.u is not None and np.isfinite(snap.u).all()
                and int(snap.header.npart[0]) == CLI_NSIDE ** 3):
            raise AssertionError("the gas --devices 2 run's snapshot has no "
                                 "gas blocks")
    stamp(f"phases {', '.join(map(str, sorted(phases)))}, the --devices 2 "
          "command lines")
    return results


def report_dist_job(job: dict, per, world: int, backend: str, card: str):
    """Print one configuration's numbers and hold them to phase 11's
    gates."""
    name = job["name"]
    r0 = per[0]
    single = SINGLE["open" if job["kind"] == "open" else "box"]["rate"]
    rate = r0["updates"] / max(r["wall"] for r in per)
    print(f"{name} [{card}]: {world} rank(s) over {backend}, "
          f"{'LET' if job['let'] else 'replicated'}: {r0['updates']} "
          f"particle-steps = {rate:.1f} particle-steps/s (single device "
          f"{single:.1f}); sync points {r0['syncs']}; K1 launches by rank "
          f"{[r['counts'] for r in per]}; last step: host syncs by rank "
          f"{[r['host_syncs'] for r in per]}, collective bytes sent by rank "
          f"{[r['bytes'] for r in per]} in {r0['calls']} calls"
          + (f", LET rows received by rank {[r['let_rows'] for r in per]}"
             if job["let"] else "")
          + f"; cap retries {r0['cap_retries']}", flush=True)
    inst = "K1a" if job["kind"] == "open" else "K1bcd"
    for r in per:
        if sum(v for k, v in r["counts"].items()
               if k.startswith(inst)) <= 0:
            raise AssertionError(f"{name}: a rank never launched {inst}: "
                                 f"{r['counts']}")
        if not r["finite"]:
            raise AssertionError(f"{name}: non-finite state")
    if len(set(map(tuple, (r["timeline"] for r in per)))) != 1:
        raise AssertionError(f"{name}: the ranks' timelines differ")
    syncs = r0["syncs"]
    if job["kind"] == "open":
        print(f"{name} force pass [{card}]: rms rel err vs direct "
              f"{r0['rms_direct']:.3e}, vs the single-device pass "
              f"{r0['rms_single']:.3e} (single vs direct "
              f"{r0['single_direct']:.3e}), momentum rate "
              f"{r0['momentum']:.2e}"
              + (f"; two runs bit-identical {r0['repeat']}"
                 if "repeat" in r0 else ""), flush=True)
        if not (r0["finite"] and r0["rms_direct"] < RMS_TREE
                and r0["rms_single"] < RMS_DIST
                and r0["momentum"] < MOMENTUM_RATE):
            raise AssertionError(f"{name}: force-pass gates failed")
        if any(b <= a for a, b in zip(syncs, syncs[1:])) \
                or len(syncs) != DIST_STEPS:
            raise AssertionError(f"{name}: the sync points did not advance")
        if r0.get("repeat") is False:
            raise AssertionError(f"{name}: two runs differ")
        return
    check_forcetest(name, os.path.join(ROOT, "build", "chip_smoke_dist",
                                       name, "forcetest.txt"),
                    card, RMS_TREEPM, 1, DIST_BOX_STEPS)
    want = SINGLE["box"]["syncs"][DIST_BOX_STEPS - 1]
    print(f"{name} timeline [{card}]: (ti, PM window) {r0['timeline']}, "
          f"single device {want}"
          + (f"; slab PM vs single-device PM max|da| / max|a| "
             f"{r0['pm_err']:.3e} (float64 {r0['pm_err64']:.3e}), "
             f"{r0['pm_ms']:.2f} ms against {r0['pm_single_ms']:.2f} ms "
             "(median of 3, CUDA events)"
             if "pm_err" in r0 else "")
          + (f"; multi-file snapshot equal {r0['snapshot_equal']}, restart "
             f"round trip bit for bit {r0['restart_equal']}"
             if "snapshot_equal" in r0 else ""), flush=True)
    if r0["timeline"] != want:
        raise AssertionError(f"{name}: timeline {r0['timeline']} against "
                             f"the single device's {want}")
    if "pm_err" in r0 and not (r0["pm_err"] < PM_SHARDED_TOL
                               and r0["pm_err64"] < PM_F64_TOL):
        raise AssertionError(f"{name}: slab PM error {r0['pm_err']}, "
                             f"float64 {r0['pm_err64']}")
    if "snapshot_equal" in r0 and not (r0["snapshot_equal"]
                                       and all(r["restart_equal"]
                                               for r in per)):
        raise AssertionError(f"{name}: snapshot or restart round trip")
    if job.get("pot"):
        n_pot = [r["counts"].get("K1bcd/pot", 0) for r in per]
        errs = r0["pot_errs"]
        print(f"{name} potential [{card}]: OutputPotential, K1bcd/pot "
              f"launches by rank {n_pot}; the first step's gathered "
              f"potential on {ORACLE_TARGETS} targets against the periodic "
              "direct sum with the lattice correction, by gravity (mean d, "
              "rms(d - mean d) / rms(pot_direct)): "
              + ", ".join(f"{g}: {m:.6e}, {e:.3e}" for g, m, e in errs)
              + f" (gate {RMS_POT_BOX:.3e}); POT block of the multi-file "
              f"snapshot equal {r0['pot_block_equal']}", flush=True)
        if min(n_pot) <= 0:
            raise AssertionError(f"{name}: a rank never launched "
                                 f"K1bcd/pot: {n_pot}")
        if not (r0["pot_finite"] and max(e for _, _, e in errs)
                < RMS_POT_BOX and r0["pot_block_equal"]):
            raise AssertionError(f"{name}: potential gates {errs}, POT "
                                 f"block equal {r0['pot_block_equal']}")


# --------------------------------------------------------------------------
# phase 12: multi-device gas over torch.distributed
# --------------------------------------------------------------------------

def gas_dist_sim(mesh, job: dict, log_dir: str, convert: bool = True):
    """Slice 3's gas box through `DistributedSimulation` (FORCETEST on),
    its IC's u turned into entropy before the first step (`convert`), from
    phase 6's first smoothing length."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import load_initial_conditions
    from ngravs_tpu_torch.parallel.runner import DistributedSimulation
    from ngravs_tpu_torch.units import set_units
    cfg = read_parameter_file(job["param"], pmgrid=BOX_PMGRID, n_gravs=2,
                              wiring="newton_yukawa", pm_interlace=True,
                              force_test=FORCETEST_FRAC)
    p, sph = load_initial_conditions(cfg, set_units(cfg), device="cpu")
    sph = sph.replace(hsml=torch.where(p.ptype == 0, job["h0"], 0.0))
    os.makedirs(log_dir, exist_ok=True)
    return DistributedSimulation(cfg, p, sph=sph, mesh=mesh, log_dir=log_dir,
                                 use_let=job["let"], entropy_is_u=convert)


def gas_against_first(pg, sg, path: str) -> dict:
    """The first step's state against phase 6's single-device first step:
    density and Hsml (largest relative difference), the hydro
    acceleration (over its largest |a|), gravity (rms relative)."""
    ref = np.load(path)
    if not np.array_equal(pg.pid.numpy(), ref["pid"]):
        raise AssertionError("phase 12: rows out of phase 6's order")
    n = ref["density"].shape[0]
    out = {}
    for k in ("density", "hsml"):
        out[k] = float((np.abs(getattr(sg, k)[:n].numpy() - ref[k])
                        / np.abs(ref[k])).max())
    ha = ref["hydro_accel"]
    out["hydro"] = float(np.abs(sg.hydro_accel[:n].numpy() - ha).max()
                         / np.abs(ha).max())
    a = (pg.accel + pg.accel_pm).numpy()
    rel = np.linalg.norm(a - ref["accel"], axis=1) \
        / np.maximum(np.linalg.norm(ref["accel"], axis=1), 1e-30)
    out["gravity_rms"] = float(np.sqrt(np.mean(rel ** 2)))
    return out


def gas_state_gates(cfg, pg, sg) -> dict:
    """Phase 6's gas-state numbers on a gathered state."""
    gas = pg.ptype == 0
    wngb = sg.num_ngb[gas]
    ma = pg.mass[gas, None] * sg.hydro_accel[gas]
    return dict(
        in_window=float(((wngb - DES_NGB).abs() <= NGB_DEV).double().mean()),
        rho_med=float(sg.density[gas].double().median())
        / (float(pg.mass[gas].double().sum()) / cfg.box_size ** 3),
        momentum=(ma.sum(0).abs() / ma.abs().sum(0).clamp(min=1e-30))
        .tolist())


def gas_job(mesh, job: dict, run_dir: str):
    """12 on one rank: DIST_GAS_STEPS steps, the first held to phase 6's;
    with `repeat` a second run's first step against this run's, bit for
    bit; with `files` the multi-file snapshot and a restart round trip."""
    from ngravs_tpu_torch.io.gadget_format import read_snapshot_set
    log_dir = os.path.join(run_dir, job["name"])
    ft = os.path.join(log_dir, "forcetest.txt")
    if mesh.rank == 0 and os.path.exists(ft):
        os.remove(ft)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = gas_dist_sim(mesh, job, log_dir)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    kept = {}

    def after(k):
        if k == 0:
            pg, sg = sim.gather_ordered()
            if job.get("repeat"):
                kept["first"] = (pg, sg)
            if mesh.rank == 0:
                kept["vs_single"] = gas_against_first(pg, sg, job["first"])

    out = dist_drive(mesh, sim, DIST_GAS_STEPS, job["name"], after=after)
    out.update(setup=setup, first=kept.get("vs_single"),
               ghost_rows=sim.ghost_rows, ghost_retries=sim.ghost_retries,
               cand_cap=sim.hydro.cand_cap,
               sph_counts=sim.trace.prefixed("sph."),
               forcetest=forcetest_steps(ft) if mesh.rank == 0 else [])
    pg, sg = sim.gather_ordered()
    if mesh.rank == 0:
        out["gates"] = gas_state_gates(sim.cfg, pg, sg)
        out["finite"] = out["finite"] and all(
            bool(torch.isfinite(getattr(sg, k)).all()) for k in vars(sg))
    if job.get("repeat"):
        again = gas_dist_sim(mesh, job, log_dir + "_again")
        again.step()
        qg, qs = again.gather_ordered()
        a, b = kept["first"]
        out["repeat"] = all(torch.equal(getattr(x, k), getattr(y, k))
                            for x, y in ((a, qg), (b, qs)) for k in vars(x))
        again.close()
    if job.get("files"):
        base = sim.write_snapshot_now(os.path.join(log_dir, "dist_snap"))
        if mesh.rank == 0:
            snap = read_snapshot_set(base)
            o = np.argsort(snap.pid.astype(np.int64))
            n_gas = int(snap.header.npart[0])
            og = np.argsort(snap.pid[:n_gas].astype(np.int64))
            out["snapshot_equal"] = bool(
                np.array_equal(snap.pos[o], pg.pos.numpy())
                and np.array_equal(snap.pid[o].astype(np.int64),
                                   pg.pid.numpy().astype(np.int64))
                and np.array_equal(snap.rho[og], sg.density[:n_gas].numpy())
                and np.array_equal(snap.hsml[og], sg.hsml[:n_gas].numpy())
                and bool(np.isfinite(snap.u).all() and (snap.u > 0).all()))
        path = sim.save_restart(os.path.join(log_dir, "restart_dist.npz"))
        again = gas_dist_sim(mesh, job, log_dir + "_resumed", convert=False)
        again.resume(path)
        qg, qs = again.gather_ordered()
        out["restart_equal"] = all(
            torch.equal(getattr(x, k), getattr(y, k))
            for x, y in ((pg, qg), (sg, qs)) for k in vars(x)) and (
            again.ti_current, again.pm_ti_begstep, again.pm_ti_endstep) == (
            sim.ti_current, sim.pm_ti_begstep, sim.pm_ti_endstep)
        again.close()
    sim.close()
    return out


def report_gas_job(job: dict, per, world: int, backend: str, card: str):
    """Print one gas configuration's numbers and hold them to phase 12's
    gates."""
    name = job["name"]
    r0 = per[0]
    single = SINGLE["gas"]
    rate = r0["updates"] / max(r["wall"] for r in per)
    print(f"{name} [{card}]: {world} rank(s) over {backend}, "
          f"{'LET' if job['let'] else 'replicated'}: {r0['updates']} "
          f"particle-steps = {rate:.1f} particle-steps/s (single-device gas "
          f"path {single['rate']:.1f}); set-up with the u -> entropy pass "
          f"{r0['setup']:.1f} s; sync points {r0['syncs']}; K1 launches by "
          f"rank {[r['counts'] for r in per]}; last step: host syncs by "
          f"rank {[r['host_syncs'] for r in per]}, collective bytes sent by "
          f"rank {[r['bytes'] for r in per]} in {r0['calls']} calls, SPH "
          f"passes {[round(r['sph_s'], 3) for r in per]} s by rank, "
          f"density iterations by rank "
          f"{[r['last_counts'].get('density_iters') for r in per]}"
          + (f", ghost rows received (rounds A, B) by rank "
             f"{[r['ghost_rows'] for r in per]}, LET gravity rows by rank "
             f"{[r['let_rows'] for r in per]}" if job["let"] else "")
          + f"; the run: SPH passes {r0['sph_counts']}, cand_cap "
          f"{[r['cand_cap'] for r in per]}, ghost-cap growths and margin "
          f"reruns {r0['ghost_retries']}, LET cap retries "
          f"{r0['cap_retries']}", flush=True)
    for r in per:
        if sum(v for k, v in r["counts"].items()
               if k.startswith("K1bcd")) <= 0:
            raise AssertionError(f"{name}: a rank never launched K1bcd: "
                                 f"{r['counts']}")
        if not r["finite"]:
            raise AssertionError(f"{name}: non-finite state")
    if len(set(map(tuple, (r["timeline"] for r in per)))) != 1:
        raise AssertionError(f"{name}: the ranks' timelines differ")
    check_forcetest(name, os.path.join(ROOT, "build", "chip_smoke_dist",
                                       name, "forcetest.txt"),
                    card, RMS_TREEPM, 1, DIST_GAS_STEPS)
    want = single["syncs"][DIST_GAS_STEPS - 1]
    f, g = r0["first"], r0["gates"]
    print(f"{name} against the single device [{card}]: timeline "
          f"{r0['timeline']} (single {want}); first step: density "
          f"{f['density']:.3e}, Hsml {f['hsml']:.3e} (max relative), hydro "
          f"{f['hydro']:.3e} of max|a|, gravity rms {f['gravity_rms']:.3e}; "
          f"gas state: neighbours in the window for {g['in_window']:.5%}, "
          f"median density / mean {g['rho_med']:.5f}, hydro momentum rate "
          f"{', '.join(f'{m:.2e}' for m in g['momentum'])}"
          + (f"; two runs' first steps bit-identical {r0['repeat']}"
             if "repeat" in r0 else "")
          + (f"; multi-file snapshot equal {r0['snapshot_equal']}, restart "
             f"round trip bit for bit {r0['restart_equal']}"
             if "snapshot_equal" in r0 else ""), flush=True)
    if r0["timeline"] != want:
        raise AssertionError(f"{name}: timeline {r0['timeline']} against "
                             f"the single device's {want}")
    if not (f["density"] < 2e-3 and f["hsml"] < 2e-3 and f["hydro"] < 3e-3
            and f["gravity_rms"] < RMS_DIST):
        raise AssertionError(f"{name}: first step against the single "
                             f"device {f}")
    if not (g["in_window"] >= 0.999 and abs(g["rho_med"] - 1) < 0.05
            and max(g["momentum"]) < MOMENTUM_RATE):
        raise AssertionError(f"{name}: gas-state gates {g}")
    if r0.get("repeat") is False:
        raise AssertionError(f"{name}: two runs differ")
    if "snapshot_equal" in r0 and not (r0["snapshot_equal"]
                                       and all(r["restart_equal"]
                                               for r in per)):
        raise AssertionError(f"{name}: snapshot or restart round trip")


# --------------------------------------------------------------------------
# phase 13: the law matrix
# --------------------------------------------------------------------------

def rms_by_grav(rel, grav, n_gravs: int) -> list:
    """The rms of `rel` over each gravity's particles: one taken over all
    would hide a species whose forces are small."""
    return [float(torch.sqrt(torch.mean(rel[grav == g] ** 2)))
            for g in range(n_gravs)]


def open_law_path(dev, card: str, label: str, instance: str, wiring: str,
                  changes: dict, pot_bounds=None, **cfg_kw):
    """Phases 13a and 13b: slice 1's IC and parameterfile (with the tags
    `changes`) run with `wiring`, LAW_STEPS steps; then one full tree pass
    against the direct sweep with the same wiring (N = 1 per particle),
    its rms by gravity below RMS_TREE, momentum rate below MOMENTUM_RATE;
    with the accumulator, the same pass with it off must err more on the
    BAM targets (gravity 1).  Every K1 launch of the pass against the
    twin.  Then phase 14 on the final state, the potential's rms by
    gravity within `pot_bounds` ({gravity: bound}; RMS_POT_OPEN for
    each by default).  Returns (launches of `instance`, the pass's
    launches, the largest |acc| difference from the twin)."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    from ngravs_tpu_torch.models.wiring import build_wiring
    from ngravs_tpu_torch.ops.direct import direct_forces
    from ngravs_tpu_torch.ops.pairwise import pairwise_eval
    run_dir = os.path.join(ROOT, "build", "chip_smoke_" + wiring)
    os.makedirs(run_dir, exist_ok=True)
    param = write_galaxy_collision(run_dir)
    param = rewrite_param(param, param, **changes)
    cfg = read_parameter_file(param, direct_crossover=1000, tree_depth=12,
                              n_gravs=2, wiring=wiring, **cfg_kw)
    sim = Simulation(cfg, device=dev)
    n = sim.p.n
    if n != sum(NPART) or sim.solver.uses_direct(n):
        raise AssertionError(f"{label} must walk the tree at 60k")
    steps, wall, counts = run_path(sim, LAW_STEPS)
    n_inst = instance_launches(label, counts, instance)
    if not bool(torch.isfinite(sim.p.accel).all()):
        raise AssertionError(f"{label}: non-finite forces")
    opening = "geometric" if cfg.type_of_opening_criterion == 0 \
        else "relative"
    print(f"{label} [{card}]: {steps} steps to t={sim.time:.6g}, "
          f"{sim.num_force_updates} particle-steps in {wall:.2f} s = "
          f"{sim.num_force_updates / wall:.1f} particle-steps/s, K1 "
          f"launches {counts}, opening {opening}, walk caps "
          f"{sim.solver.fcaps}; host seconds by phase: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sim.cpu_timers.items()),
          flush=True)

    launched, attempts = [], []
    solver = pass_solver(sim)
    with record_attempts(solver, launched, attempts):
        acc_t, pass_s = full_force_pass(sim, solver, solver.pair_eval)
    p = sim.p
    fsoft = torch.as_tensor(sim.force_soft, device=dev)[p.ptype.long()]
    acc_d, _ = direct_forces(sim.wiring, p.pos, p.mass, p.grav, fsoft,
                             chunk=1024, want_pot=False)
    acc_d = acc_d * sim.units.G
    rel = rel_errs(acc_t, acc_d)
    rms = rms_by_grav(rel, p.grav, 2)
    mom = momentum_rate(p.mass, acc_t)
    amag = [float(torch.linalg.norm(acc_d[p.grav == g], dim=1).median())
            for g in range(2)]
    print(f"{label} force pass [{card}]: {n} targets in {pass_s * 1e3:.1f} "
          f"ms, rms rel err vs the direct sweep by gravity "
          + ", ".join(f"{g}: {r:.3e} (max "
                      f"{float(rel[p.grav == g].max()):.3e}, median |a| "
                      f"{a:.3e})" for g, (r, a) in enumerate(zip(rms, amag)))
          + f"; momentum rate {mom:.2e}", flush=True)
    if not bool(torch.isfinite(acc_t).all()):
        raise AssertionError(f"{label}: non-finite forces in the pass")
    if not max(rms) < RMS_TREE:
        raise AssertionError(f"{label}: tree vs direct rms by gravity {rms}")
    if not mom < MOMENTUM_RATE:
        raise AssertionError(f"{label}: momentum rate {mom}")
    if cfg.ngravs_accumulator:
        # the same pass with the accumulator off: a node's BAM law then
        # takes its summed mass as one particle's
        cfg_off = cfg.replace(ngravs_accumulator=False)
        acc_off, _ = full_force_pass(
            sim, pass_solver(sim, cfg_off, build_wiring(cfg_off)),
            pairwise_eval)
        rms_off = rms_by_grav(rel_errs(acc_off, acc_d), p.grav, 2)
        print(f"{label} accumulator off [{card}]: rms rel err by gravity "
              + ", ".join(f"{g}: {r:.3e}" for g, r in enumerate(rms_off))
              + f" (on: {rms[0]:.3e}, {rms[1]:.3e})", flush=True)
        if not rms_off[1] > rms[1]:
            raise AssertionError(f"{label}: the accumulator made the BAM "
                                 f"targets no better: {rms} vs off {rms_off}")
    worst = check_every_launch(f"{label} pass", launched, attempts)
    potential_pass(sim, card, label, instance + "/pot", {"open": pot_bounds
                   or {0: RMS_POT_OPEN, 1: RMS_POT_OPEN}})
    sim.close()
    return n_inst, launched, worst


def three_species_path(dev, card: str, label: str = "13d three species"):
    """Phase 13d: slice 3's gas box with a third species (type 2, gravity
    2), the three_species wiring (Newton / Yukawa / Coulomb+Yukawa on the
    diagonal, Yukawa across), PMGRID 128 interlaced, LAW_BOX_STEPS steps
    with FORCETEST on the PM steps (rms < RMS_TREEPM), slice 3's gas-state
    gates and the momentum rate; PM's nine pair rounds and the SPH passes
    timed; every K1 launch of a fresh solver's settling short-range pass
    against the twin, the walk attempts that overflowed included (and,
    when no recorded pass of the script has overflowed yet, of a pass with
    the chunk cap cut to OVERFLOW_CHUNK_CAP).  Returns (K1bcd launches, the
    settled attempt's launches, the largest |acc| difference from the
    twin)."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    from ngravs_tpu_torch.ops import lattice
    run_dir = os.path.join(ROOT, "build", "chip_smoke_three")
    os.makedirs(run_dir, exist_ok=True)
    ft_path = os.path.join(run_dir, "forcetest.txt")
    if os.path.exists(ft_path):
        os.remove(ft_path)
    cfg = read_parameter_file(
        write_gas_box(run_dir, name="three_species_box", three=True),
        pmgrid=BOX_PMGRID, n_gravs=3, wiring="three_species",
        pm_interlace=True, force_test=FORCETEST_FRAC)
    lattice.last_generator = None
    t0 = time.perf_counter()
    sim = Simulation(cfg, device=dev)
    init_s = time.perf_counter() - t0
    tables_by = lattice.last_generator or "from the cache"
    n, n_gas = sim.p.n, sim.n_gas
    if n_gas != BOX_NSIDE ** 3 or n != 3 * n_gas \
            or sim.solver.treepm is None or sim.solver.uses_direct(n) \
            or len(sim.wiring.unique_laws()) != 3:
        raise AssertionError(f"{label} must run three laws in TreePM + SPH "
                             "at 3 x 64^3")
    # the SPH passes' seconds, the card synchronised around each
    sph_s = {"density": 0.0, "hydro": 0.0}

    def timed(name):
        fn = getattr(sim.hydro, name)

        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            sph_s[name] += time.perf_counter() - t
            return out
        return run
    for name in sph_s:
        setattr(sim.hydro, name, timed(name))
    try:
        steps, wall, counts = run_path(sim, LAW_BOX_STEPS)
    finally:
        for name in sph_s:
            delattr(sim.hydro, name)
    n_inst = instance_launches(label, counts, "K1bcd")
    p = sim.p
    if not (bool(p.accel_pm.abs().max() > 0) and sim.pm_ti_endstep > 0):
        raise AssertionError(f"{label}: PM never ran")
    mom = momentum_rate(p.mass, p.accel + p.accel_pm)
    print(f"{label} [{card}]: {steps} steps to a={sim.time:.6g}, "
          f"{sim.num_force_updates} particle-steps in {wall:.2f} s = "
          f"{sim.num_force_updates / wall:.1f} particle-steps/s (FORCETEST "
          f"included), K1 launches {counts}, SPH passes "
          f"{sim.trace.prefixed('sph.')}, "
          f"sph_density {sph_s['density']:.2f} s, sph_hydro "
          f"{sph_s['hydro']:.2f} s, PM window ({sim.pm_ti_begstep}, "
          f"{sim.pm_ti_endstep}), gravity momentum rate {mom:.2e}, set-up "
          f"{init_s:.1f} s (FORCETEST's lattice tables EN={cfg.ngravs_en} "
          f"{tables_by}); host seconds by phase: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sim.cpu_timers.items()),
          flush=True)
    check_forcetest(label, ft_path, card, RMS_TREEPM, 1, steps)
    check_gas_state(sim, card, f"{label} gas state")
    if not mom < MOMENTUM_RATE:
        raise AssertionError(f"{label}: momentum rate {mom}")
    pm_ms = cuda_ms(lambda: sim.solver.pm_forces(p), 5)
    box_ms = SINGLE.get("box", {}).get("pm_ms")
    print(f"{label} PM forces [{card}]: {pm_ms:.2f} ms for "
          f"{cfg.n_gravs ** 2} (source, receiver) rounds (median of 5, CUDA "
          f"events); slice 2's {cfg.pmgrid} mesh, 4 rounds: "
          + (f"{box_ms:.2f} ms" if box_ms else "not run"), flush=True)
    stamp(f"{label} run")

    launched, attempts = [], []
    pass_solver(sim, launched=launched, attempts=attempts)
    worst = check_every_launch(f"{label} settling pass", launched, attempts)
    settled = settled_launches(launched, attempts)
    if not OVERFLOW_CHECKED["launches"]:
        # no recorded pass overflowed: one whose caps are cut, so that it
        # does
        from ngravs_tpu_torch.ops.solver import GravitySolver
        solver = GravitySolver(sim.cfg, sim.wiring, sim.force_soft,
                               sim.units.G, hubble=sim.units.hubble,
                               device=sim.device)
        solver.fcaps["chunk"] = OVERFLOW_CHUNK_CAP
        cut, cut_attempts = [], []
        with record_attempts(solver, cut, cut_attempts):
            solver.compute(all_active(sim), sim.ti_current, sim.p.n)
        worst = max(worst, check_every_launch(
            f"{label} pass, chunk cap cut to {OVERFLOW_CHUNK_CAP}", cut,
            cut_attempts))
        if not OVERFLOW_CHECKED["launches"]:
            raise AssertionError(f"{label}: no recorded pass overflowed")
    sim.close()
    return n_inst, settled, worst


def law_matrix(dev, card: str, path_counts: dict) -> list:
    """Phase 13: the four configurations, each launching its K1 instance on
    a real path: 13a newton_yukawa in the open box (BASELINE config 2,
    K1b), 13b bam with the accumulator (the halo as BAM dark matter, K1b
    with the count row), 13c the stock wiring in the periodic pure-tree box
    (K1c), 13d three species with gas in the TreePM box (BASELINE config 5,
    K1bcd at N_GRAVS=3).  Returns their kernel entries; adds each
    instance's launches to `path_counts`."""
    entries, launches = [], {}

    def record(key, what, n, launched, worst):
        batch = check_largest_launch(f"kernel ({key} batch)", launched)
        entries.append(kernel_entry(f"{batch['name']} (phase {key}, {what})",
                                    n, batch, [batch["max_abs_err"], worst]))
        path_counts[batch["name"]] = path_counts.get(batch["name"], 0) + n
        launches[batch["name"]] = n

    record("13a", "newton_yukawa open box, 60k", *open_law_path(
        dev, card, "13a newton_yukawa", "K1b", "newton_yukawa", {}))
    stamp("phase 13a (newton_yukawa)")
    # the halo as BAM dark matter (arXiv:1408.2702), the rest baryons.  The
    # geometric criterion: the relative one compares a node with a BAM
    # target's |a_old|, about 5e-6 of a baryon's, and opens every node for
    # its subgroup, so no BAM target would take a node
    record("13b", "bam with the accumulator, halo as BAM, 60k",
           *open_law_path(dev, card, "13b bam accumulator", "K1b+count",
                          "bam", {"GravityHalo": 1, "GravityDisk": 0,
                                  "TypeOfOpeningCriterion": 0},
                          pot_bounds={0: RMS_POT_OPEN, 1: RMS_TREE},
                          ngravs_accumulator=True))
    stamp("phase 13b (bam, accumulator)")
    n, launched, worst = ewald_path(dev, card, wiring="newton",
                                    label="13c stock periodic",
                                    instance="K1c", profile=False)
    record("13c", "stock newton periodic pure tree, 2 x 64^3", n, launched,
           worst)
    stamp("phase 13c (stock periodic box)")
    record("13d", "three_species TreePM + SPH, 3 x 64^3",
           *three_species_path(dev, card))
    stamp("phase 13d (three species)")
    print(f"law matrix K1 launches {launches}", flush=True)
    return entries


# --------------------------------------------------------------------------
# phase 14: the potential
# --------------------------------------------------------------------------

def potential_oracle(wiring, force_soft, g_const: float, p, idx=None,
                     box: float = 0.0, tables=None):
    """G times the direct-sum potential on the targets `idx` (every
    particle when None), periodic with the lattice correction when
    `tables` are given (ops/direct.py, as slice 2's force oracle), summed
    in float64: in the tabulated box d varies by a few 1e-8 of the
    potential, the rounding of a float32 sum."""
    from ngravs_tpu_torch.ops.direct import direct_forces
    fsoft = torch.as_tensor(force_soft, device=p.pos.device)[p.ptype.long()]
    kw = dict(box=box, lattice_tables=tables, chunk=32) \
        if tables is not None else dict(chunk=1024)
    _, pot = direct_forces(wiring, p.pos, p.mass, p.grav, fsoft,
                           tgt_idx=idx, want_pot=True, dtype=torch.float64,
                           **kw)
    return pot * g_const


def oracle_targets(n: int, dev):
    """The ORACLE_TARGETS sampled targets of the periodic oracles (the box
    path's TreePM pass, the periodic potential rule)."""
    rng = np.random.default_rng(3)
    return torch.as_tensor(np.sort(rng.choice(n, ORACLE_TARGETS,
                                              replace=False))
                           .astype(np.int32), device=dev)


def periodic_pot_errors(pot, pot_d, grav, n_gravs: int) -> list:
    """The periodic rule per gravity: (gravity, mean d, rms(d - mean d) /
    rms(pot_d)) of d = pot - pot_d."""
    out = []
    for g in range(n_gravs):
        s = grav == g
        if not bool(s.any()):
            continue
        d, pd = (pot[s] - pot_d[s]).double(), pot_d[s].double()
        m = d.mean()
        out.append((g, float(m), float(torch.sqrt(torch.mean((d - m) ** 2))
                                       / torch.sqrt(torch.mean(pd * pd)))))
    return out


def potential_pass(sim, card: str, label: str, instance, gate: dict):
    """Phase 14 on one path's final state (its steps are not run again):
    the K1 counts from 0, one `sim.update_full_potential()` with each K1
    launch recorded, `instance` (potential on; None for the tabulated
    box, which launches no K1) required in the counts, the potential
    finite, one energy.txt line (`energy_statistics`) with a finite Epot;
    the potential against the direct sum: `gate` {"open": {gravity:
    bound}} holds the rms over each gravity's particles of |dpot| /
    |pot_d| below its bound, {"periodic": bound} the periodic rule on
    ORACLE_TARGETS targets; then every K1 launch
    against the twin and the largest timed, its entry added to PHASE14."""
    from ngravs_tpu_torch.diagnostics.energy import format_energy_line
    from ngravs_tpu_torch.ops import lattice, pairwise
    t_start = time.perf_counter()
    p = sim.p
    launched, attempts = [], []
    k1_before = pairwise.instance_counts(sim.trace)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with record_attempts(sim.solver, launched, attempts):
        sim.update_full_potential()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = k1_since(sim.trace, k1_before)
    n_pot = counts.get(instance, 0) if instance else 0
    if instance and n_pot <= 0:
        raise AssertionError(f"{label}: the potential pass never launched "
                             f"{instance}: {counts}")
    if not instance and counts:
        raise AssertionError(f"{label}: K1 launched {counts}")
    pot = sim.p.potential
    if not bool(torch.isfinite(pot).all()):
        raise AssertionError(f"{label}: non-finite potential")
    s = sim.energy_statistics()
    if not math.isfinite(float(s.energy_pot)):
        raise AssertionError(f"{label}: Epot {float(s.energy_pot)}")
    print(f"{label} potential pass [{card}]: update_full_potential on "
          f"{sim.p.n} particles in {secs:.3f} s, K1 launches {counts}; "
          f"energy.txt line: {format_energy_line(sim.time, s)}", flush=True)
    cfg, ng = sim.cfg, sim.cfg.n_gravs
    if "open" in gate:
        pot_d = potential_oracle(sim.wiring, sim.force_soft, sim.units.G, p)
        rel = (pot - pot_d).abs() / pot_d.abs().clamp(min=1e-30)
        rms = rms_by_grav(rel, p.grav, ng)
        bounds = gate["open"]
        print(f"{label} potential [{card}]: rms |dpot| / |pot_direct| over "
              f"every particle by gravity "
              + ", ".join(f"{g}: {r:.3e} (gate {bounds[g]:g})"
                          for g, r in enumerate(rms)), flush=True)
        if not all(rms[g] < b for g, b in bounds.items()):
            raise AssertionError(f"{label}: potential rms by gravity {rms}")
    else:
        tabs = lattice.build_lattice_tables(sim.wiring, cfg.ngravs_en,
                                            cfg.box_size, device=p.pos.device)
        idx = oracle_targets(p.n, p.pos.device)
        pot_d = potential_oracle(sim.wiring, sim.force_soft, sim.units.G, p,
                                 idx, cfg.box_size, tabs)
        errs = periodic_pot_errors(pot[idx.long()], pot_d,
                                   p.grav[idx.long()], ng)
        print(f"{label} potential [{card}]: {ORACLE_TARGETS} targets against "
              f"the periodic direct sum with the lattice correction, by "
              f"gravity (mean d, rms(d - mean d) / rms(pot_direct)): "
              + ", ".join(f"{g}: {m:.6e}, {e:.3e}" for g, m, e in errs)
              + f" (gate {gate['periodic']:.3e})", flush=True)
        if not max(e for _, _, e in errs) < gate["periodic"]:
            raise AssertionError(f"{label}: periodic potential rule {errs}")
    if launched:
        worst = check_every_launch(f"{label} potential pass", launched,
                                   attempts)
        batch = check_largest_launch(f"kernel ({label} potential batch)",
                                     launched)
        PHASE14["entries"].append(kernel_entry(
            f"{batch['name']} (phase 14, {label}, update_full_potential)",
            n_pot, batch, [batch["max_abs_err"], worst]))
        PHASE14["counts"][instance] = PHASE14["counts"].get(instance, 0) \
            + n_pot
    PHASE14["seconds"] += time.perf_counter() - t_start
    stamp(f"phase 14, {label}")


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


DIST_KINDS = {"open_rep": (11, "60k open box, replicated step"),
              "open_let": (11, "60k open box, LET step's local tree"),
              "box_rep": (11, "2 x 64^3 TreePM box, replicated step"),
              "box_let": (11, "2 x 64^3 TreePM box, LET step's local tree"),
              "gas_rep": (12, "2 x 64^3 TreePM + SPH gas box, replicated "
                              "full step"),
              "gas_let": (12, "2 x 64^3 TreePM + SPH gas box, LET full "
                              "step's local tree")}


def dist_entries(results) -> list:
    """Phases 11's and 12's K1 entries, one per instance, IC and step: the
    launches of every rank of its 1- and 2-rank runs, and the numbers of
    rank 0's check on the larger of the two runs' largest launches."""
    groups = {}
    for job, per in results.items():
        kind = job.rsplit("_", 1)[0]
        for r in per:
            for name, v in r["counts"].items():
                g = groups.setdefault((name, kind), dict(launches=0,
                                                         nums=None, errs=[]))
                g["launches"] += v
        for name, nums in per[0]["k1"].items():
            g = groups[(name, kind)]
            g["errs"].append(nums["max_abs_err"])
            if g["nums"] is None or nums["rows"] > g["nums"]["rows"]:
                g["nums"] = nums
    entries = []
    for (name, kind), g in sorted(groups.items()):
        phase, what = DIST_KINDS[kind]
        if g["nums"] is None:
            raise AssertionError(f"phase {phase}: {name} ({kind}) launched "
                                 "on a rank but never checked on rank 0")
        entries.append(kernel_entry(
            f"{name} (phase {phase}, {what}, 1 rank over NCCL + 2 ranks "
            "over gloo)", g["launches"], g["nums"], g["errs"]))
    return entries


def main(argv=None) -> int:
    """All phases; `--phases 3,6,12` runs those alone (phase 12 needs 6)
    for a quicker look, its kernels line then of those phases only."""
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    only = None
    if argv[:1] == ["--phases"] and len(argv) == 2:
        only = {int(x) for x in argv[1].split(",")}
    elif argv:
        print("usage: python3 chip_smoke.py [--phases N,N,...]",
              file=sys.stderr)
        return 2
    want = lambda k: only is None or k in only
    from ngravs_tpu_torch.ops import lattice, pairwise, sph
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)

    t0 = time.perf_counter()
    native = lattice.build_native() is not None
    t1 = time.perf_counter()
    # the periodic paths' lattice tables (EN=64, the Newton and the Yukawa
    # lattice: FORCETEST's oracle, the pure-tree walk, phase 14) made on
    # the host while the kernel builds and phases 3, 4 and 9 run
    tables = None
    if any(want(k) for k in (5, 6, 7, 8, 10, 11, 12, 13)):
        tables = threading.Thread(target=prebuild_lattice_tables)
        tables.start()
    pairwise.build_library(verbose=True)
    t2 = time.perf_counter()
    sph.build_library(verbose=True)
    t3 = time.perf_counter()
    lattice.build_k3(verbose=True)
    print(f"build: pair kernel {t2 - t1:.1f} s, SPH kernels "
          f"{t3 - t2:.1f} s, lattice kernel {time.perf_counter() - t3:.1f} s; "
          f"lattice-table generator "
          f"{'native' if native else 'numpy (no host compiler)'} "
          f"{t1 - t0:.1f} s", flush=True)

    entries = []
    path_counts = {}
    synthetic = {}
    launches1 = 0
    if want(3):
        # phase 3: every instance on synthetic walk-shaped inputs
        synthetic["K1a"] = check_kernel("kernel (synthetic)",
                                        *kernel_inputs(dev), (False, True))
        for i, case in enumerate(K1_CASES):
            w, kw = case_wiring(case)
            inputs = kernel_inputs(dev, seed=10 + i, n_gravs=w.n_gravs,
                                   box=kw["box_size"],
                                   count=kw["accumulator"])
            synthetic[case] = check_kernel(f"kernel (synthetic, {case})",
                                           *inputs, (False, True), kw)
        stamp("build and synthetic K1 instances")
    # phases 4-8: the five paths, each with its counts from 0
    if want(4):
        launches1, launched = galaxy_path(dev, card)
        batch = check_largest_launch("kernel (main-path batch)", launched)
        entries.append(kernel_entry(
            "K1a (slice 1 path, open box, one Newton law)", launches1, batch,
            [batch["max_abs_err"]] + [r["max_abs_err"] for r in
                                      synthetic.get("K1a", {}).values()]))
        stamp("slice 1")
    if want(9):
        # phase 9 needs no lattice table: it runs while they are made
        segment_paths(dev, card)
    if tables is not None:
        t0 = time.perf_counter()
        tables.join()
        stamp(f"lattice tables ready (waited {time.perf_counter() - t0:.1f}"
              " s)")
    if want(5):
        launches2, launched = box_path(dev, card)
        batch = check_largest_launch("kernel (box-path batch)", launched)
        entries.append(kernel_entry(
            f"{batch['name']} (box path, newton_yukawa periodic TreePM)",
            launches2, batch, [batch["max_abs_err"]]))
        path_counts[batch["name"]] = path_counts.get(batch["name"], 0) \
            + launches2
        stamp("slice 2 (box path, reproducibility)")
    if want(6):
        launches3, launched, sph_entries = gas_path(dev, card)
        batch = check_largest_launch("kernel (gas-path batch)", launched)
        entries.append(kernel_entry(
            f"{batch['name']} (gas path, newton_yukawa periodic TreePM + "
            "SPH)", launches3, batch, [batch["max_abs_err"]]))
        path_counts[batch["name"]] = path_counts.get(batch["name"], 0) \
            + launches3
        entries += sph_entries
        stamp("slice 3 (gas)")
    if want(7):
        launches4, launched, ewald_err = ewald_path(dev, card)
        batch = check_largest_launch("kernel (Ewald-path batch)", launched)
        del launched
        entries.append(kernel_entry(
            f"{batch['name']} (slice 4a path, newton_yukawa periodic pure "
            "tree, beside the lattice pass)", launches4, batch,
            [batch["max_abs_err"], ewald_err]))
        stamp("slice 4a (Ewald)")
    if want(8):
        tabulated_path(dev, card)
        stamp("slice 4b (tabulated TreePM)")
    if want(10):
        launches5, launched = glass_path(dev, card)
        batch = check_largest_launch("kernel (glass-path batch)", launched)
        del launched
        entries.append(kernel_entry(
            f"{batch['name']} (glass path, one Newton law periodic TreePM)",
            launches5, batch, [batch["max_abs_err"]]))
        path_counts[batch["name"]] = path_counts.get(batch["name"], 0) \
            + launches5
        stamp("phase 10a (glass)")
        special_mode_runs(dev, card)
        stamp("phase 10b (FLEXSTEPS, PSEUDOSYMMETRIC)")
        sheet_path(dev, card)
        stamp("phase 10c (TWODIMS, LONG_X)")
    dist = {}
    if want(11) or want(12):
        dist = distributed_runs(card, {k for k in (11, 12) if want(k)})
    entries += dist_entries(dist)
    if want(13):
        entries += law_matrix(dev, card, path_counts)
    entries += K3_ENTRIES
    # phase 14 ran inside each path, after its steps
    entries += PHASE14["entries"]
    for name, n in PHASE14["counts"].items():
        path_counts[name] = path_counts.get(name, 0) + n
    print(f"phase 14: the potential passes took {PHASE14['seconds']:.1f} s "
          f"in all; K1 launches {PHASE14['counts']}", flush=True)
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
