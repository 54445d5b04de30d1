"""Every K1 launch of a settling force pass, the walk attempts that overflow
included, against the twin on the GPU.

    python3 tools/port_studies/overflow_launches.py [--nside N] [--out DIR]
        [--only 13d,box,open] [--ab PARENT_CU]

chip_smoke.py's paths at their own sizes (N = 64: 3 x 64^3 for phase
13d's three species with gas, 2 x 64^3 for slice 2's TreePM box, 60k for
slice 1's open box), each run one step, then force passes of fresh
solvers on that state: as the solver settles its caps by itself, and with
its caps cut so that the walk overflows: the chunk cap (64 chunks a
block), the frontier caps (64 slots a level) and, after one settled pass,
the octet caps halved (the octet layout overflows on the next tree).
Every K1 launch of each pass is held to the twin as chip_smoke.py's
`check_every_launch` holds it (acc and pot within 1e-5 of each target's
sum of |terms|, pair counts equal) and tagged with its walk attempt.  A
launch that disagrees is described (`report_disagreement`) and its inputs
saved under DIR (build/overflow_launches by default): the first
whole, the others by their failing blocks.  Imports no JAX; needs the GPU.
One line a pass: launches, the attempts that overflowed, failures.
With --ab, the largest launch of each settling pass's last attempt is
timed with K1 built from this checkout and from PARENT_CU (another
`pairwise.cu` with the same C interface), in turns: parent, this, this,
parent, each the median of 20 launches (CUDA events).
"""

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def fresh_solver(sim):
    from ngravs_tpu_torch.ops.solver import GravitySolver
    return GravitySolver(sim.cfg, sim.wiring, sim.force_soft, sim.units.G,
                         hubble=sim.units.hubble, device=sim.device)


def kernel_library(src: str):
    """K1's library built from `src`, loaded as `pairwise._library` loads
    this checkout's."""
    from ngravs_tpu_torch.ops import pairwise
    build, lib = pairwise.build_library, pairwise._lib
    pairwise.build_library = lambda: build(src=src)
    pairwise._lib = None
    try:
        return pairwise._library()
    finally:
        pairwise.build_library, pairwise._lib = build, lib


def time_ab(label: str, launch, parent_src: str):
    """The launch timed with this checkout's K1 and the parent's, in
    turns."""
    from ngravs_tpu_torch.ops import pairwise
    libs = {"this": pairwise._library(),
            "parent": kernel_library(parent_src)}
    ms = {"this": [], "parent": []}
    for which in ("parent", "this", "this", "parent"):
        pairwise._lib = libs[which]
        ms[which].append(cs.cuda_ms(lambda: pairwise.pairwise_eval(*launch[:4],
                                                                   **launch[4]),
                                    20))
    pairwise._lib = libs["this"]
    targets, sp, n_src = launch[:3]
    print(f"{label}: A/B on the largest settled launch {tuple(sp.shape)}, "
          f"{int(n_src.sum())} source rows: this "
          + ", ".join(f"{x:.4f}" for x in ms["this"]) + " ms, parent "
          + ", ".join(f"{x:.4f}" for x in ms["parent"]) + " ms", flush=True)


def held_pass(label: str, sim, out_dir: str, saved: list, chunk=None,
              frontier=None, octet_cut: bool = False, ab=None) -> int:
    """One recorded pass of a fresh solver (caps cut as asked), every
    launch against the twin; with `ab` (a parent K1 source) the largest
    launch of its last attempt timed against it.  Returns the launches
    that disagree."""
    solver = fresh_solver(sim)
    if octet_cut:
        solver.compute(cs.all_active(sim), sim.ti_current, sim.p.n)
        solver.octet_caps = tuple(max(1, c // 2) for c in solver.octet_caps)
    if chunk:
        solver.fcaps["chunk"] = chunk
    if frontier:
        solver.fcaps["frontier"] = frontier
    launched, attempts = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cs.record_attempts(solver, launched, attempts):
        solver.compute(cs.all_active(sim), sim.ti_current, sim.p.n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tags = ["?"] * len(launched)
    for k, (first, end, ovf, lovf) in enumerate(attempts):
        tags[first:end] = [f"attempt {k + 1}"
                           + (" overflowed" if ovf else " settled")
                           + (" (octet layout)" if lovf else "")] \
            * (end - first)
    bad_by = {}
    worst = 0.0
    for i, launch in enumerate(launched):
        err, bad, out = cs.compare_launch(*launch)
        worst = max(worst, err)
        if bool(bad.any()):
            bad_by[tags[i]] = bad_by.get(tags[i], 0) + 1
            if len(saved) < 12:
                saved.append(cs.report_disagreement(
                    label, i, launch, bad, out, tags[i], out_dir,
                    whole=not saved))
    ns = [int(launch[2].max()) for launch in launched]
    full = sum(int((launch[2] == launch[1].shape[2]).sum())
               for launch in launched)
    per = ", ".join(f"{e - f} {'overflowed' if ovf else 'settled'}"
                    for f, e, ovf, _ in attempts)
    print(f"{label}: {len(launched)} launches in {len(attempts)} attempts "
          f"({per}), "
          f"pass {wall:.2f} s, caps after {solver.fcaps['chunk']} chunks, "
          f"S {max(launch[1].shape[2] for launch in launched)}, blocks "
          f"with n_src == S {full}, n_src max {max(ns)}; disagreeing "
          f"launches {bad_by or 0}, max|dacc| {worst:.3g}", flush=True)
    if ab:
        first, end = attempts[-1][:2]
        time_ab(label, cs.largest_launch(launched[first:end]), ab)
    del launched
    torch.cuda.empty_cache()
    return sum(bad_by.values())


def run_box(label: str, make_cfg, out_dir: str, saved: list, ab=None):
    from ngravs_tpu_torch.integrate.runner import Simulation
    sim = Simulation(make_cfg(), device=torch.device("cuda", 0))
    sim.run(max_steps=1)
    cs.stamp(f"{label}: one step ({sim.p.n} particles)")
    bad = held_pass(f"{label}, settling", sim, out_dir, saved, ab=ab)
    bad += held_pass(f"{label}, chunk cap 64", sim, out_dir, saved,
                     chunk=64)
    bad += held_pass(f"{label}, frontier caps 64", sim, out_dir, saved,
                     frontier=64)
    bad += held_pass(f"{label}, octet caps halved", sim, out_dir, saved,
                     octet_cut=True)
    sim.close()
    cs.stamp(label)
    return bad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nside", type=int, default=cs.BOX_NSIDE)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "overflow_launches"))
    ap.add_argument("--only", default="13d,box,open")
    ap.add_argument("--ab", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("overflow_launches: needs the GPU", file=sys.stderr)
        return 1
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.ops import pairwise
    print(f"card: {cs.card_line()}", flush=True)
    pairwise.build_library()
    cs.BOX_NSIDE = args.nside
    pmgrid = 2 * args.nside
    saved = []
    bad = 0
    only = set(args.only.split(","))
    base = os.path.join(ROOT, "build", "overflow_launches")
    if "13d" in only:
        d = os.path.join(base, "three")
        os.makedirs(d, exist_ok=True)
        param = cs.write_gas_box(d, name="three_species_box", three=True)
        bad += run_box("13d three species", lambda: read_parameter_file(
            param, pmgrid=pmgrid, n_gravs=3, wiring="three_species",
            pm_interlace=True), args.out, saved, args.ab)
    if "box" in only:
        d = os.path.join(base, "box")
        os.makedirs(d, exist_ok=True)
        param = cs.write_cosmo_box(d)
        bad += run_box("slice 2 box", lambda: read_parameter_file(
            param, pmgrid=pmgrid, n_gravs=2, wiring="newton_yukawa",
            pm_interlace=True), args.out, saved, args.ab)
    if "open" in only:
        d = os.path.join(base, "open")
        os.makedirs(d, exist_ok=True)
        param = cs.write_galaxy_collision(d)
        bad += run_box("slice 1 open box", lambda: read_parameter_file(
            param, direct_crossover=1000, tree_depth=12), args.out, saved,
            args.ab)
    print(f"disagreeing launches in all: {bad}", flush=True)
    for line in saved:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
