"""The Ewald cell with its lattice correction left out: the benchmark's
check must come out not correct.

    python3 tools/port_studies/lattice_left_out.py --seeds 11 12 13 \
        [--workload ewald_2x64.full] [--seconds 3] [--out readings.jsonl]

`portbench/faults.py` has no such fault (that file belongs to the
benchmark), so this study plants it itself: every `GravitySolver` built in
the run walks without its lattice tables, so the periodic tree's pair sums
keep their minimum image and nothing adds the rest of the lattice (the
force of a Gadget-2 build with PERIODIC and without the Ewald
correction).  For each seed it runs the cell as `portbench/calibrate.py`
does (its own Simulation from the seed, the warm-up, a short window, the
check against the plain reference) and prints one JSON line: the seed,
`correct`, and each reading beside its limit.  Needs a CUDA card, as the
benchmark does; exits 1 if any seed came out correct.
"""

import argparse
import contextlib
import json
import os
import sys
import time

for _k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):   # as portbench/run.py
    os.environ[_k] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@contextlib.contextmanager
def lattice_left_out():
    """Every GravitySolver built inside walks without its lattice tables."""
    from ngravs_tpu_torch.ops.solver import GravitySolver
    real = GravitySolver.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.lattice_tables = None
    GravitySolver.__init__ = init
    try:
        yield
    finally:
        GravitySolver.__init__ = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="ewald_2x64.full")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "portbench"))
    import torch
    torch.set_num_threads(1)
    import harness
    if not torch.cuda.is_available():
        print("lattice_left_out: no CUDA card", file=sys.stderr)
        return 2
    harness.import_port()
    bench = harness.benchmark_file()
    any_correct = False
    for seed in args.seeds:
        cell = harness.Cell(args.workload)
        with open(os.devnull, "w") as null, lattice_left_out():
            res = harness.run(cell, seed, args.seconds, False,
                              time.perf_counter(), bench=bench, stream=null)
        any_correct |= res["correct"]
        line = dict(workload=args.workload, seed=seed,
                    fault="lattice_left_out", correct=res["correct"],
                    readings={k: v["value"] for k, v in res["check"].items()},
                    limits={k: v["limit"] for k, v in res["check"].items()})
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 1 if any_correct else 0


if __name__ == "__main__":
    sys.exit(main())
