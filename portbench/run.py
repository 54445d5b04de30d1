"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds ngravs_tpu_torch's Simulation for the cell named in BENCHMARK.json
on the first CUDA card, warms it up, times `Simulation.step()` for
`--seconds`, checks the outputs against the plain reference and prints one
JSON line last on standard output (`--trace 0`: the end-to-end metrics;
`--trace 1`: the per-layer metrics, the device's busy time and a
breakdown).  Without a card, or with fewer cards than the cell asks for,
it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with one host thread: the port's host work is serial, and
# idle OpenMP workers spinning on a shared host only add noise
for _k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_k] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import torch
        torch.set_num_threads(1)
        import harness
        bench = harness.benchmark_file()
        entry = next(w for w in bench["workloads"]
                     if w["name"] == args.workload)
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(entry["chips"]):
            print(f"portbench: {args.workload} needs {entry['chips']} CUDA "
                  "card(s); none or too few here", file=sys.stderr)
            return 2
        harness.import_port()
        harness.run(harness.Cell(args.workload), args.seed, args.seconds,
                    bool(args.trace), T_START, bench=bench)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
