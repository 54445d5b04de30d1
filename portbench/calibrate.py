"""Readings for setting a cell's limits, and the walk-batch sweep.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 13 \
        --seconds 3 [--control 3] [--set port.walk_batch_blocks=512] \
        [--fault pm_left_out] [--out readings.jsonl]

Runs the cell once a seed in one process (each run builds its own
Simulation from its seed, warms it up and times a short window) and
prints, a seed, the program's readings and, for the first `--control`
seeds, the control's: the reference computed in bfloat16 in the
program's place.  `--set` changes a key of the configuration file for
this process only (a dotted path).  `--fault` plants one of `faults.py`'s
faults in the port for every run.  The benchmark's own runs never run
this.
"""

import argparse
import json
import os
import sys
import time

for _k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):   # as run.py
    os.environ[_k] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    torch.set_num_threads(1)
    import contextlib
    import faults
    import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    harness.import_port()
    bench = harness.benchmark_file()
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        cell = harness.Cell(args.workload)
        for item in args.set:
            key, val = item.split("=", 1)
            *path, last = key.split(".")
            node = cell.config
            for k in path:
                node = node[k]
            node[last] = json.loads(val)
        fault = faults.FAULTS[args.fault](cell) if args.fault \
            else contextlib.nullcontext()
        with open(os.devnull, "w") as null, fault:
            res = harness.run(cell, seed, args.seconds, bool(args.trace),
                              time.perf_counter(), bench=bench, stream=null,
                              control=i < args.control, detail=True)
        line = dict(workload=args.workload, seed=seed, set=args.set,
                    fault=args.fault,
                    correct=res["correct"], metrics=res["metrics"],
                    readings={k: v["value"] for k, v in res["check"].items()},
                    control=res.get("control"),
                    gravity_detail=res.get("gravity_detail"),
                    memory_peak_bytes=res["device"]["memory_peak_bytes"])
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
