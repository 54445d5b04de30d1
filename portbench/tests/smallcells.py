"""Small cells for the benchmark's CPU tests."""

import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

import harness  # noqa: E402

harness.import_port()


def small_cell(name: str) -> harness.Cell:
    """The cell with its particle count cut for the CPU: 2 x 8^3 with
    PMGRID 16 for the gas box, 3,000 particles walking an 8-level tree for
    the galaxies (softening kept at its fraction of the spacing), and the
    walk in batches of 128 blocks (a batch of 2048 makes the CPU's pair
    evaluation hold gigabytes; forces do not depend on it)."""
    c = harness.Cell(name)
    c.config["port"]["walk_batch_blocks"] = 128
    if c.config["ic"]["generator"] == "gas_box":
        ns = 8
        c.config["ic"]["n_side"] = ns
        c.config["port"]["pmgrid"] = 2 * ns
        box = c.config["param"]["BoxSize"]
        for k in ("SofteningGas", "SofteningHalo"):
            c.config["param"][k] = box / ns / 30
        c.workload["check"].update(grav_targets=256, gas_targets=128)
    else:
        c.config["ic"]["npart"] = [0, 500, 1000, 500, 500, 500]
        c.config["port"].update(direct_crossover=100, tree_depth=8)
        c.workload["check"]["grav_targets"] = 512
    return c


def run_small(name: str, seed: int, seconds: float = 2.0, trace=False,
              control=False, cell=None):
    with open(os.devnull, "w") as null:
        return harness.run(cell or small_cell(name), seed, seconds, trace,
                           time.perf_counter(), device="cpu", stream=null,
                           control=control)
