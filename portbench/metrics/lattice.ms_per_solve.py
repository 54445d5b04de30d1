"""K3's device time in the profiled sub-window (every device operation
whose name holds `lattice_kernel`, read from the trace's ten largest) over
the gravity solves counted there, in milliseconds.  None where K3 is not
among the ten largest device operations: a cell without lattice tables
never launches it."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import lattice_roofline  # noqa: E402


def read(v):
    p = v["profile"]
    t = lattice_roofline.k3_seconds(p)
    if t <= 0 or p["counts"]["solves"] <= 0:
        return None
    return 1e3 * t / p["counts"]["solves"]
