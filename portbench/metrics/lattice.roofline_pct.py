"""K3's share of its roofline in the profiled sub-window: the least time
the card could take for the valid pairs K3 corrected (the solver's n_ia:
K3 corrects exactly K1's valid pairs) times the fewest operations a pair
takes in K3 (`lattice_roofline.OPS_LATTICE`), by `roofline.bound_s`, over
K3's device time (every device operation whose name holds
`lattice_kernel`, read from the trace's ten largest).  None where K3 is
not among the ten largest device operations: a cell without lattice
tables never launches it.  A floor, stated against the H100's published
FP32 peak."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import lattice_roofline  # noqa: E402
import roofline  # noqa: E402


def read(v):
    p = v["profile"]
    t = lattice_roofline.k3_seconds(p)
    if t <= 0 or p["counts"]["n_ia"] <= 0:
        return None
    return 100.0 * roofline.bound_s(p["counts"]["n_ia"], p["updates"],
                                    lattice_roofline.OPS_LATTICE) / t
