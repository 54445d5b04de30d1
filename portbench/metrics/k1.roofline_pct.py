"""K1's share of its roofline in the profiled sub-window: the least time
the card could take for the valid pairs K1 evaluated (the solver's n_ia
times the fewest operations a pair takes, roofline.py) over the device
time of the kernels named pairwise_kernel.  A floor, stated against the
H100's published FP32 peak."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import roofline  # noqa: E402


def read(v):
    p = v["profile"]
    if p["k1_s"] <= 0 or p["counts"]["n_ia"] <= 0:
        return None
    ops = roofline.config_ops_per_pair(v["config"])
    return 100.0 * roofline.bound_s(p["counts"]["n_ia"], p["updates"], ops) \
        / p["k1_s"]
