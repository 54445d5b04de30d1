"""Kernels the host launched while the gravity solve ran (the launch
calls inside the benchmark's `gravity` span around
`GravitySolver.compute`: tree, walk and K1), in the profiled sub-window,
per thousand active-particle updates in it: the walk's host dispatch,
which grows with the number of walk batches.  Launches under the SPH and
PM spans are not counted."""


def read(v):
    p = v["profile"]
    n = p["launches"].get("gravity", 0)
    if p["updates"] <= 0 or n <= 0:
        return None
    return n / (p["updates"] / 1000.0)
