"""Wall microseconds of the SPH density iterations (the trace's
`sph.density` span: every smoothing-length iteration, ending on its own
convergence read, so with the iterations' device time) per active gas
update of the window: the density half of `sph.us_per_gas_particle`."""


def read(v):
    w = v["window"]
    t, n = w["timers"].get("sph.density"), w["counts"].get("gas_updates", 0)
    if t is None or n <= 0:
        return None
    return 1e6 * t / n
