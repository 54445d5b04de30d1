"""Wall microseconds of the SPH timer (`cpu_timers["hydro"]`: the density
iterations and the hydro pass, ending synchronised) per active gas update
of the window."""


def read(v):
    w = v["window"]
    n = w["counts"]["gas_updates"]
    if n <= 0:
        return None
    return 1e6 * w["timers"]["hydro"] / n
