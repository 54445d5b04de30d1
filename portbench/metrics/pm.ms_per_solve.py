"""Wall milliseconds of the PM timer (`cpu_timers["pm"]`, ending
synchronised) per PM solve the benchmark counted around
`GravitySolver.pm_forces`, over the window."""


def read(v):
    w = v["window"]
    n = w["counts"]["pm_solves"]
    if n <= 0:
        return None
    return 1e3 * w["timers"]["pm"] / n
