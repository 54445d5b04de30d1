"""Host microseconds of the port's own work per active-particle update:
the window's wall time less the seconds the port waited on the card
(`cpu_timers["wait"]`: the trace's timer on every explicit host read and
synchronisation of the step, and on every torch operation of the step
that waits by itself, such as `nonzero` or a copy from the host), over
the window's updates.  Nothing to read where the port keeps no such
timer."""


def read(v):
    w = v["window"]
    wait = w["timers"].get("wait")
    if wait is None or w["updates"] <= 0:
        return None
    return 1e6 * (w["window_s"] - wait) / w["updates"]
