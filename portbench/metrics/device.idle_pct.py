"""Share of the profiled sub-window in which no kernel, copy or fill ran
on the card."""


def read(v):
    p = v["profile"]
    if p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
