"""Wall microseconds of the gravity solve (`cpu_timers["gravity"]`: tree
build or refresh, walk and K1, ending synchronised) per active-particle
update of the window."""


def read(v):
    w = v["window"]
    if w["updates"] <= 0:
        return None
    return 1e6 * w["timers"]["gravity"] / w["updates"]
