"""Host microseconds of the walk per active-particle update: the trace's
`walk` span (the attempts: tables, batches, traversal, chunk lists,
gathers, the K1 launch and the overflow reads) less the waits on the card
inside it (`wait.walk` and those of the spans nested in it,
`wait.walk.traverse`, `wait.walk.k1`, ...), over the window's updates.
The walk's dispatch, which CUDA graphs or fewer launches would cut."""


def read(v):
    w = v["window"]
    t = w["timers"]
    if "walk" not in t or w["updates"] <= 0:
        return None
    wait = sum(s for k, s in t.items()
               if k == "wait.walk" or k.startswith("wait.walk."))
    return 1e6 * (t["walk"] - wait) / w["updates"]
