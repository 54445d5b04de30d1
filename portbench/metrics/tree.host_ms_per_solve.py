"""Host milliseconds of the gravity tree's build or refresh per gravity
solve: the trace's `tree` span (the build or refresh, the fat-leaf loop,
the octet measure) less the waits on the card inside it (`wait.tree` and
those of any span nested in it), over the solves the benchmark counted
around `GravitySolver.compute`.  The fixed cost a solve pays whatever its
active set."""


def read(v):
    w = v["window"]
    t, n = w["timers"], w["counts"].get("solves", 0)
    if "tree" not in t or n <= 0:
        return None
    wait = sum(s for k, s in t.items()
               if k == "wait.tree" or k.startswith("wait.tree."))
    return 1e3 * (t["tree"] - wait) / n
