"""Where the card idles inside the port: one profiled sub-window of each
benchmark cell, its idle time and launch calls by the innermost
`ngravs.*` range (the port's trace spans, `ngravs_tpu_torch/trace.py`).

    python3 tools/port_studies/idle_by_span.py
        [--cells lcdm_gas.full,galaxy.tree] [--seed N] [--seconds S]
        [--root CHECKOUT] [--out DIR] [--syncs K]

For each cell it drives `portbench`'s own functions (imported, not
edited): the cell's Simulation from the seed, the warm-up, a timed window
of S seconds (51, the benchmark's), then whole sync points under
torch.profiler as the benchmark profiles them (the traffic's `profile`
rule, `portbench.*` ranges on).  The trace is reduced as `devtrace.py`
reduces it, with the idle gaps (and the host's launch calls) charged to
the innermost `ngravs.*` range open at each gap's middle; a gap under no
range below `total` is named by the innermost benchmark span.  Blocked
means busy: the idle time inside `ngravs.wait` should be near 0, which
checks that the port's ranges share the trace's clock.  The host's
blocking calls (`cuda*Synchronize`) are summed by the innermost range
too: those outside `ngravs.wait` are the waits inside torch operations
that synchronise by themselves (a boolean mask, `nonzero`), which the
trace's `wait` timer does not see.  The trace's counters over the timed
window and the profiled sync points are printed beside.

The costs: a twin Simulation from the same seed (the port repeats bit
for bit on the card) is brought to the same sync point.  Under the
profiler, the twins then take turns over the same sync points, one with
the port's ranges and one without (the spans' profiler check patched to
False), which one alternating by round (`--rounds`).  With no profiler,
they step in lockstep, one with its trace and one `untraced` (spans,
reads and counts as the port made them before it had a trace), swapped
half way (`--cost-steps`); the summed walls are printed side by side.

`--syncs K` instead steps K warm sync points of each cell under CUDA's
sync debug mode and prints the lines of the port that made the host
wait, with their counts and whether the trace timed each (a `read`,
`sync` or `blocking` on the stack), and the trace's host reads and syncs
where the checkout has a trace: `--root` another checkout (a parent) to
hold the counts equal.  `--steps K` times K warm sync points one by one
(wall, updates and the timers of each), to set two checkouts' steps side
by side.  The profiled rounds also give the device's idle share with the
ranges on and off.

Needs the GPU; imports no JAX.  One JSON file a cell under --out
(build/idle_by_span by default).
"""

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PREFIX = "ngravs."
BENCH_PREFIX = "portbench."


def innermost(ranges, points):
    """For each of the sorted `points`, the name of the innermost of the
    properly nested `ranges` ((name, start, end)) open there, or None."""
    order = sorted(ranges, key=lambda r: (r[1], -r[2]))
    out, stack, j = [], [], 0
    for t in points:
        while j < len(order) and order[j][1] <= t:
            while stack and stack[-1][2] <= order[j][1]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def attribute(prof, devtrace) -> dict:
    """The profiled sub-window's busy and idle seconds, idle and launch
    calls by the innermost port range, and by the innermost benchmark span
    where no port range below `total` is open."""
    ops, ours, bench, calls, host, blocks = [], [], [], [], set(), []
    for name, on_device, s, e, ann in devtrace._events(prof):
        if not on_device and "Synchronize" in name:
            blocks.append((s, e))
        if on_device:
            ops.append((name, s, e, ann))
        elif name.startswith(PREFIX):
            ours.append((name[len(PREFIX):], s, e))
            host.add(name)
        elif name.startswith(BENCH_PREFIX):
            bench.append((name[len(BENCH_PREFIX):], s, e))
            host.add(name)
        elif ann:
            host.add(name)
        elif any(k in name for k in devtrace.LAUNCH_MARKS):
            calls.append(s)
    ops = [(s, e) for n, s, e, ann in ops
           if not ann and n not in host
           and not n.startswith((PREFIX, BENCH_PREFIX))]
    steps = [(s, e) for n, s, e in bench if n == "step"]
    lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    inside = [(max(s, lo), min(e, hi)) for s, e in ops if e > lo and s < hi]
    gaps = devtrace.gaps(inside, lo, hi)
    mids = [(s + e) // 2 for s, e in gaps]
    order = sorted(range(len(gaps)), key=lambda i: mids[i])
    sorted_mids = [mids[i] for i in order]
    ours_at = dict(zip(order, innermost(ours, sorted_mids)))
    bench_at = dict(zip(order, innermost(bench, sorted_mids)))
    idle, rest = {}, {}
    for i, (s, e) in enumerate(gaps):
        k = ours_at[i] or "outside ngravs ranges"
        idle[k] = idle.get(k, 0) + e - s
        if ours_at[i] in (None, "total"):
            b = f"{k} / {BENCH_PREFIX}{bench_at[i] or 'none'}"
            rest[b] = rest.get(b, 0) + e - s
    calls = sorted(t for t in calls if lo <= t < hi)
    launches = {}
    for k in innermost(ours, calls):
        k = k or "outside ngravs ranges"
        launches[k] = launches.get(k, 0) + 1
    blocks = sorted((s, e) for s, e in blocks if lo <= s < hi)
    blocked = {}
    for (s, e), k in zip(blocks, innermost(ours, [s for s, _ in blocks])):
        k = k or "outside ngravs ranges"
        blocked[k] = blocked.get(k, 0) + e - s
    idle_ns = sum(idle.values())
    below = sum(v for k, v in idle.items()
                if k not in ("total", "outside ngravs ranges"))
    by = lambda d: dict(sorted(d.items(), key=lambda x: -x[1]))
    return dict(
        window_s=(hi - lo) / 1e9,
        busy_s=devtrace.union_length(inside) / 1e9,
        idle_s=idle_ns / 1e9,
        idle_below_total_share=below / idle_ns if idle_ns else 0.0,
        idle_in_wait_share=idle.get("wait", 0) / idle_ns if idle_ns else 0.0,
        idle_by_range={k: v / 1e9 for k, v in by(idle).items()},
        idle_not_below_total={k: v / 1e9 for k, v in by(rest).items()},
        launches_by_range=by(launches), launches=len(calls),
        blocked_s=sum(blocked.values()) / 1e9,
        blocked_outside_wait_s=sum(v for k, v in blocked.items()
                                   if k != "wait") / 1e9,
        blocked_by_range={k: v / 1e9 for k, v in by(blocked).items()})


def profiled(harness, sim, rec, n_sync: int | None, traffic, device):
    """Whole sync points under torch.profiler, as the benchmark profiles
    them: `n_sync` of them, or the traffic's rule.  Returns (profile,
    sync points, wall seconds, updates)."""
    import torch
    spec = traffic["profile"]
    u0 = sim.num_force_updates
    rec.annotate = True
    harness.sync(device)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = 0
        while True:
            rec.step(sim)
            n += 1
            if n_sync is not None:
                if n >= n_sync:
                    break
            elif time.perf_counter() - t0 >= float(spec["min_seconds"]) \
                    or n >= int(spec["max_sync_points"]):
                break
        harness.sync(device)
        wall = time.perf_counter() - t0
    rec.annotate = False
    return prof, n, wall, sim.num_force_updates - u0


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


class untraced:
    """Within the block, `trace` does what the port did before it had
    one: a span is no range and no timer, a read a plain copy, a sync a
    plain synchronisation, a blocking operation a plain call, a count
    nothing (with no span open, code handed no trace counts and times
    nothing either)."""

    def __init__(self, trace, device):
        self.trace, self.device = trace, device

    def __enter__(self):
        import contextlib
        import torch
        dev, null = self.device, contextlib.nullcontext()
        self.trace.span = lambda name: null
        self.trace.read = lambda t: t.cpu()
        self.trace.sync = lambda d: torch.cuda.synchronize(dev) \
            if dev.type == "cuda" else None
        self.trace.count = lambda *a: None
        self.trace.blocking = lambda fn, *a, **kw: fn(*a, **kw)
        return self

    def __exit__(self, *exc):
        for k in ("span", "read", "sync", "count", "blocking"):
            delattr(self.trace, k)
        return False


def lockstep(harness, sims, steps: int, traced, device) -> list:
    """`steps` sync points of each of the twin `sims` (the same state),
    one sim's step after the other's in alternating order; `traced(k)`
    says whether sim k runs with its trace (else `untraced`).  Returns
    each sim's summed wall seconds, the card synchronised around every
    step."""
    import contextlib
    walls = [0.0, 0.0]
    for i in range(steps):
        for k in ((0, 1) if i % 2 == 0 else (1, 0)):
            sim, rec = sims[k]
            ctx = contextlib.nullcontext() if traced(k) \
                else untraced(sim.trace, device)
            with ctx:
                harness.sync(device)
                t0 = time.perf_counter()
                rec.step(sim)
                harness.sync(device)
                walls[k] += time.perf_counter() - t0
    return walls


def idle_study(harness, devtrace, cell_name, seed, seconds, device,
               rounds: int, cost_steps: int):
    import tempfile
    import ngravs_tpu_torch.trace as ttrace
    cell = harness.Cell(cell_name)
    out = {"cell": cell_name, "seed": seed, "card": card()}
    diff = lambda a, b: {k: v - a.get(k, 0) for k, v in b.items()
                         if v != a.get(k, 0)}
    with tempfile.TemporaryDirectory(prefix="idle_by_span_") as tmp:
        sims = []
        for _ in range(2):
            sim = harness.make_simulation(cell, seed, device, tmp)
            rec = harness.Recorder(sim)
            sims.append((sim, rec, harness.warm_up(sim, rec, cell.traffic,
                                                   device)))
        (sim, rec, pm_last), (twin, twin_rec, _) = sims
        sims = [(sim, rec), (twin, twin_rec)]
        c0 = dict(sim.trace.counts)
        win, _ = harness.run_window(sim, rec, seconds, 1, pm_last, device)
        c1 = dict(sim.trace.counts)
        prof, n, wall, updates = profiled(harness, sim, rec, None,
                                          cell.traffic, device)
        out.update(window_sync_points=win["sync_points"],
                   timed_window_s=win["window_s"],
                   window_updates=win["updates"],
                   window_timers=win["timers"],
                   window_counts=diff(c0, c1),
                   profiled_counts=diff(c1, dict(sim.trace.counts)),
                   sync_points=n, updates=updates, profiled_wall_s=wall,
                   **attribute(prof, devtrace))
        del prof
        # the twin to the same sync point (the port repeats bit for bit)
        for _ in range(win["sync_points"] + n):
            twin_rec.step(twin)
        if (twin.ti_current, twin.num_force_updates) != \
                (sim.ti_current, sim.num_force_updates):
            raise RuntimeError("the twin Simulation did not repeat the run")
        # the ranges' cost under the profiler: the same n sync points of
        # each twin, one with the port's ranges and one without; which twin
        # goes first and which runs first with ranges alternate by round
        on = ttrace._profiling
        walls = {"on": 0.0, "off": 0.0}
        idle_pct = {"on": [], "off": []}
        for r in range(rounds):
            order = (0, 1) if r % 2 == 0 else (1, 0)
            for k in order:
                ranges = (k == order[0]) == ((r // 2) % 2 == 0)
                if not ranges:
                    ttrace._profiling = lambda: False
                try:
                    prof, _, wall, _ = profiled(harness, *sims[k], n,
                                                cell.traffic, device)
                finally:
                    ttrace._profiling = on
                red = devtrace.reduce(prof)
                del prof
                walls["on" if ranges else "off"] += wall
                idle_pct["on" if ranges else "off"].append(
                    100.0 * (1.0 - red["busy_s"] / red["window_s"]))
        out.update(ranges_rounds=rounds,
                   profiled_wall_ranges_on_s=walls["on"],
                   profiled_wall_ranges_off_s=walls["off"],
                   device_idle_pct_ranges_on=idle_pct["on"],
                   device_idle_pct_ranges_off=idle_pct["off"])
        # the trace's cost with no profiler: cost_steps sync points of each
        # twin in lockstep, the trace on one and off the other, swapped
        # half way
        half = cost_steps // 2
        a = lockstep(harness, sims, half, lambda k: k == 0, device)
        b = lockstep(harness, sims, cost_steps - half, lambda k: k == 1,
                     device)
        out.update(cost_sync_points=cost_steps,
                   wall_traced_s=a[0] + b[1], wall_untraced_s=a[1] + b[0])
        del sim, rec, twin, twin_rec, sims
    return out


TIMED = ("read", "sync", "blocking")


def wait_site(frame):
    """(the port's line that made the host wait, whether the port's trace
    timed the wait): the innermost frame of `ngravs_tpu_torch` outside
    `trace.py`, and whether a `read`, `sync` or `blocking` of `trace.py`
    is on the stack."""
    site, timed = None, False
    while frame is not None:
        path = frame.f_code.co_filename.replace(os.sep, "/")
        if path.endswith("ngravs_tpu_torch/trace.py"):
            timed = timed or frame.f_code.co_name in TIMED
        elif site is None and "/ngravs_tpu_torch/" in path:
            site = (path.split("/ngravs_tpu_torch/")[-1]
                    + f":{frame.f_lineno} {frame.f_code.co_name}")
        frame = frame.f_back
    return site or "outside the port", timed


def sync_study(harness, cell_name, seed, k, device):
    import tempfile
    import torch
    cell = harness.Cell(cell_name)
    with tempfile.TemporaryDirectory(prefix="idle_by_span_") as tmp:
        sim = harness.make_simulation(cell, seed, device, tmp)
        rec = harness.Recorder(sim)
        harness.warm_up(sim, rec, cell.traffic, device)
        tr = getattr(sim, "trace", None)
        c0 = dict(tr.counts) if tr is not None else {}
        sites = {}

        def seen(message, *a, **kw):
            if "synchroniz" not in str(message):
                return
            key = wait_site(sys._getframe(1))
            sites[key] = sites.get(key, 0) + 1

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(k):
                    rec.step(sim)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        by = sorted(sites.items(), key=lambda x: -x[1])
        out = {"cell": cell_name, "seed": seed, "sync_points": k,
               "updates": sim.num_force_updates, "ti": sim.ti_current,
               "sync_debug_waits": sum(sites.values()),
               "untimed_waits": sum(n for (_, t), n in by if not t),
               "sites": [[s, n, t] for (s, t), n in by]}
        if tr is not None:
            out.update({n: tr.counts.get(n, 0) - c0.get(n, 0)
                        for n in ("host_reads", "syncs")})
        return out


def op_counts(prof) -> dict:
    """The CUDA runtime calls and torch operations of a profile, by name,
    and the torch operations' host seconds (self time)."""
    calls, aten, self_s = {}, 0, {}
    for e in prof.key_averages():
        if e.key.startswith("cuda"):
            calls[e.key] = e.count
        elif e.key.startswith("aten::"):
            aten += e.count
            self_s[e.key] = e.self_cpu_time_total / 1e6
    top = dict(sorted(self_s.items(), key=lambda x: -x[1])[:12])
    return {"cuda_calls": calls, "aten_ops": aten,
            "aten_self_s": sum(self_s.values()), "aten_top_self_s": top}


def steps_study(harness, cell_name, seed, k, device, plain=False,
                profile_steps=10):
    """K warm sync points, each one's wall and timers (the card ends each
    step synchronised), to hold two checkouts' steps side by side; the
    allocator's device allocations over them; then `profile_steps` more
    under torch.profiler, counted by CUDA call and operation.  `plain`:
    the trace `untraced` throughout."""
    import contextlib
    import tempfile
    import torch
    cell = harness.Cell(cell_name)
    x = torch.zeros(64, device=device)

    def calibrate():
        """The process's own host speed: the least of three timings of a
        fixed run of small launches, to set processes side by side."""
        out = []
        for _ in range(3):
            harness.sync(device)
            c0 = time.perf_counter()
            for _ in range(5000):
                x.add_(1.0)
            harness.sync(device)
            out.append(time.perf_counter() - c0)
        return min(out)

    calib = [calibrate()]
    with tempfile.TemporaryDirectory(prefix="idle_by_span_") as tmp:
        sim = harness.make_simulation(cell, seed, device, tmp)
        rec = harness.Recorder(sim)
        harness.warm_up(sim, rec, cell.traffic, device)
        harness.sync(device)
        ctx = untraced(sim.trace, device) if plain \
            else contextlib.nullcontext()
        ctx.__enter__()
        mem = lambda: {n: v for n, v in torch.cuda.memory_stats(
            device).items() if n in ("num_device_alloc", "num_device_free",
                                     "num_alloc_retries")}
        m0 = mem()
        rows = []
        for _ in range(k):
            t0 = dict(sim.cpu_timers)
            u0 = sim.num_force_updates
            w0 = time.perf_counter()
            rec.step(sim)
            wall = time.perf_counter() - w0
            rows.append(dict(
                ti=sim.ti_current, updates=sim.num_force_updates - u0,
                wall=wall, timers={n: v - t0.get(n, 0.0)
                                   for n, v in sim.cpu_timers.items()
                                   if v != t0.get(n, 0.0)}))
        m1 = mem()
        calib.append(calibrate())
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(profile_steps):
                rec.step(sim)
            harness.sync(device)
        ctx.__exit__(None, None, None)
        return {"cell": cell_name, "seed": seed, "sync_points": k,
                "plain": plain, "calibration_s": calib, "steps": rows,
                "allocator": {n: m1[n] - m0.get(n, 0) for n in m1},
                "profile_steps": profile_steps, **op_counts(prof)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="lcdm_gas.full,galaxy.tree")
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose portbench and port to run")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "idle_by_span"))
    ap.add_argument("--syncs", type=int, default=0,
                    help="count the waits of K sync points instead")
    ap.add_argument("--steps", type=int, default=0,
                    help="time K sync points one by one instead")
    ap.add_argument("--plain", action="store_true",
                    help="--steps with the trace untraced")
    ap.add_argument("--rounds", type=int, default=4,
                    help="profiled rounds a twin, ranges on and off")
    ap.add_argument("--cost-steps", default="lcdm_gas.full=10,"
                    "galaxy.tree=100", help="lockstep sync points a cell")
    args = ap.parse_args(argv)
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = "1"
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "portbench"))
    import torch
    torch.set_num_threads(1)
    import devtrace
    import harness
    harness.import_port()
    if not torch.cuda.is_available():
        print("idle_by_span: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    os.makedirs(args.out, exist_ok=True)
    for name in args.cells.split(","):
        if args.syncs:
            res = sync_study(harness, name, args.seed, args.syncs, device)
            tag = "syncs"
        elif args.steps:
            res = steps_study(harness, name, args.seed, args.steps, device,
                              args.plain)
            tag = "steps"
        else:
            steps = dict(kv.split("=") for kv in args.cost_steps.split(","))
            res = idle_study(harness, devtrace, name, args.seed,
                             args.seconds, device, args.rounds,
                             int(steps.get(name, 10)))
            tag = "idle"
        res["root"] = os.path.abspath(args.root)
        with open(os.path.join(args.out, f"{name}.{tag}.json"), "w") as f:
            json.dump(res, f, indent=1)
        if tag == "steps":
            res = dict(res, steps=None,
                       wall_s=sum(r["wall"] for r in res["steps"]),
                       updates=sum(r["updates"] for r in res["steps"]))
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
