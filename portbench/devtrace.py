"""The profiled sub-window reduced to what the per-layer metrics read.

From torch.profiler's raw (kineto) events: the device operations (kernels,
copies, fills), the host's kernel launches (cudaLaunchKernel,
cuLaunchKernel and their kin) and the benchmark's host spans
(`portbench.<name>` ranges).  The window runs from the first profiled step's start to the last
one's end; busy time is the union of the device operations' intervals in
it.
"""

from __future__ import annotations

from collections import defaultdict

from torch.autograd import DeviceType

K1_NAME = "pairwise_kernel"
SPAN_PREFIX = "portbench."
# host calls that launch work on the card: cudaLaunchKernel(ExC),
# cuLaunchKernel(Ex), cudaLaunchCooperativeKernel, cudaGraphLaunch
LAUNCH_MARKS = ("LaunchKernel", "LaunchCooperativeKernel", "GraphLaunch")
TOP = 10
NAME_CHARS = 160        # a kernel's name as the breakdown gives it


def _events(prof):
    """(name, device side, start ns, end ns, user annotation) of every
    event."""
    kr = getattr(prof.profiler, "kineto_results", None)
    if kr is None:
        for e in prof.events():
            yield (e.name, e.device_type == DeviceType.CUDA,
                   int(e.time_range.start * 1000),
                   int(e.time_range.end * 1000), False)
        return
    for e in kr.events():
        ann = getattr(e, "is_user_annotation", None)
        start = e.start_ns()
        yield (e.name(), e.device_type() == DeviceType.CUDA, start,
               start + e.duration_ns(), bool(ann()) if ann else False)


def union_length(intervals) -> int:
    """Total length covered by [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: int, hi: int):
    """The idle [start, end) stretches of [lo, hi) between intervals."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def reduce(prof) -> dict:
    """busy_s, window_s, kernels (device kernels in the window),
    launches (the host's launch calls in the window, by the benchmark span
    open around each: {span: count}), k1_s (K1's device time), and the
    breakdown: the device operations that took most time, and the idle
    time summed by what the host was doing (the innermost benchmark span
    open at each gap's middle), largest first."""
    ops, spans, host_ranges, calls = [], [], set(), []
    for name, on_device, s, e, ann in _events(prof):
        if on_device:
            ops.append((name, s, e, ann))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], s, e))
        elif ann:
            host_ranges.add(name)
        elif any(k in name for k in LAUNCH_MARKS):
            calls.append(s)
    # a range also leaves an event on the device side: not an operation
    ops = [(n, s, e) for n, s, e, ann in ops
           if not ann and not n.startswith(SPAN_PREFIX)
           and n not in host_ranges]
    steps = [(s, e) for n, s, e in spans if n == "step"]
    if not steps:
        raise ValueError("the profile holds no benchmark step span")
    lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in ops
              if e > lo and s < hi]
    busy = union_length((s, e) for _, s, e in inside)
    by_name = defaultdict(int)
    for n, s, e in inside:
        by_name[n] += e - s
    kernels = sum(1 for n, _, _ in inside
                  if not n.startswith(("Memcpy", "Memset")))
    k1 = sum(e - s for n, s, e in inside if K1_NAME in n)
    inner = lambda t: max(((ss, n) for n, ss, ee in spans if ss <= t < ee),
                          default=(0, "outside spans"))[1]
    launches = defaultdict(int)
    for t in calls:
        if lo <= t < hi:
            launches[inner(t)] += 1
    idle = defaultdict(int)
    for s, e in gaps([(s, e) for _, s, e in inside], lo, hi):
        idle[inner((s + e) // 2)] += e - s
    top = sorted(by_name.items(), key=lambda x: -x[1])[:TOP]
    idle_top = sorted(idle.items(), key=lambda x: -x[1])[:TOP]
    return dict(
        busy_s=busy / 1e9, window_s=(hi - lo) / 1e9, kernels=kernels,
        launches=dict(launches), k1_s=k1 / 1e9,
        breakdown={"device_ops": [[n[:NAME_CHARS], t / 1e9]
                                  for n, t in top],
                   "idle_gaps": [[n, t / 1e9] for n, t in idle_top]})
