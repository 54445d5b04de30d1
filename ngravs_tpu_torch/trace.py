"""The port's tracer: host-time spans, counters, and a timer on every
blocking host read.

A `Trace` holds `timers` (seconds) and `counts` (integers).  One belongs to
each `Simulation` (on the multi-device path, to each rank's `Mesh`), and
the solvers it builds share it.

- `span(name)` adds the host seconds of its body to `timers[name]`,
  inclusive of the spans nested in it.  While a torch profiler runs, the
  span is also a profiler range `ngravs.<name>`, on the trace's clock
  beside the kernels; with none running it enters no range.
- `read(t)` and `sync(device)` are the only ways the step's path turns a
  device tensor into host numbers or waits for the card.  Each adds its
  blocked seconds to `timers["wait"]` and to `timers["wait.<span>"]` of
  the innermost open span, and counts `counts["host_reads"]` or
  `counts["syncs"]`; under a profiler it is a range `ngravs.wait`.
- `blocking(fn, *args)` calls a torch operation that waits for the card
  by itself (`nonzero`, a boolean mask, a size taken from the device's
  data, any copy from the host's memory to the card's, which drains the
  stream first) and adds its seconds to `wait` and `wait.<span>` as
  `read` does.  It counts nothing, and opens no profiler range: the
  profiler shows the wait as the operation's own `cudaStreamSynchronize`.
- `count(name)` adds to a counter.

Code below the solvers that is handed no trace (the K1 wrapper, which a
caller may swap or wrap; the snapshot, energy and FORCETEST writers)
counts and reads through `current()`: the trace of the innermost span
open in this process, if any.  Outside every span such code counts
nothing and its reads are plain copies.
"""

from __future__ import annotations

import time

import torch

RANGE_PREFIX = "ngravs."

# (trace, span name) of every span open in this process, innermost last
_OPEN: list = []


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


def current() -> "Trace | None":
    """The trace of the innermost open span, or None."""
    return _OPEN[-1][0] if _OPEN else None


def read(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host, charged to `current()` when a span is open."""
    tr = current()
    return tr.read(t) if tr is not None else t.cpu()


def blocking(fn, *args, **kwargs):
    """`fn(*args, **kwargs)`, an operation that waits for the card by
    itself, timed as a wait of `current()` when a span is open."""
    tr = current()
    return tr.blocking(fn, *args, **kwargs) if tr is not None \
        else fn(*args, **kwargs)


class _Span:
    __slots__ = ("trace", "name", "t0", "rng")

    def __init__(self, trace: "Trace", name: str):
        self.trace, self.name = trace, name

    def __enter__(self):
        self.rng = None
        if _profiling():
            self.rng = torch.profiler.record_function(RANGE_PREFIX
                                                      + self.name)
            self.rng.__enter__()
        _OPEN.append((self.trace, self.name))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.trace.add(self.name, time.perf_counter() - self.t0)
        _OPEN.pop()
        if self.rng is not None:
            self.rng.__exit__(*exc)
        return False


class Trace:
    """Timers (seconds) and counters (integers) of one run."""

    def __init__(self):
        self.timers: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def add(self, name: str, seconds: float):
        self.timers[name] = self.timers.get(name, 0.0) + seconds

    def count(self, name: str, n: int = 1):
        self.counts[name] = self.counts.get(name, 0) + n

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def _innermost(self) -> str | None:
        for t, name in reversed(_OPEN):
            if t is self:
                return name
        return None

    def _waited(self, counter: str | None, t0: float):
        dt = time.perf_counter() - t0
        self.add("wait", dt)
        inner = self._innermost()
        if inner is not None:
            self.add("wait." + inner, dt)
        if counter is not None:
            self.count(counter)

    def read(self, t: torch.Tensor) -> torch.Tensor:
        """`t` on the host (one copy, waiting for the card)."""
        t0 = time.perf_counter()
        if _profiling():
            with torch.profiler.record_function(RANGE_PREFIX + "wait"):
                out = t.cpu()
        else:
            out = t.cpu()
        self._waited("host_reads", t0)
        return out

    def blocking(self, fn, *args, **kwargs):
        """`fn(*args, **kwargs)`, an operation that waits for the card by
        itself, timed as a wait (not counted)."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self._waited(None, t0)
        return out

    def sync(self, device):
        """Wait for the card's work on `device` (nothing to wait for on the
        CPU; the call is counted all the same)."""
        t0 = time.perf_counter()
        if torch.device(device).type == "cuda":
            if _profiling():
                with torch.profiler.record_function(RANGE_PREFIX + "wait"):
                    torch.cuda.synchronize(device)
            else:
                torch.cuda.synchronize(device)
        self._waited("syncs", t0)

    def prefixed(self, prefix: str) -> dict:
        """The counters whose names start with `prefix`, without it."""
        n = len(prefix)
        return {k[n:]: v for k, v in self.counts.items()
                if k.startswith(prefix)}
