"""One run of one cell: build the port's Simulation from the cell's files,
warm it up, time a window of `Simulation.step()` calls, read the per-layer
metrics, check the outputs against the plain reference, and print the
result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name BENCHMARK.json
gives it: `configs/<config>.json`, `traffic/<traffic>.json`,
`workloads/<cell>.json`, `metrics/<metric>.py` and `ic/<generator>.py`.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from collections import deque

import numpy as np
import torch

from reference.check import Check, Record, Snapshot, Step
from reference.cosmology import Cosmology
import devtrace

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names no run may load (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ngravs_tpu")
# fixed cache directories inside the checkout: only a cell's first run
# there builds anything
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton",
              "NGRAVS_TORCH_TABLE_DIR": "lattice_tables"}


def load(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_file() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """A cell's files: the workload, its configuration and its traffic."""

    def __init__(self, name: str):
        self.name = name
        self.workload = load("workloads", name)
        self.config = load("configs", self.workload["config"])
        self.traffic = load("traffic", self.workload["traffic"])

    def metrics(self, bench: dict) -> list:
        """The per-layer metrics BENCHMARK.json reads in this cell."""
        return [m["name"] for m in bench["per_layer"]
                if self.name in m.get("workloads", [self.name])]


def import_port():
    """The port from this checkout, and nothing installed elsewhere."""
    for k, sub in CACHE_DIRS.items():
        os.environ[k] = os.path.join(ROOT, "build", "portbench", sub)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import ngravs_tpu_torch
    where = os.path.dirname(os.path.abspath(ngravs_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        raise RuntimeError(f"ngravs_tpu_torch imported from {where}, not "
                           f"from the checkout {ROOT}")


def write_param(path: str, params: dict) -> str:
    with open(path, "w") as f:
        for k, v in params.items():
            f.write(f"{k:<28s} {v}\n")
    return path


def make_simulation(cell: Cell, seed: int, device, tmpdir: str):
    """The port's Simulation of the cell's configuration, its IC drawn
    from `seed` in memory (headless: no log files)."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation
    from ngravs_tpu_torch.particles import Particles, SphState
    conf = cell.config
    param = dict(conf["param"], InitCondFile=os.path.join(tmpdir, "none"),
                 OutputDir=tmpdir, SnapshotFileBase="snapshot", ICFormat=1,
                 SnapFormat=1)
    cfg = read_parameter_file(
        write_param(os.path.join(tmpdir, "run.param"), param),
        **conf["port"])
    cosmo = Cosmology(conf["param"])
    ic = load_module("ic", conf["ic"]["generator"]).make(
        conf["ic"], conf["param"], seed, cosmo.G, cosmo.H0)
    vel = ic["vel"]
    if cosmo.comoving:
        # Gadget's file velocities -> the internal variable (read_ic.c)
        vel = vel * np.float32(cosmo.t_begin ** 1.5)
    p = Particles.create(ic["pos"], vel, ic["mass"], ic["pid"], ic["ptype"],
                         cfg.type_to_grav, device=device)
    gas = None
    if ic["u"] is not None:
        gas = SphState.zeros(p.n, device)
        gas.entropy[:len(ic["u"])] = torch.as_tensor(ic["u"], device=device)
    return Simulation(cfg, particles=p, sph=gas, log_dir="",
                      segment_steps=cell.traffic["segment_steps"],
                      device=device)


class Recorder:
    """Counters around the calls into the port's layers: the gravity solve
    (`GravitySolver.compute`, with its interaction count n_ia), the PM
    solve and the two SPH passes.  With `annotate` each call is also a
    profiler range (a span) `portbench.<name>`."""

    def __init__(self, sim):
        self.counts = dict(n_ia=0, solves=0, pm_solves=0, gas_updates=0)
        self.annotate = False
        self._wrap(sim.solver, "compute", "gravity", self._after_compute)
        if sim.solver.pm is not None:
            self._wrap(sim.solver, "pm_forces", "pm",
                       lambda a, r: self._bump("pm_solves", 1))
        if sim.hydro is not None:
            self._wrap(sim.hydro, "density", "sph.density", None)
            self._wrap(sim.hydro, "hydro", "sph.hydro",
                       lambda a, r: self._bump("gas_updates", int(a[4])))

    def _bump(self, key, n):
        self.counts[key] += n

    def _after_compute(self, args, res):
        self.counts["solves"] += 1
        self.counts["n_ia"] += int(res[1])

    def _wrap(self, obj, attr, name, after):
        fn = getattr(obj, attr)

        def wrapped(*a, **kw):
            if self.annotate:
                with torch.profiler.record_function("portbench." + name):
                    res = fn(*a, **kw)
            else:
                res = fn(*a, **kw)
            if after is not None:
                after(a, res)
            return res
        setattr(obj, attr, wrapped)

    def step(self, sim):
        if self.annotate:
            with torch.profiler.record_function("portbench.step"):
                sim.step()
        else:
            sim.step()


def snapshot(sim) -> Snapshot:
    return Snapshot(sim.p, sim.sph, sim.ti_current,
                    (sim.pm_ti_begstep, sim.pm_ti_endstep))


def caps(sim):
    """Everything the solvers size themselves by; warm-up runs until it
    holds."""
    s = sim.solver
    out = (repr(s.fcaps), s.octet_caps, s.depth, s.leaf_factor, s._tightened)
    if sim.hydro is not None:
        out += (sim.hydro.cand_cap, sim.hydro.frontier_cap)
    return out


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(sim, rec: Recorder, traffic: dict, device) -> Step | None:
    """The first force pass and its cap settling, then whole sync points
    until the solvers' caps hold (traffic "warmup").  Returns the last PM
    step."""
    w = traffic["warmup"]
    last, stable, pm_last = None, 0, None
    for k in range(int(w["max_steps"])):
        pre, pm0 = snapshot(sim), rec.counts["pm_solves"]
        rec.step(sim)
        if rec.counts["pm_solves"] > pm0:
            pm_last = Step(pre, snapshot(sim), True)
        now = caps(sim)
        stable = stable + 1 if now == last else 0
        last = now
        if k + 1 >= int(w["min_steps"]) and stable >= int(w["stable_steps"]):
            break
    sync(device)
    return pm_last


def run_window(sim, rec: Recorder, seconds: float, keep: int, pm_last,
               device):
    """Steps for `seconds` of wall time, whole sync points, the card
    synchronised at both ends.  Returns the window's numbers and the
    record the check reads."""
    gc.collect()
    sync(device)
    timers0, counts0 = dict(sim.cpu_timers), dict(rec.counts)
    updates0 = sim.num_force_updates
    steps, stalled, n = deque(maxlen=keep), 0, 0
    t0 = time.perf_counter()
    while True:
        n += 1
        pre, pm0 = snapshot(sim), rec.counts["pm_solves"]
        rec.step(sim)
        post = snapshot(sim)
        st = Step(pre, post, rec.counts["pm_solves"] > pm0)
        steps.append(st)
        if st.pm_step:
            pm_last = st
        if post.ti <= pre.ti:
            stalled += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    wall = time.perf_counter() - t0
    win = dict(window_s=wall, sync_points=n,
               updates=sim.num_force_updates - updates0,
               timers={k: sim.cpu_timers[k] - timers0.get(k, 0.0)
                       for k in sim.cpu_timers},
               counts={k: rec.counts[k] - counts0[k] for k in rec.counts},
               stalled=stalled)
    return win, Record(list(steps), pm_last, stalled)


def profile_sync_points(sim, rec: Recorder, traffic: dict, device):
    """A profiled sub-window of whole sync points after the timed window
    (traffic "profile": at least `min_seconds` or `max_sync_points`)."""
    prof_spec = traffic["profile"]
    counts0, updates0 = dict(rec.counts), sim.num_force_updates
    rec.annotate = True
    sync(device)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = 0
        while True:
            rec.step(sim)
            n += 1
            if time.perf_counter() - t0 >= float(prof_spec["min_seconds"]) \
                    or n >= int(prof_spec["max_sync_points"]):
                break
        sync(device)
    rec.annotate = False
    red = devtrace.reduce(prof)
    red.update(
        sync_points=n, updates=sim.num_force_updates - updates0,
        counts={k: rec.counts[k] - counts0[k] for k in rec.counts})
    return red


def card(device) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda:0", bench: dict | None = None, stream=sys.stdout,
        control: bool = False, detail: bool = False) -> dict:
    """One run; returns the result line's dict (also printed to
    `stream`).  `control` adds the control's readings under "control",
    `detail` the per-target view of gravity under "gravity_detail"."""
    bench = bench or benchmark_file()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    w = cell.workload
    with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
        sim = make_simulation(cell, seed, dev, tmp)
        rec = Recorder(sim)
        pm_last = warm_up(sim, rec, cell.traffic, dev)
        setup_s = time.perf_counter() - t_start
        win, record = run_window(sim, rec, seconds,
                                 int(w["check"]["keep_sync_points"]),
                                 pm_last, dev)
        prof = profile_sync_points(sim, rec, cell.traffic, dev) \
            if trace else None
        mem = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
            else 0
        del sim, rec
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check = Check(cell.config, w["check"], w["limits"], seed)
    with torch.no_grad():
        prog = check.program(record)
        ref = check.reference(record)
        readings = check.readings(record, prog, ref)
        ctrl = check.control(record, ref) if control else None
        grav = check.gravity_detail(prog, ref) if detail else None
    correct, table = check.judge(readings)
    failed = record.stalled
    device_info = dict(card(dev) if dev.type == "cuda" else
                       {"platform": "cpu", "kind": "cpu", "count": 1},
                       memory_peak_bytes=int(mem))
    if trace:
        values = {"window": win, "profile": prof, "config": cell.config}
        metrics = {}
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        for name in cell.metrics(bench):
            v = load_module("metrics", name).read(values)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
        device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    else:
        metrics = {
            "particle_steps_per_s": {
                "value": win["updates"] / win["window_s"],
                "unit": "particle-steps/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    result = {"correct": bool(correct), "attempted": win["sync_points"],
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = prof["breakdown"]
    if ctrl is not None:
        result["control"] = ctrl
    if grav is not None:
        result["gravity_detail"] = grav
    result["check"] = table
    # last, once every module this run needs (metrics, check, control)
    # has been loaded: a run that loaded JAX prints no result
    found = forbidden_modules()
    if found:
        raise RuntimeError("modules outside the port were loaded: "
                           + ", ".join(found))
    for k, v in table.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), file=stream, flush=True)
    return result
