"""The port's tracer (`ngravs_tpu_torch/trace.py`) and the benchmark's
metric files that read it.

The tracer: nested spans add up inclusive; a blocking read or wait, and
an operation that waits by itself, is charged to `wait` and to the
innermost open span; reads and waits count, such operations do not;
under a torch profiler the spans are `ngravs.*` ranges, nested and in
order, and with none running no range is entered.  Two tiny Simulations
(an open box on the tree, a comoving TreePM box with gas) step a few sync
points: the layer timers exist and nest, and each general step makes
exactly the host reads and synchronisations of its path's read sites,
pinned below (PERF.md lists them).  The four metric files read synthetic
windows, and nothing where the port keeps no such timer.
"""

import importlib.util
import math
import os
import time

import numpy as np
import pytest
import torch

from ngravs_tpu_torch import trace as ttrace
from ngravs_tpu_torch.config import SimulationConfig
from ngravs_tpu_torch.integrate.runner import Simulation
from ngravs_tpu_torch.particles import Particles, SphState
from ngravs_tpu_torch.trace import Trace
from ngravs_tpu_torch.units import set_units

torch.set_num_threads(1)

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench", "metrics")


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def test_nested_spans_add_up_inclusive():
    tr = Trace()
    with tr.span("outer"):
        time.sleep(0.01)
        with tr.span("inner"):
            time.sleep(0.02)
        with tr.span("inner"):
            time.sleep(0.01)
    t = tr.timers
    assert t["inner"] >= 0.03
    assert t["outer"] >= t["inner"] + 0.01
    assert ttrace.current() is None


def test_waits_go_to_the_innermost_span_and_count():
    tr = Trace()
    x = torch.arange(5)
    with tr.span("a"):
        with tr.span("b"):
            got = tr.read(x)
            tr.sync("cpu")
        tr.read(x)
    tr.read(x)
    assert torch.equal(got, x)
    assert tr.counts == {"host_reads": 3, "syncs": 1}
    t = tr.timers
    assert set(t) == {"a", "b", "wait", "wait.a", "wait.b"}
    assert t["wait"] == pytest.approx(t["wait.a"] + t["wait.b"], abs=1e-3)
    assert t["wait"] >= t["wait.a"] and t["wait"] >= t["wait.b"]


def test_blocking_operations_are_waits_and_count_nothing():
    tr = Trace()
    mask = torch.tensor([True, False, True])
    slow = lambda t: (time.sleep(0.01), torch.nonzero(t))[1]
    with tr.span("a"):
        with tr.span("b"):
            got = tr.blocking(slow, mask)
        # code handed no trace: the innermost open span's
        assert ttrace.blocking(torch.nonzero, mask).shape == (2, 1)
    assert ttrace.blocking(torch.nonzero, mask).shape == (2, 1)
    assert got.squeeze(1).tolist() == [0, 2]
    assert tr.counts == {}
    t = tr.timers
    assert set(t) == {"a", "b", "wait", "wait.a", "wait.b"}
    assert t["wait.b"] >= 0.01
    assert t["wait"] == pytest.approx(t["wait.a"] + t["wait.b"], abs=1e-3)


def test_current_is_the_innermost_open_trace():
    a, b = Trace(), Trace()
    assert ttrace.current() is None
    with a.span("x"):
        assert ttrace.current() is a
        with b.span("y"):
            assert ttrace.current() is b
            # a read of `a` inside b's span is charged to a's open span
            a.read(torch.zeros(1))
        assert ttrace.current() is a
        assert ttrace.read(torch.ones(2)).tolist() == [1.0, 1.0]
    assert ttrace.current() is None
    assert set(a.timers) >= {"wait.x"} and "wait.y" not in a.timers
    assert a.counts["host_reads"] == 2 and "host_reads" not in b.counts


def test_spans_are_profiler_ranges_nested_in_order():
    tr = Trace()
    x = torch.arange(4.0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            with tr.span("inner"):
                y = (x * 2).sum()
                tr.read(y)
            with tr.span("next"):
                x + 1
    ev = {e.name: e for e in prof.events() if e.name.startswith("ngravs.")}
    assert set(ev) == {"ngravs.outer", "ngravs.inner", "ngravs.wait",
                       "ngravs.next"}
    rng = {k: (e.time_range.start, e.time_range.end) for k, e in ev.items()}
    inside = lambda a, b: rng[b][0] <= rng[a][0] and rng[a][1] <= rng[b][1]
    assert inside("ngravs.inner", "ngravs.outer")
    assert inside("ngravs.next", "ngravs.outer")
    assert inside("ngravs.wait", "ngravs.inner")
    assert rng["ngravs.inner"][1] <= rng["ngravs.next"][0]
    assert tr.counts["host_reads"] == 1


# ---------------------------------------------------------------------------
# the Simulation's timers and read sites
# ---------------------------------------------------------------------------

def _open_box(log_dir=""):
    rng = np.random.default_rng(1)
    n = 256
    pos = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    cfg = SimulationConfig(
        time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
        softening=(0.05,) * 6, max_size_timestep=0.01,
        time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
        time_bet_statistics=0.0, wiring="newton", solver="tree",
        tree_depth=6, err_tol_theta=0.6, type_of_opening_criterion=0,
        walk_batch_blocks=32, tree_domain_update_frequency=2.5)
    return Simulation(cfg, particles=Particles.create(
        pos, vel, np.full(n, 1e-3, np.float32), np.arange(n),
        np.ones(n, np.int32), cfg.type_to_grav, device="cpu"),
        log_dir=log_dir)


def _gas_box(ns=4):
    rng = np.random.default_rng(11)
    box = 10000.0
    g = (np.stack(np.meshgrid(*[np.arange(ns)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / ns * box
    n = len(g)
    pos = np.concatenate([
        np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape), box),
        np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape) + 0.5 * box / ns,
               box)]).astype(np.float32)
    vel = rng.normal(0, 1.0, pos.shape).astype(np.float32)
    cfg = SimulationConfig(
        comoving_integration=True, omega0=1.0, omega_lambda=0.0,
        omega_baryon=0.1, hubble_param=1.0, time_begin=0.1, time_max=0.2,
        periodic=True, box_size=box, pmgrid=2 * ns, softening=(100.0,) * 6,
        max_size_timestep=0.02, err_tol_int_accuracy=0.025, des_num_ngb=33,
        max_num_ngb_deviation=3, n_gravs=2, type_to_grav=(0, 1, 0, 0, 0, 0),
        wiring="newton_yukawa", tree_depth=5, tree_bucket_size=16,
        tree_group_size=64, walk_batch_blocks=32, time_bet_snapshot=0.0,
        time_of_first_snapshot=1e30, time_bet_statistics=0.0)
    u = set_units(cfg)
    m_tot = 3 * u.hubble ** 2 / (8 * math.pi * u.G) * box ** 3
    mass = np.concatenate([np.full(n, 0.1 * m_tot / n),
                           np.full(n, 0.9 * m_tot / n)])
    sph = SphState.zeros(2 * n, "cpu")
    sph.entropy[:n] = 1.0
    return Simulation(cfg, particles=Particles.create(
        pos, vel, mass, np.arange(2 * n), np.repeat([0, 1], n),
        cfg.type_to_grav, device="cpu"), sph=sph, log_dir="")


def _steps(sim, k):
    """k general steps; each step's change of every timer and counter."""
    out = []
    for _ in range(k):
        t0, c0 = dict(sim.trace.timers), dict(sim.trace.counts)
        sim.step()
        out.append(({n: v - t0.get(n, 0.0)
                     for n, v in sim.trace.timers.items()},
                    {n: v - c0.get(n, 0) for n, v in sim.trace.counts.items()}))
    return out


def _gravity_reads(c):
    """The gravity solve's read sites as the step's counters say it ran:
    a build's fat-leaf read each, three a walk attempt (its active blocks,
    the overflow row, the frontier demand), one octet measure on a first
    build or a layout overflow, the interaction count."""
    return c.get("tree.builds", 0) + 3 * c.get("walk.attempts", 0) + 1


def test_open_box_steps_time_their_layers_and_pin_their_reads():
    sim = _open_box()
    assert sim.cpu_timers is sim.trace.timers
    steps = _steps(sim, 4)
    for k, (t, c) in enumerate(steps):
        for key in ("total", "drift", "gravity", "tree", "walk",
                    "walk.traverse", "walk.k1", "scatter", "timeline",
                    "wait", "wait.tree", "wait.walk"):
            assert t.get(key, 0.0) > 0, (k, key)
        assert t["tree"] + t["walk"] + t["scatter"] <= t["gravity"]
        assert t["walk.traverse"] + t["walk.k1"] <= t["walk"]
        assert t["gravity"] + t["drift"] + t["timeline"] <= t["total"]
        assert c["walk.batches"] >= c["walk.attempts"] >= 1
        # three _active_info reads (sync point, after the drift, the
        # forces' active count), the gravity solve's, the first pass's
        # octet measure; the gravity and timeline synchronisations
        octets = 1 if k == 0 else 0
        assert c["host_reads"] == 3 + _gravity_reads(c) + octets, (k, c)
        assert c["syncs"] == 2
    # pinned: the first pass (a build, one attempt, the octet measure)
    # reads 3 + 1 + 3 + 1 + 1 = 9 times; a step on a refreshed tree 7
    assert steps[0][1]["host_reads"] == 9
    refreshed = [c for _, c in steps if c.get("tree.refreshes")]
    assert refreshed and all(c["host_reads"] == 7 for c in refreshed
                             if c["walk.attempts"] == 1)


def test_gas_box_steps_time_their_layers_and_pin_their_reads():
    sim = _gas_box()
    steps = _steps(sim, 3)
    for k, (t, c) in enumerate(steps):
        for key in ("pm", "gravity", "hydro", "sph.density", "sph.hydro",
                    "tree", "walk", "scatter"):
            assert t.get(key, 0.0) > 0, (k, key)
        assert t["tree"] + t["walk"] + t["scatter"] <= t["gravity"]
        assert t["sph.density"] + t["sph.hydro"] <= t["hydro"]
        # PM, gravity, hydro, timeline
        assert c["syncs"] == 4
        assert c["sph.hydro_passes"] == 1
    for t, c in steps[1:]:
        iters, growths = c["sph.density_iters"], c.get("sph.cap_growths", 0)
        # the general step's 3 reads and the gravity solve's; SPH: the
        # active gas count, each pass's target blocking, the density
        # iterations' overflow flags and convergence reads, the hydro
        # gather's overflow flag (a candidate-cap growth adds an overflow
        # flag and one or two reads of the demand); the displacement
        # constraint of a comoving full step
        want = 3 + _gravity_reads(c) + (1 + 2 + 2 * iters + 1) + 1
        assert want + 2 * growths <= c["host_reads"] <= want + 3 * growths
    # pinned: the first step bootstraps the relative criterion with a
    # geometric pass (a build, its octet measure, one attempt, the
    # interaction count: 6 reads), then reads OldAcc's largest value and
    # solves again (1 + 5): 3 + 6 + 6 + (1 + 2 + 2 + 1) + 1 = 22
    assert steps[0][1]["host_reads"] == 22
    # a step of one density iteration on a built tree, one walk attempt:
    # 3 + (1 + 3 + 1) + (1 + 2 + 2 + 1) + 1 = 15
    settled = [c for _, c in steps[1:] if c["sph.density_iters"] == 1
               and c.get("tree.builds") == 1 and c["walk.attempts"] == 1
               and not c.get("sph.cap_growths")]
    assert settled and all(c["host_reads"] == 15 for c in settled)


def test_timings_line_gains_the_steps_reads_and_wait(tmp_path):
    sim = _open_box(log_dir=str(tmp_path))
    _steps(sim, 2)
    sim.close()
    lines = (tmp_path / "timings.txt").read_text().splitlines()
    assert len(lines) == 2
    reads = [int(ln.split("host_reads=")[1].split()[0]) for ln in lines]
    assert reads[0] == 9 and reads[1] in (7, 8)
    assert all(ln.split("ia/part=")[1].split()[1].startswith("host_reads=")
               and ln.endswith("s") and " wait=" in ln for ln in lines)


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    sim = _open_box()
    _steps(sim, 2)
    tr = Trace()
    with tr.span("x"):
        tr.read(torch.ones(1))
        tr.sync("cpu")
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tr.span("x"):
            tr.read(torch.ones(1))
    assert entered == ["ngravs.x", "ngravs.wait"]


# ---------------------------------------------------------------------------
# the benchmark's metric files
# ---------------------------------------------------------------------------

def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), os.path.join(METRICS,
                                                         name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _window(**timers):
    return {"window": {"window_s": 10.0, "updates": 2_000_000,
                       "timers": dict(gravity=6.0, hydro=3.0, **timers),
                       "counts": {"solves": 400, "gas_updates": 1_000_000,
                                  "pm_solves": 5, "n_ia": 1}}}


@pytest.mark.parametrize("name, timers, want", [
    ("host.busy_us_per_particle", {"wait": 4.0}, 3.0),
    ("tree.host_ms_per_solve",
     {"tree": 0.9, "wait.tree": 0.1, "wait.treepm": 5.0}, 2.0),
    ("tree.host_ms_per_solve", {"tree": 0.4}, 1.0),
    ("walk.host_us_per_particle",
     {"walk": 5.0, "wait.walk": 0.5, "wait.walk.traverse": 0.25,
      "wait.walk.k1": 0.25, "wait.walk.k1.x": 1.0, "wait.walker": 9.0},
     1.5),
    ("sph.density_us_per_gas_particle", {"sph.density": 2.0}, 2.0),
])
def test_metric_reads_the_window(name, timers, want):
    assert _metric(name)(_window(**timers)) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "host.busy_us_per_particle", "tree.host_ms_per_solve",
    "walk.host_us_per_particle", "sph.density_us_per_gas_particle"])
def test_metric_with_nothing_to_read_is_left_out(name):
    read = _metric(name)
    # a port without the trace's timers (the parent of this benchmark)
    assert read(_window()) is None
    full = _window(wait=1.0, tree=1.0, walk=1.0, **{"sph.density": 1.0})
    assert read(full) is not None
    full["window"]["updates"] = 0
    full["window"]["counts"].update(solves=0, gas_updates=0)
    assert read(full) is None
