"""The metric arithmetic on synthetic records: the window's rate, the
roofline share, the idle union and the breakdown."""

import json
import os

import pytest
from torch.autograd import DeviceType

import smallcells  # noqa: F401
import devtrace
import harness
import roofline


def values(**over):
    v = {"window": {"window_s": 10.0, "updates": 2_000_000,
                    "timers": {"gravity": 6.0, "hydro": 3.0, "pm": 0.5},
                    "counts": {"n_ia": 4_000_000_000, "pm_solves": 5,
                               "gas_updates": 1_000_000}},
         "profile": {"updates": 100_000, "kernels": 40_000,
                     "launches": {"gravity": 30_000, "sph.hydro": 9_000},
                     "busy_s": 0.25,
                     "window_s": 1.0, "k1_s": 0.02,
                     "counts": {"n_ia": 200_000_000}},
         "config": harness.load("configs", "lcdm_gas_2x64")}
    v.update(over)
    return v


def metric(name, v):
    return harness.load_module("metrics", name).read(v)


def test_window_metrics():
    v = values()
    assert metric("loop.outside_forces_pct", v) == pytest.approx(5.0)
    assert metric("gravity.us_per_particle", v) == pytest.approx(3.0)
    assert metric("pm.ms_per_solve", v) == pytest.approx(100.0)
    assert metric("sph.us_per_gas_particle", v) == pytest.approx(3.0)
    assert metric("walk.kernels_per_kparticle", v) == pytest.approx(300.0)
    assert metric("device.idle_pct", v) == pytest.approx(75.0)


def test_roofline_share_is_the_bound_over_k1_time():
    v = values()
    ops = roofline.ops_per_pair("newton_yukawa", True, True)
    assert ops == 31
    bound = max(2e8 * ops / 67e12, 1e5 * roofline.BYTES_TARGET / 3.35e12)
    assert metric("k1.roofline_pct", v) == pytest.approx(100 * bound / 0.02)
    g = values(config=harness.load("configs", "galaxy_collision_60k"))
    assert roofline.ops_per_pair("newton", False, False) == 23
    assert metric("k1.roofline_pct", g) == pytest.approx(
        100 * 2e8 * 23 / 67e12 / 0.02)


def test_a_metric_with_nothing_to_read_is_left_out():
    v = values()
    v["window"]["counts"]["pm_solves"] = 0
    v["profile"]["k1_s"] = 0.0
    assert metric("pm.ms_per_solve", v) is None
    assert metric("k1.roofline_pct", v) is None
    v["profile"]["launches"] = {"sph.hydro": 9_000}
    assert metric("walk.kernels_per_kparticle", v) is None


@pytest.mark.parametrize("iv, lo, hi, busy, idle", [
    ([(0, 10), (5, 15), (20, 30)], 0, 40, 25, [(15, 20), (30, 40)]),
    ([(2, 3), (2, 3), (1, 4)], 0, 5, 3, [(0, 1), (4, 5)]),
    ([], 0, 7, 0, [(0, 7)]),
])
def test_idle_union(iv, lo, hi, busy, idle):
    assert devtrace.union_length(iv) == busy
    assert devtrace.gaps(iv, lo, hi) == idle


class _Ev:
    def __init__(self, name, cuda, start, dur, ann=False):
        self._n, self._c, self._s, self._d, self._a = \
            name, cuda, start, dur, ann

    def name(self):
        return self._n

    def device_type(self):
        return DeviceType.CUDA if self._c else DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._a


class _Prof:
    def __init__(self, events):
        class K:
            def events(self_inner):
                return events
        self.profiler = type("P", (), {"kineto_results": K()})()


def test_reduce_a_synthetic_trace():
    ev = [_Ev("portbench.step", False, 0, 1000, True),
          _Ev("portbench.gravity", False, 100, 600, True),
          _Ev("portbench.sph.hydro", False, 700, 250, True),
          _Ev("sph_hydro", False, 720, 200, True),
          _Ev("sph_hydro", True, 720, 200, True),        # range, not an op
          _Ev("portbench.step", True, 0, 1000, True),    # range, not an op
          _Ev("void pairwise_kernel<3>(...)", True, 200, 100),
          _Ev("void walk_kernel()", True, 250, 150),
          _Ev("Memcpy HtoD (Pageable -> Device)", True, 750, 50),
          _Ev("aten::add", False, 10, 5),
          _Ev("cudaLaunchKernel", False, 150, 2),
          _Ev("cuLaunchKernel", False, 240, 2),
          _Ev("cudaLaunchKernel", False, 710, 2),
          _Ev("cudaMemcpyAsync", False, 720, 2),
          _Ev("cudaLaunchKernel", False, 1500, 2)]     # after the window
    r = devtrace.reduce(_Prof(ev))
    assert r["window_s"] == pytest.approx(1e-6)
    assert r["busy_s"] == pytest.approx(250e-9)
    assert r["kernels"] == 2
    assert r["launches"] == {"gravity": 2, "sph.hydro": 1}
    assert r["k1_s"] == pytest.approx(100e-9)
    names = [n for n, _ in r["breakdown"]["device_ops"]]
    assert names[0] == "void walk_kernel()" and len(names) == 3
    assert r["breakdown"]["idle_gaps"] == [
        ["gravity", pytest.approx(550e-9)], ["sph.hydro", pytest.approx(200e-9)]]


def test_benchmark_moves_and_layers():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] == "particle_steps_per_s"
        assert set(m.get("workloads", cells)) <= cells
