"""The benchmark is driven by data: every configuration, cell, traffic mix
and per-layer metric BENCHMARK.json names is a file of its own, found by
name, and a new file is taken without an edit to any other."""

import ast
import io
import json
import os
import shutil
import sys
import time

import pytest

import smallcells
import harness

ROOT = harness.ROOT
BENCH = harness.BENCH


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_finds_its_file():
    b = bench()
    for c in b["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert harness.load("configs", c["name"])["name"] == c["name"]
    for w in b["workloads"]:
        cell = harness.Cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert cell.config["name"] == w["config"]
    for m in b["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    names = {m["name"] for m in b["per_layer"]}
    assert {"k1.roofline_pct", "device.idle_pct",
            "walk.kernels_per_kparticle"} <= names
    assert [m["name"] for m in b["end_to_end"]] == [
        "particle_steps_per_s", "setup_s"]


def test_a_new_file_is_taken_without_editing_others(tmp_path, monkeypatch):
    copy = tmp_path / "portbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    wl = json.loads((copy / "workloads" / "galaxy.tree.json").read_text())
    wl.update(name="galaxy.segments16", traffic="segments16")
    (copy / "workloads" / "galaxy.segments16.json").write_text(
        json.dumps(wl))
    (copy / "traffic" / "segments16.json").write_text(json.dumps(dict(
        json.loads((copy / "traffic" / "sync_points.json").read_text()),
        name="segments16", segment_steps=16)))
    (copy / "metrics" / "segments.host_reads_per_step.py").write_text(
        "def read(v):\n    return 1.5\n")
    monkeypatch.setattr(harness, "BENCH", str(copy))
    cell = harness.Cell("galaxy.segments16")
    assert cell.traffic["segment_steps"] == 16
    b = bench()
    b["per_layer"].append(dict(name="segments.host_reads_per_step",
                               workloads=["galaxy.segments16"]))
    assert "segments.host_reads_per_step" in cell.metrics(b)
    assert harness.load_module(
        "metrics", "segments.host_reads_per_step").read({}) == 1.5
    assert "segments.host_reads_per_step" not in \
        harness.Cell("galaxy.tree").metrics(b)
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_run_that_loads_jax_prints_no_result(tmp_path, monkeypatch):
    """A metric file that imports a module of a forbidden name (a stand-in
    package `jax` here) is loaded after the window; the run then raises
    and prints no result line."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    copy = tmp_path / "portbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (copy / "metrics" / "loads.jax.py").write_text(
        "import jax  # noqa: F401\n\n\ndef read(v):\n    return 1.0\n")
    monkeypatch.setattr(harness, "BENCH", str(copy))
    monkeypatch.syspath_prepend(str(tmp_path))
    b = bench()
    b["per_layer"].append(dict(name="loads.jax", unit="%",
                               workloads=["galaxy.tree"]))
    cell = smallcells.small_cell("galaxy.tree")
    out = io.StringIO()
    try:
        with pytest.raises(RuntimeError, match="jax"):
            harness.run(cell, 7, 0.5, True, time.perf_counter(),
                        device="cpu", bench=b, stream=out)
    finally:
        sys.modules.pop("jax", None)
    assert out.getvalue() == ""


@pytest.mark.parametrize("loaded, found", [
    (["ngravs_tpu_torch", "ngravs_tpu_torch.ops.walk", "torch"], []),
    (["ngravs_tpu.ops.tree"], ["ngravs_tpu"]),
    (["jaxlib.xla_client", "flax"], ["flax", "jaxlib"]),
    (["jax"], ["jax"]),
])
def test_import_check_compares_whole_top_level_names(monkeypatch, loaded,
                                                     found):
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == found


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert tops <= {"__future__", "math", "typing", "numpy",
                            "torch"}, (f, tops)


def test_nothing_in_the_harness_imports_jax():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0]
                        for m in _imports(os.path.join(dirpath, f))}
                assert not tops & set(harness.FORBIDDEN), (f, tops)
