"""The port's examples (`examples/*_torch.py`) on the CPU at a tiny size,
2 steps each: the galaxy collision from the synthetic IC on one device and
on 2 gloo ranks, and the cosmological TreePM + SPH box on one device and
on 2 gloo ranks."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), *args,
         "--device", "cpu"], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_galaxy_collision_example(tmp_path):
    out = str(tmp_path / "galaxy")
    r = _run("galaxy_collision_torch.py", "--n", "1200", "--steps", "2",
             "--out", out)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "building the synthetic 1200-particle" in r.stdout
    assert "done: " in r.stdout and "steps=2" in r.stdout
    assert os.path.exists(os.path.join(out, "GalaxyCollision.IC"))


def test_galaxy_collision_example_on_ranks(tmp_path):
    out = str(tmp_path / "galaxy2")
    r = _run("galaxy_collision_torch.py", "--n", "1200", "--steps", "2",
             "--out", out, "--devices", "2")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "steps=2" in r.stdout and "ranks=2" in r.stdout


def test_cosmological_box_example(tmp_path):
    out = str(tmp_path / "box")
    r = _run("cosmological_box_torch.py", "--n-side", "4", "--pmgrid", "16",
             "--steps", "2", "--out", out)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "done: " in r.stdout and "steps=2" in r.stdout
    r = _run("cosmological_box_torch.py", "--n-side", "4", "--pmgrid", "16",
             "--steps", "2", "--out", out, "--devices", "2")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "steps=2" in r.stdout and "ranks=2" in r.stdout
