"""A cell run on the card through the benchmark's command; skips
without a card."""

import json
import os
import subprocess
import sys

import pytest

import smallcells

ROOT = smallcells.harness.ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_the_command_on_the_card(cuda_device, trace):
    r = subprocess.run(
        [sys.executable, os.path.join("portbench", "run.py"), "--workload",
         "galaxy.tree", "--seed", str(2 ** 31 + 5), "--seconds", "3",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "check"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert "k1.roofline_pct" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"particle_steps_per_s", "setup_s"}


def test_no_card_no_result():
    """Without a card (here, or hidden) the command exits 2 and prints no
    result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, os.path.join("portbench", "run.py"), "--workload",
         "galaxy.tree", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 2 and r.stdout.strip() == ""
