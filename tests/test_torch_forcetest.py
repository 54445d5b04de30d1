"""FORCETEST of the port (`diagnostics/forcetest.py`) against the JAX
package's, on the CPU at small sizes, with inputs made from a seed.

 * A port of tests/test_verification.py:38: tree forces against the
   direct sum, rms relative error < 5e-3, forcetest.txt rows of 12
   columns.
 * A port of tests/test_verification.py:127: the `yukawa` preset's
   two-body forces in closed form (rtol 2e-5) and its same-type pair off.
 * A port of tests/test_treepm.py:190: the oracle of a periodic TreePM run
   is the periodic force with the Ewald correction (rms 1e-3 against the
   periodic direct sum), built on demand when ForceTest is not configured,
   and the TreePM forces are within rms 3e-2 of it.
 * `force_test` in both packages on the same state: the same sampled
   indices (the same numpy generator and seed), the direct forces within
   1e-5 of each |acc|, and forcetest.txt rows with the same type, tick and
   id and numbers within 1e-4 relative (1e-5 apart, printed with six
   digits).
 * The `rdep` and `tpmfp` utilities of the port run on the CPU with the
   arguments of the repo's utilities/rdep.py and utilities/tpmfp.py.
"""

import os

import numpy as np
import pytest
import torch

from ngravs_tpu.config import SimulationConfig as JConfig
from ngravs_tpu.diagnostics import forcetest as jft
from ngravs_tpu.integrate.runner import Simulation as JSimulation
from ngravs_tpu.particles import Particles as JParticles

from ngravs_tpu_torch.config import SimulationConfig as TConfig
from ngravs_tpu_torch.diagnostics.forcetest import force_test, rms_error
from ngravs_tpu_torch.integrate.runner import Simulation as TSimulation
from ngravs_tpu_torch.models.wiring import build_wiring
from ngravs_tpu_torch.ops import lattice as tlat
from ngravs_tpu_torch.ops.direct import direct_forces
from ngravs_tpu_torch.ops.solver import GravitySolver
from ngravs_tpu_torch.particles import Particles as TParticles
from ngravs_tpu_torch.units import set_units

torch.set_num_threads(1)


def _small(n=1200, **kw):
    """tests/test_verification.py:_small_sim's system and settings."""
    rng = np.random.default_rng(5)
    base = dict(
        time_begin=0.0, time_max=0.5, gravity_constant_internal=1.0,
        softening=(0.05,) * 6, max_size_timestep=0.005,
        tree_depth=7, tree_bucket_size=16, tree_group_size=64,
        tree_block_batch=4, time_bet_snapshot=0.0,
        time_of_first_snapshot=1e30, time_bet_statistics=0.0,
        wiring="newton")
    base.update(kw)
    pos = np.concatenate([rng.normal(0, 1.0, (n // 2, 3)),
                          rng.normal(4, 0.5, (n - n // 2, 3))]) \
        .astype(np.float32)
    vel = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    return base, pos, vel, np.full(n, 1e-3, np.float32), np.ones(n, np.int32)


def _port_sim(base, pos, vel, mass, ptype, log_dir=""):
    cfg = TConfig(**base)
    return TSimulation(cfg, particles=TParticles.create(
        pos, vel, mass, np.arange(len(pos)), ptype, cfg.type_to_grav,
        device="cpu"), log_dir=log_dir)


def test_forcetest_accuracy_gate(tmp_path):
    """tests/test_verification.py:38 for the port."""
    sim = _port_sim(*_small(), log_dir=str(tmp_path))
    sim.compute_forces(full=True)
    idx, acc_d, acc_s, rel = force_test(sim, fraction=0.2)
    stats = rms_error(rel)
    assert stats["rms"] < 5e-3 and stats["n"] == 240
    row = open(tmp_path / "forcetest.txt").readline().split()
    assert len(row) == 12


def test_yukawa_forcetest_two_body_exact():
    """tests/test_verification.py:127 for the port: the NGRAVS_YUKAWA_
    FORCETEST wiring (ngravs.c:213-282), same-type force off, the cross
    force pure Yukawa."""
    box = 10000.0
    cfg = TConfig(n_gravs=2, type_to_grav=(0, 0, 1, 0, 0, 0),
                  wiring="yukawa", softening=(1.0,) * 6,
                  gravity_constant_internal=1.0, box_size=box)
    units = set_units(cfg)
    w = build_wiring(cfg)
    d = 50.0
    pos = np.array([[100.0, 100, 100], [100 + d, 100, 100]], np.float32)
    p = TParticles.create(pos, np.zeros((2, 3)), [3.0, 5.0], [1, 2], [1, 2],
                          cfg.type_to_grav, device="cpu")
    solver = GravitySolver(cfg, w, np.array(cfg.softening) * 2.8, units.G)
    p2, _, _ = solver.compute(p, 0, 2)
    acc = p2.accel.numpy()
    law = w.law(0, 1)
    fac = float(law.force_factor(3.0, 5.0, torch.tensor(d * d),
                                 torch.tensor(d), torch.tensor(2.8), 1))
    np.testing.assert_allclose(acc[0], fac * np.array([d, 0, 0]), rtol=2e-5,
                               atol=1e-12)
    np.testing.assert_allclose(acc[1] * 5.0, -acc[0] * 3.0, rtol=2e-5,
                               atol=1e-10)
    p_same = TParticles.create(pos, np.zeros((2, 3)), [3.0, 5.0], [1, 2],
                               [1, 1], cfg.type_to_grav, device="cpu")
    p3, _, _ = solver.compute(p_same, 0, 2)
    assert float(p3.accel.abs().max()) < 1e-12


def test_forcetest_oracle_includes_ewald(tmp_path, monkeypatch):
    """tests/test_treepm.py:190 for the port."""
    monkeypatch.setenv(tlat.CACHE_DIR_ENV, str(tmp_path))
    box, n = 1000.0, 512
    rng = np.random.default_rng(5)
    cfg = TConfig(
        time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
        softening=(box / 3000,) * 6, max_size_timestep=0.01,
        periodic=True, box_size=box, pmgrid=64, time_bet_snapshot=0.0,
        time_of_first_snapshot=1e30, time_bet_statistics=0.0,
        wiring="newton", ngravs_en=16)
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    mass = np.full(n, 1.0, np.float32)
    sim = TSimulation(cfg, particles=TParticles.create(
        pos, np.zeros((n, 3), np.float32), mass, np.arange(n),
        np.ones(n, np.int32), cfg.type_to_grav, device="cpu"), log_dir="")
    assert sim.solver.oracle_lattice_tables is None    # ForceTest 0
    sim.compute_forces(full=True)
    idx, acc_d, acc_s, rel = force_test(sim, fraction=0.5, write=False)
    assert sim.solver.oracle_lattice_tables is not None
    fsoft = torch.full((n,), box / 3000 * 2.8)
    exact, _ = direct_forces(sim.wiring, sim.p.pos, sim.p.mass, sim.p.grav,
                             fsoft, box=box, want_pot=False,
                             lattice_tables=tlat.build_lattice_tables(
                                 sim.wiring, 16, box))
    exact = exact.numpy()[idx]
    rel_oracle = np.linalg.norm(acc_d - exact, axis=1) \
        / np.maximum(np.linalg.norm(exact, axis=1), 1e-12)
    assert np.sqrt((rel_oracle ** 2).mean()) < 1e-3
    assert np.sqrt((rel ** 2).mean()) < 0.03


@pytest.mark.parametrize("periodic", [False, True])
def test_forcetest_rows_match_jax(periodic, tmp_path, monkeypatch):
    monkeypatch.setenv(tlat.CACHE_DIR_ENV, str(tmp_path))
    extra = dict(force_test=0.1)
    if periodic:
        extra.update(periodic=True, box_size=12.0, ngravs_en=8,
                     tree_depth=6)
    base, pos, vel, mass, ptype = _small(n=600, **extra)
    if periodic:
        pos = np.mod(pos + 4.0, 12.0).astype(np.float32)
    n = len(pos)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jcfg = JConfig(**base)
    js = JSimulation(jcfg, particles=JParticles.create(
        pos, vel, mass, np.arange(n), ptype, jcfg.type_to_grav),
        log_dir=str(tmp_path / "j"))
    ts = _port_sim(base, pos, vel, mass, ptype, log_dir=str(tmp_path / "t"))
    js.step()
    ts.step()                    # the runner's hook writes the rows
    js.close()
    ts.close()
    ji, jd, js_acc, _ = jft.force_test(js, write=False)
    ti, td, ts_acc, _ = force_test(ts, write=False)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    amag = np.linalg.norm(jd, axis=1)
    assert np.all(np.linalg.norm(td - jd, axis=1) <= 1e-5 * amag + 1e-30)
    amag = np.linalg.norm(js_acc, axis=1)
    assert np.all(np.linalg.norm(ts_acc - js_acc, axis=1)
                  <= 1e-5 * amag + 1e-30)
    jrows = open(tmp_path / "j" / "forcetest.txt").read().splitlines()
    trows = open(tmp_path / "t" / "forcetest.txt").read().splitlines()
    assert len(trows) == len(jrows) == int(0.1 * n)
    for jr, tr in zip(jrows, trows):
        jr, tr = jr.split(), tr.split()
        assert len(tr) == 12
        assert (tr[0], tr[1], tr[11]) == (jr[0], jr[1], jr[11])
        jv = np.array(jr[2:11], np.float64).reshape(3, 3)
        tv = np.array(tr[2:11], np.float64).reshape(3, 3)
        assert np.all(np.abs(tv - jv)
                      <= 1e-4 * np.abs(jv).max(axis=1, keepdims=True))


def test_utilities_run_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(tlat.CACHE_DIR_ENV, str(tmp_path))
    from ngravs_tpu_torch.utilities import rdep, tpmfp
    rows = rdep.main(["--points", "4", "--rmin", "10", "--rmax", "1000",
                      "--device", "cpu"])
    r, a = np.array(rows).T
    np.testing.assert_allclose(a, 1000.0 / r ** 2, rtol=1e-5)
    rows = tpmfp.main(["--pmgrid", "16", "--n", "256", "--real", "1",
                       "--bins", "6", "--en", "8", "--cpu"])
    assert rows and all(np.isfinite(e) and c > 0 for _, e, c in rows)
    out = capsys.readouterr().out
    assert "# r   |F_solver|" in out and "# realization 0" in out
