"""The potential path of the port against the JAX package, on the CPU.

 * `Simulation.update_full_potential` through the walk (compute_potential,
   potential.c:22), after one step from the same particles in each
   package: the open box with `newton_yukawa`, the open box with `bam`
   and the accumulator (the geometric criterion), the periodic pure-tree
   box (the lattice pass, on the four clumps of the port's pure-tree run
   test, tests/test_torch_lattice_walk.py:_box_ic), the comoving TreePM
   box with `newton_yukawa` (tree plus PM potential) and the tabulated
   `yukawa` TreePM box.  The port's potential equals JAX's within rtol
   1e-5 (atol 1e-6 of max|pot|).  In the periodic boxes the potential
   sits a constant a gravity away from the periodic direct sum with the
   lattice correction (under TreePM the long-range part's self term, G m
   / (sqrt(pi) r_s) for one species; the comoving Madelung term), in JAX
   and in the port alike: per gravity the port's mean(pot - pot_direct)
   equals JAX's within 1e-5 of rms(pot_direct).  chip_smoke.py's phase 14
   removes that mean before it gates the card's potential.  On a
   near-uniform comoving lattice (tests/test_torch_wirings.py's) the
   pure-tree potential is a remainder of terms about a thousand times
   larger, and JAX's walk (the lattice terms in its pair loop) and the
   port's (in a second pass) differ there by up to 8.5e-6 of max|pot|,
   the float32 rounding of those sums in two orders, which this
   tolerance does not allow for.
 * `energy_statistics` with ComputePotentialEnergy: the port's energy.txt
   row against JAX's within 1e-5 relative, column by column.
 * `DistributedSimulation` on 2 gloo ranks with OutputPotential and
   ComputePotentialEnergy, replicated and LET, on the collisionless
   TreePM box of tests/test_torch_parallel_runner.py (1,024 particles),
   against JAX's `DistributedSimulation` on a 2-device mesh: the same sync
   points, the multi-file snapshot's POT block (both sets read back) and
   the energy.txt row after the first (PM, all-active) step: the
   potential within 1e-4 of max|pot| and each energy column within 1e-4
   of its largest magnitude (measured: 9.0e-6 and 1.4e-6 replicated,
   4.8e-7 and 5.2e-7 LET; 100 times below the 1e-2 of the largest |v|
   that tests/test_torch_parallel_runner.py takes from JAX's own bound).
 * The K1 instance each path of chip_smoke.py's phase 14 launches.
"""

import os
import sys

import numpy as np
import pytest
import torch

from ngravs_tpu.config import SimulationConfig as JConfig
from ngravs_tpu.integrate.runner import Simulation as JSimulation
from ngravs_tpu.particles import Particles as JParticles

from ngravs_tpu_torch.config import SimulationConfig as TConfig
from ngravs_tpu_torch.integrate.runner import Simulation as TSimulation
from ngravs_tpu_torch.interop import particles_from_numpy
from ngravs_tpu_torch.models.wiring import build_wiring as t_build_wiring
from ngravs_tpu_torch.ops import lattice as tlat
from ngravs_tpu_torch.ops.direct import direct_forces
from ngravs_tpu_torch.ops.pairwise import instance_flags, instance_name

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as R  # noqa: E402
from test_torch_lattice_walk import _box_ic  # noqa: E402
from test_torch_sph_runs import _np  # noqa: E402
from test_torch_wirings import (BOX_CFG, OPEN_CFG, _lattice_box,  # noqa: E402
                                _two_plummers)

torch.set_num_threads(1)

BOX_SPECIES = [(1, 0.0, 0.9), (2, 0.5, 0.1)]
BOX_KW = dict(BOX_CFG, n_gravs=2, type_to_grav=(0, 0, 1, 0, 0, 0),
              ngravs_en=8)

POT_CASES = {
    "open_newton_yukawa": (lambda: _two_plummers(n=1200, seed=8),
                           dict(OPEN_CFG, wiring="newton_yukawa")),
    "open_bam_accumulator": (lambda: _two_plummers(n=1200, seed=8),
                             dict(OPEN_CFG, wiring="bam",
                                  ngravs_accumulator=True,
                                  type_of_opening_criterion=0)),
    "periodic_pure_tree": (lambda: _box_ic(n=800)[1:] + (None,),
                           _box_ic(n=800)[0]),
    "comoving_treepm_newton_yukawa": (lambda: _lattice_box(BOX_SPECIES),
                                      dict(BOX_KW, wiring="newton_yukawa",
                                           pmgrid=16)),
    "tabulated_yukawa_treepm": (lambda: _lattice_box(BOX_SPECIES),
                                dict(BOX_KW, wiring="yukawa", pmgrid=16)),
}


def _both(case, **extra):
    """Both packages' Simulation of POT_CASES[case] after one step."""
    make, kw = POT_CASES[case]
    kw = dict(kw, **extra)
    pos, vel, mass, ptype, _ = make()
    n = len(pos)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jp = JParticles.create(pos, vel, mass, np.arange(n), ptype,
                           jcfg.type_to_grav)
    log = extra.get("output_dir", "")
    js = JSimulation(jcfg, particles=jp, log_dir=log and log + "/jax")
    ts = TSimulation(tcfg, particles=particles_from_numpy(_np(jp), "cpu"),
                     log_dir=log and log + "/port", device="cpu")
    assert not ts.solver.uses_direct(n)
    js.step()
    ts.step()
    assert ts.ti_current == js.ti_current
    return js, ts, tcfg


def _direct_pot(ts, cfg):
    """G times the periodic direct-sum potential with the lattice
    correction on every particle."""
    p = ts.p
    tabs = tlat.build_lattice_tables(ts.wiring, cfg.ngravs_en, cfg.box_size)
    fsoft = torch.as_tensor(ts.force_soft)[p.ptype.long()]
    _, pot = direct_forces(ts.wiring, p.pos, p.mass, p.grav, fsoft,
                           box=cfg.box_size, chunk=256, want_pot=True,
                           lattice_tables=tabs)
    return pot.double().numpy() * ts.units.G


@pytest.mark.parametrize("case", list(POT_CASES))
def test_update_full_potential_matches_jax(case, tmp_path, monkeypatch):
    monkeypatch.setenv(tlat.CACHE_DIR_ENV, str(tmp_path))
    js, ts, cfg = _both(case)
    accel = ts.p.accel.clone()
    js.update_full_potential()
    ts.update_full_potential()
    jp, tp = np.asarray(js.p.potential), ts.p.potential.numpy()
    assert np.isfinite(tp).all() and np.abs(tp).max() > 0
    np.testing.assert_allclose(tp, jp, rtol=1e-5,
                               atol=1e-6 * np.abs(jp).max())
    # the accelerations are left as the step made them
    assert torch.equal(ts.p.accel, accel)
    if not cfg.periodic:
        return
    pot_d = _direct_pot(ts, cfg)
    grav = ts.p.grav.numpy()
    for g in np.unique(grav):
        s = grav == g
        jm = np.mean(jp[s] - pot_d[s])
        tm = np.mean(tp[s] - pot_d[s])
        scale = np.sqrt(np.mean(pot_d[s] ** 2))
        assert abs(tm - jm) <= 1e-5 * scale, (g, tm, jm, scale)


@pytest.mark.parametrize("case", ["open_newton_yukawa",
                                  "comoving_treepm_newton_yukawa"])
def test_energy_statistics_with_the_potential_match_jax(case, tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv(tlat.CACHE_DIR_ENV, str(tmp_path))
    js, ts, cfg = _both(case, compute_potential_energy=True,
                        output_dir=str(tmp_path))
    js.energy_statistics()
    ts.energy_statistics()
    js.close()
    ts.close()
    rows = [np.loadtxt(os.path.join(str(tmp_path), who, cfg.energy_file))
            for who in ("jax", "port")]
    jrow, trow = (np.atleast_2d(r)[-1] for r in rows)
    assert jrow.shape == trow.shape and np.isfinite(trow).all()
    # the potential energy columns are not zero
    assert np.abs(trow[2]) > 0
    np.testing.assert_allclose(trow, jrow, rtol=1e-5,
                               atol=1e-30)


TREEPM_POT_CFG = dict(
    time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
    softening=(0.2,) * 6, max_size_timestep=0.005, n_gravs=2,
    type_to_grav=(0, 0, 1, 0, 0, 0), wiring="newton_yukawa", periodic=True,
    box_size=50.0, pmgrid=32, time_bet_snapshot=0.0,
    time_of_first_snapshot=1e30, tree_depth=6, walk_batch_blocks=32,
    type_of_opening_criterion=0, output_potential=True,
    compute_potential_energy=True, time_bet_statistics=0.0025)
DIST_STEPS = 1


def _treepm_inputs(tmp_path, n=1024, seed=9):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 50.0, (n, 3))
    vel = rng.normal(0, 0.01, (n, 3))
    ptype = rng.integers(1, 3, n).astype(np.int32)
    path = os.path.join(str(tmp_path), "in.npz")
    np.savez(path, pos=pos, vel=vel, mass=np.full(n, 1.0 / n),
             pid=np.arange(n), ptype=ptype)
    return path, pos, vel, ptype


@pytest.mark.parametrize("use_let", [False, True], ids=["replicated", "let"])
def test_distributed_potential_matches_jax(use_let, tmp_path):
    from ngravs_tpu.io.gadget_format import read_snapshot_set as j_read_set
    from ngravs_tpu.parallel.mesh import make_mesh
    from ngravs_tpu.parallel.runner import DistributedSimulation as JDist
    from ngravs_tpu_torch.io.gadget_format import read_snapshot_set
    path, pos, vel, ptype = _treepm_inputs(tmp_path)
    n = len(pos)
    jdir = os.path.join(str(tmp_path), "jax")
    tdir = os.path.join(str(tmp_path), "port")
    cfg = JConfig(**dict(TREEPM_POT_CFG, ngravs_en=8))
    jp = JParticles.create(pos, vel, np.full(n, 1.0 / n), np.arange(n),
                           ptype, cfg.type_to_grav)
    js = JDist(cfg, jp, mesh=make_mesh(2), log_dir=jdir, use_let=use_let)
    jsyncs = []
    for _ in range(DIST_STEPS):
        js.step()
        jsyncs.append(js.ti_current)
    jbase = js.write_snapshot_now(os.path.join(jdir, "snap"))
    js.close()

    tbase = os.path.join(tdir, "snap")
    o = R.run_ranks(R.simulate, 2, tmp_path,
                    dict(TREEPM_POT_CFG, ngravs_en=8), path,
                    dict(steps=DIST_STEPS, use_let=use_let, log_dir=tdir,
                         snapshot=tbase))[0]
    assert o["syncs"][:, 0].tolist() == jsyncs
    # the POT block of both multi-file sets, by particle ID
    js_set, ts_set = j_read_set(jbase), read_snapshot_set(tbase)
    assert js_set.pot is not None and ts_set.pot is not None
    jo, to = (np.argsort(s.pid.astype(np.int64)) for s in (js_set, ts_set))
    jpot, tpot = js_set.pot[jo], ts_set.pot[to]
    assert np.isfinite(tpot).all() and np.abs(tpot).max() > 0
    # the set holds what gather_ordered() held
    np.testing.assert_array_equal(tpot, o["potential"][np.argsort(o["pid"])])
    pot_err = np.abs(tpot - jpot).max() / np.abs(jpot).max()
    # energy.txt: one row a statistics time, column by column
    jrows, trows = (np.atleast_2d(np.loadtxt(os.path.join(d, cfg.energy_file)))
                    for d in (jdir, tdir))
    assert jrows.shape == trows.shape
    assert np.isfinite(trows).all()
    scale = np.abs(jrows).max(axis=0)
    col_err = (np.abs(trows - jrows) / np.maximum(scale, 1e-30)).max()
    print(f"2 ranks, {'LET' if use_let else 'replicated'}: POT block "
          f"{pot_err:.3e} of max|pot|, energy.txt columns {col_err:.3e} of "
          "their largest magnitude, against JAX")
    assert pot_err <= 1e-4
    assert col_err <= 1e-4, (trows, jrows)


def test_crash_dump_and_forcetest_arguments(tmp_path):
    """A step that raises on every rank: each rank writes
    crash_dump.<rank>.npz with no collective and the exception propagates;
    `read_crash_dump` gives the state from before that step in ID order.
    FORCETEST with fraction and write=False returns rows and writes no
    file."""
    from ngravs_tpu_torch.parallel.runner import read_crash_dump
    from test_torch_parallel_runner import HALO_CFG, _inputs, _small_halo
    pos, vel = _small_halo()
    log_dir = os.path.join(str(tmp_path), "run")
    o = R.run_ranks(R.crash_run, 2, tmp_path, HALO_CFG,
                    _inputs(tmp_path, pos, vel),
                    dict(log_dir=log_dir, crash_at=2, fraction=0.125))
    assert str(o[0]["error"]) == "step failed on rank 0"
    assert str(o[1]["error"]) == "step failed on rank 1"
    assert sorted(f for f in os.listdir(log_dir)
                  if f.startswith("crash_dump")) == ["crash_dump.0.npz",
                                                    "crash_dump.1.npz"]
    assert not os.path.exists(os.path.join(log_dir, "forcetest.txt"))
    r0 = o[0]
    assert len(r0["ft_idx"]) == int(0.125 * len(pos))
    assert np.isfinite(r0["ft_solver"]).all()
    assert float(np.sqrt(np.mean(r0["ft_rel"] ** 2))) < 5e-2
    dump = read_crash_dump(log_dir)
    parts = dump["particles"]
    assert dump["sph"] is None
    np.testing.assert_array_equal(parts["pid"], np.arange(len(pos)))
    for k in ("pos", "vel", "accel", "ti_endstep", "ti_begstep", "old_acc",
              "mass", "potential"):
        np.testing.assert_array_equal(parts[k], r0[f"before_{k}"],
                                      err_msg=k)
    s = dump["scalars"]
    assert int(s["ti_current"]) == int(r0["ti_current"]) > 0
    assert int(s["step_count"]) == int(r0["step_count"]) == 2


def test_phase_14_instances():
    """The K1 instance, potential on, of each path chip_smoke.py's phase 14
    runs `update_full_potential` on."""
    def name(wiring, n_gravs, box=0.0, pmgrid=0, accumulator=False):
        cfg = TConfig(n_gravs=n_gravs, wiring=wiring,
                      ngravs_accumulator=accumulator, box_size=box or 1.0,
                      periodic=box > 0, pmgrid=pmgrid)
        return instance_name(instance_flags(
            t_build_wiring(cfg), box_size=box,
            treepm_asmth=cfg.asmth * box / pmgrid if pmgrid else 0.0,
            want_pot=True))
    paths = {
        "slice 1, open box": name("newton", 2),
        "13a newton_yukawa": name("newton_yukawa", 2),
        "13b bam accumulator": name("bam", 2, accumulator=True),
        "slice 4a Ewald box": name("newton_yukawa", 2, box=50000.0),
        "13c stock periodic box": name("newton", 2, box=50000.0),
        "slice 2 TreePM box": name("newton_yukawa", 2, box=50000.0,
                                   pmgrid=128),
        "glass box": name("newton", 1, box=50000.0, pmgrid=128),
    }
    assert paths == {
        "slice 1, open box": "K1a/pot",
        "13a newton_yukawa": "K1b/pot",
        "13b bam accumulator": "K1b+count/pot",
        "slice 4a Ewald box": "K1bc/pot",
        "13c stock periodic box": "K1c/pot",
        "slice 2 TreePM box": "K1bcd/pot",
        "glass box": "K1cd/pot",
    }
    assert len(set(paths.values())) == 7
