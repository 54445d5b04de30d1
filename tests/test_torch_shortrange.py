"""The tabulated TreePM transition of the port against the JAX package
(`ngravs_tpu/ops/shortrange.py` and the tabulated branch of its fused
walk), on the CPU at small sizes, with inputs made from a seed.

 * `shortrange_tables` for the `newton_yukawa` and `yukawa` wirings: both
   packages sample each law's normed Green's function in f32 and integrate
   in f64, so the f32 tables agree within 1e-6 relative (1e-7 of the
   largest entry near zeros).
 * Ports of tests/test_treepm.py:24 (the Newtonian tables against the
   analytic erf form, 1e-5 relative), :116 (the NGRAVS_TREEPM_XITION_CHECK
   dump round-trips, 1e-5 relative) and :153 (the closed-form Yukawa and
   ColoYuk truncations against the tables, 2e-5 of the full force).
 * The fused walk with the `yukawa` wiring (a `NoneLaw` diagonal, so no
   closed form and every pair takes the tabulated transition) against the
   JAX walk on one tree: interaction counts equal, acc within 1e-5 of each
   target's |acc| and pot within 1e-5 relative (the pair sums run in
   another order).
 * A `yukawa` TreePM `Simulation` with ForceTest on, five sync points in
   each package from the same particles: the timeline, PM window and
   `ti_endstep` equal, positions within 1e-5 relative, accel_pm within
   1e-4 of its largest value (the FFTs and CIC sums run in another order),
   every kicked particle more than 1e-4 (in log2) off a timestep-bin edge;
   the forcetest.txt rows are written on the PM steps only, for the same
   particles.  With NGRAVS_TREEPM_XITION_CHECK the run writes the same
   files as the JAX package's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.special import erf

from ngravs_tpu.config import SimulationConfig as JConfig
from ngravs_tpu.integrate.runner import Simulation as JSimulation
from ngravs_tpu.models.wiring import build_wiring as j_build_wiring
from ngravs_tpu.ops import shortrange as jsr
from ngravs_tpu.ops import tree as jtree
from ngravs_tpu.ops import walk as jwalk
from ngravs_tpu.particles import Particles as JParticles

from ngravs_tpu_torch.config import SimulationConfig as TConfig
from ngravs_tpu_torch.integrate.kdk import compute_timestep_dt
from ngravs_tpu_torch.integrate.runner import Simulation as TSimulation
from ngravs_tpu_torch.integrate.timeline import timebase_interval
from ngravs_tpu_torch.interop import octree_from_numpy
from ngravs_tpu_torch.models import laws as L
from ngravs_tpu_torch.models.wiring import GravityWiring
from ngravs_tpu_torch.models.wiring import build_wiring as t_build_wiring
from ngravs_tpu_torch.ops import shortrange as tsr
from ngravs_tpu_torch.ops import walk as twalk
from ngravs_tpu_torch.particles import Particles as TParticles

torch.set_num_threads(1)

BOX, PMGRID, DEPTH, BUCKET, NG = 50.0, 32, 6, 16, 2


def _wirings(wiring):
    kw = dict(n_gravs=2, type_to_grav=(0, 0, 1, 0, 0, 0), wiring=wiring,
              box_size=BOX, periodic=True, pmgrid=PMGRID)
    return j_build_wiring(JConfig(**kw)), t_build_wiring(TConfig(**kw))


@pytest.mark.parametrize("wiring", ["newton_yukawa", "yukawa"])
def test_tables_match_jax(wiring):
    jw, tw = _wirings(wiring)
    jf, jp = (np.asarray(a) for a in jsr.shortrange_tables(jw, ntab=256))
    tf, tp = tsr.shortrange_tables(tw, ntab=256)
    for got, want in ((tf.numpy(), jf), (tp.numpy(), jp)):
        assert got.shape == want.shape == (NG, NG, 256)
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-7 * np.abs(want).max())
    if wiring == "yukawa":
        # the NoneLaw diagonal has no long range at all
        assert not tf[0, 0].any() and not tf[1, 1].any()


def test_newton_tables_analytic():
    """tests/test_treepm.py:24 for the port."""
    ftab, ptab = tsr.shortrange_tables(GravityWiring([[L.Newtonian()]]),
                                       ntab=256)
    u = tsr.UMAX / 256 * (np.arange(256) + 0.5)
    fexp = np.pi * (erf(u) - 2 * u / np.sqrt(np.pi) * np.exp(-u * u)) / u ** 2
    pexp = np.pi * erf(u) / u
    assert np.abs(ftab.numpy()[0, 0] / fexp - 1).max() < 1e-5
    assert np.abs(ptab.numpy()[0, 0] / pexp - 1).max() < 1e-5


def test_xition_check_dump(tmp_path):
    """tests/test_treepm.py:116 for the port: one file per law name, rows
    u C(u) I(u) that give back the tables, and the force trace."""
    box = 100.0
    w = GravityWiring([[L.Newtonian(), L.Newtonian()],
                       [L.Newtonian(), L.Yukawa(5.0, box, pmgrid=32)]])
    ftab, ptab = tsr.shortrange_tables(w, ntab=256)
    files = tsr.dump_transition_tables(w, ftab, ptab, 1.25 * box / 32, box,
                                       str(tmp_path))
    names = {w.names[i][j] for i in range(2) for j in range(2)}
    assert len(files) == len(names)
    for path in files:
        txt = open(path).read().split("\n# Begin debug forcetrace")
        rows = np.array([[float(x) for x in ln.split()]
                         for ln in txt[0].strip().splitlines()])
        assert rows.shape == (256, 3)
        u, c_u, i_u = rows.T
        name = path.split("ngravs_tpm_")[1].split("_l")[0]
        tg, sg = next((i, j) for i in range(2) for j in range(2)
                      if w.names[i][j] == name)
        np.testing.assert_allclose(i_u / u ** 2 - c_u / u,
                                   ftab.numpy()[tg, sg], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(i_u / u, ptab.numpy()[tg, sg], rtol=1e-5,
                                   atol=1e-6)
        assert len(txt) == 2 and "Asmth" in txt[1]


def test_closed_form_matches_tables():
    """tests/test_treepm.py:153 for the port: the closed-form Yukawa and
    ColoYuk truncations against the tabulated transition, across the band,
    within the erfc approximation's 2e-5 of the full force."""
    box, pmgrid, asmth_cells = 1000.0, 128, 1.25
    yuk = L.Yukawa(60.0, box, pmgrid, asmth_cells)
    colo = L.ColoYuk(60.0, box, pmgrid, asmth_cells)
    w = GravityWiring([[L.Newtonian(), yuk], [yuk, colo]])
    ftab, ptab = tsr.shortrange_tables(w, ntab=1000)
    asmth = asmth_cells * box / pmgrid
    for law, slots in w.unique_laws():
        sf, sp = law.kernel_shortrange()
        r = torch.linspace(0.05 * asmth, 5.9 * asmth, 400,
                           dtype=torch.float64).float()
        u = r / (2 * asmth)
        pair = torch.full_like(r, slots[0][0] * 2 + slots[0][1],
                               dtype=torch.int32)
        lr, _ = tsr.longrange_force_factor(ftab, asmth, 1000, r, pair)
        lrp, _ = tsr.longrange_pot_factor(ptab, asmth, 1000, r, pair)
        acc_full = law.accel(1.0, 1.0, r * r, r, 1.0)
        rel = (acc_full * sf(u) - (acc_full - lr)).abs() \
            / acc_full.abs().clamp(min=1e-30)
        assert float(rel.max()) < 2e-5, law.name
        p_full = law.potential(1.0, 1.0, r * r, r, 1.0)
        relp = (p_full * sp(u) - (p_full - lrp)).abs() \
            / p_full.abs().clamp(min=1e-30)
        assert float(relp.max()) < 2e-5, law.name


def _box_system(n=1500, seed=2):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, BOX, (5, 3))
    k = rng.integers(0, 5, n)
    pos = np.mod(centers[k] + rng.normal(0, 4.0, (n, 3)), BOX)
    pos[:40] = rng.uniform(0, 0.5, (40, 3))          # across a corner
    pos[40:80] = BOX - rng.uniform(0, 0.5, (40, 3))
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    grav = rng.integers(0, NG, n).astype(np.int32)
    fsoft = np.full(n, 0.15, np.float32)
    aold = (1e-3 * rng.uniform(0.5, 2, n)).astype(np.float32)
    return pos.astype(np.float32), mass, grav, fsoft, aold


@pytest.mark.parametrize("opening", ["bh", "relative"])
def test_tabulated_walk_matches_jax(opening):
    pos, mass, grav, fsoft, aold = _box_system()
    n = len(pos)
    j = jtree.build_tree(*(jnp.asarray(a) for a in (pos, mass, grav, fsoft,
                                                    aold)),
                         depth=DEPTH, n_gravs=NG, bucket=BUCKET, box_size=BOX)
    t = octree_from_numpy({f: np.asarray(getattr(j, f)) for f in j._fields},
                          "cpu")
    jw, tw = _wirings("yukawa")
    assert any(law.kernel_shortrange() is None for law, _ in tw.unique_laws())
    asmth = 1.25 * BOX / PMGRID
    jf, jp = jsr.shortrange_tables(jw, ntab=512)
    tf, tp = tsr.shortrange_tables(tw, ntab=512)
    walk_kw = dict(depth=DEPTH, bucket=BUCKET, group_size=64,
                   batch_blocks=32, chunk_cap=1024, frontier_cap=4096,
                   opening=opening, box_size=BOX, want_pot=True)
    jfn = jwalk.make_fused_walk(
        jw, NG, use_pallas=False, treepm=dict(
            sr_ftab=jf, sr_ptab=jp, asmth=asmth, rcut=4.5 * asmth),
        **walk_kw)
    tgt = np.concatenate([np.arange(0, n, 3), [-1] * 3]).astype(np.int32)
    jr = jax.jit(lambda tr, tg: jfn(tr, tg))(j, jnp.asarray(tgt))

    def no_kernel(*a, **k):
        raise AssertionError("the tabulated walk launched K1")

    tr = twalk.make_fused_walk(
        tw, NG, treepm=dict(sr_ftab=tf, sr_ptab=tp, asmth=asmth,
                            rcut=4.5 * asmth),
        pair_eval=no_kernel, **walk_kw)(t, torch.as_tensor(tgt))
    assert not bool(jr.overflow) and not bool(tr.overflow)
    np.testing.assert_array_equal(tr.ninteract.numpy(),
                                  np.asarray(jr.ninteract))
    ja = np.asarray(jr.acc)
    amag = np.linalg.norm(ja, axis=1)
    assert np.all(np.linalg.norm(tr.acc.numpy() - ja, axis=1)
                  <= 1e-5 * amag + 1e-30)
    np.testing.assert_allclose(tr.pot.numpy(), np.asarray(jr.pot), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(jr.pot)).max())
    assert int(tr.ninteract.max()) > 0 and float(amag.max()) > 0


def test_tabulated_eval_chunks_change_no_bit():
    """The tabulated evaluation in chunks of 1 and 3 target blocks gives
    the bits of one chunk (every sum runs along S inside a block)."""
    rng = np.random.default_rng(4)
    _, tw = _wirings("yukawa")
    tf, tp = tsr.shortrange_tables(tw, ntab=256)
    nb, g, s = 5, 16, 96
    targets = dict(
        x=rng.uniform(0, BOX, (nb * g, 1)), y=rng.uniform(0, BOX, (nb * g, 1)),
        z=rng.uniform(0, BOX, (nb * g, 1)),
        mass=rng.uniform(0.5, 1.5, (nb * g, 1)),
        fsoft=np.full((nb * g, 1), 0.2),
        grav=rng.integers(0, 2, (nb * g, 1)),
        gid=np.arange(nb * g).reshape(-1, 1))
    targets = {k: torch.as_tensor(v.astype(np.int32 if k in ("grav", "gid")
                                           else np.float32))
               for k, v in targets.items()}
    sp = np.zeros((nb, 8, s), np.float32)
    sp[:, 0:3] = rng.uniform(0, BOX, (nb, 3, s))
    sp[:, 3] = rng.uniform(0.5, 1.5, (nb, s))
    sp[:, 4] = 0.2
    sp[:, 5] = 1.0
    sp[:, 6] = rng.integers(0, 2, (nb, s)).astype(np.int32).view(np.float32)
    sp[:, 7] = rng.integers(-2, nb * g, (nb, s)).astype(np.int32) \
        .view(np.float32)
    sp = torch.as_tensor(sp)
    n_src = torch.tensor([[s], [0], [17], [64], [95]], dtype=torch.int32)
    kw = dict(wiring=tw, box_size=BOX, sr_ftab=tf, sr_ptab=tp,
              asmth=1.25 * BOX / PMGRID)
    one = twalk.tabulated_pair_eval(targets, sp, n_src, True, **kw)
    for bc in (1, 3):
        again = twalk.tabulated_pair_eval(targets, sp, n_src, True,
                                          block_chunk=bc, **kw)
        assert all(torch.equal(a, b) for a, b in zip(one, again)), bc
    assert float(one[0].abs().max()) > 0 and int(one[2].sum()) > 0
    assert not one[2].reshape(nb, g)[1].any()          # n_src 0


def _yukawa_box(extra=None, n=600, seed=5):
    """Four clumps of two species in the box; masses of 10 give the
    clumps' particles steps shorter than the PM step, so some sync points
    move only part of the system."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, BOX, (4, 3))
    k = rng.integers(0, 4, n)
    pos = np.mod(centers[k] + rng.normal(0, 2.0, (n, 3)), BOX) \
        .astype(np.float32)
    vel = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    ptype = rng.integers(1, 3, n).astype(np.int32)
    kw = dict(time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
              softening=(0.3,) * 6, max_size_timestep=0.05, periodic=True,
              box_size=BOX, pmgrid=PMGRID, ntab=512, n_gravs=2,
              type_to_grav=(0, 0, 1, 0, 0, 0), wiring="yukawa",
              tree_depth=DEPTH, tree_bucket_size=BUCKET,
              walk_batch_blocks=32, time_bet_snapshot=0.0,
              time_of_first_snapshot=1e30, time_bet_statistics=0.0,
              ngravs_en=8, **(extra or {}))
    mass = np.full(n, 10.0, np.float32)
    return kw, pos, vel, mass, ptype


def _forcetest_rows(path):
    rows = [ln.split() for ln in open(path).read().splitlines()]
    assert rows and all(len(r) == 12 for r in rows)
    return rows


def test_yukawa_treepm_simulation_matches_jax(tmp_path):
    kw, pos, vel, mass, ptype = _yukawa_box(dict(force_test=0.05))
    n = len(pos)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    js = JSimulation(jcfg, particles=JParticles.create(
        pos, vel, mass, np.arange(n), ptype, jcfg.type_to_grav),
        log_dir=str(tmp_path / "j"))
    ts = TSimulation(tcfg, particles=TParticles.create(
        pos, vel, mass, np.arange(n), ptype, tcfg.type_to_grav,
        device="cpu"), log_dir=str(tmp_path / "t"))
    assert ts.solver.treepm is not None and not ts.solver.uses_direct(n)
    assert ts.solver.oracle_lattice_tables is not None
    assert ts.solver.lattice_tables is None
    pm_ti, active = [], []
    for _ in range(5):
        pm_end = ts.pm_ti_endstep
        js.step()
        ts.step()
        if ts.ti_current == pm_end:
            pm_ti.append(ts.ti_current)
        active.append(int((ts.p.ti_begstep == ts.ti_current).sum()))
        # the seed keeps every kicked particle off a timestep-bin edge
        # (more than 1e-4 in log2, far above the packages' 1e-6 force
        # differences), so rounding cannot move one into another bin
        kicked = ts.p.ti_begstep == ts.ti_current
        ticks = compute_timestep_dt(tcfg, ts.p, ts.dt_displacement,
                                    ts._soft_t)[kicked].double().numpy() \
            / timebase_interval(tcfg)
        assert np.abs(np.log2(ticks) - np.round(np.log2(ticks))).min() > 1e-4
        assert ts.ti_current == js.ti_current
        assert (ts.pm_ti_begstep, ts.pm_ti_endstep) == \
            (js.pm_ti_begstep, js.pm_ti_endstep)
        np.testing.assert_array_equal(ts.p.ti_endstep.numpy(),
                                      np.asarray(js.p.ti_endstep))
        jpos = np.asarray(js.p.pos)
        assert np.abs(ts.p.pos.numpy() - jpos).max() \
            <= 1e-5 * np.abs(jpos).max()
        jpm = np.asarray(js.p.accel_pm)
        assert np.abs(ts.p.accel_pm.numpy() - jpm).max() \
            <= 1e-4 * np.abs(jpm).max()
    js.close()
    ts.close()
    jrows = _forcetest_rows(tmp_path / "j" / "forcetest.txt")
    trows = _forcetest_rows(tmp_path / "t" / "forcetest.txt")
    # the same particles (type, ti, id) on the same steps, PM steps only
    key = lambda rows: [(r[0], r[1], r[11]) for r in rows]
    assert key(trows) == key(jrows)
    assert sorted({int(r[1]) for r in trows}) == pm_ti
    assert len(trows) == int(0.05 * n) * len(pm_ti)
    # PM steps, and sync points between them that move part of the system
    assert len(pm_ti) >= 2 and min(active) < n


def test_xition_check_through_simulation(tmp_path):
    kw, pos, vel, mass, ptype = _yukawa_box(n=200)
    outs = []
    for pkg, (Cfg, Sim, Part) in (("j", (JConfig, JSimulation, JParticles)),
                                  ("t", (TConfig, TSimulation, TParticles))):
        out = tmp_path / pkg
        out.mkdir()
        cfg = Cfg(**dict(kw, ngravs_treepm_xition_check=True,
                         output_dir=str(out)))
        extra = {} if pkg == "j" else {"device": "cpu"}
        Sim(cfg, particles=Part.create(pos, vel, mass, np.arange(len(pos)),
                                       ptype, cfg.type_to_grav, **extra),
            log_dir="")
        outs.append(out)
    jfiles = sorted(os.listdir(outs[0]))
    assert jfiles and sorted(os.listdir(outs[1])) == jfiles
    for name in jfiles:
        want = np.loadtxt(outs[0] / name, comments="#")
        got = np.loadtxt(outs[1] / name, comments="#")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-7 * np.abs(want).max())
