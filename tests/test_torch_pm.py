"""PM, lattice tables and the periodic direct sweep of the port against the
JAX package, and the port's TreePM total force against its Ewald sum.

 * `PMSolver.forces` / `potential` with the newton_yukawa wiring, 2k
   particles, PMGRID 32, for the fd4 and spectral gradients and with
   interlacing: within 1e-4 of the largest |value| (both packages run the
   same f32 program, but the CIC scatter-add and the FFTs sum in different
   orders, and on a GPU the scatter-add is atomic and varies between runs).
 * The lattice tables from the native generator (built into `build/`) and
   from the numpy sums against the JAX package's, in f64 (1e-10), and
   `lattice_correction` and the periodic direct sweep with the lattice
   correction against the JAX functions (1e-5 of each target's |acc|).
 * The TreePM total force (the port's PM plus its short-range walk with the
   closed-form truncation) against the port's Ewald direct sum at 700
   particles: rms relative error < 2.5e-2, the JAX package's own bound
   (tests/test_treepm.py:49-79).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ngravs_tpu.config import SimulationConfig as JConfig
from ngravs_tpu.models import laws as jlaws
from ngravs_tpu.models.wiring import GravityWiring as JWiring
from ngravs_tpu.models.wiring import build_wiring as j_build_wiring
from ngravs_tpu.ops import lattice as jlat
from ngravs_tpu.ops.direct import direct_forces as j_direct
from ngravs_tpu.ops.pm import PMSolver as JPM

from ngravs_tpu_torch.config import SimulationConfig as TConfig
from ngravs_tpu_torch.models import laws as tlaws
from ngravs_tpu_torch.models.wiring import GravityWiring as TWiring
from ngravs_tpu_torch.models.wiring import build_wiring as t_build_wiring
from ngravs_tpu_torch.ops import lattice as tlat
from ngravs_tpu_torch.ops.direct import direct_forces as t_direct
from ngravs_tpu_torch.ops.pm import PMSolver as TPM
from ngravs_tpu_torch.ops.tree import build_tree
from ngravs_tpu_torch.ops.walk import make_fused_walk

BOX = 50.0


def _wirings(n_gravs=2, pmgrid=32, wiring="newton_yukawa"):
    kw = dict(n_gravs=n_gravs, type_to_grav=(0, 0, 1, 0, 0, 0),
              wiring=wiring, box_size=BOX, periodic=True, pmgrid=pmgrid)
    return j_build_wiring(JConfig(**kw)), t_build_wiring(TConfig(**kw))


def _particles(n, seed=3, box=BOX, n_gravs=2):
    rng = np.random.default_rng(seed)
    # clumped, so the long-range field has structure at several scales
    centers = rng.uniform(0, box, (6, 3))
    k = rng.integers(0, 6, n)
    pos = np.mod(centers[k] + rng.normal(0, 0.08 * box, (n, 3)), box)
    return (pos.astype(np.float32),
            rng.uniform(0.5, 1.5, n).astype(np.float32),
            rng.integers(0, n_gravs, n).astype(np.int32))


@pytest.mark.parametrize("gradient,interlace", [("fd4", False),
                                                ("spectral", False),
                                                ("fd4", True)])
def test_pm_matches_jax(gradient, interlace):
    jw, tw = _wirings()
    pos, mass, grav = _particles(2000)
    kw = dict(asmth_cells=1.25, gradient=gradient, interlace=interlace)
    jpm = JPM(jw, 32, BOX, 2, 1.0, **kw)
    tpm = TPM(tw, 32, BOX, 2, 1.0, **kw)
    np.testing.assert_allclose(tpm.smth.numpy(), np.asarray(jpm.smth),
                               rtol=1e-6, atol=0)
    assert tpm.recv_groups == jpm.recv_groups
    ja = np.asarray(jpm.forces(*(jnp.asarray(a) for a in (pos, mass, grav))))
    ta = tpm.forces(*(torch.as_tensor(a) for a in (pos, mass, grav)))
    assert np.abs(ta.numpy() - ja).max() <= 1e-4 * np.abs(ja).max()
    jp = np.asarray(jpm.potential(*(jnp.asarray(a)
                                    for a in (pos, mass, grav))))
    tp = tpm.potential(*(torch.as_tensor(a) for a in (pos, mass, grav)))
    assert np.abs(tp.numpy() - jp).max() <= 1e-4 * np.abs(jp).max()
    assert tpm.asmth == jpm.asmth and tpm.rcut == jpm.rcut


@pytest.mark.parametrize("kind,params", [("newton", {}),
                                         ("yukawa", {"ym": 60.0}),
                                         ("coloyuk", {"ym": 60.0})])
def test_lattice_tables_match_jax(kind, params, tmp_path, monkeypatch):
    monkeypatch.setenv(tlat.CACHE_DIR_ENV, str(tmp_path))
    en = 6
    want = jlat.lattice_tables_for(kind, en, params, cache=False)
    got = tlat.lattice_tables_for(kind, en, params, cache=False)
    assert tlat.last_generator == "native"
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    got_np = tlat.lattice_tables_for(kind, en, params, cache=False,
                                     native=False)
    assert tlat.last_generator == "numpy"
    np.testing.assert_allclose(got_np, want, rtol=1e-10, atol=1e-12)
    # cached on disk, outside the repository
    cached = tlat.lattice_tables_for(kind, en, params)
    assert list(tmp_path.glob("lattice_spc_table_*.npy"))
    np.testing.assert_array_equal(tlat.lattice_tables_for(kind, en, params),
                                  cached)


def test_periodic_direct_with_lattice_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(tlat.CACHE_DIR_ENV, str(tmp_path))
    jw, tw = _wirings(pmgrid=0)
    en = 8
    pos, mass, grav = _particles(600, seed=4)
    fsoft = np.full(600, 0.3, np.float32)
    jtab = jlat.build_lattice_tables(jw, en, BOX)
    ttab = tlat.build_lattice_tables(tw, en, BOX)
    # entries that vanish by symmetry come out as +-1e-21 round-off
    np.testing.assert_allclose(ttab.numpy(), np.asarray(jtab), rtol=1e-6,
                               atol=1e-9 * float(np.abs(jtab).max()))
    # the lookup alone, on displacements of every octant
    rng = np.random.default_rng(9)
    d = rng.uniform(-BOX / 2, BOX / 2, (3, 500)).astype(np.float32)
    pidx = rng.integers(0, 4, 500).astype(np.int32)
    want = jlat.lattice_correction(jtab, 2 * en / BOX, *d, pidx)
    got = tlat.lattice_correction(ttab, 2 * en / BOX,
                                  *(torch.as_tensor(x) for x in d),
                                  torch.as_tensor(pidx))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)
    tgt = np.array([5, 0, -1, 599, 17, 300], np.int32)   # a subset, padded
    ja, jp = j_direct(jw, *(jnp.asarray(a) for a in (pos, mass, grav, fsoft)),
                      tgt_idx=jnp.asarray(tgt), box=BOX, chunk=4,
                      lattice_tables=jtab)
    ta, tp = t_direct(tw, *(torch.as_tensor(a)
                            for a in (pos, mass, grav, fsoft)),
                      tgt_idx=torch.as_tensor(tgt), box=BOX, chunk=4,
                      lattice_tables=ttab)
    ja, jp = np.asarray(ja), np.asarray(jp)
    amag = np.linalg.norm(ja, axis=1)
    assert np.all(np.linalg.norm(ta.numpy() - ja, axis=1)
                  <= 1e-5 * amag + 1e-30)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-5)
    assert not ta[2].any()                       # the padding target


def test_treepm_total_force_vs_ewald(tmp_path, monkeypatch):
    """tests/test_treepm.py:49-79 for the port, with the closed-form
    truncation: PM + short-range walk against the Ewald direct sum."""
    monkeypatch.setenv(tlat.CACHE_DIR_ENV, str(tmp_path))
    box, pmgrid, n = 100.0, 64, 700
    w = TWiring([[tlaws.Newtonian()]])
    pm = TPM(w, pmgrid, box, 1, g_const=1.0)
    rng = np.random.default_rng(1)
    pos = torch.as_tensor(rng.uniform(0, box, (n, 3)).astype(np.float32))
    mass = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32))
    grav = torch.zeros(n, dtype=torch.int32)
    fsoft = torch.full((n,), 0.5)
    tabs = tlat.build_lattice_tables(w, 16, box)
    acc_exact, _ = t_direct(w, pos, mass, grav, fsoft, box=box,
                            want_pot=False, lattice_tables=tabs)
    acc_pm = pm.forces(pos, mass, grav)
    tree = build_tree(pos, mass, grav, fsoft, torch.ones(n), depth=7,
                      n_gravs=1, bucket=16, box_size=box)
    walk = make_fused_walk(w, 1, depth=7, bucket=16, group_size=64,
                           batch_blocks=32, chunk_cap=2048,
                           frontier_cap=4096, opening="bh", box_size=box,
                           want_pot=False,
                           treepm=dict(asmth=pm.asmth, rcut=pm.rcut))
    res = walk(tree, torch.arange(n, dtype=torch.int32))
    assert not bool(res.overflow)
    acc_t = torch.zeros(n, 3)
    acc_t[tree.order.long()] = res.acc
    tot = acc_t + acc_pm
    rel = torch.linalg.norm(tot - acc_exact, dim=1) \
        / torch.clamp(torch.linalg.norm(acc_exact, dim=1), min=1e-12)
    assert float(torch.sqrt(torch.mean(rel ** 2))) < 2.5e-2
    # the short range alone is far from the total: the PM part matters
    rel_sr = torch.linalg.norm(acc_t - acc_exact, dim=1) \
        / torch.linalg.norm(acc_exact, dim=1)
    assert float(torch.sqrt(torch.mean(rel_sr ** 2))) > 0.1


def test_walk_refuses_what_is_not_ported():
    w = TWiring([[tlaws.NoneLaw()]])
    with pytest.raises(NotImplementedError, match="item 14"):
        make_fused_walk(w, 1, depth=4, treepm=dict(asmth=1.0, rcut=4.5))
    with pytest.raises(NotImplementedError, match="item 13"):
        make_fused_walk(w, 1, depth=4, box_size=1.0,
                        lattice_tables=torch.zeros(1, 2, 2, 2, 4))
