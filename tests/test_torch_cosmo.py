"""Comoving integration, the periodic tree and the TreePM multi-law walk of
the port against the JAX package.

 * `DriftKickTables`: the f64 tables within 1e-12 relative (the same numpy
   program), and the f32 lookups bit-equal; the comoving `ti_to_time` /
   `time_to_ti` exactly.
 * `pm_window_update` and `cosmo_factors` equal (integers exactly, the f32
   factors bit-equal: the same f32 operations in the same order).
 * The periodic tree (root cell = the box): every integer field equal, the
   moments within f32 rounding (rtol 2e-6, the segment sums run in another
   order).
 * The TreePM short-range walk with the newton_yukawa wiring in a periodic
   box: `ninteract` equal to `make_fused_walk(use_pallas=False, box_size=...,
   treepm=...)` on the same tree, acc within 1e-5 of each target's |acc|
   (the walk tolerance of tests/test_torch_tree_walk.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ngravs_tpu import config as jconfig
from ngravs_tpu import units as junits
from ngravs_tpu.cosmology import DriftKickTables as JTables
from ngravs_tpu.integrate import kdk as jkdk
from ngravs_tpu.integrate import timeline as jtl
from ngravs_tpu.models.wiring import build_wiring as j_build_wiring
from ngravs_tpu.ops import tree as jtree
from ngravs_tpu.ops import walk as jwalk

from ngravs_tpu_torch import config as tconfig
from ngravs_tpu_torch import units as tunits
from ngravs_tpu_torch.cosmology import DriftKickTables as TTables
from ngravs_tpu_torch.integrate import kdk as tkdk
from ngravs_tpu_torch.integrate import timeline as ttl
from ngravs_tpu_torch.interop import octree_from_numpy
from ngravs_tpu_torch.models.wiring import build_wiring as t_build_wiring
from ngravs_tpu_torch.ops import tree as ttree
from ngravs_tpu_torch.ops import walk as twalk

COSMO = dict(comoving_integration=True, omega0=0.3, omega_lambda=0.7,
             hubble_param=0.7, time_begin=0.1, time_max=1.0)
BOX, DEPTH, BUCKET, NG = 100.0, 6, 16, 2


def test_drift_kick_tables_match():
    args = (0.1, 1.0, 0.3, 0.7, 0.1)
    j, t = JTables(*args), TTables(*args)
    for name in ("drift_table", "gravkick_table", "hydrokick_table"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=1e-12, atol=0, err_msg=name)
    rng = np.random.default_rng(0)
    ti = np.sort(rng.integers(0, 1 << 28, 200)).astype(np.int32)
    ti[:2] = (0, 1 << 28)
    for meth in ("drift_factor", "gravkick_factor", "hydrokick_factor"):
        want = np.asarray(getattr(j, meth)(ti[:-1], ti[1:]))
        got = getattr(t, meth)(torch.as_tensor(ti[:-1]),
                               torch.as_tensor(ti[1:])).numpy()
        np.testing.assert_array_equal(got, want, err_msg=meth)
    assert float(t.gravkick_factor(7, 1 << 25)) == \
        float(j.gravkick_factor(7, 1 << 25))


def test_comoving_timeline_match():
    jc = jconfig.SimulationConfig(**COSMO)
    tc = tconfig.SimulationConfig(**COSMO)
    assert ttl.timebase_interval(tc) == jtl.timebase_interval(jc)
    ti = np.array([0, 1, 12345, 1 << 27, (1 << 28) - 1, 1 << 28])
    np.testing.assert_array_equal(ttl.ti_to_time(tc, ti),
                                  jtl.ti_to_time(jc, ti))
    for a in (0.1, 0.1000001, 0.37, 0.5, 0.99999, 1.0):
        assert ttl.time_to_ti(tc, a) == jtl.time_to_ti(jc, a)


def test_pm_window_and_cosmo_factors_match():
    tbi = jtl.timebase_interval(jconfig.SimulationConfig(**COSMO))
    cases = [(0, 0, 0, 0.02), (1 << 22, 0, 1 << 22, 0.02),
             (3 << 20, 1 << 20, 3 << 20, 0.011), (1 << 27, 0, 1 << 27, 5e-4),
             ((1 << 28) - 8, (1 << 28) - 16, (1 << 28) - 8, 0.02),
             (1 << 28, (1 << 28) - 8, 1 << 28, 0.02)]
    for ti_next, beg, end, dt in cases:
        want = [int(x) for x in jtl.pm_window_update(ti_next, beg, end, dt,
                                                      tbi)]
        assert list(ttl.pm_window_update(ti_next, beg, end, dt, tbi)) \
            == want, (ti_next, beg, end, dt)
    jc = jconfig.SimulationConfig(**COSMO)
    tc = tconfig.SimulationConfig(**COSMO)
    ju, tu = junits.set_units(jc), tunits.set_units(tc)
    for a in (0.1, 0.33, 1.0):
        jf = jkdk.cosmo_factors(jc, ju, a)
        tf = tkdk.cosmo_factors(tc, tu, a)
        for name in ("fac1", "hubble_a", "a3inv", "atime"):
            assert float(getattr(tf, name)) == float(getattr(jf, name)), name


def _box_system(n=1500, seed=2):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, BOX, (5, 3))
    k = rng.integers(0, 5, n)
    # clumps that straddle the box faces
    pos = np.mod(centers[k] + rng.normal(0, 8.0, (n, 3)), BOX)
    pos[:40] = rng.uniform(0, 1.0, (40, 3))          # at a corner
    pos[40:80] = BOX - rng.uniform(0, 1.0, (40, 3))
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    grav = rng.integers(0, NG, n).astype(np.int32)
    fsoft = np.full(n, 0.3, np.float32)
    aold = (1e-3 * rng.uniform(0.5, 2, n)).astype(np.float32)
    vel = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    return pos.astype(np.float32), mass, grav, fsoft, aold, vel


def test_periodic_tree_matches():
    pos, mass, grav, fsoft, aold, vel = _box_system()
    j = jtree.build_tree(*(jnp.asarray(a) for a in (pos, mass, grav, fsoft,
                                                    aold)),
                         depth=DEPTH, n_gravs=NG, bucket=BUCKET, box_size=BOX,
                         vel=jnp.asarray(vel))
    t = ttree.build_tree(*(torch.as_tensor(a) for a in (pos, mass, grav,
                                                        fsoft, aold)),
                         depth=DEPTH, n_gravs=NG, bucket=BUCKET, box_size=BOX,
                         vel=torch.as_tensor(vel))
    assert float(t.root_len) == BOX and not t.corner.any()
    for f in jtree.Octree._fields:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=2e-6, atol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(b.astype(np.int64),
                                          a.astype(np.int64), err_msg=f)


@pytest.mark.parametrize("opening", ["bh", "relative"])
def test_treepm_multilaw_walk_matches(opening):
    pos, mass, grav, fsoft, aold, vel = _box_system()
    n = len(pos)
    j = jtree.build_tree(*(jnp.asarray(a) for a in (pos, mass, grav, fsoft,
                                                    aold)),
                         depth=DEPTH, n_gravs=NG, bucket=BUCKET, box_size=BOX)
    t = octree_from_numpy({f: np.asarray(getattr(j, f)) for f in j._fields},
                          "cpu")
    kw = dict(n_gravs=NG, type_to_grav=(0, 0, 1, 0, 0, 0),
              wiring="newton_yukawa", box_size=BOX, periodic=True, pmgrid=32)
    jw = j_build_wiring(jconfig.SimulationConfig(**kw))
    tw = t_build_wiring(tconfig.SimulationConfig(**kw))
    asmth = 1.25 * BOX / 32
    walk_kw = dict(depth=DEPTH, bucket=BUCKET, group_size=64,
                   batch_blocks=32, chunk_cap=1024, frontier_cap=4096,
                   opening=opening, box_size=BOX, want_pot=True)
    dummy = np.zeros((NG, NG, 8), np.float32)   # closed form: unused
    jfn = jwalk.make_fused_walk(
        jw, NG, use_pallas=False,
        treepm=dict(sr_ftab=dummy, sr_ptab=dummy, asmth=asmth,
                    rcut=4.5 * asmth), **walk_kw)
    tgt = np.concatenate([np.arange(0, n, 3), [-1] * 3]).astype(np.int32)
    jr = jax.jit(lambda tr, tg: jfn(tr, tg))(j, jnp.asarray(tgt))
    tr = twalk.make_fused_walk(tw, NG, treepm=dict(asmth=asmth,
                                                   rcut=4.5 * asmth),
                               **walk_kw)(t, torch.as_tensor(tgt))
    assert not bool(jr.overflow) and not bool(tr.overflow)
    np.testing.assert_array_equal(tr.ninteract.numpy(),
                                  np.asarray(jr.ninteract))
    ja = np.asarray(jr.acc)
    amag = np.linalg.norm(ja, axis=1)
    assert np.all(np.linalg.norm(tr.acc.numpy() - ja, axis=1)
                  <= 1e-5 * amag + 1e-30)
    np.testing.assert_allclose(tr.pot.numpy(), np.asarray(jr.pot), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(jr.pot)).max())
    assert int(tr.ninteract.max()) > 0
