"""Octree build and fused walk of the PyTorch port against the JAX package.

 * `build_tree`: same particle order and occupied cells per level, every
   integer field equal, per-gravity node mass and CM within f32 rounding;
   `refresh_tree` likewise after the particles move.
 * `pack_walk_tables` on the SAME tree (handed over with
   `interop.octree_from_numpy`): bit-identical tables.
 * `make_fused_walk` (port, CPU twin) against the JAX walk with
   `use_pallas=False` on the same tree: interaction counts equal, acc and
   pot within 1e-5 of each target's magnitude (the pair sums run in
   another order).
 * The port's walk against the port's direct sweep at the level of
   tests/test_tree.py:302-336: rms relative error < 5e-3, max < 0.1.
 * The solver's cap contract: a walk that overflows small caps reports it,
   and `GravitySolver.compute` grows the caps and gives the same forces.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ngravs_tpu.models import laws as jlaws
from ngravs_tpu.models.wiring import GravityWiring as JWiring
from ngravs_tpu.ops import tree as jtree
from ngravs_tpu.ops import walk as jwalk

from ngravs_tpu_torch.config import SimulationConfig
from ngravs_tpu_torch.interop import octree_from_numpy
from ngravs_tpu_torch.models import laws as tlaws
from ngravs_tpu_torch.models.wiring import GravityWiring as TWiring
from ngravs_tpu_torch.ops import tree as ttree
from ngravs_tpu_torch.ops import walk as twalk
from ngravs_tpu_torch.ops.direct import direct_forces
from ngravs_tpu_torch.ops.solver import GravitySolver
from ngravs_tpu_torch.particles import Particles

DEPTH, BUCKET, NG = 8, 16, 2


def _system(n=2000, seed=1):
    """Two clumps of a 2-gravity system (tests/test_tree.py:_system)."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.normal(0, 1.0, (n // 2, 3)),
                          rng.normal(4, 0.5, (n - n // 2, 3))]
                         ).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    grav = rng.integers(0, NG, n).astype(np.int32)
    fsoft = np.full(n, 0.05, np.float32)
    aold = (1e-3 * rng.uniform(0.5, 2, n)).astype(np.float32)
    vel = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    return pos, mass, grav, fsoft, aold, vel


def _builds(n=2000):
    pos, mass, grav, fsoft, aold, vel = _system(n)
    j = jtree.build_tree(*(jnp.asarray(a) for a in (pos, mass, grav, fsoft,
                                                    aold)),
                         depth=DEPTH, n_gravs=NG, bucket=BUCKET,
                         vel=jnp.asarray(vel))
    t = ttree.build_tree(*(torch.as_tensor(a) for a in (pos, mass, grav,
                                                        fsoft, aold)),
                         depth=DEPTH, n_gravs=NG, bucket=BUCKET,
                         vel=torch.as_tensor(vel))
    return j, t


def _assert_tree_close(j, t, fields):
    for f in fields:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=2e-6, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(b.astype(np.int64),
                                          a.astype(np.int64), err_msg=f)


def test_build_tree_parity():
    j, t = _builds()
    _assert_tree_close(j, t, jtree.Octree._fields)
    # the point of the layout: same order, same occupied cells per level
    np.testing.assert_array_equal(t.order.numpy(), np.asarray(j.order))
    assert int(t.n_chunk_rows) == int(j.n_chunk_rows)
    caps = ttree.level_caps(2000, DEPTH, bucket=BUCKET)
    assert caps == jtree.level_caps(2000, DEPTH, bucket=BUCKET)
    lv = t.node_level.numpy()
    for lvl in range(DEPTH + 1):
        live = t.node_pcount.numpy()[lv == lvl] > 0
        np.testing.assert_array_equal(
            live, np.asarray(j.node_pcount)[lv == lvl] > 0)


def test_refresh_and_drift_tree_parity():
    j, t = _builds()
    pos, mass, grav, fsoft, aold, vel = _system()
    pos2 = (pos + 0.01 * vel).astype(np.float32)
    hsml = np.zeros_like(mass)
    j2 = jtree.refresh_tree(j, *(jnp.asarray(a) for a in (
        pos2, mass, grav, fsoft, aold, hsml)), depth=DEPTH, n_gravs=NG,
        bucket=BUCKET, vel=jnp.asarray(vel))
    t2 = ttree.refresh_tree(t, *(torch.as_tensor(a) for a in (
        pos2, mass, grav, fsoft, aold, hsml)), depth=DEPTH, n_gravs=NG,
        bucket=BUCKET, vel=torch.as_tensor(vel))
    _assert_tree_close(j2, t2, jtree.Octree._fields)
    _assert_tree_close(jtree.drift_tree(j2, 0.02), ttree.drift_tree(t2, 0.02),
                       ("node_cm", "pos_s"))


def _same_tree(n=2000):
    j, _ = _builds(n)
    return j, octree_from_numpy({f: np.asarray(getattr(j, f))
                                 for f in j._fields}, "cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_walk_tables_bit_identical():
    j, t = _same_tree()
    jt = jwalk.pack_walk_tables(j, 2000, DEPTH, BUCKET, NG, 2.0)
    tt = twalk.pack_walk_tables(t, 2000, DEPTH, BUCKET, NG, 2.0)
    for f in jt._fields:
        np.testing.assert_array_equal(_bits(getattr(tt, f).numpy()),
                                      _bits(getattr(jt, f)), err_msg=f)


WALK_KW = dict(depth=DEPTH, bucket=BUCKET, group_size=64, batch_blocks=32,
               chunk_cap=1024, frontier_cap=4096, theta=0.5, want_pot=True)


@pytest.mark.parametrize("opening", ["bh", "relative"])
def test_fused_walk_matches_jax(opening):
    j, t = _same_tree()
    n = 2000
    nl = jlaws.Newtonian()
    jfn = jwalk.make_fused_walk(JWiring([[nl, nl], [nl, nl]]), NG,
                                use_pallas=False, opening=opening, **WALK_KW)
    # every other particle is a target; -1 pads the list
    tgt = np.concatenate([np.arange(0, n, 2), [-1] * 5]).astype(np.int32)
    jr = jax.jit(lambda tr, tg: jfn(tr, tg))(j, jnp.asarray(tgt))
    tl = tlaws.Newtonian()
    tr = twalk.make_fused_walk(TWiring([[tl, tl], [tl, tl]]), NG,
                               opening=opening, **WALK_KW)(
        t, torch.as_tensor(tgt))
    assert not bool(jr.overflow) and not bool(tr.overflow)
    np.testing.assert_array_equal(tr.ninteract.numpy(),
                                  np.asarray(jr.ninteract))
    ja, ta = np.asarray(jr.acc), tr.acc.numpy()
    amag = np.linalg.norm(ja, axis=1)
    assert np.all(np.linalg.norm(ta - ja, axis=1) <= 1e-5 * amag + 1e-30)
    np.testing.assert_allclose(tr.pot.numpy(), np.asarray(jr.pot), rtol=1e-5)
    for f in ("max_ent", "max_chunk", "max_rows", "max_frontier"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)


def test_walk_vs_direct_accuracy():
    """tests/test_tree.py:302-336 for the port: the fused walk against the
    O(N^2) oracle on a clumpy two-species system."""
    n, depth = 6000, 8
    rng = np.random.default_rng(7)
    centers = rng.uniform(0, 1000.0, (5, 3))
    k = rng.integers(0, 5, n)
    pos = torch.as_tensor((centers[k] + rng.normal(0, 20.0, (n, 3)))
                          .astype(np.float32))
    mass = torch.full((n,), 1.0 / n)
    grav = torch.as_tensor(rng.integers(0, 2, n).astype(np.int32))
    fsoft = torch.full((n,), 0.1)
    tree = ttree.build_tree(pos, mass, grav, fsoft, torch.full((n,), 1e-3),
                            depth=depth, n_gravs=2, bucket=32)
    tl = tlaws.Newtonian()
    walk = twalk.make_fused_walk(
        TWiring([[tl, tl], [tl, tl]]), 2, depth=depth, bucket=32,
        group_size=64, batch_blocks=128, chunk_cap=2048, frontier_cap=4096,
        theta=0.5, opening="bh", want_pot=False)
    res = walk(tree, torch.arange(n, dtype=torch.int32))
    assert not bool(res.overflow)
    acc_w = torch.zeros(n, 3)
    acc_w[tree.order.long()] = res.acc
    acc_d, _ = direct_forces(TWiring([[tl, tl], [tl, tl]]), pos, mass, grav,
                             fsoft, chunk=2048, want_pot=False)
    err = torch.linalg.norm(acc_w - acc_d, dim=1) \
        / torch.clamp(torch.linalg.norm(acc_d, dim=1), min=1e-12)
    assert float(torch.sqrt(torch.mean(err ** 2))) < 5e-3
    assert float(err.max()) < 0.1
    assert (res.ninteract > 0).float().mean() > 0.99


def test_solver_grows_overflowing_caps():
    n = 2000
    pos, mass, grav, fsoft, aold, vel = _system(n)
    ptype = np.where(grav == 1, 2, 1)
    base = dict(gravity_constant_internal=1.0, softening=(0.05 / 2.8,) * 6,
                n_gravs=2, type_to_grav=(0, 0, 1, 0, 0, 0), solver="tree",
                tree_depth=DEPTH, tree_bucket_size=BUCKET,
                walk_batch_blocks=32, type_of_opening_criterion=0)
    p = Particles.create(pos, vel, mass, np.arange(n), ptype,
                         base["type_to_grav"], device="cpu")
    from ngravs_tpu_torch.models.wiring import build_wiring
    results = []
    for caps in (dict(), dict(walk_chunk_cap=64, walk_frontier_cap=64)):
        cfg = SimulationConfig(**base, **caps)
        solver = GravitySolver(cfg, build_wiring(cfg), cfg.softening, 1.0)
        if caps:
            walk = solver._walk(False)
            from ngravs_tpu_torch.ops.tree import build_tree
            tree = build_tree(p.pos, p.mass, p.grav,
                              torch.full((n,), 0.05), torch.zeros(n),
                              depth=DEPTH, n_gravs=2, bucket=BUCKET)
            assert bool(walk(tree, torch.arange(n)).overflow)
        p2, n_ia, _ = solver.compute(p, 0, n)
        results.append((p2.accel, n_ia))
        if caps:
            assert solver.fcaps["chunk"] > 64
    torch.testing.assert_close(results[1][0], results[0][0], rtol=0, atol=0)
    assert results[0][1] == results[1][1]


def test_solver_deepens_fat_leaves():
    """A depth limit that leaves > bucket particles in a leaf deepens the
    tree and re-derives the depth-shaped caps.  (The JAX solver keeps the
    frontier caps of the old depth here and stops on an assertion in
    normalize_frontier_caps; ROADMAP Queue 3.)"""
    n = 600
    pos = _system(n)[0]
    cfg = SimulationConfig(gravity_constant_internal=1.0,
                           softening=(0.01,) * 6, solver="tree",
                           tree_depth=1, type_of_opening_criterion=0)
    p = Particles.create(pos, np.zeros_like(pos), np.full(n, 1e-3),
                         np.arange(n), np.ones(n, np.int32),
                         cfg.type_to_grav, device="cpu")
    from ngravs_tpu_torch.models.wiring import build_wiring
    solver = GravitySolver(cfg, build_wiring(cfg), cfg.softening, 1.0)
    p2, _, tree = solver.compute(p, 0, n)
    assert solver.depth == 4 and len(solver.fcaps["frontier"]) == 5
    fat = torch.where(tree.node_terminal, tree.node_pcount, 0).max()
    assert int(fat) <= cfg.tree_bucket_size
    fsoft = torch.full((n,), 0.01)   # the solver's softening table above
    acc_d, _ = direct_forces(build_wiring(cfg), p.pos, p.mass, p.grav, fsoft,
                             want_pot=False)
    err = torch.linalg.norm(p2.accel - acc_d, dim=1) \
        / torch.linalg.norm(acc_d, dim=1)
    assert float(torch.sqrt(torch.mean(err ** 2))) < 5e-3
