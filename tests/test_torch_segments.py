"""Segments (`Simulation(..., segment_steps=K)`) of the port against its own
single stepping and against the JAX package's segments, on the CPU.

 * The direct path (tests/test_integrator.py:401): a segment, a loop of
   the general step, is bit for bit the single stepping, in fewer than
   half as many `step()` calls.
 * The tree path (tests/test_integrator.py:441): the same timeline as
   single stepping, positions and velocities within 2e-3 (the JAX test's
   tolerance: a segment drifts the tree between re-aggregations, single
   stepping re-aggregates every pass).
 * The port's tree segment against JAX's on a centrally concentrated halo
   of 256 particles (steps spread over the hierarchy, so every step of a
   segment takes one of the three tree modes) and on a comoving TreePM box
   of 2 x 6^3 particles at PMGRID 16: the step count, `ti_endstep` and the
   PM window exactly equal, positions and velocities within 1e-5 of their
   largest magnitude, and the port's sequence of tree modes (drift,
   refresh, rebuild; recorded by wrapping `Simulation._tree_maintain`)
   the one JAX's rule (ngravs_tpu/integrate/runner.py:686-692) gives for
   JAX's own active counts, read from its info.txt.  JAX's
   `drift_walk_tables` adds the velocity terms with a 0/1 matrix product
   over every column, and XLA:CPU flushes f32 denormals to zero, so the
   small integers stored as bit patterns in the tables (flags, chunk
   offsets, gids) become 0 and a drift step walks an empty tree: no
   gravity (`test_jax_table_drift_flushes_bit_patterns_on_cpu` pins
   this).  These tests run JAX's segment with a table drift that adds to
   the position columns only, as the JAX docstring describes it and as
   the port does.
 * `drift_walk_tables` on one tree: the position columns within 1e-6
   relative of JAX's own `drift_walk_tables`; every other column, the
   grav/gid bit patterns included, exactly the packed table's.
 * A segment whose walk overflows its caps freezes the state before that
   step, grows the caps and resumes: the same trajectory, bit for bit, as
   a run whose caps never overflow.

Every run asks for the CPU by name.
"""

import math
import re

import numpy as np
import torch
import jax.numpy as jnp

import ngravs_tpu.ops.walk as jwalk
from ngravs_tpu.config import SimulationConfig as JConfig
from ngravs_tpu.integrate.runner import Simulation as JSimulation
from ngravs_tpu.ops.tree import build_tree as j_build_tree
from ngravs_tpu.particles import Particles as JParticles
from ngravs_tpu.units import set_units as j_set_units

from ngravs_tpu_torch.config import SimulationConfig as TConfig
from ngravs_tpu_torch.constants import TIMEBASE
from ngravs_tpu_torch.integrate.runner import REFRESH_EVERY, TREE_MODES
from ngravs_tpu_torch.integrate.runner import Simulation as TSimulation
from ngravs_tpu_torch.ops.walk import WalkTables, drift_walk_tables
from ngravs_tpu_torch.particles import Particles as TParticles

# tiny tensors: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (a parallel run is several times slower else)
torch.set_num_threads(1)

RTOL = 1e-5


def _port(kw, pos, vel, mass, ptype=None, seg=1, log_dir=""):
    cfg = TConfig(**kw)
    n = len(pos)
    ptype = np.ones(n, np.int32) if ptype is None else ptype
    return TSimulation(cfg, particles=TParticles.create(
        pos, vel, mass, np.arange(n), ptype, cfg.type_to_grav, device="cpu"),
        log_dir=log_dir, segment_steps=seg)


def _jax(kw, pos, vel, mass, ptype=None, seg=1, log_dir=""):
    cfg = JConfig(**kw)
    n = len(pos)
    ptype = np.ones(n, np.int32) if ptype is None else ptype
    return JSimulation(cfg, particles=JParticles.create(
        pos, vel, mass, np.arange(n), ptype, cfg.type_to_grav),
        log_dir=log_dir, segment_steps=seg)


def _uniform(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    return pos, vel, np.full(n, 1e-3, np.float32)


OPEN_CFG = dict(time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
                softening=(0.05,) * 6, max_size_timestep=0.01,
                time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
                time_bet_statistics=0.0, wiring="newton")


def test_direct_segment_is_bit_identical():
    kw = dict(OPEN_CFG, solver="direct")
    a = _port(kw, *_uniform(128, 0))
    b = _port(kw, *_uniform(128, 0), seg=16)
    for _ in range(48):
        a.step()
        if a.ti_current >= TIMEBASE:
            break
    calls = 0
    while b.step_count < a.step_count and b.ti_current < TIMEBASE:
        b.step()
        calls += 1
    assert b.step_count == a.step_count and b.ti_current == a.ti_current
    assert calls < a.step_count / 2
    assert b.trace.counts["segment.segments"] >= 1
    for k in ("pos", "vel", "ti_endstep", "accel"):
        assert torch.equal(getattr(a.p, k), getattr(b.p, k)), k
    assert a.num_force_updates == b.num_force_updates


def test_tree_segment_matches_single_stepping():
    kw = dict(OPEN_CFG, solver="tree", tree_depth=6, err_tol_theta=0.6,
              type_of_opening_criterion=0, time_max=0.05,
              walk_batch_blocks=32)
    runs = []
    for seg in (1, 16):
        sim = _port(kw, *_uniform(256, 1), seg=seg)
        calls = 0
        while sim.ti_current < TIMEBASE and sim.time <= kw["time_max"]:
            sim.step()
            calls += 1
            assert calls < 2000
        runs.append((sim, calls))
    (a, _), (b, calls) = runs
    assert b.step_count == a.step_count and b.ti_current == a.ti_current
    assert calls < a.step_count / 2
    assert a.num_force_updates == b.num_force_updates
    assert torch.equal(a.p.ti_endstep, b.p.ti_endstep)
    # tree-maintenance noise, not bits (tests/test_integrator.py:484-490)
    assert float((a.p.pos - b.p.pos).abs().max()) <= 2e-3
    assert float((a.p.vel - b.p.vel).abs().max()) <= 2e-3


def _exact_table_drift(wt, dd, n_gravs):
    """JAX's table drift on the position columns only (the fix of the
    flushed bit patterns; see the module docstring)."""
    gsrc = wt.gsrc.reshape(-1, 8, 8).at[:, :, 0:3].add(
        wt.gvel.reshape(-1, 8, 3) * dd).reshape(wt.gsrc.shape)
    n_oct, w8 = wt.wtab8.shape
    cols = np.array([8 + 4 * g + a for g in range(n_gravs)
                     for a in range(3)])
    wtab8 = wt.wtab8.reshape(n_oct, 8, w8 // 8).at[:, :, cols].add(
        wt.wvel8.reshape(n_oct, 8, n_gravs * 3) * dd).reshape(n_oct, w8)
    return wt._replace(gsrc=gsrc, wtab8=wtab8)


def _jax_modes(info_path, segments, n, freq):
    """The tree mode of each JAX segment step by JAX's rule
    (ngravs_tpu/integrate/runner.py:686-692: each segment starts from a
    fresh build with both counters 0), from its logged active counts."""
    active = [int(a) for a in re.findall(r"Active: (\d+) \(segment\)",
                                         open(info_path).read())]
    assert len(active) == sum(segments)
    rebuild_every = max(1, int(freq * n))
    modes, k = [], 0
    for count in segments:
        since = since_agg = 0
        for a in active[k:k + count]:
            mode = 2 if since >= rebuild_every else \
                1 if since_agg >= REFRESH_EVERY else 0
            since = (0 if mode == 2 else since) + a
            since_agg = 0 if mode > 0 else since_agg + 1
            modes.append(TREE_MODES[mode])
        k += count
    return modes


def _close(got, want, what):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= RTOL * float(np.abs(want).max()), f"{what}: {err}"


def _record_modes(sim):
    """Wrap `sim._tree_maintain` to record the mode of each segment step
    (the call that builds a segment's first tree passes no tree)."""
    modes = []
    maintain = sim._tree_maintain

    def spy(p, mode, tree, wt, dd):
        if tree is not None:
            modes.append(TREE_MODES[mode])
        return maintain(p, mode, tree, wt, dd)
    sim._tree_maintain = spy
    return modes


def _run_both(ts, js, steps, tmp_path, freq, pm=False):
    """Step both until `steps`; per call: the timeline equal, and the
    segments' step counts for the mode rule."""
    segments = []
    modes = _record_modes(ts)
    while js.step_count < steps:
        before = js.step_count
        js.step()
        ts.step()
        assert ts.step_count == js.step_count
        assert ts.ti_current == js.ti_current
        np.testing.assert_array_equal(ts.p.ti_endstep.numpy(),
                                      np.asarray(js.p.ti_endstep))
        if pm:
            assert (ts.pm_ti_begstep, ts.pm_ti_endstep) == \
                (js.pm_ti_begstep, js.pm_ti_endstep)
        if before > 0:
            segments.append(js.step_count - before)
    _close(ts.p.pos, js.p.pos, "pos")
    _close(ts.p.vel, js.p.vel, "vel")
    assert ts.num_force_updates == js.num_force_updates
    want = _jax_modes(tmp_path / "jax" / "info.txt", segments, ts.p.n, freq)
    # no cap overflow, so every recorded step was committed
    assert ts.trace.counts.get("segment.retries", 0) == 0
    assert modes == want
    assert [ts.trace.counts.get("segment." + m, 0) for m in TREE_MODES] == \
        [want.count(m) for m in TREE_MODES]
    return want


def test_tree_segment_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jwalk, "drift_walk_tables", _exact_table_drift)
    # a centrally concentrated halo (tests/test_parallel.py:_small_halo):
    # steps over several bins; a rebuild every 4 N updates lets drift and
    # refresh steps occur
    rng = np.random.default_rng(11)
    n = 256
    r = 0.05 + 3.0 * rng.random(n) ** 3
    u = rng.normal(size=(n, 3))
    pos = (5.0 + r[:, None] * u / np.linalg.norm(u, axis=1, keepdims=True)) \
        .astype(np.float32)
    vel = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    freq = 4.0
    kw = dict(OPEN_CFG, softening=(0.05,) * 6, max_size_timestep=0.02,
              err_tol_int_accuracy=0.02, solver="tree", tree_depth=6,
              err_tol_theta=0.6, type_of_opening_criterion=0,
              walk_batch_blocks=32, tree_domain_update_frequency=freq)
    js = _jax(kw, pos, vel, mass, seg=12, log_dir=str(tmp_path / "jax"))
    ts = _port(kw, pos, vel, mass, seg=12)
    modes = _run_both(ts, js, 25, tmp_path, freq)
    assert set(modes) == set(TREE_MODES)
    js.close()


def _cosmo_box(n_side=6, box=10000.0, seed=19):
    """tests/test_torch_slice.py:_cosmo_box: two jittered lattices in a
    comoving newton_yukawa TreePM box."""
    rng = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / n_side * box
    n = len(g)
    a = np.mod(g + rng.normal(0, 0.02 * box / n_side, g.shape), box)
    b = np.mod(g + rng.normal(0, 0.02 * box / n_side, g.shape)
               + 0.5 * box / n_side, box)
    pos = np.concatenate([a, b]).astype(np.float32)
    vel = rng.normal(0, 1.0, pos.shape).astype(np.float32)
    ptype = np.concatenate([np.ones(n, np.int32), np.full(n, 2, np.int32)])
    kw = dict(comoving_integration=True, omega0=1.0, omega_lambda=0.0,
              omega_baryon=0.1, hubble_param=1.0, time_begin=0.1,
              time_max=0.2, periodic=True, box_size=box, pmgrid=16,
              softening=(5.0,) * 6, max_size_timestep=0.1,
              err_tol_int_accuracy=0.025, n_gravs=2,
              type_to_grav=(0, 0, 1, 0, 0, 0), wiring="newton_yukawa",
              tree_depth=6, tree_bucket_size=16, walk_batch_blocks=32,
              time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
              time_bet_statistics=0.0)
    units = j_set_units(JConfig(**kw))
    m_tot = 3 * units.hubble ** 2 / (8 * math.pi * units.G) * box ** 3
    mass = np.concatenate([np.full(n, 0.9 * m_tot / n),
                           np.full(n, 0.1 * m_tot / n)]).astype(np.float32)
    return kw, pos, vel, mass, ptype


def test_comoving_treepm_segment_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jwalk, "drift_walk_tables", _exact_table_drift)
    kw, pos, vel, mass, ptype = _cosmo_box()
    js = _jax(kw, pos, vel, mass, ptype, seg=8, log_dir=str(tmp_path / "jax"))
    ts = _port(kw, pos, vel, mass, ptype, seg=8)
    _run_both(ts, js, 6, tmp_path, 0.1, pm=True)
    assert ts.pm_ti_endstep > 0
    assert ts.dt_displacement == js.dt_displacement
    js.close()


def _packed_tables():
    """One JAX tree of 512 particles in two gravities and its packed
    tables."""
    from ngravs_tpu.ops.walk import pack_walk_tables as j_pack
    rng = np.random.default_rng(0)
    n, ng = 512, 2
    pos = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    grav = rng.integers(0, ng, n).astype(np.int32)
    tree = j_build_tree(jnp.asarray(pos), jnp.full(n, 1e-3, jnp.float32),
                        jnp.asarray(grav), jnp.full(n, 0.1, jnp.float32),
                        jnp.zeros(n), jnp.zeros(n), depth=5, n_gravs=ng,
                        bucket=16, vel=jnp.asarray(vel))
    return j_pack(tree, n, 5, 16, ng, 2.0), ng


def _xyz_masks(jt, ng):
    """Per table, the columns that hold positions (source rows: x, y, z of
    each of 8 rows; walk table: each gravity's CM of each of 8 slots)."""
    w = jt.wtab8.shape[1] // 8
    xyz_w = np.zeros((8, w), bool)
    for g in range(ng):
        xyz_w[:, 8 + 4 * g:11 + 4 * g] = True
    xyz_s = np.zeros((8, 8), bool)
    xyz_s[:, 0:3] = True
    return {name: np.tile(mask.reshape(-1),
                          getattr(jt, name).shape[1] // mask.size)
            for name, mask in (("gsrc", xyz_s), ("wtab8", xyz_w))}


def test_drift_walk_tables_matches_jax():
    jt, ng = _packed_tables()
    dd = np.float32(0.37)
    want = jwalk.drift_walk_tables(jt, jnp.float32(dd), ng)
    t = WalkTables(*(torch.as_tensor(np.array(x)) for x in jt))
    got = drift_walk_tables(t, torch.tensor(dd), ng)
    for name, m in _xyz_masks(jt, ng).items():
        before = np.asarray(getattr(jt, name))
        g = getattr(got, name).numpy()
        ref = np.asarray(getattr(want, name))
        # the position columns move as JAX's, to f32 rounding
        np.testing.assert_allclose(g[:, m], ref[:, m], rtol=1e-6,
                                   atol=1e-6 * np.abs(ref[:, m]).max())
        assert np.abs(g[:, m] - before[:, m]).max() > 0
        # everything else keeps its bits (flags, offsets, grav, gid)
        np.testing.assert_array_equal(g[:, ~m].view(np.int32),
                                      before[:, ~m].view(np.int32))
    # the packed table's bit patterns are the ones JAX packed
    assert torch.equal(got.slot8, t.slot8)


def test_jax_table_drift_flushes_bit_patterns_on_cpu():
    """The witness for the patched table drift of the segment tests: on the
    CPU, JAX's own `drift_walk_tables` turns the small integers stored as
    f32 bit patterns (f32 denormals) outside the position columns into 0,
    where the port and `_exact_table_drift` keep them."""
    jt, ng = _packed_tables()
    dd = jnp.float32(0.37)
    real = jwalk.drift_walk_tables(jt, dd, ng)
    exact = _exact_table_drift(jt, dd, ng)
    flushed = 0
    for name, m in _xyz_masks(jt, ng).items():
        before = np.asarray(getattr(jt, name))[:, ~m].view(np.int32)
        r = np.asarray(getattr(real, name))[:, ~m].view(np.int32)
        e = np.asarray(getattr(exact, name))[:, ~m].view(np.int32)
        np.testing.assert_array_equal(e, before)
        # exponent bits 0, mantissa not: an f32 denormal
        denormal = ((before & 0x7F800000) == 0) & ((before & 0x7FFFFF) != 0)
        # every nonzero denormal pattern is flushed to zero; the other
        # bits stay as they were packed
        np.testing.assert_array_equal(r[denormal], 0)
        np.testing.assert_array_equal(r[~denormal], before[~denormal])
        flushed += int(denormal.sum())
    assert flushed > 0


def test_overflowing_segment_resumes_on_the_same_trajectory():
    kw = dict(OPEN_CFG, solver="tree", tree_depth=6, err_tol_theta=0.6,
              type_of_opening_criterion=0, walk_batch_blocks=32)
    small = _port(kw, *_uniform(256, 2), seg=8)
    small.step()
    # caps far below the walk's demand: the segment's first walk overflows
    small.solver.fcaps["frontier"] = (8,) * (small.solver.depth + 1)
    small.solver.fcaps["chunk"] = 8
    small.step()
    assert small.trace.counts["segment.retries"] >= 1
    assert small.step_count > 2
    ample = _port(kw, *_uniform(256, 2), seg=8)
    ample.step()
    # the caps the small run grew to, which never overflow
    ample.solver.fcaps = dict(small.solver.fcaps)
    ample.step()
    assert ample.trace.counts.get("segment.retries", 0) == 0
    while ample.step_count < small.step_count:
        ample.step()
    assert ample.step_count == small.step_count
    assert ample.ti_current == small.ti_current
    for k in ("pos", "vel", "accel", "ti_endstep"):
        assert torch.equal(getattr(small.p, k), getattr(ample.p, k)), k
    # the frozen steps are not counted: the committed steps by mode agree
    assert [small.trace.counts.get("segment." + m, 0) for m in TREE_MODES] \
        == [ample.trace.counts.get("segment." + m, 0) for m in TREE_MODES]
