"""The ngravs law matrix in the port against the JAX package, on the CPU.

The wirings that set ngravs apart from plain GADGET-2 go through the
port's production walk and main loop here, each against the same
configuration in the JAX package (the Pallas kernel's plain version: the
JAX walk with `use_pallas=False`, the port's walk with K1's twin):

 * The fused walk on the two-clump system of tests/test_torch_tree_walk.py
   for `newton_yukawa` (open box: a multi-law walk without a box),
   `bam` with the accumulator (both opening criteria), `bam` without it,
   and `three_species` at N_GRAVS=3 (three diagonal laws, Yukawa across):
   interaction counts and the walk's caps equal, acc within 1e-5 of each
   target's |acc|, pot within 1e-5 relative (the pair sums run in another
   order).
 * The accumulator on the production walk (NGRAVS_ACCUMULATOR, ngravs.c:
   163-210): eight BAM targets beside a 16-member BAM clump, in blocks of
   8, so that the fused walk takes the clump as one node (`ninteract` 8);
   with the accumulator on the port equals JAX's fused walk and stays
   near the direct sum, with it off the error is larger on every target
   and at least ten times larger in the mean.  On the probe of
   tests/test_tree.py:244 (one target; its block holds the clump, so the
   fused walk opens it) the port's fused walk equals JAX's two-phase walk
   `make_tree_forces`, which takes the clump as a node.
 * Five `Simulation` steps of each package from the same particles, as
   tests/test_torch_slice.py: `newton_yukawa` and `bam` with the
   accumulator (the geometric criterion) on its two Plummer spheres, the
   stock `newton` periodic pure-tree box at 2 x 8^3, and `three_species`
   TreePM + SPH at 3 x 8^3 with gas (PMGRID 32 and walk blocks of 16:
   the port's CPU twin evaluates every law on every row of a block, so a
   narrower cut and smaller blocks keep a step near 4 s here).  The
   timeline and `ti_endstep` equal, positions within 1e-5 of the extent,
   the gas's entropy, Hsml and density within 1e-4 relative, and every kicked
   particle more than 1e-4 (log2) off a timestep-bin edge, so that
   rounding cannot move one into another bin: the Plummer spheres' seed
   is chosen so (1,200 particles, seed 8: 5.1e-4 with newton_yukawa, 4.9e-4
   with bam; seed 4 comes within 5e-5 and 1.2e-5).
 * The K1 instance each configuration of chip_smoke.py's phase 13 runs.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ngravs_tpu.config import SimulationConfig as JConfig
from ngravs_tpu.integrate.runner import Simulation as JSimulation
from ngravs_tpu.models.wiring import build_wiring as j_build_wiring
from ngravs_tpu.ops import tree as jtree
from ngravs_tpu.ops import walk as jwalk
from ngravs_tpu.particles import Particles as JParticles
from ngravs_tpu.particles import SphState as JSph

from ngravs_tpu_torch.config import SimulationConfig as TConfig
from ngravs_tpu_torch.integrate.runner import Simulation as TSimulation
from ngravs_tpu_torch.interop import (octree_from_numpy,
                                      particles_from_numpy, sph_from_numpy)
from ngravs_tpu_torch.models.wiring import build_wiring as t_build_wiring
from ngravs_tpu_torch.ops import lattice as tlat
from ngravs_tpu_torch.ops import walk as twalk
from ngravs_tpu_torch.ops.direct import direct_forces
from ngravs_tpu_torch.ops.pairwise import instance_flags, instance_name

import test_torch_slice
from test_torch_sph_runs import SPH_FIELDS, _np, _off_bin_edges

# tiny tensors: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

DEPTH, BUCKET = 8, 16
WALK_KW = dict(depth=DEPTH, bucket=BUCKET, group_size=64, batch_blocks=32,
               chunk_cap=1024, frontier_cap=4096, theta=0.5, want_pot=True)


def _wirings(name, n_gravs, accumulator=False, **kw):
    """The same wiring in both packages."""
    args = dict(n_gravs=n_gravs, wiring=name,
                ngravs_accumulator=accumulator, **kw)
    return (j_build_wiring(JConfig(**args)),
            t_build_wiring(TConfig(**args)))


def _two_clumps(n_gravs, n=2000, seed=1):
    """tests/test_torch_tree_walk.py:_system with `n_gravs` gravities."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.normal(0, 1.0, (n // 2, 3)),
                          rng.normal(4, 0.5, (n - n // 2, 3))]
                         ).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    grav = rng.integers(0, n_gravs, n).astype(np.int32)
    fsoft = np.full(n, 0.05, np.float32)
    aold = (1e-3 * rng.uniform(0.5, 2, n)).astype(np.float32)
    return pos, mass, grav, fsoft, aold


def _same_tree(pos, mass, grav, fsoft, aold, n_gravs, depth, bucket):
    """JAX's tree, and the same tree handed to the port."""
    j = jtree.build_tree(*(jnp.asarray(a) for a in (pos, mass, grav, fsoft,
                                                    aold)),
                         depth=depth, n_gravs=n_gravs, bucket=bucket)
    return j, octree_from_numpy({f: np.asarray(getattr(j, f))
                                 for f in j._fields}, "cpu")


def _both_walks(jw, tw, n_gravs, j, t, tgt, **kw):
    jfn = jwalk.make_fused_walk(jw, n_gravs, use_pallas=False, **kw)
    jr = jax.jit(lambda tr, tg: jfn(tr, tg))(j, jnp.asarray(tgt))
    tr = twalk.make_fused_walk(tw, n_gravs, **kw)(t, torch.as_tensor(tgt))
    assert not bool(jr.overflow) and not bool(tr.overflow)
    return jr, tr


def _assert_walks_equal(jr, tr):
    np.testing.assert_array_equal(tr.ninteract.numpy(),
                                  np.asarray(jr.ninteract))
    ja, ta = np.asarray(jr.acc), tr.acc.numpy()
    amag = np.linalg.norm(ja, axis=1)
    assert np.all(np.linalg.norm(ta - ja, axis=1) <= 1e-5 * amag + 1e-30)
    np.testing.assert_allclose(tr.pot.numpy(), np.asarray(jr.pot), rtol=1e-5)
    for f in ("max_ent", "max_chunk", "max_rows", "max_frontier"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)


WALK_CASES = {
    "newton_yukawa": ("newton_yukawa", 2, False, "relative"),
    "bam_accumulator_bh": ("bam", 2, True, "bh"),
    "bam_accumulator_relative": ("bam", 2, True, "relative"),
    "bam_no_accumulator": ("bam", 2, False, "bh"),
    "three_species": ("three_species", 3, False, "relative"),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_fused_walk_matches_jax_wirings(case):
    name, ng, acc, opening = WALK_CASES[case]
    jw, tw = _wirings(name, ng, acc)
    assert tw.accumulator == acc
    n = 2000
    j, t = _same_tree(*_two_clumps(ng, n), ng, DEPTH, BUCKET)
    # every other particle is a target; -1 pads the list
    tgt = np.concatenate([np.arange(0, n, 2), [-1] * 5]).astype(np.int32)
    jr, tr = _both_walks(jw, tw, ng, j, t, tgt, opening=opening, **WALK_KW)
    _assert_walks_equal(jr, tr)
    assert float(np.abs(tr.acc.numpy()).max()) > 0


def test_configuration_instances():
    """The K1 instance of each configuration of chip_smoke's phase 13."""
    def name(wiring, n_gravs, **kw):
        cfg = TConfig(n_gravs=n_gravs, wiring=wiring,
                      ngravs_accumulator=kw.pop("accumulator", False),
                      box_size=kw.get("box_size", 0.0),
                      periodic=kw.get("box_size", 0.0) > 0,
                      pmgrid=kw.pop("pmgrid", 0))
        return instance_name(instance_flags(
            t_build_wiring(cfg), want_pot=False,
            treepm_asmth=cfg.asmth * cfg.box_size / cfg.pmgrid
            if cfg.pmgrid else 0.0, **kw))
    assert name("newton_yukawa", 2) == "K1b"
    assert name("bam", 2, accumulator=True) == "K1b+count"
    assert name("bam", 2) == "K1b"
    assert name("newton", 2, box_size=50.0) == "K1c"
    assert name("newton", 1, box_size=50.0) == "K1c"
    assert name("three_species", 3, box_size=50.0, pmgrid=16) == "K1bcd"
    # the accumulator row needs a law that reads it: not Newton alone
    assert name("newton", 2, accumulator=True) == "K1a"


def _bam_probe(k_clump=16, seed=4):
    """Eight BAM targets (gravity 1) near (1, 1, 1), spread 0.3, and a
    clump of `k_clump` BAM sources at 8 (spread 1e-4); every mass 2."""
    rng = np.random.default_rng(seed)
    tgt = (1.0 + rng.normal(0, 0.3, (8, 3))).astype(np.float32)
    src = (8.0 + rng.normal(0, 1e-4, (k_clump, 3))).astype(np.float32)
    pos = np.concatenate([tgt, src])
    n = len(pos)
    return (pos, np.full(n, 2.0, np.float32), np.ones(n, np.int32),
            np.full(n, 0.05, np.float32), np.ones(n, np.float32))


PROBE_KW = dict(depth=4, bucket=2, group_size=8, batch_blocks=4,
                chunk_cap=64, frontier_cap=512, theta=0.7, opening="bh",
                leaf_factor=4.0, want_pot=False)


def test_accumulator_acts_in_the_fused_walk():
    pos, mass, grav, fsoft, aold = _bam_probe()
    errs = {}
    for acc in (True, False):
        jw, tw = _wirings("bam", 2, acc)
        j, t = _same_tree(pos, mass, grav, fsoft, aold, 2, 4, 2)
        order = t.order.numpy()
        slots = np.sort(np.nonzero(order < 8)[0]).astype(np.int32)
        jr, tr = _both_walks(jw, tw, 2, j, t, slots, **PROBE_KW)
        _assert_walks_equal(jr, tr)
        # the 16 clump members come as one node: 7 targets and the node
        assert np.all(tr.ninteract.numpy() == 8)
        got = tr.acc.numpy()
        want, _ = direct_forces(tw, torch.as_tensor(pos),
                                torch.as_tensor(mass), torch.as_tensor(grav),
                                torch.as_tensor(fsoft),
                                tgt_idx=torch.as_tensor(order[slots]),
                                want_pot=False)
        want = want.numpy()
        errs[acc] = np.linalg.norm(got - want, axis=1) \
            / np.linalg.norm(want, axis=1)
    on, off = errs[True], errs[False]
    assert on.max() < 1e-4, on
    assert np.all(off > on), (on, off)
    assert off.mean() >= 10 * on.mean(), (on, off)


def test_fused_walk_equals_two_phase_walk_on_the_jax_probe():
    """tests/test_tree.py:244's probe: one baryon target, 16 co-located BAM
    sources.  The fused walk's block holds the clump, so it opens it
    (`ninteract` 16); JAX's two-phase walk takes it as one node; with the
    accumulator both give the exact sum."""
    k = 16
    rng = np.random.default_rng(4)
    src = 8.0 + rng.normal(0, 1e-4, (k, 3)).astype(np.float32)
    pos = np.concatenate([np.array([[1.0, 1.0, 1.0]], np.float32), src])
    n = k + 1
    mass = np.full(n, 2.0, np.float32)
    grav = np.concatenate([[0], np.ones(k)]).astype(np.int32)
    fsoft = np.full(n, 0.05, np.float32)
    jw, tw = _wirings("bam", 2, True, softening=(0.05,) * 6)
    j, t = _same_tree(pos, mass, grav, fsoft, np.ones(n, np.float32), 2, 4,
                      2)
    slot = int(np.nonzero(np.asarray(j.order) == 0)[0][0])
    two_phase = jtree.make_tree_forces(
        jw, n_gravs=2, group_size=8, node_list_cap=256, leaf_list_cap=256,
        bucket=2, depth=4, theta=0.7, opening="bh", block_batch=1,
        use_pallas=False)
    jr = two_phase.static(j, jnp.asarray([slot], jnp.int32), fcap=4096)
    assert int(np.asarray(jr.ninteract)[0]) == 1
    tr = twalk.make_fused_walk(tw, 2, **PROBE_KW)(
        t, torch.as_tensor([slot], dtype=torch.int32))
    assert not bool(tr.overflow) and int(tr.ninteract[0]) == k
    ja, ta = np.asarray(jr.acc)[0], tr.acc.numpy()[0]
    assert np.linalg.norm(ta - ja) <= 1e-5 * np.linalg.norm(ja)


# --------------------------------------------------------------------------
# five Simulation steps of each package from the same particles
# --------------------------------------------------------------------------

def _two_plummers(n, seed):
    """tests/test_torch_slice.py's two Plummer spheres on a collision
    orbit, 30 % of the particles type 2 (gravity 1); no gas."""
    return test_torch_slice._two_plummers(n=n, seed=seed) + (None,)


OPEN_CFG = dict(
    time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
    softening=(0.0, 0.05, 0.02, 0.05, 0.05, 0.05), max_size_timestep=0.01,
    time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
    time_bet_statistics=0.0, n_gravs=2, type_to_grav=(0, 0, 1, 0, 0, 0),
    solver="tree", tree_depth=8, walk_batch_blocks=32)


def _lattice_box(species, n_side=8, box=10000.0, seed=11):
    """tests/test_cosmological.py:_cosmo_box with one jittered lattice a
    species: (ptype, offset in cells, share of the box mass); type 0 is gas
    with u = 1 (km/s)^2.  Omega0 1, so the masses match the cosmology."""
    from ngravs_tpu.units import set_units as j_set_units
    rng = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / n_side * box
    n = len(g)
    units = j_set_units(JConfig(**BOX_CFG))
    m_tot = 3 * units.hubble ** 2 / (8 * math.pi * units.G) * box ** 3
    pos, mass, ptype = [], [], []
    for t, off, share in species:
        pos.append(np.mod(g + rng.normal(0, 0.02 * box / n_side, g.shape)
                          + off * box / n_side, box))
        mass.append(np.full(n, share * m_tot / n))
        ptype.append(np.full(n, t))
    pos = np.concatenate(pos).astype(np.float32)
    vel = rng.normal(0, 1.0, pos.shape).astype(np.float32)
    u = np.where(np.concatenate(ptype) == 0, 1.0, 0.0).astype(np.float32)
    return (pos, vel, np.concatenate(mass).astype(np.float32),
            np.concatenate(ptype).astype(np.int32), u if u.any() else None)


BOX_CFG = dict(
    comoving_integration=True, omega0=1.0, omega_lambda=0.0,
    omega_baryon=0.1, hubble_param=1.0, time_begin=0.1, time_max=0.2,
    periodic=True, box_size=10000.0, softening=(50.0,) * 6,
    max_size_timestep=0.02, err_tol_int_accuracy=0.025, des_num_ngb=33,
    max_num_ngb_deviation=3, tree_depth=6, tree_bucket_size=16,
    tree_group_size=64, walk_batch_blocks=32, time_bet_snapshot=0.0,
    time_of_first_snapshot=1e30, time_bet_statistics=0.0)

RUN_CASES = {
    # BASELINE config 2: Newton within a species, Yukawa across
    "newton_yukawa": (lambda: _two_plummers(n=1200, seed=8),
                      dict(OPEN_CFG, wiring="newton_yukawa")),
    # BAM dark matter (type 2 -> gravity 1) with the accumulator; the
    # geometric criterion, under which BAM targets take nodes (the relative
    # one opens every node for them: their |a_old| is the BAM laws')
    "bam_accumulator": (lambda: _two_plummers(n=1200, seed=8),
                        dict(OPEN_CFG, wiring="bam", ngravs_accumulator=True,
                             type_of_opening_criterion=0)),
    # plain GADGET-2's periodic run: one Newton law, no mesh (Ewald)
    "newton_periodic_tree": (
        lambda: _lattice_box([(1, 0.0, 0.9), (2, 0.5, 0.1)]),
        dict(BOX_CFG, n_gravs=2, type_to_grav=(0, 0, 1, 0, 0, 0),
             wiring="newton", solver="tree", type_of_opening_criterion=0,
             ngravs_en=8)),
    # BASELINE config 5: three species with gas, TreePM
    "three_species_treepm_gas": (
        lambda: _lattice_box([(0, 0.0, 0.1), (1, 0.5, 0.45),
                              (2, 0.25, 0.45)]),
        dict(BOX_CFG, n_gravs=3, type_to_grav=(0, 1, 2, 0, 0, 0),
             wiring="three_species", pmgrid=32, walk_group_size=16)),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_wiring_runs_match_jax(case, tmp_path, monkeypatch):
    monkeypatch.setenv(tlat.CACHE_DIR_ENV, str(tmp_path))
    make, kw = RUN_CASES[case]
    pos, vel, mass, ptype, u = make()
    n = len(pos)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jp = JParticles.create(pos, vel, mass, np.arange(n), ptype,
                           jcfg.type_to_grav)
    jsph = None if u is None else \
        JSph.zeros(n).replace(entropy=jnp.asarray(u))
    js = JSimulation(jcfg, particles=jp, sph=jsph, log_dir="")
    ts = TSimulation(tcfg, particles=particles_from_numpy(_np(jp), "cpu"),
                     sph=None if u is None else sph_from_numpy(
                         _np(jsph, SPH_FIELDS), "cpu"),
                     log_dir="", device="cpu")
    assert not ts.solver.uses_direct(n)
    assert ts.wiring.accumulator == kw.get("ngravs_accumulator", False)
    gas = ptype == 0
    active = []
    for _ in range(5):
        js.step()
        ts.step()
        assert ts.ti_current == js.ti_current
        assert (ts.pm_ti_begstep, ts.pm_ti_endstep) == \
            (js.pm_ti_begstep, js.pm_ti_endstep)
        assert ts.num_force_updates == js.num_force_updates
        np.testing.assert_array_equal(ts.p.ti_endstep.numpy(),
                                      np.asarray(js.p.ti_endstep))
        active.append(int((ts.p.ti_begstep == ts.ti_current).sum()))
        jpos = np.asarray(js.p.pos)
        assert np.abs(ts.p.pos.numpy() - jpos).max() \
            <= 1e-5 * np.abs(jpos).max()
        for name in ("entropy", "hsml", "density") if gas.any() else ():
            np.testing.assert_allclose(
                getattr(ts.sph, name).numpy()[gas],
                np.asarray(getattr(js.sph, name))[gas], rtol=1e-4,
                err_msg=name)
        assert _off_bin_edges(ts)
    assert active[0] == n
    if tcfg.pmgrid:
        assert ts.pm_ti_endstep > 0 and bool(ts.p.accel_pm.abs().max() > 0)
    if tcfg.periodic and not tcfg.pmgrid:
        assert ts.solver.lattice_tables is not None
