"""The port on the card: every K1 instance against its twin, and the walk,
the main path and the comoving TreePM box path on CUDA against the same
code on the CPU; the periodic walk's lattice pass and the tabulated TreePM
evaluation on the card against the CPU; runs on the card that repeat bit
for bit (two force passes, two three-step runs, a resume); and segments on
the card: the direct path's bit for bit its single stepping, the tree
path's within the CPU test's tolerance of it, and the table drift equal
to the CPU's.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes

import numpy as np
import pytest
import torch

from ngravs_tpu_torch.config import SimulationConfig
from ngravs_tpu_torch.constants import TIMEBASE
from ngravs_tpu_torch.integrate.runner import Simulation
from ngravs_tpu_torch.models import laws as L
from ngravs_tpu_torch.models.laws import Newtonian
from ngravs_tpu_torch.models.wiring import GravityWiring, build_wiring
from ngravs_tpu_torch.ops import tree as ttree
from ngravs_tpu_torch.ops import walk as twalk
from ngravs_tpu_torch.ops import pairwise as tpw
from ngravs_tpu_torch.ops.pairwise import (FMASS, FSOFT, IGID, pairwise_eval,
                                           pairwise_eval_torch)
from ngravs_tpu_torch.particles import Particles

pytestmark = pytest.mark.cuda
NB, G, S = 8, 64, 512
RTOL_TERMS = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(seed=0):
    """Walk-shaped inputs: self pairs, node rows (gid -2), padding (-1),
    pairs on both sides of r = h, ragged n_src, garbage past n_src."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-20, 20, (NB, 1, 3))
    tpos = (centre + rng.normal(0, 0.5, (NB, G, 3))).astype(np.float32)
    tgid = np.arange(NB * G, dtype=np.int32).reshape(NB, G)
    tgid[1, -5:] = -1
    sgid = rng.integers(0, NB * G, (NB, S)).astype(np.int32)
    kind = rng.uniform(size=(NB, S))
    sgid[kind < 0.1] = -1
    sgid[(kind >= 0.1) & (kind < 0.3)] = -2
    rows = np.nonzero((kind >= 0.3) & (kind < 0.4))
    sgid[rows] = np.maximum(tgid[rows[0], rng.integers(0, G, rows[0].size)],
                            0)
    n_src = np.array([0, S, 1, 255, 256, 257, 300, 511], np.int32)
    sp = np.zeros((NB, 8, S), np.float32)
    sp[:, 0:3] = (centre + rng.normal(0, 2.0, (NB, S, 3))).transpose(0, 2, 1)
    sp[:, FMASS] = rng.uniform(0.5, 2.0, (NB, S))
    sp[:, FSOFT] = rng.uniform(0.1, 1.0, (NB, S))
    sp[:, 5] = 1.0
    sp[:, IGID] = sgid.view(np.float32)
    sp[:, 0][np.arange(S)[None, :] >= n_src[:, None]] = np.nan
    col = lambda a, dt=np.float32: torch.as_tensor(
        np.ascontiguousarray(a, dt).reshape(NB * G, 1))
    targets = dict(x=col(tpos[..., 0]), y=col(tpos[..., 1]),
                   z=col(tpos[..., 2]),
                   mass=col(rng.uniform(0.5, 2, (NB, G))),
                   grav=col(np.zeros((NB, G)), np.int32),
                   fsoft=col(rng.uniform(0.1, 1.0, (NB, G))),
                   gid=col(tgid, np.int32))
    return targets, torch.as_tensor(sp), torch.as_tensor(n_src.reshape(NB, 1))


def _term_scales(targets, sp, n_src):
    """Per target: sums over valid pairs of |fac*d| per axis and |pot|."""
    law = Newtonian()
    col = lambda k: targets[k].reshape(NB, G, 1)
    live = torch.arange(S)[None, None, :] < n_src.reshape(NB, 1, 1)
    sgid = sp[:, IGID].view(torch.int32)[:, None, :]
    valid = live & (sgid != -1) & (sgid != col("gid")) & (col("gid") >= 0)
    d = [sp[:, None, a] - col(k) for a, k in enumerate("xyz")]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    r = torch.sqrt(r2)
    h = torch.maximum(col("fsoft"), sp[:, None, FSOFT])
    sm = sp[:, None, FMASS]
    fac = law.force_factor(None, sm, r2, r, h, 1)
    pot = law.potential_factor(None, sm, r2, r, h, 1)
    return torch.stack(
        [torch.where(valid, (fac * x).abs(), 0.).sum(-1) for x in d]
        + [torch.where(valid, pot.abs(), 0.).sum(-1)], -1).reshape(NB * G, 4)


@pytest.mark.parametrize("want_pot", [True, False])
def test_kernel_matches_twin(cuda, want_pot):
    targets, sp, n_src = _inputs()
    before = pairwise_eval.launches
    acc, pot, nia = pairwise_eval({k: v.to(cuda) for k, v in targets.items()},
                                  sp.to(cuda), n_src.to(cuda), want_pot)
    torch.cuda.synchronize()
    assert pairwise_eval.launches == before + 1
    acc_t, pot_t, nia_t = pairwise_eval_torch(targets, sp, n_src, want_pot)
    scale = _term_scales(targets, sp, n_src)
    assert bool(((acc.cpu() - acc_t).abs()
                 <= RTOL_TERMS * scale[:, :3]).all())
    if want_pot:
        assert bool(((pot.cpu() - pot_t).abs()
                     <= RTOL_TERMS * scale[:, 3]).all())
    assert torch.equal(nia.cpu(), nia_t)


CUDA_ERROR_INVALID_VALUE = 1


def _entry_point(cuda, group=G, s=S, flags=0, shift=0, table=None, **edit):
    """The C entry point `ngravs_pairwise` called directly on one block of
    `group` targets over `s` source rows (`shift` floats past an aligned
    buffer), with `launch_plan(G, S, flags)`'s plan but for the fields in
    `edit` (shared memory recomputed unless given); its cudaError."""
    plan = tpw.launch_plan(G, S, flags)._replace(**edit)
    if "smem" not in edit:
        rows = 6 + bool(flags & tpw.F_MULTI) + bool(flags & tpw.F_COUNT)
        plan = plan._replace(smem=4 * plan.stages * rows * plan.tile
                             + 20 * plan.lanes * group + 16 * plan.stages)
    cols = [torch.zeros(group, device=cuda,
                        dtype=torch.int32 if k in ("grav", "gid")
                        else torch.float32) for k in tpw._T_DTYPES]
    base = torch.zeros(8 * s + 4, device=cuda)
    sp = base[shift:shift + 8 * s]
    n_src = torch.full((1, 1), s, dtype=torch.int32, device=cuda)
    acc = torch.zeros(group, 3, device=cuda)
    pot = torch.zeros(group, device=cuda)
    nia = torch.zeros(group, dtype=torch.int32, device=cuda)
    err = tpw._library().ngravs_pairwise(
        *(c.data_ptr() for c in cols), sp.data_ptr(), n_src.data_ptr(), 1,
        group, s, flags, table,
        ctypes.byref(tpw._Plan(plan.lanes, plan.cluster, plan.tile,
                               plan.stages, plan.smem)),
        0.0, 0.0, 0.0, acc.data_ptr(), pot.data_ptr(), nia.data_ptr(),
        torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    return err


def test_kernel_reports_a_refused_launch(cuda):
    targets, sp, n_src = _inputs()
    # all NB*G = 512 targets as one block: past the kernel's group bound;
    # the wrapper refuses it before any launch...
    one_block = {k: v.to(cuda) for k, v in targets.items()}
    with pytest.raises(ValueError, match="launch_plan refuses"):
        pairwise_eval(one_block, sp[:1].to(cuda), n_src[1:2].to(cuda))
    # ...and the kernel's entry point, handed it, returns the cudaError
    assert _entry_point(cuda, group=NB * G) == CUDA_ERROR_INVALID_VALUE


@pytest.mark.parametrize("args", [
    dict(group=12), dict(group=0), dict(s=S + 2), dict(shift=1),
    dict(smem=1 << 20), dict(lanes=0), dict(lanes=32), dict(cluster=3),
    dict(cluster=16), dict(tile=126), dict(stages=1), dict(stages=5),
    dict(flags=tpw.F_COUNT), dict(flags=tpw.F_MULTI)],
    ids=lambda a: ",".join(f"{k}={v}" for k, v in a.items()))
def test_kernel_entry_point_refuses(cuda, args):
    """Every launch the C entry point does not take returns
    cudaErrorInvalidValue before any launch; the plan it was derived from
    runs."""
    assert _entry_point(cuda) == 0
    assert _entry_point(cuda, **args) == CUDA_ERROR_INVALID_VALUE


def _clumps(n, seed=1):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.normal(0, 1.0, (n // 2, 3)),
                          rng.normal(4, 0.5, (n - n // 2, 3))]
                         ).astype(np.float32)
    return pos, rng.uniform(0.5, 1.5, n).astype(np.float32), \
        rng.integers(0, 2, n).astype(np.int32)


def test_walk_on_cuda_matches_cpu(cuda):
    n = 6000
    pos, mass, grav = _clumps(n)
    args = [torch.as_tensor(a) for a in (pos, mass, grav)] \
        + [torch.full((n,), 0.05), torch.full((n,), 1e-3)]
    tree = ttree.build_tree(*args, depth=9, n_gravs=2, bucket=32)
    law = Newtonian()
    walk = twalk.make_fused_walk(
        GravityWiring([[law, law], [law, law]]), 2, depth=9, bucket=32,
        chunk_cap=2048, frontier_cap=4096, opening="bh")
    tgt = torch.arange(n, dtype=torch.int32)
    r_cpu = walk(tree, tgt)
    r_gpu = walk(ttree.Octree(*(t.to(cuda) for t in tree)), tgt.to(cuda))
    assert not bool(r_cpu.overflow) and not bool(r_gpu.overflow)
    assert torch.equal(r_gpu.ninteract.cpu(), r_cpu.ninteract)
    amag = torch.linalg.norm(r_cpu.acc, dim=1)
    assert bool((torch.linalg.norm(r_gpu.acc.cpu() - r_cpu.acc, dim=1)
                 <= 1e-5 * amag).all())


def test_main_path_on_cuda_matches_cpu(cuda):
    n = 4000
    pos, mass, _ = _clumps(n, seed=3)
    rng = np.random.default_rng(3)
    vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    ptype = np.where(rng.uniform(size=n) < 0.3, 2, 1)
    cfg = SimulationConfig(
        gravity_constant_internal=1.0, softening=(0.0,) + (0.05,) * 5,
        max_size_timestep=0.01, time_bet_snapshot=0.0,
        time_of_first_snapshot=1e30, time_bet_statistics=0.0, n_gravs=2,
        type_to_grav=(0, 0, 1, 0, 0, 0), solver="tree", tree_depth=9)
    sims = [Simulation(cfg, particles=Particles.create(
        pos, vel, mass * 50 / n, np.arange(n), ptype, cfg.type_to_grav,
        device=d), log_dir="") for d in ("cpu", cuda)]
    for _ in range(4):
        for s in sims:
            s.step()
        assert sims[0].ti_current == sims[1].ti_current
        p0, p1 = sims[0].p.pos, sims[1].p.pos.cpu()
        assert float((p0 - p1).abs().max()) <= 1e-5 * float(p0.abs().max())
    assert torch.equal(sims[0].p.ti_endstep, sims[1].p.ti_endstep.cpu())


BOX = 60.0
K1_CASES = {
    # name: (wiring, n_gravs, periodic, treepm, accumulator)
    "newton_periodic": ("newton", 1, True, False, False),           # K1c
    "newton_periodic_treepm": ("newton", 1, True, True, False),     # K1cd
    "newton_yukawa": ("newton_yukawa", 2, False, False, False),
    "newton_yukawa_periodic_treepm": ("newton_yukawa", 2, True, True, False),
    "three_species_periodic_treepm": ("three_species", 3, True, True, False),
    "coloyuk_periodic": ("coloyuk", 2, True, False, False),
    "bam_accumulator": ("bam", 2, False, False, True),
}


def _k1_terms(wiring, targets, sp, n_src, box, asmth, use_count):
    """Per target: sums over valid pairs of |fac*d| per axis and |pot|."""
    nb, _, s = sp.shape
    g = targets["x"].shape[0] // nb
    col = lambda k: targets[k].reshape(nb, g, 1)
    live = torch.arange(s, device=sp.device)[None, None, :] \
        < n_src.reshape(nb, 1, 1)
    sgid = sp[:, IGID].view(torch.int32)[:, None, :]
    valid = live & (sgid != -1) & (sgid != col("gid")) & (col("gid") >= 0)
    d = [sp[:, None, a] - col(k) for a, k in enumerate("xyz")]
    if box:
        d = [x - box * torch.round(x * (1.0 / box)) for x in d]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    r = torch.sqrt(r2)
    h = torch.maximum(col("fsoft"), sp[:, None, FSOFT])
    sg = sp[:, 6].view(torch.int32)[:, None, :]
    fac = torch.zeros_like(r)
    pot = torch.zeros_like(r)
    groups = wiring.unique_laws() if wiring is not None \
        else [(Newtonian(), [(0, 0)])]
    for law, slots in groups:
        mk = torch.zeros_like(valid)
        for i, j in slots:
            mk = mk | ((col("grav") == i) & (sg == j))
        f, p = tpw.law_factors(law, col("mass"), sp[:, None, FMASS], r2, r,
                                h, sp[:, None, 5] if use_count else 1.0,
                                True, 0.5 / asmth if asmth else 0.0)
        fac, pot = torch.where(mk, f, fac), torch.where(mk, p, pot)
    return torch.stack(
        [torch.where(valid, (fac * x).abs(), 0.).sum(-1) for x in d]
        + [torch.where(valid, pot.abs(), 0.).sum(-1)], -1).reshape(nb * g, 4)


@pytest.mark.parametrize("want_pot", [True, False])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_instances_match_twin(cuda, case, want_pot):
    wname, ng, periodic, treepm, acc = K1_CASES[case]
    box = BOX if periodic else 0.0
    cfg = SimulationConfig(n_gravs=ng,
                           type_to_grav=(0, 0, min(1, ng - 1), 0, 0, 0),
                           wiring=wname, box_size=BOX, periodic=periodic,
                           pmgrid=32 if treepm else 0, ngravs_accumulator=acc)
    w = build_wiring(cfg)
    asmth = 1.25 * BOX / 32 if treepm else 0.0
    targets, sp, n_src = _inputs(seed=3)
    rng = np.random.default_rng(4)
    sp[:, 6] = torch.as_tensor(rng.integers(0, ng, (NB, S)).astype(np.int32)
                               .view(np.float32))
    targets["grav"] = torch.as_tensor(
        rng.integers(0, ng, (NB * G, 1)).astype(np.int32))
    if acc:
        sp[:, 5] = torch.as_tensor(rng.integers(1, 9, (NB, S))
                                   .astype(np.float32))
    kw = dict(wiring=w, box_size=box, treepm_asmth=asmth)
    name = tpw.instance_name(tpw.instance_flags(w, box, None, asmth,
                                                want_pot))
    before = pairwise_eval.counts.get(name, 0)
    a, p, n = pairwise_eval({k: v.to(cuda) for k, v in targets.items()},
                            sp.to(cuda), n_src.to(cuda), want_pot, **kw)
    torch.cuda.synchronize()
    assert pairwise_eval.counts[name] == before + 1
    at, pt, nt = pairwise_eval_torch(targets, sp, n_src, want_pot, **kw)
    scale = _k1_terms(w, targets, sp, n_src, box, asmth, acc)
    assert bool(((a.cpu() - at).abs() <= RTOL_TERMS * scale[:, :3]).all())
    if want_pot:
        assert bool(((p.cpu() - pt).abs() <= RTOL_TERMS * scale[:, 3]).all())
    assert torch.equal(n.cpu(), nt)


def test_kernel_refuses_a_law_without_a_kind(cuda):
    class UserLaw(L.Newtonian):
        pass

    w = GravityWiring([[UserLaw(), L.Newtonian()],
                       [L.Newtonian(), UserLaw()]])
    targets, sp, n_src = _inputs()
    with pytest.raises(ValueError, match="no kind"):
        pairwise_eval({k: v.to(cuda) for k, v in targets.items()},
                      sp.to(cuda), n_src.to(cuda), wiring=w)


def _box_sims(devices):
    """The comoving TreePM box (2 x 8^3, newton_yukawa), one Simulation on
    each of `devices`."""
    import math
    from ngravs_tpu_torch.units import set_units
    rng = np.random.default_rng(19)
    ns, box = 8, 10000.0
    g = (np.stack(np.meshgrid(*[np.arange(ns)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / ns * box
    n = len(g)
    pos = np.concatenate([
        np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape), box),
        np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape) + 0.5 * box / ns,
               box)]).astype(np.float32)
    vel = rng.normal(0, 1.0, pos.shape).astype(np.float32)
    ptype = np.repeat([1, 2], n)
    cfg = SimulationConfig(
        comoving_integration=True, omega0=1.0, omega_lambda=0.0,
        omega_baryon=0.1, hubble_param=1.0, time_begin=0.1, time_max=0.2,
        periodic=True, box_size=box, pmgrid=16, softening=(5.0,) * 6,
        max_size_timestep=0.1, n_gravs=2, type_to_grav=(0, 0, 1, 0, 0, 0),
        wiring="newton_yukawa", tree_depth=6, tree_bucket_size=16,
        time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
        time_bet_statistics=0.0)
    u = set_units(cfg)
    m_tot = 3 * u.hubble ** 2 / (8 * math.pi * u.G) * box ** 3
    mass = np.concatenate([np.full(n, 0.9 * m_tot / n),
                           np.full(n, 0.1 * m_tot / n)])
    return [Simulation(cfg, particles=Particles.create(
        pos, vel, mass, np.arange(2 * n), ptype, cfg.type_to_grav,
        device=d), log_dir="") for d in devices]


def test_box_path_on_cuda_matches_cpu(cuda):
    """The comoving TreePM box a few steps on the card and on the CPU: the
    same timeline and PM window, positions within 1e-5 relative, accel_pm
    within 1e-4 of its largest value (the FFTs sum in other orders)."""
    sims = _box_sims(("cpu", cuda))
    before = pairwise_eval.launches
    for _ in range(4):
        for s_ in sims:
            s_.step()
        assert sims[0].ti_current == sims[1].ti_current
        assert sims[0].pm_ti_endstep == sims[1].pm_ti_endstep
        p0, p1 = sims[0].p.pos, sims[1].p.pos.cpu()
        assert float((p0 - p1).abs().max()) <= 1e-5 * float(p0.abs().max())
        a0, a1 = sims[0].p.accel_pm, sims[1].p.accel_pm.cpu()
        assert float((a0 - a1).abs().max()) <= 1e-4 * float(a0.abs().max())
    assert torch.equal(sims[0].p.ti_endstep, sims[1].p.ti_endstep.cpu())
    assert pairwise_eval.launches > before
    assert any(k.startswith("K1bcd") for k in pairwise_eval.counts)


# --------------------------------------------------------------------------
# the kernel's launch shape: lanes per target, a cluster of CTAs per block
# cutting its rows on multiples of 4, a ring of bulk-copied tiles, targets
# sorted by gravity.  The n_src of each block sits on an edge of these
# splits; two more blocks are all padding (targets, then sources).
# --------------------------------------------------------------------------

EDGE_CASES = {"newton": (None, 1, False, False, False), **K1_CASES}


def _edge_case(case, s, group, seed=7):
    """Inputs, wiring keywords and plan of one case: a block per n_src edge
    (0, 1, 3, 4, 5, tile - 1, tile, tile + 1, one not divisible by C * 4,
    S), a block of padding targets and one of padding sources."""
    wname, ng, periodic, treepm, acc = EDGE_CASES[case]
    w = None if wname is None else build_wiring(SimulationConfig(
        n_gravs=ng, type_to_grav=(0, 0, min(1, ng - 1), 0, 0, 0),
        wiring=wname,
        box_size=BOX, periodic=periodic, pmgrid=32 if treepm else 0,
        ngravs_accumulator=acc))
    kw = dict(wiring=w, box_size=BOX if periodic else 0.0,
              treepm_asmth=1.25 * BOX / 32 if treepm else 0.0)
    plan = tpw.launch_plan(group, s, tpw.instance_flags(
        w, kw["box_size"], None, kw["treepm_asmth"], True))
    edges = [0, 1, 3, 4, 5, plan.tile - 1, plan.tile, plan.tile + 1,
             4 * plan.cluster * (s // (8 * plan.cluster)) + 2, s, s, s]
    nb = len(edges)
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-20, 20, (nb, 1, 3))
    tpos = (centre + rng.normal(0, 0.5, (nb, group, 3))).astype(np.float32)
    tgid = np.arange(nb * group, dtype=np.int32).reshape(nb, group)
    tgid[-2] = -1                                     # padding targets
    sgid = rng.integers(0, nb * group, (nb, s)).astype(np.int32)
    kind = rng.uniform(size=(nb, s))
    sgid[kind < 0.1] = -1
    sgid[(kind >= 0.1) & (kind < 0.3)] = -2
    rows = np.nonzero((kind >= 0.3) & (kind < 0.4))
    sgid[rows] = np.maximum(tgid[rows[0], rng.integers(0, group,
                                                       rows[0].size)], 0)
    sgid[-1] = -1                                     # padding sources
    n_src = np.array(edges, np.int32)
    sp = np.zeros((nb, 8, s), np.float32)
    sp[:, 0:3] = (centre + rng.normal(0, 2.0, (nb, s, 3))).transpose(0, 2, 1)
    sp[:, FMASS] = rng.uniform(0.5, 2.0, (nb, s))
    sp[:, FSOFT] = rng.uniform(0.1, 1.0, (nb, s))
    sp[:, 5] = rng.integers(1, 9, (nb, s)) if acc else 1.0
    sp[:, 6] = rng.integers(0, ng, (nb, s)).astype(np.int32).view(np.float32)
    sp[:, IGID] = sgid.view(np.float32)
    sp[:, 0][np.arange(s)[None, :] >= n_src[:, None]] = np.nan
    col = lambda a, dt=np.float32: torch.as_tensor(
        np.ascontiguousarray(a, dt).reshape(nb * group, 1))
    targets = dict(x=col(tpos[..., 0]), y=col(tpos[..., 1]),
                   z=col(tpos[..., 2]),
                   mass=col(rng.uniform(0.5, 2, (nb, group))),
                   grav=col(rng.integers(0, ng, (nb, group)), np.int32),
                   fsoft=col(rng.uniform(0.1, 1.0, (nb, group))),
                   gid=col(tgid, np.int32))
    return targets, torch.as_tensor(sp), \
        torch.as_tensor(n_src.reshape(nb, 1)), kw, plan


def _check_edges(cuda, case, s, group, want_pot):
    targets, sp, n_src, kw, plan = _edge_case(case, s, group)
    tg = {k: v.to(cuda) for k, v in targets.items()}
    spg, nsg = sp.to(cuda), n_src.to(cuda)
    a, p, n = pairwise_eval(tg, spg, nsg, want_pot, **kw)
    at, pt, nt = pairwise_eval_torch(tg, spg, nsg, want_pot, **kw)
    scale = _k1_terms(kw["wiring"], tg, spg, nsg, kw["box_size"],
                      kw["treepm_asmth"], EDGE_CASES[case][4])
    assert bool(((a - at).abs() <= RTOL_TERMS * scale[:, :3]).all())
    if want_pot:
        assert bool(((p - pt).abs() <= RTOL_TERMS * scale[:, 3]).all())
    assert torch.equal(n, nt)
    assert not bool(n.reshape(-1, group)[-2:].any())   # the padding blocks
    assert not bool(a.reshape(-1, group, 3)[-2:].any())
    return plan


@pytest.mark.parametrize("s", [512, 4096])
@pytest.mark.parametrize("want_pot", [True, False])
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_k1_split_edges_match_twin(cuda, case, want_pot, s):
    plan = _check_edges(cuda, case, s, 64, want_pot)
    if s == 4096:                        # the rows really split
        assert plan.cluster > 1 and plan.tile < s // plan.cluster


@pytest.mark.parametrize("case", ["newton", "three_species_periodic_treepm"])
@pytest.mark.parametrize("group", [8, 64, 136, 256])
def test_k1_group_sizes_match_twin(cuda, case, group):
    plan = _check_edges(cuda, case, 4096, group, True)
    # 136 x 2 lanes: the CTA is rounded up to 288 threads
    assert group * plan.lanes <= plan.threads <= tpw.MAX_THREADS


@pytest.mark.parametrize("case", ["newton", "three_species_periodic_treepm",
                                  "bam_accumulator"])
def test_k1_two_launches_bit_identical(cuda, case):
    targets, sp, n_src, kw, _ = _edge_case(case, 4096, 64)
    args = ({k: v.to(cuda) for k, v in targets.items()}, sp.to(cuda),
            n_src.to(cuda), True)
    first = pairwise_eval(*args, **kw)
    second = pairwise_eval(*args, **kw)
    for x, y in zip(first, second):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_kernel_refuses_an_unaligned_source_buffer(cuda):
    targets, sp, n_src = _inputs()
    base = torch.zeros(NB * 8 * S + 1, device=cuda)
    shifted = base[1:].view(NB, 8, S)
    shifted.copy_(sp.to(cuda))
    with pytest.raises(ValueError, match="aligned"):
        pairwise_eval({k: v.to(cuda) for k, v in targets.items()}, shifted,
                      n_src.to(cuda))


# --------------------------------------------------------------------------
# SPH gas: the comoving TreePM + SPH box of tests/test_cosmological.py:20-63
# (2 x 8^3, newton_yukawa) on the card against the CPU
# --------------------------------------------------------------------------

SPH_FIELDS = ("entropy", "density", "hsml", "pressure", "dt_entropy",
              "hydro_accel", "vel_pred", "div_vel", "curl_vel",
              "dhsml_density_factor", "max_signal_vel", "num_ngb")


def _gas_box_sims(cuda):
    """The gas box on the CPU and on the card: type 0 gas (u = 1, gravity
    0) and type 1 dark matter (gravity 1) half a cell off, masses from
    Omega0 with OmegaBaryon of it in gas."""
    import math
    from ngravs_tpu_torch.particles import SphState
    from ngravs_tpu_torch.units import set_units
    rng = np.random.default_rng(11)
    ns, box = 8, 10000.0
    g = (np.stack(np.meshgrid(*[np.arange(ns)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / ns * box
    n = len(g)
    pos = np.concatenate([
        np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape), box),
        np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape) + 0.5 * box / ns,
               box)]).astype(np.float32)
    vel = rng.normal(0, 1.0, pos.shape).astype(np.float32)
    ptype = np.repeat([0, 1], n)
    cfg = SimulationConfig(
        comoving_integration=True, omega0=1.0, omega_lambda=0.0,
        omega_baryon=0.1, hubble_param=1.0, time_begin=0.1, time_max=0.2,
        periodic=True, box_size=box, pmgrid=16, softening=(50.0,) * 6,
        max_size_timestep=0.02, err_tol_int_accuracy=0.025, des_num_ngb=33,
        max_num_ngb_deviation=3, n_gravs=2, type_to_grav=(0, 1, 0, 0, 0, 0),
        wiring="newton_yukawa", tree_depth=6, tree_bucket_size=16,
        tree_group_size=64, walk_batch_blocks=32, time_bet_snapshot=0.0,
        time_of_first_snapshot=1e30, time_bet_statistics=0.0)
    u = set_units(cfg)
    m_tot = 3 * u.hubble ** 2 / (8 * math.pi * u.G) * box ** 3
    mass = np.concatenate([np.full(n, 0.1 * m_tot / n),
                           np.full(n, 0.9 * m_tot / n)])
    sims = []
    for d in ("cpu", cuda):
        sph = SphState.zeros(2 * n, d)
        sph.entropy[:n] = 1.0                 # u; converted at the first pass
        sims.append(Simulation(cfg, particles=Particles.create(
            pos, vel, mass, np.arange(2 * n), ptype, cfg.type_to_grav,
            device=d), sph=sph, log_dir=""))
    return sims, n


def _assert_gas_close(s0, s1, n_gas, rtol):
    """SPH fields of the gas within `rtol` relative (hydro terms within
    `rtol` of their largest value: pair forces cancel)."""
    for name in SPH_FIELDS:
        a = getattr(s0.sph, name)[:n_gas]
        b = getattr(s1.sph, name)[:n_gas].cpu()
        scale = a.abs() if name in ("entropy", "density", "hsml",
                                    "pressure", "num_ngb",
                                    "max_signal_vel") else a.abs().max()
        assert bool(((a - b).abs() <= rtol * scale + 1e-30).all()), name


def test_gas_box_force_pass_on_cuda_matches_cpu(cuda):
    sims, n = _gas_box_sims(cuda)
    for s_ in sims:
        s_.compute_forces(full=True)
    a0, a1 = sims[0].p.accel, sims[1].p.accel.cpu()
    assert float((a0 - a1).abs().max()) <= 1e-5 * float(a0.abs().max())
    _assert_gas_close(*sims, n, 1e-5)
    assert sims[1].hydro.counts == sims[0].hydro.counts
    assert float(sims[1].sph.max_signal_vel[:n].min()) > 0


def test_gas_box_steps_on_cuda_match_cpu(cuda):
    sims, n = _gas_box_sims(cuda)
    before = pairwise_eval.counts.copy()
    for _ in range(3):
        for s_ in sims:
            s_.step()
        assert sims[0].ti_current == sims[1].ti_current
        assert (sims[0].pm_ti_begstep, sims[0].pm_ti_endstep) == \
            (sims[1].pm_ti_begstep, sims[1].pm_ti_endstep)
        assert torch.equal(sims[0].p.ti_endstep, sims[1].p.ti_endstep.cpu())
        p0, p1 = sims[0].p.pos, sims[1].p.pos.cpu()
        assert float((p0 - p1).abs().max()) <= 1e-5 * float(p0.abs().max())
        _assert_gas_close(*sims, n, 1e-4)
    assert any(v > before.get(k, 0) for k, v in pairwise_eval.counts.items()
               if k.startswith("K1bcd"))


# --------------------------------------------------------------------------
# the periodic pure-tree walk's lattice pass and the tabulated TreePM
# evaluation (torch ops over the packed buffer) on the card against the CPU
# --------------------------------------------------------------------------

def _periodic_inputs(n_gravs, seed=3):
    """`_inputs` moved into a box of side BOX, with source and target
    gravities drawn from `n_gravs`; rows past n_src hold NaN."""
    targets, sp, n_src = _inputs(seed)
    rng = np.random.default_rng(seed)
    sp = sp.clone()
    live = torch.arange(S)[None, :] < n_src.reshape(NB, 1)
    for a, k in enumerate("xyz"):
        targets[k] = torch.remainder(targets[k], BOX)
        sp[:, a] = torch.where(live, torch.remainder(sp[:, a], BOX),
                               float("nan"))
    targets["grav"] = torch.as_tensor(
        rng.integers(0, n_gravs, (NB * G, 1)).astype(np.int32))
    sp[:, 6] = torch.as_tensor(rng.integers(0, n_gravs, (NB, S))
                               .astype(np.int32)).view(torch.float32)
    return targets, sp, n_src


def _on(dev, targets, sp, n_src):
    return ({k: v.to(dev) for k, v in targets.items()}, sp.to(dev),
            n_src.to(dev))


def _within_terms(got, want, scale):
    return bool(((got.cpu() - want).abs() <= RTOL_TERMS * scale
                 + 1e-30).all())


def test_lattice_pass_on_cuda_matches_cpu(cuda):
    """acc and pot within 1e-5 of each target's sum of |terms| (the sums
    along S run in other orders on the two devices)."""
    from ngravs_tpu_torch.ops import lattice as tlat
    w = build_wiring(SimulationConfig(
        n_gravs=2, type_to_grav=(0, 0, 1, 0, 0, 0), wiring="newton_yukawa",
        box_size=BOX, periodic=True))
    tabs = tlat.build_lattice_tables(w, 8, BOX, cache=False)
    targets, sp, n_src = _periodic_inputs(2)
    acc, pot = twalk.lattice_pass(targets, sp, n_src, tabs, 2, BOX)
    acc_c, pot_c = twalk.lattice_pass(*_on(cuda, targets, sp, n_src),
                                      tabs.to(cuda), 2, BOX)
    # the terms: each valid pair's mass times its correction
    col, valid, d = twalk._pair_geometry(targets, sp, slice(None), n_src, G,
                                         BOX)
    pidx = col("grav") * 2 + sp[:, 6].view(torch.int32)[:, None, :]
    fc = tlat.lattice_correction(tabs, 2 * 8 / BOX, *d, pidx)
    term = lambda f: torch.where(valid, (sp[:, None, FMASS] * f).abs(),
                                 0.0).sum(-1).reshape(NB * G)
    assert _within_terms(acc_c, acc, torch.stack([term(f) for f in fc[:3]],
                                                 -1))
    assert _within_terms(pot_c, pot, term(fc[3]))
    assert bool(torch.isfinite(acc_c).all()) and float(acc.abs().max()) > 0


@pytest.mark.parametrize("want_pot", [True, False])
def test_tabulated_eval_on_cuda_matches_cpu(cuda, want_pot):
    """The yukawa preset (a NoneLaw diagonal: no closed form): acc and pot
    within 1e-5 of each target's sum of |terms|, pair counts equal."""
    from ngravs_tpu_torch.ops.shortrange import shortrange_tables
    w = build_wiring(SimulationConfig(
        n_gravs=2, type_to_grav=(0, 0, 1, 0, 0, 0), wiring="yukawa",
        box_size=BOX, periodic=True, pmgrid=32))
    ftab, ptab = shortrange_tables(w, ntab=512)
    kw = dict(wiring=w, box_size=BOX, sr_ftab=ftab, sr_ptab=ptab,
              asmth=1.25 * BOX / 32)
    targets, sp, n_src = _periodic_inputs(2, seed=5)
    acc, pot, nia = twalk.tabulated_pair_eval(targets, sp, n_src, want_pot,
                                              **kw)
    kw_c = dict(kw, sr_ftab=ftab.to(cuda), sr_ptab=ptab.to(cuda))
    acc_c, pot_c, nia_c = twalk.tabulated_pair_eval(
        *_on(cuda, targets, sp, n_src), want_pot, **kw_c)
    # the terms: the evaluation one source row at a time, summed as |.|
    one = [twalk.tabulated_pair_eval(
        targets, sp[:, :, k:k + 1].contiguous(),
        (n_src > k).to(torch.int32), want_pot, **kw) for k in range(S)]
    scale_a = sum(o[0].abs() for o in one)
    scale_p = sum(o[1].abs() for o in one)
    assert torch.equal(nia_c.cpu(), nia)
    assert _within_terms(acc_c, acc, scale_a)
    assert _within_terms(pot_c, pot, scale_p)
    assert float(acc.abs().max()) > 0 and int(nia.sum()) > 0


# --------------------------------------------------------------------------
# runs on the card repeat bit for bit: the tree's moments and PM's mass
# assignment are fixed-order sums
# --------------------------------------------------------------------------

def _same(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def test_fixed_order_sums_repeat_and_match_the_cpu(cuda):
    """1M values into 1000 slots: three sums on the card bit-identical and
    equal to the CPU's (the same sort and adds in the same order), and
    within f32 rounding of the plain sum (1e-5 of the sum of |terms|)."""
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(0, 1000, 1 << 20))
    src = torch.as_tensor(rng.normal(0, 1, ((1 << 20), 8)).astype(np.float32))
    want = ttree.fixed_order_index_add(torch.zeros(1000, 8), idx, src)
    got = [ttree.fixed_order_index_add(torch.zeros(1000, 8, device=cuda),
                                       idx.to(cuda), src.to(cuda))
           for _ in range(3)]
    assert _same(got[0], got[1]) and _same(got[0], got[2])
    assert _same(got[0].cpu(), want)
    plain = torch.zeros(1000, 8).index_add_(0, idx, src)
    scale = torch.zeros(1000, 8).index_add_(0, idx, src.abs())
    assert bool(((want - plain).abs() <= 1e-5 * scale).all())


def test_box_runs_on_cuda_are_bit_identical(cuda, tmp_path):
    """Two full force passes (tree build, walk, PM) from one state, two
    three-step runs from one state, and a save and resume: bit-identical."""
    s1, s2 = _box_sims((cuda, cuda))
    for s_ in (s1, s2):
        s_.compute_forces(full=True)
    for f in ("accel", "accel_pm", "old_acc", "grav_cost"):
        assert _same(getattr(s1.p, f), getattr(s2.p, f)), f
    for s_ in (s1, s2):
        s_.run(max_steps=3)
    assert s1.ti_current == s2.ti_current
    for f in ("pos", "vel", "accel", "accel_pm", "ti_endstep"):
        assert _same(getattr(s1.p, f), getattr(s2.p, f)), f
    path = s1.save_restart(str(tmp_path / "restart.npz"))
    (s3,) = _box_sims((cuda,))
    s3.resume(path)
    for s_ in (s1, s3):
        s_.run(max_steps=2)
    assert s1.ti_current == s3.ti_current
    for f in ("pos", "vel", "accel", "accel_pm"):
        assert _same(getattr(s1.p, f), getattr(s3.p, f)), f


def _uniform_system(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 4, (n, 3)).astype(np.float32),
            rng.normal(0, 0.05, (n, 3)).astype(np.float32),
            np.full(n, 1e-3, np.float32))


SEG_CFG = dict(time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
               softening=(0.05,) * 6, max_size_timestep=0.01,
               time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
               time_bet_statistics=0.0, wiring="newton")


def _seg_sims(cuda, kw, n, seed, caps=(1, 16)):
    cfg = SimulationConfig(**kw)
    pos, vel, mass = _uniform_system(n, seed)
    return [Simulation(cfg, particles=Particles.create(
        pos, vel, mass, np.arange(n), np.ones(n, np.int32),
        cfg.type_to_grav, device=cuda), log_dir="", segment_steps=c)
        for c in caps]


def test_direct_segment_on_cuda_is_bit_identical(cuda):
    """tests/test_torch_segments.py::test_direct_segment_is_bit_identical
    on the card."""
    a, b = _seg_sims(cuda, dict(SEG_CFG, solver="direct"), 2048, 0)
    for _ in range(32):
        a.step()
    calls = 0
    while b.step_count < a.step_count:
        b.step()
        calls += 1
    assert b.step_count == a.step_count and b.ti_current == a.ti_current
    assert calls < a.step_count / 2
    for k in ("pos", "vel", "accel", "ti_endstep"):
        assert torch.equal(getattr(a.p, k), getattr(b.p, k)), k


def test_tree_segment_on_cuda_matches_single_stepping(cuda):
    """tests/test_torch_segments.py::test_tree_segment_matches_single_
    stepping on the card: the timeline exact, positions and velocities
    within 2e-3."""
    kw = dict(SEG_CFG, solver="tree", tree_depth=6, err_tol_theta=0.6,
              type_of_opening_criterion=0, time_max=0.05)
    a, b = _seg_sims(cuda, kw, 256, 1)
    for sim in (a, b):
        while sim.ti_current < TIMEBASE and sim.time <= kw["time_max"]:
            sim.step()
    assert b.step_count == a.step_count and b.ti_current == a.ti_current
    assert b.seg_counts["steps"] > 0
    assert torch.equal(a.p.ti_endstep, b.p.ti_endstep)
    assert float((a.p.pos - b.p.pos).abs().max()) <= 2e-3
    assert float((a.p.vel - b.p.vel).abs().max()) <= 2e-3


def test_drift_walk_tables_on_cuda_matches_cpu(cuda):
    n = 6000
    pos, mass, grav = _clumps(n)
    vel = np.random.default_rng(8).normal(0, 0.1, (n, 3)).astype(np.float32)
    args = [torch.as_tensor(a) for a in (pos, mass, grav)] \
        + [torch.full((n,), 0.05), torch.full((n,), 1e-3)]
    tree = ttree.build_tree(*args, depth=9, n_gravs=2, bucket=32,
                            vel=torch.as_tensor(vel))
    wt = twalk.pack_walk_tables(tree, n, 9, 32, 2, 2.0)
    dd = torch.tensor(0.37)
    cpu = twalk.drift_walk_tables(wt, dd, 2)
    gpu = twalk.drift_walk_tables(
        twalk.WalkTables(*(t.to(cuda) for t in wt)), dd.to(cuda), 2)
    for name in ("gsrc", "wtab8"):
        assert torch.equal(getattr(gpu, name).cpu().view(torch.int32),
                           getattr(cpu, name).view(torch.int32)), name


def test_distributed_one_rank_over_nccl_matches_single_device(cuda,
                                                             tmp_path):
    """A 1-rank `DistributedSimulation` over NCCL on cuda:0 (the replicated
    step, its padding rows at the origin inside the halo) against the
    single-device `Simulation` on the same card, one step: the same sync
    point, accelerations within rms 5e-3 of each other, K1 launched by the
    rank."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_ranks as R
    kw = dict(time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
              softening=(0.02,) * 6, max_size_timestep=0.02, n_gravs=1,
              type_to_grav=(0,) * 6, wiring="newton", solver="tree",
              type_of_opening_criterion=0, err_tol_int_accuracy=0.02)
    rng = np.random.default_rng(13)
    n = 8192
    r = 0.05 + 3.0 * rng.random(n) ** 3
    u = rng.normal(size=(n, 3))
    pos = r[:, None] * u / np.linalg.norm(u, axis=1, keepdims=True)
    vel = rng.normal(0, 0.05, (n, 3))
    path = str(tmp_path / "in.npz")
    np.savez(path, pos=pos, vel=vel, mass=np.full(n, 1.0 / n),
             pid=np.arange(n), ptype=np.ones(n, np.int32))
    o = R.run_ranks(R.simulate, 1, tmp_path, kw, path, dict(steps=1),
                    backend="nccl", device="cuda")[0]
    sim = Simulation(SimulationConfig(**kw), particles=Particles.create(
        pos, vel, np.full(n, 1.0 / n), np.arange(n), np.ones(n), kw[
            "type_to_grav"], device=cuda), log_dir="")
    sim.step()
    assert o["syncs"][0, 0] == sim.ti_current
    a = sim.p.accel.cpu().numpy()
    rel = np.linalg.norm(o["accel"] - a, axis=1) \
        / np.maximum(np.linalg.norm(a, axis=1), 1e-12)
    assert np.sqrt(np.mean(rel ** 2)) < 5e-3
    assert int(o["k1"]) > 0
