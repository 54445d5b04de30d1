"""The port on the card: every K1 instance against its twin, and the walk,
the main path and the comoving TreePM box path on CUDA against the same
code on the CPU.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ngravs_tpu_torch.config import SimulationConfig
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


def test_kernel_reports_a_refused_launch(cuda):
    targets, sp, n_src = _inputs()
    # all NB*G = 512 targets as one block: past the kernel's launch bound
    one_block = {k: v.to(cuda) for k, v in targets.items()}
    with pytest.raises(RuntimeError, match="cudaError"):
        pairwise_eval(one_block, sp[:1].to(cuda), n_src[1:2].to(cuda))


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
    "newton_yukawa": ("newton_yukawa", 2, False, False, False),
    "newton_yukawa_periodic_treepm": ("newton_yukawa", 2, True, True, False),
    "three_species_periodic_treepm": ("three_species", 3, True, True, False),
    "coloyuk_periodic": ("coloyuk", 2, True, False, False),
    "bam_accumulator": ("bam", 2, False, False, True),
}


def _k1_terms(wiring, targets, sp, n_src, box, asmth, use_count):
    """Per target: sums over valid pairs of |fac*d| per axis and |pot|."""
    col = lambda k: targets[k].reshape(NB, G, 1)
    live = torch.arange(S)[None, None, :] < n_src.reshape(NB, 1, 1)
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
    for law, slots in wiring.unique_laws():
        mk = torch.zeros_like(valid)
        for i, j in slots:
            mk = mk | ((col("grav") == i) & (sg == j))
        f, p = tpw.law_factors(law, col("mass"), sp[:, None, FMASS], r2, r,
                                h, sp[:, None, 5] if use_count else 1.0,
                                True, 0.5 / asmth if asmth else 0.0)
        fac, pot = torch.where(mk, f, fac), torch.where(mk, p, pot)
    return torch.stack(
        [torch.where(valid, (fac * x).abs(), 0.).sum(-1) for x in d]
        + [torch.where(valid, pot.abs(), 0.).sum(-1)], -1).reshape(NB * G, 4)


@pytest.mark.parametrize("want_pot", [True, False])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_instances_match_twin(cuda, case, want_pot):
    wname, ng, periodic, treepm, acc = K1_CASES[case]
    box = BOX if periodic else 0.0
    cfg = SimulationConfig(n_gravs=ng, type_to_grav=(0, 0, 1, 0, 0, 0),
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


def test_box_path_on_cuda_matches_cpu(cuda):
    """The comoving TreePM box (2 x 8^3, newton_yukawa) a few steps on the
    card and on the CPU: the same timeline and PM window, positions within
    1e-5 relative, accel_pm within 1e-4 of its largest value (the card's
    scatter-add is atomic)."""
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
    sims = [Simulation(cfg, particles=Particles.create(
        pos, vel, mass, np.arange(2 * n), ptype, cfg.type_to_grav,
        device=d), log_dir="") for d in ("cpu", cuda)]
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
