"""The port on the card: K1a against its twin, and the walk and the main path
on CUDA against the same code on the CPU.

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
from ngravs_tpu_torch.models.laws import Newtonian
from ngravs_tpu_torch.models.wiring import GravityWiring
from ngravs_tpu_torch.ops import tree as ttree
from ngravs_tpu_torch.ops import walk as twalk
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
