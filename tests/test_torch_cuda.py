"""The port on the card: every K1 instance against its twin, and the walk,
the main path and the comoving TreePM box path on CUDA against the same
code on the CPU; the periodic walk's lattice pass and the tabulated TreePM
evaluation on the card against the CPU; runs on the card that repeat bit
for bit (two force passes, two three-step runs, a resume); segments on
the card: the direct path's bit for bit its single stepping, the tree
path's within the CPU test's tolerance of it, and the table drift equal
to the CPU's; update_full_potential on the open box and on the TreePM
box against the CPU; the bam wiring with the accumulator and the three_species
TreePM box, one force pass each on the card against the CPU; and one rank
over NCCL: the collisionless step against the
single device, the replicated and the LET gas steps against the same
steps on the CPU.

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
from ngravs_tpu_torch.trace import Trace

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
    trace = Trace()
    with trace.span("k1"):
        acc, pot, nia = pairwise_eval(
            {k: v.to(cuda) for k, v in targets.items()}, sp.to(cuda),
            n_src.to(cuda), want_pot)
    torch.cuda.synchronize()
    assert sum(tpw.instance_counts(trace).values()) == 1
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
    trace = Trace()
    with trace.span("k1"):
        a, p, n = pairwise_eval({k: v.to(cuda) for k, v in targets.items()},
                                sp.to(cuda), n_src.to(cuda), want_pot, **kw)
    torch.cuda.synchronize()
    assert tpw.instance_counts(trace) == {name: 1}
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


def _box_sims(devices, ns=8):
    """The comoving TreePM box (2 x ns^3, newton_yukawa, PMGRID 2 ns), one
    Simulation on each of `devices`."""
    import math
    from ngravs_tpu_torch.units import set_units
    rng = np.random.default_rng(19)
    box = 10000.0
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
        periodic=True, box_size=box, pmgrid=2 * ns, softening=(5.0,) * 6,
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
    assert sum(tpw.instance_counts(sims[1].trace).values()) > 0
    assert any(k.startswith("K1bcd")
               for k in tpw.instance_counts(sims[1].trace))


def _potential_on_both(sims, instance, rtol):
    """One step on each device, then update_full_potential: the card's
    potential within `rtol` of the CPU's largest |pot|, `instance` (a K1
    instance with the potential) launched."""
    for s_ in sims:
        s_.step()
    before = tpw.instance_counts(sims[1].trace).get(instance, 0)
    for s_ in sims:
        s_.update_full_potential()
    assert tpw.instance_counts(sims[1].trace).get(instance, 0) > before, \
        tpw.instance_counts(sims[1].trace)
    p0, p1 = sims[0].p.potential, sims[1].p.potential.cpu()
    assert bool(torch.isfinite(p1).all()) and float(p0.abs().max()) > 0
    assert float((p0 - p1).abs().max()) <= rtol * float(p0.abs().max())


def test_open_box_potential_on_cuda_matches_cpu(cuda):
    """update_full_potential on the open box (4,096 particles, two Plummer-
    like clumps, the tree): K1a/pot on the card, within 1e-5 of the CPU's
    largest |pot| (the main path's tolerance)."""
    n = 4096
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
    _potential_on_both(sims, "K1a/pot", 1e-5)


def test_treepm_box_potential_on_cuda_matches_cpu(cuda):
    """update_full_potential on the comoving TreePM box at 2 x 16^3: the
    short-range walk (K1bcd/pot) and PM's potential on the card, within
    1e-4 of the CPU's largest |pot| (accel_pm's tolerance: the FFTs sum in
    other orders)."""
    _potential_on_both(_box_sims(("cpu", cuda), ns=16), "K1bcd/pot", 1e-4)


def test_bam_accumulator_pass_on_cuda_matches_cpu(cuda):
    """chip_smoke's phase 13b configuration at 4,096 particles: the bam
    wiring with the accumulator, a sixth of the particles (type 1) BAM
    dark matter, the geometric criterion, one force pass on the card
    (K1b+count) and on the CPU: each particle's acceleration within 1e-5
    of its own magnitude (a BAM target's is below 1e-3 of a baryon's)."""
    n = 4096
    pos, mass, _ = _clumps(n, seed=5)
    rng = np.random.default_rng(5)
    ptype = np.where(rng.uniform(size=n) < 1 / 6, 1, 2)
    cfg = SimulationConfig(
        gravity_constant_internal=1.0, softening=(0.05,) * 6,
        max_size_timestep=0.01, time_bet_snapshot=0.0,
        time_of_first_snapshot=1e30, time_bet_statistics=0.0, n_gravs=2,
        type_to_grav=(0, 1, 0, 0, 0, 0), wiring="bam",
        ngravs_accumulator=True, solver="tree", tree_depth=9,
        type_of_opening_criterion=0)
    sims = [Simulation(cfg, particles=Particles.create(
        pos, np.zeros_like(pos), mass * 50 / n, np.arange(n), ptype,
        cfg.type_to_grav, device=d), log_dir="") for d in ("cpu", cuda)]
    for s_ in sims:
        s_.compute_forces()
    assert tpw.instance_counts(sims[1].trace).get("K1b+count", 0) > 0
    a0, a1 = sims[0].p.accel, sims[1].p.accel.cpu()
    bam = sims[0].p.grav == 1
    assert bool(bam.any()) and float(a0[bam].norm(dim=1).max()) \
        < 1e-3 * float(a0[~bam].norm(dim=1).median())
    assert bool((torch.linalg.norm(a1 - a0, dim=1)
                 <= 1e-5 * torch.linalg.norm(a0, dim=1)).all())


def test_three_species_treepm_pass_on_cuda_matches_cpu(cuda):
    """chip_smoke's phase 13d law matrix at 3 x 16^3: three jittered
    lattices (types 1-3 -> gravities 0-2), the three_species wiring, TreePM
    at PMGRID 64; one full force pass on the card (K1bcd, nine PM rounds)
    and on the CPU: the short-range accelerations within 1e-5 of their
    largest value, the PM ones within 1e-4 (the FFTs sum in other
    orders)."""
    import math
    from ngravs_tpu_torch.units import set_units
    rng = np.random.default_rng(13)
    ns, box = 16, 10000.0
    g = (np.stack(np.meshgrid(*[np.arange(ns)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / ns * box
    n = len(g)
    pos = np.concatenate([
        np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape) + off * box / ns,
               box) for off in (0.0, 0.5, 0.25)]).astype(np.float32)
    vel = rng.normal(0, 1.0, pos.shape).astype(np.float32)
    ptype = np.repeat([1, 2, 3], n)
    cfg = SimulationConfig(
        comoving_integration=True, omega0=1.0, omega_lambda=0.0,
        omega_baryon=0.1, hubble_param=1.0, time_begin=0.1, time_max=0.2,
        periodic=True, box_size=box, pmgrid=64, softening=(20.0,) * 6,
        max_size_timestep=0.02, n_gravs=3, type_to_grav=(0, 0, 1, 2, 0, 0),
        wiring="three_species", tree_depth=7, tree_bucket_size=16,
        time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
        time_bet_statistics=0.0)
    u = set_units(cfg)
    m_tot = 3 * u.hubble ** 2 / (8 * math.pi * u.G) * box ** 3
    mass = np.full(3 * n, m_tot / (3 * n))
    sims = [Simulation(cfg, particles=Particles.create(
        pos, vel, mass, np.arange(3 * n), ptype, cfg.type_to_grav,
        device=d), log_dir="") for d in ("cpu", cuda)]
    assert len(sims[1].wiring.unique_laws()) == 3
    for s_ in sims:
        s_.compute_forces(full=True)
    assert any(v > 0 for k, v in tpw.instance_counts(sims[1].trace).items()
               if k.startswith("K1bcd"))
    for name, rtol in (("accel", 1e-5), ("accel_pm", 1e-4)):
        a0 = getattr(sims[0].p, name)
        a1 = getattr(sims[1].p, name).cpu()
        assert float(a0.abs().max()) > 0
        assert float((a0 - a1).abs().max()) <= rtol * float(a0.abs().max())


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
    assert sims[1].trace.prefixed("sph.") == sims[0].trace.prefixed("sph.")
    assert float(sims[1].sph.max_signal_vel[:n].min()) > 0


def test_gas_box_steps_on_cuda_match_cpu(cuda):
    sims, n = _gas_box_sims(cuda)
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
    assert any(v > 0 for k, v in tpw.instance_counts(sims[1].trace).items()
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
    assert b.trace.counts["segment.steps"] > 0
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


def test_distributed_gas_steps_over_nccl_match_cpu(cuda, tmp_path):
    """The replicated and the LET gas step (`parallel/full_sharded.py`,
    `full_let_sharded.py`) on one rank over NCCL on cuda:0 against the same
    steps on one gloo rank on the CPU, from the gas box of `_gas_box_sims`
    (u taken as entropy): the SPH fields within 1e-5 (relative; hydro of
    its largest value), gravity and PM within 1e-5 of their largest |a|,
    the same timesteps."""
    import dataclasses
    import os
    import sys
    from ngravs_tpu_torch.interop import particles_to_numpy
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_ranks as R
    sims, n = _gas_box_sims(cuda)
    sim = sims[0]
    path = str(tmp_path / "gas.npz")
    np.savez(path, **particles_to_numpy(sim.p),
             **{f"s_{k}": v.numpy() for k, v in vars(sim.sph).items()})
    kw = {f.name: getattr(sim.cfg, f.name)
          for f in dataclasses.fields(sim.cfg)}
    outs = [R.run_ranks(R.full_steps, 1, tmp_path, kw, path, ("rep", "let"),
                        backend=b, device=d)[0]
            for b, d in (("gloo", "cpu"), ("nccl", "cuda"))]
    for mode in ("rep", "let"):
        want, got = ({k[len(mode) + 1:]: v for k, v in o.items()
                      if k.startswith(mode + "_")} for o in outs)
        np.testing.assert_array_equal(got["ti_endstep"], want["ti_endstep"])
        for k in ("accel", "pm", "hydro_accel"):
            scale = np.abs(want[k][:n] if k == "hydro_accel"
                           else want[k]).max()
            assert np.abs(got[k] - want[k]).max() <= 1e-5 * scale, (mode, k)
        for k in ("density", "hsml", "pressure", "num_ngb",
                  "max_signal_vel"):
            a, b = want[k][:n], got[k][:n]
            assert (np.abs(a - b) <= 1e-5 * np.abs(a) + 1e-30).all(), \
                (mode, k)


# --------------------------------------------------------------------------
# K1 on the inputs of walk attempts that overflow: rows at the TreePM cut,
# gravities without a slot, every block's list full at the path's plan,
# and every launch of a fresh solver's overflowing first attempts
# --------------------------------------------------------------------------

CUT_ASMTH = 1.25 * BOX / 32


def _r2_roundings(dx, dy, dz):
    """r^2 of f32 offsets rounded once an operation, as the Pallas source
    and the twin write it, and contracted into fused multiply-adds as a
    compiler may (each fma emulated in float64, its product exact)."""
    f32, x = np.float32, lambda a: a.astype(np.float64)
    sq = [(v * v).astype(f32) for v in (dx, dy, dz)]
    xy = (x(dx) * x(dx) + x(sq[1])).astype(f32)
    return dict(per_op=((sq[0] + sq[1]).astype(f32) + sq[2]).astype(f32),
                fma_dz=(x(dz) * x(dz) + x(xy)).astype(f32),
                fma_add=(x(xy) + x(sq[2])).astype(f32))


def _inside_cut(r2, asmth=CUT_ASMTH):
    """u = r / (2 asmth) < 3, in f32 as K1 and the twin compute it."""
    inv2a = np.float32(0.5 / asmth)
    return (np.sqrt(r2).astype(np.float32) * inv2a).astype(np.float32) < 3


def cut_pairs(nb=8, group=8, s=64, seed=0, n_gravs=3):
    """K1bcd-shaped inputs (the periodic box BOX, asmth CUT_ASMTH) whose
    source rows all lie within a few ulps of the TreePM cut u = 3 of their
    block's targets, each at an r^2 that one rounding an operation puts
    on one side of the cut and a fused multiply-add contraction
    (fma(dz, dz, fma(dx, dx, dy^2)) or fma(dx, dx, dy^2) + dz^2) on the
    other.  A block's targets sit at one point.  Returns the targets, the
    sources, n_src (all S) and, per row, whether one rounding an
    operation puts it inside the cut."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    r0 = 3.0 / float(np.float32(0.5 / CUT_ASMTH))
    centre = rng.uniform(0.3 * BOX, 0.7 * BOX, (nb, 3)).astype(f32)
    src = np.zeros((nb, s, 3), f32)
    inside = np.zeros((nb, s), bool)
    for b in range(nb):
        got = 0
        while got < s:
            u = rng.normal(size=(20000, 3))
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            rad = r0 * (1 + rng.uniform(-4e-7, 4e-7, 20000))
            cand = (centre[b] + u * rad[:, None]).astype(f32)
            d = (cand - centre[b]).astype(f32)
            ins = {k: _inside_cut(v) for k, v in
                   _r2_roundings(d[:, 0], d[:, 1], d[:, 2]).items()}
            amb = np.nonzero((ins["per_op"] != ins["fma_dz"])
                             | (ins["per_op"] != ins["fma_add"]))[0]
            take = amb[:s - got]
            src[b, got:got + len(take)] = cand[take]
            inside[b, got:got + len(take)] = ins["per_op"][take]
            got += len(take)
    sgid = np.where(rng.uniform(size=(nb, s)) < 0.5, -2,
                    rng.integers(nb * group, 10 * nb * group, (nb, s)))
    sp = np.zeros((nb, 8, s), f32)
    sp[:, 0:3] = src.transpose(0, 2, 1)
    sp[:, FMASS] = rng.uniform(0.5, 2.0, (nb, s))
    sp[:, FSOFT] = 0.1
    sp[:, 5] = 1.0
    sp[:, 6] = rng.integers(0, n_gravs, (nb, s)).astype(np.int32) \
        .view(f32)
    sp[:, IGID] = sgid.astype(np.int32).view(f32)
    col = lambda a, dt=f32: torch.as_tensor(
        np.ascontiguousarray(a, dt).reshape(nb * group, 1))
    rep = lambda k: np.repeat(centre[:, None, k], group, axis=1)
    targets = dict(x=col(rep(0)), y=col(rep(1)), z=col(rep(2)),
                   mass=col(rng.uniform(0.5, 2, (nb, group))),
                   grav=col(rng.integers(0, n_gravs, (nb, group)), np.int32),
                   fsoft=col(np.full((nb, group), 0.1)),
                   gid=col(np.arange(nb * group).reshape(nb, group),
                           np.int32))
    return targets, torch.as_tensor(sp), \
        torch.full((nb, 1), s, dtype=torch.int32), inside


def _one_row_a_block(targets, sp, n_src):
    """Each source row of a launch as a block of its own (the row padded
    to 4 columns with gid -1), with its block's targets: the output of a
    block is then that row's term alone."""
    nb, _, s = sp.shape
    g = targets["x"].shape[0] // nb
    one = torch.zeros(nb * s, 8, 4)
    one[:, :, 0] = sp.permute(0, 2, 1).reshape(nb * s, 8)
    one.view(torch.int32)[:, IGID, 1:] = -1
    tg = {k: v.reshape(nb, 1, g).expand(nb, s, g).reshape(nb * s * g, 1)
          .contiguous() for k, v in targets.items()}
    return tg, one, torch.ones(nb * s, 1, dtype=torch.int32)


def _three_species_kw():
    w = build_wiring(SimulationConfig(
        n_gravs=3, type_to_grav=(0, 0, 1, 2, 0, 0), wiring="three_species",
        box_size=BOX, periodic=True, pmgrid=32))
    return w, dict(wiring=w, box_size=BOX, treepm_asmth=CUT_ASMTH)


@pytest.mark.parametrize("want_pot", [True, False])
def test_k1_puts_cut_rows_on_the_twins_side(cuda, want_pot):
    """Rows within an ulp of the TreePM cut, where a fused multiply-add in
    r^2 changes the side (13d's overflowing attempts met such rows: a
    list cut to far rows makes their terms count): K1bcd and the twin
    agree within 1e-5 of each target's sum of |terms|, and, each row
    alone, take the same rows inside the cut, those that one rounding an
    operation takes."""
    w, kw = _three_species_kw()
    targets, sp, n_src, inside = cut_pairs()
    assert inside.any() and not inside.all()
    dev = lambda t: {k: v.to(cuda) for k, v in t.items()}
    a, p, n = pairwise_eval(dev(targets), sp.to(cuda), n_src.to(cuda),
                            want_pot, **kw)
    at, pt, nt = pairwise_eval_torch(targets, sp, n_src, want_pot, **kw)
    scale = _k1_terms(w, targets, sp, n_src, BOX, CUT_ASMTH, False)
    assert bool(((a.cpu() - at).abs() <= RTOL_TERMS * scale[:, :3]).all())
    if want_pot:
        assert bool(((p.cpu() - pt).abs() <= RTOL_TERMS * scale[:, 3]).all())
    assert torch.equal(n.cpu(), nt)
    tg, one, ns = _one_row_a_block(targets, sp, n_src)
    a1, _, _ = pairwise_eval(dev(tg), one.to(cuda), ns.to(cuda), want_pot,
                             **kw)
    at1, _, _ = pairwise_eval_torch(tg, one, ns, want_pot, **kw)
    hit = lambda x: (x.reshape(sp.shape[0], sp.shape[2], -1, 3) != 0) \
        .any(-1).any(-1)
    assert torch.equal(hit(a1.cpu()), hit(at1))
    assert torch.equal(hit(at1), torch.as_tensor(inside))


def _no_slot_inputs(ng, seed):
    targets, sp, n_src = _inputs(seed=seed)
    rng = np.random.default_rng(seed)
    sgrav = rng.integers(-2, ng + 2, (NB, S)).astype(np.int32)
    tgrav = rng.integers(-2, ng + 2, (NB * G, 1)).astype(np.int32)
    sp[:, 6] = torch.as_tensor(sgrav.view(np.float32))
    sp[:, 5] = torch.as_tensor(rng.integers(1, 9, (NB, S))
                               .astype(np.float32))
    targets["grav"] = torch.as_tensor(tgrav)
    return targets, sp, n_src


@pytest.mark.parametrize("case", ["three_species_periodic_treepm",
                                  "newton_yukawa", "bam_accumulator",
                                  "one_yukawa_law"])
def test_k1_gives_no_law_to_a_gravity_without_a_slot(cuda, case):
    """Target and source gravities outside [0, N_GRAVS): among several
    laws, a pair whose gravities match no slot of the wiring takes no law
    and still counts, as the Pallas kernel's masks do
    (pairwise_pallas.py:135-146); one law takes every pair, as there."""
    if case == "one_yukawa_law":
        y = L.Yukawa(2.0, BOX)
        w = GravityWiring([[y, y], [y, y]])
        ng, periodic, treepm, acc = 2, False, False, False
    else:
        wname, ng, periodic, treepm, acc = K1_CASES[case]
        w = build_wiring(SimulationConfig(
            n_gravs=ng, type_to_grav=(0, 0, min(1, ng - 1), 0, 0, 0),
            wiring=wname, box_size=BOX, periodic=periodic,
            pmgrid=32 if treepm else 0, ngravs_accumulator=acc))
    box = BOX if periodic else 0.0
    asmth = CUT_ASMTH if treepm else 0.0
    kw = dict(wiring=w, box_size=box, treepm_asmth=asmth)
    assert tpw.instance_flags(want_pot=True, **kw) & tpw.F_MULTI
    targets, sp, n_src = _no_slot_inputs(ng, seed=21)
    dev = lambda t: {k: v.to(cuda) for k, v in t.items()}
    a, p, n = (x.cpu() for x in pairwise_eval(
        dev(targets), sp.to(cuda), n_src.to(cuda), True, **kw))
    at, pt, nt = pairwise_eval_torch(targets, sp, n_src, True, **kw)
    one_law = len(w.unique_laws()) == 1
    # the scale's masks: the slots, or for one law every pair
    clamp = lambda t, s_: (t, s_) if not one_law else (
        dict(t, grav=t["grav"].clamp(0, ng - 1)),
        torch.cat([s_[:, :6], s_[:, 6:7].view(torch.int32).clamp(0, ng - 1)
                   .view(torch.float32), s_[:, 7:]], 1))
    scale = _k1_terms(w, *clamp(targets, sp), n_src, box, asmth, acc)
    assert bool(((a - at).abs() <= RTOL_TERMS * scale[:, :3]).all())
    assert bool(((p - pt).abs() <= RTOL_TERMS * scale[:, 3]).all())
    assert torch.equal(n, nt)
    # the same launch with the rows of gravities without a slot padding:
    # the sums do not move, the counts lose exactly those pairs
    sg = sp[:, 6].view(torch.int32)
    off = (sg < 0) | (sg >= ng)
    sp_off = sp.clone()
    sp_off.view(torch.int32)[:, IGID] = torch.where(
        off, -1, sp.view(torch.int32)[:, IGID])
    tg_off = dict(targets)
    a2, _, n2 = (x.cpu() for x in pairwise_eval(
        dev(tg_off), sp_off.to(cuda), n_src.to(cuda), True, **kw))
    tgr = targets["grav"].reshape(NB, G)
    t_off = ((tgr < 0) | (tgr >= ng)).reshape(-1)
    if one_law:
        assert float((a - a2).abs().max()) > 0    # those rows did pull
    else:
        rows_ok = ~t_off[:, None]
        assert bool(((a - a2).abs() <= RTOL_TERMS * scale[:, :3])
                    [rows_ok.expand(-1, 3)].all())
        assert not bool(a[t_off].any()) and not bool(p[t_off].any())
    assert bool((n - n2 >= 0).all()) and int((n - n2).sum()) > 0
    assert bool(n[t_off].sum() > 0)                # and they counted


def test_k1_full_blocks_on_tree_geometry(cuda):
    """The path's own plan (S = 8192, groups of 64: 8 lanes, a cluster of
    4, tiles of 256) with every block's list full, n_src == S, as an
    overflowing attempt hands it over, on a tree's rows (node rows near
    and at the targets, self rows, leaf chunks): a TreePM walk of a
    clumped three-species box with the chunk cap at 1024 and a geometric
    opening of theta 0.1, which asks each block for more.  Every K1bcd
    launch against the twin."""
    rng = np.random.default_rng(8)
    n, box, depth = 16384, BOX, 8
    pos = np.mod(box / 2 + rng.normal(0, 2.0, (n, 3)), box).astype(
        np.float32)
    grav = rng.integers(0, 3, n).astype(np.int32)
    w = build_wiring(SimulationConfig(
        n_gravs=3, type_to_grav=(0, 0, 1, 2, 0, 0), wiring="three_species",
        box_size=box, periodic=True, pmgrid=16))
    asmth = 1.25 * box / 16
    tree = ttree.build_tree(
        torch.as_tensor(pos, device=cuda),
        torch.full((n,), 1.0, device=cuda),
        torch.as_tensor(grav, device=cuda), torch.full((n,), 0.02,
                                                        device=cuda),
        torch.full((n,), 1e-3, device=cuda), depth=depth, n_gravs=3,
        bucket=16, box_size=box)
    launched = []

    def record(targets, sp, n_src, want_pot, **kw):
        launched.append((targets, sp, n_src, want_pot, kw))
        return pairwise_eval(targets, sp, n_src, want_pot, **kw)
    walk = twalk.make_fused_walk(
        w, 3, depth=depth, bucket=16, group_size=64, batch_blocks=128,
        chunk_cap=1024, frontier_cap=8 ** 6, theta=0.1, opening="bh",
        box_size=box, want_pot=False,
        treepm=dict(asmth=asmth, rcut=4.5 * asmth), pair_eval=record)
    res = walk(tree, torch.arange(n, dtype=torch.int32, device=cuda))
    assert bool(res.overflow) and launched
    plan = tpw.launch_plan(64, 8192, tpw.instance_flags(
        w, box, None, asmth, False))
    assert (plan.lanes, plan.cluster, plan.tile) == (8, 4, 256)
    for targets, sp, n_src, want_pot, kw in launched:
        assert sp.shape[2] == 8192
        live = (targets["gid"].reshape(sp.shape[0], 64) >= 0).any(1)
        assert bool((n_src.reshape(-1)[live] == 8192).all())
        a, _, nv = pairwise_eval(targets, sp, n_src, want_pot, **kw)
        at, _, nt = pairwise_eval_torch(targets, sp, n_src, want_pot, **kw)
        scale = _k1_terms(w, targets, sp, n_src, box, asmth, False)
        assert bool(((a - at).abs() <= RTOL_TERMS * scale[:, :3]).all())
        assert torch.equal(nv, nt)


def _smoke():
    """chip_smoke.py, the script beside the tests (its IC writers and its
    every-launch check)."""
    import importlib
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("box", ["three_species_gas", "open"])
def test_fresh_solver_overflowing_attempts_match_twin(cuda, box, tmp_path):
    """A fresh solver's pass after one step, its chunk cap at 64 and its
    frontier caps at 64 a level, so that its first attempts overflow and
    are thrown away: phase 13d's box at 3 x 16^3 (three species with gas,
    PMGRID 32) and slice 1's open box at 12k.  Every K1 launch of every
    attempt against the twin (chip_smoke's check: within 1e-5 of each
    target's sum of |terms|, pair counts equal)."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.ops.solver import GravitySolver
    cs = _smoke()
    if box == "open":
        cfg = read_parameter_file(cs.write_galaxy_collision(
            str(tmp_path), npart=(0, 2000, 4000, 2000, 2000, 2000)),
            direct_crossover=1000, tree_depth=12)
    else:
        cfg = read_parameter_file(
            cs.write_gas_box(str(tmp_path), ns=16, name="three", three=True),
            pmgrid=32, n_gravs=3, wiring="three_species", pm_interlace=True)
    sim = Simulation(cfg, device=cuda)
    sim.run(max_steps=1)
    solver = GravitySolver(sim.cfg, sim.wiring, sim.force_soft, sim.units.G,
                           hubble=sim.units.hubble, device=sim.device)
    solver.fcaps["chunk"] = 64
    solver.fcaps["frontier"] = 64
    launched, attempts = [], []
    with cs.record_attempts(solver, launched, attempts):
        solver.compute(cs.all_active(sim), sim.ti_current, sim.p.n)
    assert cs.overflowing(attempts) > 0 and not attempts[-1][2]
    for launch in launched:
        _, bad, _ = cs.compare_launch(*launch)
        assert not bool(bad.any())
    sim.close()
