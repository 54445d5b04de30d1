"""K1a: the port's pair evaluation against the JAX package's Pallas kernel.

On the CPU `pairwise_eval` takes its plain twin `pairwise_eval_torch`; it is
held against `make_pairwise_kernel(..., interpret=True)` (as
tests/test_pallas_kernel.py runs it) with the stock 2-gravity wiring, over
ragged per-block source counts (0, partial, full), padding (gid -1) and
node (gid -2) rows, self pairs, and pairs inside and outside the softening
length.  acc and pot agree within 1e-5 of each target's sum of |terms|
(the two sum in different orders); pair counts agree exactly.  The CUDA
kernel itself is held against the twin in tests/test_torch_cuda.py and by
chip_smoke.py, on the card.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ngravs_tpu.models import laws as jlaws
from ngravs_tpu.models.wiring import GravityWiring as JWiring
from ngravs_tpu.ops.pairwise_pallas import make_pairwise_kernel

from ngravs_tpu_torch.models.laws import Newtonian
from ngravs_tpu_torch.models.wiring import GravityWiring as TWiring
from ngravs_tpu_torch.ops.pairwise import pairwise_eval

NB, G, SCH = 4, 16, 128
S = 2 * SCH
RTOL_TERMS = 1e-5


def _inputs(seed=11, garbage_tail=False):
    """[NB*G] targets and [NB, 8, S] sources; per block n_src = 0, S, a
    partial chunk and a chunk plus one.  Rows past n_src are padding
    (gid -1), as the walk lays them out — or, with `garbage_tail`, live
    rows the port must not read."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-5, 5, (NB, 1, 3))
    tpos = (centre + rng.normal(0, 0.3, (NB, G, 3))).astype(np.float32)
    tgid = np.arange(NB * G, dtype=np.int32).reshape(NB, G)
    tgid[2, -3:] = -1                         # padding targets
    spos = (centre + rng.normal(0, 1.0, (NB, S, 3))).astype(np.float32)
    sgid = rng.integers(0, NB * G, (NB, S)).astype(np.int32)
    kind = rng.uniform(size=(NB, S))
    sgid[kind < 0.15] = -1
    sgid[(kind >= 0.15) & (kind < 0.35)] = -2
    self_rows = (kind >= 0.35) & (kind < 0.45)
    blk = np.nonzero(self_rows)[0]
    sgid[self_rows] = np.maximum(tgid[blk, rng.integers(0, G, blk.size)], 0)
    n_src = np.array([0, S, 77, SCH + 1], np.int32)
    tail = np.arange(S)[None, :] >= n_src[:, None]
    if not garbage_tail:
        sgid[tail] = -1
    sp = np.zeros((NB, 8, S), np.float32)
    sp[:, 0:3] = spos.transpose(0, 2, 1)
    sp[:, 3] = rng.uniform(0.5, 2.0, (NB, S))
    sp[:, 4] = rng.uniform(0.05, 0.6, (NB, S))   # r < h and r > h pairs
    sp[:, 5] = 1.0
    sp[:, 6] = rng.integers(0, 2, (NB, S)).astype(np.int32).view(np.float32)
    sp[:, 7] = sgid.view(np.float32)
    tcols = dict(x=tpos[..., 0], y=tpos[..., 1], z=tpos[..., 2],
                 mass=rng.uniform(0.5, 2, (NB, G)).astype(np.float32),
                 grav=rng.integers(0, 2, (NB, G)).astype(np.int32),
                 fsoft=rng.uniform(0.05, 0.6, (NB, G)).astype(np.float32),
                 gid=tgid)
    tcols = {k: np.ascontiguousarray(v).reshape(NB * G, 1)
             for k, v in tcols.items()}
    return tcols, sp, n_src.reshape(NB, 1)


def _torch_inputs(tcols, sp, n_src, device="cpu"):
    return ({k: torch.as_tensor(v, device=device) for k, v in tcols.items()},
            torch.as_tensor(sp, device=device),
            torch.as_tensor(n_src, device=device))


def _term_scales(tcols, sp, n_src):
    """Per target: sums over valid pairs of |fac*d| per axis and |pot|."""
    law = Newtonian()
    out = np.zeros((NB * G, 4))
    for b in range(NB):
        for i in range(G):
            t = b * G + i
            if tcols["gid"][t, 0] < 0:
                continue
            m = np.arange(S) < n_src[b, 0]
            sgid = sp[b, 7].view(np.int32)
            m &= (sgid != -1) & (sgid != tcols["gid"][t, 0])
            d = sp[b, 0:3][:, m] - np.array(
                [tcols["x"][t, 0], tcols["y"][t, 0], tcols["z"][t, 0]])[:, None]
            r2 = torch.as_tensor((d * d).sum(0))
            r = torch.sqrt(r2)
            h = torch.maximum(torch.as_tensor(tcols["fsoft"][t]),
                              torch.as_tensor(sp[b, 4][m]))
            sm = torch.as_tensor(sp[b, 3][m])
            fac = law.force_factor(None, sm, r2, r, h, 1).numpy()
            pot = law.potential_factor(None, sm, r2, r, h, 1).numpy()
            out[t, :3] = np.abs(fac[None, :] * d).sum(1)
            out[t, 3] = np.abs(pot).sum()
    return out


def _check_close(acc, pot, nia, acc_ref, pot_ref, nia_ref, scale, want_pot):
    assert np.all(np.abs(acc - acc_ref) <= RTOL_TERMS * scale[:, :3])
    if want_pot:
        assert np.all(np.abs(pot - pot_ref) <= RTOL_TERMS * scale[:, 3])
    else:
        assert not np.any(pot)
    np.testing.assert_array_equal(nia, nia_ref)


@pytest.mark.parametrize("want_pot", [True, False])
def test_twin_matches_pallas_interpret(want_pot):
    tcols, sp, n_src = _inputs()
    n = jlaws.Newtonian()
    jfn = make_pairwise_kernel(JWiring([[n, n], [n, n]]), 2, group=G,
                               s_chunk=SCH, want_pot=want_pot,
                               interpret=True)
    jacc, jpot, jnia = jfn({k: jnp.asarray(v) for k, v in tcols.items()},
                           jnp.asarray(sp), jnp.asarray(n_src))
    acc, pot, nia = pairwise_eval(*_torch_inputs(tcols, sp, n_src),
                                  want_pot=want_pot)
    scale = _term_scales(tcols, sp, n_src)
    _check_close(acc.numpy(), pot.numpy(), nia.numpy(), np.asarray(jacc),
                 np.asarray(jpot) if want_pot else 0.0, np.asarray(jnia),
                 scale, want_pot)
    # the cases the inputs are meant to cover
    nia = nia.numpy().reshape(NB, G)
    assert not nia[0].any()                       # n_src = 0
    assert not nia[2, -3:].any()                  # padding targets
    assert (nia[1] > 0).all() and (nia[3] > 0).all()


def test_rows_past_n_src_are_not_read():
    tcols, sp, n_src = _inputs()
    _, sp_g, _ = _inputs(garbage_tail=True)
    live = np.arange(S)[None, :] < n_src
    sp_mixed = np.where(live[:, None, :], sp, sp_g)
    sp_mixed[:, 0][~live] = np.nan
    a1 = pairwise_eval(*_torch_inputs(tcols, sp, n_src))
    a2 = pairwise_eval(*_torch_inputs(tcols, sp_mixed, n_src))
    for x, y in zip(a1, a2):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    tcols, sp, n_src = _inputs()
    targets, spt, nst = _torch_inputs(tcols, sp, n_src)
    with pytest.raises(ValueError, match="n_src"):
        pairwise_eval(targets, spt, nst.to(torch.int64))
    with pytest.raises(ValueError, match="gid"):
        pairwise_eval(dict(targets, gid=targets["gid"].float()), spt, nst)
    with pytest.raises(ValueError, match="spacked"):
        pairwise_eval(targets, spt[:, :7], nst)



# --------------------------------------------------------------------------
# K1b (multi-law dispatch, accumulator count row), K1c (periodic minimum
# image), K1d (TreePM closed-form truncation)
# --------------------------------------------------------------------------

from ngravs_tpu.config import SimulationConfig as JConfig
from ngravs_tpu.models.wiring import build_wiring as j_build_wiring

from ngravs_tpu_torch.config import SimulationConfig as TConfig
from ngravs_tpu_torch.models.wiring import build_wiring as t_build_wiring
from ngravs_tpu_torch.ops import pairwise as tpw

BOX = 12.0          # the inputs span about 10: many pairs wrap
PMGRID = 16         # asmth = 1.25 * 12 / 16 = 0.94: pairs on both sides of
                    # the u = 3 cut


def _multi_inputs(n_gravs, count_rows, seed=5):
    tcols, sp, n_src = _inputs(seed)
    rng = np.random.default_rng(seed + 100)
    sp[:, 6] = rng.integers(0, n_gravs, (NB, S)).astype(np.int32) \
        .view(np.float32)
    tcols["grav"] = rng.integers(0, n_gravs, (NB * G, 1)).astype(np.int32)
    if count_rows:
        sp[:, 5] = rng.integers(1, 9, (NB, S)).astype(np.float32)
    return tcols, sp, n_src


def _multi_scales(wiring, tcols, sp, n_src, box, asmth, use_count):
    """Per target: sums over valid pairs of |fac*d| per axis and |pot|,
    from the port's own per-pair law factors."""
    tt, st, nt = _torch_inputs(tcols, sp, n_src)
    col = lambda k: tt[k].reshape(NB, G, 1)
    sgid = st[:, 7].view(torch.int32)[:, None, :]
    live = torch.arange(S)[None, None, :] < nt.reshape(NB, 1, 1)
    valid = live & (sgid != -1) & (col("gid") >= 0) & (sgid != col("gid"))
    d = [st[:, None, a] - col(k) for a, k in enumerate("xyz")]
    if box:
        d = [x - box * torch.round(x * (1.0 / box)) for x in d]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    r = torch.sqrt(r2)
    h = torch.maximum(col("fsoft"), st[:, None, 4])
    sg = st[:, 6].view(torch.int32)[:, None, :]
    n = st[:, None, 5] if use_count else 1.0
    fac = torch.zeros_like(r)
    pot = torch.zeros_like(r)
    for law, slots in wiring.unique_laws():
        mk = torch.zeros_like(valid)
        for i, j in slots:
            mk = mk | ((col("grav") == i) & (sg == j))
        f, p = tpw.law_factors(law, col("mass"), st[:, None, 3], r2, r, h,
                                n, True, 0.5 / asmth if asmth else 0.0)
        fac, pot = torch.where(mk, f, fac), torch.where(mk, p, pot)
    return torch.stack(
        [torch.where(valid, (fac * x).abs(), 0.).sum(-1) for x in d]
        + [torch.where(valid, pot.abs(), 0.).sum(-1)], -1) \
        .reshape(NB * G, 4).numpy()


K1_CASES = {
    # name: (wiring, n_gravs, periodic, treepm, accumulator)
    "newton_yukawa": ("newton_yukawa", 2, False, False, False),
    "newton_yukawa_periodic": ("newton_yukawa", 2, True, False, False),
    "newton_yukawa_periodic_treepm": ("newton_yukawa", 2, True, True, False),
    "three_species_periodic_treepm": ("three_species", 3, True, True, False),
    "bam_accumulator": ("bam", 2, False, False, True),
}


@pytest.mark.parametrize("want_pot", [True, False])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_parts_match_pallas_interpret(case, want_pot):
    wname, ng, periodic, treepm, acc = K1_CASES[case]
    box = BOX if periodic else 0.0
    kw = dict(n_gravs=ng, type_to_grav=(0, 0, 1, 0, 0, 0), wiring=wname,
              box_size=BOX, periodic=periodic,
              pmgrid=PMGRID if treepm else 0, ngravs_accumulator=acc)
    jw = j_build_wiring(JConfig(**kw))
    tw = t_build_wiring(TConfig(**kw))
    asmth = 1.25 * BOX / PMGRID if treepm else 0.0
    tcols, sp, n_src = _multi_inputs(ng, acc)
    jfn = make_pairwise_kernel(jw, ng, group=G, s_chunk=SCH, box_size=box,
                               want_pot=want_pot, treepm_asmth=asmth,
                               interpret=True)
    jacc, jpot, jnia = jfn({k: jnp.asarray(v) for k, v in tcols.items()},
                           jnp.asarray(sp), jnp.asarray(n_src))
    acc_t, pot_t, nia_t = pairwise_eval(
        *_torch_inputs(tcols, sp, n_src), want_pot=want_pot, wiring=tw,
        box_size=box, treepm_asmth=asmth)
    scale = _multi_scales(tw, tcols, sp, n_src, box, asmth, acc)
    _check_close(acc_t.numpy(), pot_t.numpy(), nia_t.numpy(),
                 np.asarray(jacc), np.asarray(jpot) if want_pot else 0.0,
                 np.asarray(jnia), scale, want_pot)
    assert np.abs(np.asarray(jacc)).max() > 0
    # the instance the kernel would run for this configuration
    flags = tpw.instance_flags(tw, box, None, asmth, want_pot)
    assert bool(flags & tpw.F_MULTI) and \
        bool(flags & tpw.F_PERIODIC) == periodic and \
        bool(flags & tpw.F_TREEPM) == treepm and \
        bool(flags & tpw.F_COUNT) == acc


def test_law_table_and_instances():
    """The kernel's view of a wiring: one law index per gravity slot, the
    law groups' kinds; K1a for the single Newton law; a law without a kernel
    kind refused."""
    tw = t_build_wiring(TConfig(n_gravs=3, wiring="three_species",
                                box_size=BOX, periodic=True, pmgrid=PMGRID))
    tab = tpw.law_table(tw)
    assert tab.n_gravs == 3 and tab.n_laws == 3
    assert [tab.slot[k] for k in range(9)] == \
        list(tw.pair_index_matrix().reshape(-1))
    assert [tab.kind[k] for k in range(3)] == [1, 3, 4]
    assert tpw.law_table(tw) is tab                  # cached per wiring
    assert tpw.instance_name(tpw.instance_flags(want_pot=False)) == "K1a"
    newton = t_build_wiring(TConfig(n_gravs=2))
    assert tpw.instance_flags(newton, want_pot=False) == 0
    assert tpw.instance_name(tpw.instance_flags(
        tw, BOX, None, 0.5, True)) == "K1bcd/pot"

    class UserLaw(Newtonian):
        pass

    user = TWiring([[UserLaw()]])
    with pytest.raises(ValueError, match="no kind"):
        tpw.law_table(user)


# --------------------------------------------------------------------------
# the kernel's launch plan (ops/pairwise.py:launch_plan), on the CPU
# --------------------------------------------------------------------------

# every kernel instance: the count row only with the multi-law dispatch
ALL_FLAGS = [f for f in range(32) if f & tpw.F_MULTI or not f & tpw.F_COUNT]


def _rank_cuts(ns, cluster, s_cap):
    """The rows of each CTA of a block's cluster, as csrc/pairwise.cu cuts
    n_src (clamped to S): parts of ceil(ns / C) rounded up to 4 rows."""
    ns = min(max(ns, 0), s_cap)
    part = (-(-ns // cluster) + 3) // 4 * 4
    return [(min(r * part, ns), min(min(r * part, ns) + part, ns))
            for r in range(cluster)]


@pytest.mark.parametrize("s_cap", [512, 4096, 32768])
@pytest.mark.parametrize("group", [8, 64, 136, 256])
def test_launch_plan_invariants(group, s_cap):
    assert len(ALL_FLAGS) == 24
    for flags in ALL_FLAGS:
        p = tpw.launch_plan(group, s_cap, flags)
        assert p.lanes in (1, 2, 4, 8, 16)
        # the most lanes within 512 threads, rounded up to whole warps
        assert group * p.lanes <= 512 < group * 2 * p.lanes or p.lanes == 16
        assert p.threads % 32 == 0
        assert group * p.lanes <= p.threads < group * p.lanes + 32
        assert p.threads <= tpw.MAX_THREADS <= 1024
        assert p.cluster in (1, 2, 4, 8)
        assert p.tile % 4 == 0 and 0 < p.tile <= s_cap
        assert 2 <= p.stages <= 4
        rows = 6 + bool(flags & tpw.F_MULTI) + bool(flags & tpw.F_COUNT)
        assert p.smem == (4 * p.stages * rows * p.tile
                          + 20 * p.lanes * group + 16 * p.stages)
        assert p.smem + tpw.STATIC_SMEM <= 232448
        for ns in (0, 1, 3, 4, 5, p.tile - 1, p.tile, p.tile + 1,
                   4 * p.cluster * (s_cap // (8 * p.cluster)) + 2, s_cap):
            cuts = _rank_cuts(ns, p.cluster, s_cap)
            assert cuts[0][0] == 0 and cuts[-1][1] == min(ns, s_cap)
            assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
            # a CTA with rows starts on a multiple of 4 (an empty one
            # issues no copy)
            assert all(beg % 4 == 0 for beg, end in cuts if end > beg)
            assert all(beg <= end for beg, end in cuts)
            # a ragged tail rounded up to 4 rows stays inside the row
            assert all((end + 3) // 4 * 4 <= s_cap for _, end in cuts)


@pytest.mark.parametrize("group,s_cap", [(512, 4096), (12, 4096),
                                         (0, 4096), (64, 4098)])
def test_launch_plan_refuses(group, s_cap):
    with pytest.raises(ValueError, match="launch_plan refuses"):
        tpw.launch_plan(group, s_cap, 0)


def test_cpu_twin_takes_any_group_and_s():
    """The plan binds the kernel only: on the CPU a group of 12 and an S of
    6 go to the twin."""
    rng = np.random.default_rng(2)
    nb, g, s = 2, 12, 6
    col = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt) \
        .reshape(nb * g, 1)
    targets = dict(x=col(rng.normal(size=nb * g)),
                   y=col(rng.normal(size=nb * g)),
                   z=col(rng.normal(size=nb * g)),
                   mass=col(np.ones(nb * g)),
                   grav=col(np.zeros(nb * g), torch.int32),
                   fsoft=col(np.full(nb * g, 0.1)),
                   gid=col(np.arange(nb * g), torch.int32))
    sp = np.zeros((nb, 8, s), np.float32)
    sp[:, 0:3] = rng.normal(size=(nb, 3, s))
    sp[:, 3] = 1.0
    sp[:, 7] = np.full((nb, s), -2, np.int32).view(np.float32)
    acc, _, nia = pairwise_eval(targets, torch.as_tensor(sp),
                                torch.as_tensor([[s], [3]], dtype=torch.int32))
    assert bool(torch.isfinite(acc).all())
    assert nia.reshape(nb, g)[0].eq(s).all()
    assert nia.reshape(nb, g)[1].eq(3).all()
