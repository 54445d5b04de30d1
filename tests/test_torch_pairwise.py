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

