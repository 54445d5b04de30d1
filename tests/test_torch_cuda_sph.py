"""K2 on the card: the SPH density and hydro kernels (`csrc/sph.cu`)
against their plain twins (`ops/sph.py` `density_pass_torch`,
`hydro_pass_torch`) on the CPU, from the same inputs.

The inputs are made from a seed without a tree: particles in clumps (some
across the faces of a periodic box), blocks of G targets in a coarse cell
order with the last block's targets padded with -1, and each block's
candidates (every particle within reach of a target, a few -1 among them)
padded with -1 to S, with n_cand well under S and one block with none.
Boxes: open, cubic periodic, per-axis periodic, periodic on two axes of
three, and TWODIMS (a 2-D kernel on a sheet); the hydro pass with the
limiter on and off and with comoving and physical factors.

Tolerance: a pair's term in the kernel is the twin's bit for bit (both
round each float32 operation on its own, with IEEE division and square
root), so only the order of the sums over candidates differs.  That moves
an output by a few units of float32 rounding of the sum of |terms| of its
target; each output must lie within RTOL_TERMS = 1e-5 of that sum (the
terms from the twin on one candidate column at a time), as in
`chip_smoke.py`; the largest signal velocity, a maximum and not a sum,
within 1e-6 relative.

Every test here needs an NVIDIA GPU and skips without one; the file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sph.py
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from ngravs_tpu_torch.ops import sph as S
from ngravs_tpu_torch.trace import Trace

pytestmark = pytest.mark.cuda
G, N = 64, 3000
RTOL_TERMS = 1e-5
BOXES = {"open": (0.0, 0.0, 0.0), "cubic": (10.0, 10.0, 10.0),
         "per_axis": (12.0, 10.0, 7.0), "two_axes": (10.0, 0.0, 8.0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(box, twodims=False, seed=0):
    """A stand-in tree (sorted positions and masses), target blocks,
    candidates and the per-particle fields of both passes, on the CPU."""
    rng = np.random.default_rng(seed)
    span = np.array([b if b > 0 else 10.0 for b in box])
    centres = rng.uniform(0, 1, (6, 3)) * span
    centres[0] = 0.3           # a clump across the faces of a periodic box
    pos = centres[rng.integers(0, 6, N)] + rng.normal(0, 0.9, (N, 3))
    for a, b in enumerate(box):
        if b > 0:
            pos[:, a] = np.mod(pos[:, a], b)
    if twodims:
        pos[:, 2] = 0.0
    cell = np.floor(pos / 2.5).astype(np.int64)
    order = np.lexsort((cell[:, 2], cell[:, 1], cell[:, 0]))
    pos = pos[order].astype(np.float32)
    f32 = lambda a: np.asarray(a, np.float32)
    hsml = f32(rng.uniform(0.4, 1.2, N))
    fields = dict(
        hsml_all=hsml, rho_all=f32(rng.uniform(0.5, 2.0, N)),
        pres_all=f32(rng.uniform(0.1, 1.0, N)),
        f_all=f32(rng.uniform(0.8, 1.2, N)),
        vel_all=f32(rng.normal(0, 1.0, (N, 3))),
        csnd_all=f32(rng.uniform(0.5, 1.5, N)),
        divv_all=f32(rng.normal(0, 1.0, N)),
        curl_all=f32(rng.uniform(0, 1.0, N)),
        dt_all=f32(np.where(rng.uniform(size=N) < 0.2, 0.0,
                            rng.uniform(1e-3, 1e-2, N))))
    nb = -(-N // G) + 1
    tgt = np.full(nb * G, -1, np.int32)
    tgt[:N] = np.arange(N)
    tgt = tgt.reshape(nb, G)
    tgt[3, ::3] = -1                  # padding inside a block too
    lists = []
    for b in range(nb):
        live = tgt[b][tgt[b] >= 0]
        if b == 5 or live.size == 0:
            lists.append(np.zeros(0, np.int64))    # a block with none
            continue
        d = pos[None, :, :] - pos[live][:, None, :]
        for a, bx in enumerate(box):
            if bx > 0:
                d[..., a] -= bx * np.round(d[..., a] / bx)
        r = np.sqrt((d.astype(np.float64) ** 2).sum(-1)).min(0)
        c = np.nonzero(r < hsml[live].max() + hsml.max())[0]
        c = c[rng.uniform(size=c.size) < 0.9]      # not every neighbour
        c = np.insert(c, rng.integers(0, c.size + 1, 3), -1)
        lists.append(c)
    n_cand = np.array([c.size for c in lists], np.int32)
    s = int(-(-(n_cand.max() + 200) // 128) * 128)
    cand = np.full((nb, s), -1, np.int32)
    for b, c in enumerate(lists):
        cand[b, :c.size] = c
    tree = types.SimpleNamespace(pos_s=torch.as_tensor(pos),
                                 mass_s=torch.as_tensor(
                                     f32(rng.uniform(0.5, 1.5, N))))
    cands = S.SphCandidates(torch.as_tensor(cand), torch.as_tensor(n_cand),
                            torch.tensor(False), torch.tensor(n_cand.max()))
    kernel = S.Kernel.twodims(box[2] or 1.0) if twodims else S.K3D
    return tree, torch.as_tensor(tgt), cands, \
        {k: torch.as_tensor(v) for k, v in fields.items()}, kernel


def _to(dev, tree, tgt, cands, fields):
    return (types.SimpleNamespace(pos_s=tree.pos_s.to(dev),
                                  mass_s=tree.mass_s.to(dev)),
            tgt.to(dev),
            S.SphCandidates(*(t.to(dev) for t in cands)),
            {k: v.to(dev) for k, v in fields.items()})


def _term_sums(fn, tgt, cand):
    """Per target and output, the sum over its candidates of |that pair's
    term|: the twin on one candidate column at a time."""
    nb, s = cand.shape
    outs = fn(tgt.repeat_interleave(s, dim=0),
              S.SphCandidates(cand.reshape(nb * s, 1), None, None, None))
    return [o.reshape(nb, s, *o.shape[1:]).abs().sum(1) for o in outs]


def _density(tree, tgt, cands, fields, box, kernel, twin):
    safe = tgt.clamp(min=0).long()
    h = torch.where(tgt >= 0, fields["hsml_all"][safe], 0.0)
    vel = fields["vel_all"]
    fn = S.density_pass_torch if twin else S.density_pass
    return fn(tree, tgt, h, vel[safe], cands, vel, box_size=box,
              kernel=kernel)


def _hydro(tree, tgt, cands, fields, box, kernel, twin, limiter, facs):
    fn = S.hydro_pass_torch if twin else S.hydro_pass
    return fn(tree, tgt, cands, *fields.values(), *facs, 0.8, box_size=box,
              use_limiter=limiter, kernel=kernel)


def _within(got, want, scales, names, maxed=()):
    for name, g, w, sc in zip(names, got, want, scales):
        err = (g.cpu() - w).abs()
        bound = (1e-6 * w.abs() if name in maxed
                 else RTOL_TERMS * sc + 1e-30)
        assert bool((err <= bound).all()), \
            f"{name}: kernel vs twin off by {float(err.max())}"


CASES = [("open", False), ("cubic", False), ("per_axis", False),
         ("two_axes", False), ("cubic", True)]


@pytest.mark.parametrize("box,twodims", CASES)
def test_density_kernel_matches_twin(cuda, box, twodims):
    tree, tgt, cands, fields, kernel = _inputs(BOXES[box], twodims)
    b = BOXES[box]
    trace = Trace()
    with trace.span("sph"):
        got = _density(*_to(cuda, tree, tgt, cands, fields), b, kernel,
                       twin=False)
    torch.cuda.synchronize()
    assert trace.counts.get("k2.density") == 1
    want = _density(tree, tgt, cands, fields, b, kernel, twin=True)
    safe = tgt.clamp(min=0).long()
    h = torch.where(tgt >= 0, fields["hsml_all"][safe], 0.0)
    vel = fields["vel_all"]
    rep = lambda a: a.repeat_interleave(cands.cand.shape[1], dim=0)
    scales = _term_sums(
        lambda tg, c: S.density_pass_torch(tree, tg, rep(h), rep(vel[safe]),
                                           c, vel, box_size=b,
                                           kernel=kernel),
        tgt, cands.cand)
    _within(got, want, scales, ("rho", "wngb", "dhsml", "divv", "rotv"))
    assert float(want[0].max()) > 0 and float(want[1].max()) > 10
    assert float(got[0][5].abs().max()) == 0.0     # the block with none


@pytest.mark.parametrize("box,twodims,limiter,comoving", [
    ("open", False, True, False), ("cubic", False, False, False),
    ("per_axis", False, True, True), ("two_axes", False, False, True),
    ("cubic", True, True, False)])
def test_hydro_kernel_matches_twin(cuda, box, twodims, limiter, comoving):
    tree, tgt, cands, fields, kernel = _inputs(BOXES[box], twodims, seed=1)
    b = BOXES[box]
    facs = (0.53, 1.7, 2.3) if comoving else (1.0, 1.0, 1.0)
    trace = Trace()
    with trace.span("sph"):
        got = _hydro(*_to(cuda, tree, tgt, cands, fields), b, kernel,
                     False, limiter, facs)
    torch.cuda.synchronize()
    assert trace.counts.get("k2.hydro") == 1
    want = _hydro(tree, tgt, cands, fields, b, kernel, True, limiter, facs)
    scales = _term_sums(
        lambda tg, c: _hydro(tree, tg, c, fields, b, kernel, True, limiter,
                             facs), tgt, cands.cand)
    _within(got, want, scales, ("acc", "dt_entropy", "max_signal_vel"),
            maxed=("max_signal_vel",))
    assert float(want[0].abs().max()) > 0 and float(want[2].max()) > 0
    assert float(want[1].abs().max()) > 0


def test_k2_repeats_bit_for_bit(cuda):
    """Two launches of each kernel on the same inputs give the same bits
    (no atomics), and each counts one launch."""
    tree, tgt, cands, fields, kernel = _inputs(BOXES["cubic"], seed=2)
    args = _to(cuda, tree, tgt, cands, fields)
    trace = Trace()
    with trace.span("sph"):
        runs = [(_density(*args, BOXES["cubic"], kernel, False),
                 _hydro(*args, BOXES["cubic"], kernel, False, True,
                        (0.53, 1.7, 2.3))) for _ in range(2)]
    torch.cuda.synchronize()
    assert trace.prefixed("k2.") == {"density": 2, "hydro": 2}
    for a, b in zip(*runs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_k2_refuses_what_it_does_not_take(cuda):
    tree, tgt, cands, fields, kernel = _inputs(BOXES["open"], seed=3)
    tree, tgt, cands, fields = _to(cuda, tree, tgt, cands, fields)
    with pytest.raises(ValueError):
        S.launch_lanes(300)
    with pytest.raises(ValueError):     # targets as int64
        _density(tree, tgt.long(), cands, fields, BOXES["open"], kernel,
                 False)
    with pytest.raises(ValueError):     # no candidate counts
        _density(tree, tgt, cands._replace(n_cand=None), fields,
                 BOXES["open"], kernel, False)
    with pytest.raises(ValueError):     # a field on the CPU
        _hydro(tree, tgt, cands, dict(fields, rho_all=fields["rho_all"]
                                      .cpu()), BOXES["open"], kernel,
               False, True, (1.0, 1.0, 1.0))
    # the entry point itself: lanes that are not a power of two
    err = S._library().ngravs_sph_density(
        *[None] * 8, tgt.shape[0], G, cands.cand.shape[1], 3,
        ctypes.byref(S.spline_args(kernel)), 0.0, 0.0, 0.0, None,
        torch.cuda.current_stream().cuda_stream)
    assert err == 1                     # cudaErrorInvalidValue
