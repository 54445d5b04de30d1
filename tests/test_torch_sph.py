"""SPH of the port against the JAX package (`ngravs_tpu/ops/sph.py`), on
the CPU at small sizes, with inputs made from a seed.

 * `kernel_wk_dwk` on a u x h grid, within 1e-6 relative.
 * The row-compaction helpers, element for element.
 * `make_sph_gather`, open and periodic, gather and pairs modes, on one
   JAX-built tree: `cand`, `n_cand`, `overflow` and `max_cand` equal.
 * `density_pass` and `hydro_pass` (limiter on and off, comoving factors):
   every output within 1e-5 of each target's sum of |terms| (the terms are
   the pass's own, from one call per candidate column), `max_signal_vel`
   within 1e-6 relative; the block-chunk size changes no bit.
 * `hsml_update` on inputs that reach every branch.
 * `HydroSolver.density` on a jittered gas box: the same number of
   density passes, Hsml, rho and num_ngb within 1e-5 relative.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ngravs_tpu.ops import sph as jsph
from ngravs_tpu.ops import tree as jtree

from ngravs_tpu_torch.interop import octree_from_numpy
from ngravs_tpu_torch.ops import sph as tsph
from ngravs_tpu_torch.ops import tree as ttree

# tiny tensors: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (a parallel run is several times slower else)
torch.set_num_threads(1)

BOX, DEPTH, BUCKET, G = 10.0, 5, 16, 16
T = lambda a: torch.as_tensor(np.asarray(a))


def test_kernel_wk_dwk_matches():
    u = np.linspace(0.0, 1.2, 121, dtype=np.float32)
    h = np.array([0.01, 0.3, 1.0, 7.5], np.float32)
    uu, hh = (a.astype(np.float32) for a in np.meshgrid(u, h))
    hinv = (1.0 / hh).astype(np.float32)
    for k in (jsph.K3D, jsph.Kernel.twodims(4.0)):
        tk = tsph.K3D if k.ndims == 3 else tsph.Kernel.twodims(4.0)
        assert tuple(tk) == tuple(k)
        for want, got in zip(jsph.kernel_wk_dwk(uu, hinv, k),
                             tsph.kernel_wk_dwk(T(uu), T(hinv), tk)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("out_size", [5, 40])
def test_row_compaction_matches(out_size):
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 1000, (7, 33)).astype(np.int32)
    valid = rng.uniform(size=(7, 33)) < 0.5
    valid[0] = False
    valid[1] = True
    for want, got in zip(jtree._compact_rows(jnp.asarray(vals),
                                             jnp.asarray(valid), out_size),
                         ttree._compact_rows(T(vals), T(valid), out_size)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    buf = np.where(np.arange(out_size)[None, :] < 3,
                   rng.integers(0, 9, (7, out_size)), -1).astype(np.int32)
    n_in = np.full(7, 3, np.int32)
    new = np.where(valid, vals, -1).astype(np.int32)
    extra = rng.normal(size=(7, 33)).astype(np.float32)
    buf_b = rng.normal(size=(7, out_size)).astype(np.float32)
    for want, got in zip(
            jtree._append_rows(jnp.asarray(buf), jnp.asarray(n_in),
                               jnp.asarray(new)),
            ttree._append_rows(T(buf), T(n_in), T(new))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for want, got in zip(
            jtree._append_rows2(jnp.asarray(buf), jnp.asarray(n_in),
                                jnp.asarray(new), jnp.asarray(buf_b),
                                jnp.asarray(extra)),
            ttree._append_rows2(T(buf), T(n_in), T(new), T(buf_b),
                                T(extra))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _gas_system(periodic: bool, n=700, seed=5):
    """Gas (hsml > 0) and collisionless particles in clumps, some across
    the box faces when periodic."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, BOX, (4, 3))
    pos = centres[rng.integers(0, 4, n)] + rng.normal(0, 1.2, (n, 3))
    pos = np.mod(pos, BOX) if periodic else pos
    gas = rng.uniform(size=n) < 0.7
    hsml = np.where(gas, rng.uniform(0.3, 0.9, n), 0.0).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    return pos.astype(np.float32), mass, hsml, vel


def _trees(periodic: bool):
    pos, mass, hsml, vel = _gas_system(periodic)
    n = len(pos)
    j = jtree.build_tree(jnp.asarray(pos), jnp.asarray(mass),
                         jnp.zeros(n, jnp.int32), jnp.full(n, 0.1),
                         jnp.zeros(n), jnp.asarray(hsml), depth=DEPTH,
                         n_gravs=1, bucket=BUCKET,
                         box_size=BOX if periodic else 0.0)
    t = octree_from_numpy({f: np.asarray(getattr(j, f)) for f in j._fields},
                          "cpu")
    hs = np.asarray(j.hsml_s)
    tgt = np.nonzero(hs > 0)[0].astype(np.int32)
    tgt = np.concatenate([tgt, np.full((-len(tgt)) % G + G, -1, np.int32)])
    return j, t, tgt.reshape(-1, G), vel


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
def test_sph_gather_matches(periodic, pairs):
    j, t, tgt, _ = _trees(periodic)
    radius = np.where(tgt >= 0, np.asarray(j.hsml_s)[np.maximum(tgt, 0)], 0)
    box = (BOX,) * 3 if periodic else (0.0,) * 3
    overflowed = []
    for cand_cap, frontier_cap in ((1024, 2048), (64, 2048), (1024, 16)):
        kw = dict(depth=DEPTH, bucket=BUCKET, cand_cap=cand_cap,
                  frontier_cap=frontier_cap, box_size=box, group_size=G,
                  pairs=pairs)
        jc = jsph.make_sph_gather(**kw)(j, jnp.asarray(tgt),
                                        jnp.asarray(radius, jnp.float32))
        tc = tsph.make_sph_gather(**kw, block_chunk=3)(
            t, T(tgt), T(radius.astype(np.float32)))
        for name in jc._fields:
            np.testing.assert_array_equal(
                getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                err_msg=f"{name} cap={cand_cap}")
        overflowed.append(bool(tc.overflow))
    # a roomy cap fits; the small candidate and frontier caps overflow
    assert overflowed == [False, True, True]
    assert int(tc.max_cand) > 64


def _pass_inputs(periodic: bool, seed=7):
    """A JAX tree and candidates (pairs mode), and per-particle SPH fields
    in sorted order, for the two passes."""
    j, t, tgt, vel = _trees(periodic)
    box = (BOX,) * 3 if periodic else (0.0,) * 3
    hs = np.asarray(j.hsml_s)
    radius = np.where(tgt >= 0, hs[np.maximum(tgt, 0)], 0).astype(np.float32)
    jc = jsph.make_sph_gather(DEPTH, BUCKET, 1024, box_size=box,
                              group_size=G, pairs=True)(
        j, jnp.asarray(tgt), jnp.asarray(radius))
    assert not bool(jc.overflow)
    tc = tsph.SphCandidates(*(T(x) for x in jc))
    rng = np.random.default_rng(seed)
    n = hs.shape[0]
    f32 = lambda a: np.asarray(a, np.float32)
    fields = dict(
        hsml_all=hs, rho_all=f32(rng.uniform(0.5, 2.0, n)),
        pres_all=f32(rng.uniform(0.1, 1.0, n)),
        f_all=f32(rng.uniform(0.8, 1.2, n)),
        vel_all=f32(np.asarray(vel)[np.asarray(j.order)]),
        csnd_all=f32(rng.uniform(0.5, 1.5, n)),
        divv_all=f32(rng.normal(0, 1.0, n)),
        curl_all=f32(rng.uniform(0, 1.0, n)),
        dt_all=f32(np.where(rng.uniform(size=n) < 0.2, 0.0,
                            rng.uniform(1e-3, 1e-2, n))))
    return j, t, tgt, jc, tc, fields, box


def _kernel_monomials(u, hinv, k=tsph.K3D):
    """W and dW with each cubic-spline polynomial replaced by the sum of its
    monomials' magnitudes, signs kept (dW <= 0): near u = 1 the spline
    (1-u)^2 cancels to far below its terms, and so does a pair's force."""
    hinv3, hinv4 = tsph._hinv_pow(hinv, k)
    lo_wk = hinv3 * (abs(k.c1) + abs(k.c2) * (u + 1) * u * u)
    lo_dwk = hinv4 * u * (abs(k.c3) * u + abs(k.c4))
    hi_wk = hinv3 * abs(k.c5) * (1.0 + u) ** 3
    hi_dwk = hinv4 * abs(k.c6) * (1.0 + u) ** 2
    inside = u < 1.0
    return (torch.where(inside, torch.where(u < 0.5, lo_wk, hi_wk), 0.0),
            -torch.where(inside, torch.where(u < 0.5, lo_dwk, hi_dwk), 0.0))


def _per_pair_abs(fn, tgt, cand, per_target=()):
    """Sum over candidates of |each pair's term| per output: the pass on
    one candidate column at a time (target blocks repeated S times)."""
    nb, s = cand.shape
    rep = lambda a: a.repeat_interleave(s, dim=0)
    outs = fn(rep(tgt), tsph.SphCandidates(cand.reshape(nb * s, 1), None,
                                           None, None),
              *[rep(a) for a in per_target])
    return [o.reshape(nb, s, *o.shape[1:]).abs().sum(1) for o in outs]


# f32 rounding that u = r / h can carry between two programs that compute it
# the same way: r^2 (three products and two sums, possibly fused), its
# square root, the reciprocal of h and the product each round once, so two
# programs' u differ by at most about four units of eps = 2^-23
U_ROUNDING = 4 * 2.0 ** -23


def _kernel_du(u, hinv, k=tsph.K3D):
    """d wk / du and d dwk / du of the cubic spline, in the dtype of u, from
    the same polynomials `kernel_wk_dwk` and `_kernel_monomials` use."""
    hinv3, hinv4 = tsph._hinv_pow(hinv, k)
    omu = 1.0 - u
    lo_wk = hinv3 * k.c2 * (3 * u - 2) * u
    lo_dwk = hinv4 * (2 * k.c3 * u - k.c4)
    hi_wk = -3 * hinv3 * k.c5 * omu * omu
    hi_dwk = -2 * hinv4 * k.c6 * omu
    inside = u < 1.0
    return (torch.where(inside, torch.where(u < 0.5, lo_wk, hi_wk), 0.0),
            torch.where(inside, torch.where(u < 0.5, lo_dwk, hi_dwk), 0.0))


def _density_pair_terms(t, tgt, cand, hsml, vpt, vel_all, box):
    """Per pair [nb, G, S], in f64: the velocity products' magnitudes each
    of div v and curl v adds (|fac dx_a dv_b| summed over the products of
    the output; a single pair's cross product may cancel to far below its
    products), and each output's sensitivity to the rounding of u,
    |d term / du| u U_ROUNDING.  Near the kernel's edge dW/du goes as
    (1 - u)^2, so one pair at u = 0.9987 turns one unit of rounding in u
    into about 2u / (1 - u) = 1.6e3 units of its term."""
    k = tsph.K3D
    valid = (tgt >= 0)[:, :, None] & (cand >= 0)[:, None, :]
    tp = t.pos_s[tgt.clamp(min=0).long()].double()
    sp = t.pos_s[cand.clamp(min=0).long()].double()
    dx = tp[:, :, None, :] - sp[:, None, :, :]
    if box[0] > 0:
        dx = dx - BOX * torch.round(dx / BOX)
    dv = (vpt.double()[:, :, None, :]
          - vel_all.double()[cand.clamp(min=0).long()][:, None, :, :])
    r = torch.linalg.norm(dx, dim=-1)
    hinv = 1.0 / hsml.double().clamp(min=1e-30)[:, :, None]
    u = r * hinv
    _, dwk = tsph.kernel_wk_dwk(u, hinv)
    dwk_du, ddwk_du = _kernel_du(u, hinv)
    live = valid & (u < 1.0)
    m = t.mass_s.double()[cand.clamp(min=0).long()][:, None, :]
    inv_r = torch.where(r > 0, 1.0 / r.clamp(min=1e-30), 0.0)
    fac = (m * dwk * inv_r).abs()
    p = (dx[..., :, None] * dv[..., None, :]).abs()       # |dx_a dv_b|
    div_p = p[..., 0, 0] + p[..., 1, 1] + p[..., 2, 2]
    rot_p = torch.stack([p[..., a, b] + p[..., b, a]
                         for a, b in ((2, 1), (0, 2), (1, 0))], dim=-1)
    hinv3, _ = tsph._hinv_pow(hinv, k)
    grad = (m * ddwk_du * inv_r).abs()
    sens = [(m * dwk_du).abs(), (k.norm * dwk_du / hinv3).abs(),
            (m * (k.ndims * hinv * dwk_du + dwk + u * ddwk_du)).abs(),
            grad * div_p, grad[..., None] * rot_p]
    rnd = u * U_ROUNDING
    zero = lambda a: torch.where(live.reshape(live.shape + (1,) * (
        a.dim() - live.dim())), a, 0.0)
    return dict(div=zero(fac * div_p), rot=zero(fac[..., None] * rot_p),
                sens=[zero(s * (rnd if s.dim() == 3 else rnd[..., None]))
                      for s in sens])


def _density_bounds(terms, pair_abs):
    """Per output: 1e-5 of each target's sum of |terms| (div v and curl v:
    of its velocity products), plus the sum of the pairs' sensitivities to
    the rounding of u."""
    scales = list(pair_abs[:3]) + [terms["div"].sum(2), terms["rot"].sum(2)]
    return [1e-5 * sc + s.sum(2) for sc, s in zip(scales, terms["sens"])]


def _density_misses(want, got, bounds):
    """Names of the outputs outside their bounds."""
    names = ("rho", "wngb", "dhsml", "divv", "rotv")
    return [name for name, w, g, b in zip(names, want, got, bounds)
            if not np.all(np.abs(g.numpy() - np.asarray(w))
                          <= b.numpy() + 1e-30)]


def _density_case(periodic):
    j, t, tgt, jc, tc, fl, box = _pass_inputs(periodic)
    hsml = np.where(tgt >= 0, fl["hsml_all"][np.maximum(tgt, 0)], 0) \
        .astype(np.float32)
    vpt = fl["vel_all"][np.maximum(tgt, 0)]
    want = jsph.density_pass(j, jnp.asarray(tgt), jnp.asarray(hsml),
                             jnp.asarray(vpt), jc,
                             jnp.asarray(fl["vel_all"]), box_size=box)
    vel_all = T(fl["vel_all"])

    def run(tg, cands, h, v, block_chunk=None):
        return tsph.density_pass_torch(t, tg, h, v, cands, vel_all,
                                       box_size=box, block_chunk=block_chunk)

    terms = _density_pair_terms(t, T(tgt), tc.cand, T(hsml), T(vpt),
                                vel_all, box)
    bounds = _density_bounds(terms, _per_pair_abs(run, T(tgt), tc.cand,
                                                  (T(hsml), T(vpt))))
    return want, run, (T(tgt), tc, T(hsml), T(vpt)), terms, bounds


@pytest.mark.parametrize("periodic", [False, True])
def test_density_pass_matches(periodic):
    want, run, args, _, bounds = _density_case(periodic)
    got = run(*args)
    assert _density_misses(want, got, bounds) == []
    assert float(got[0].max()) > 0 and float(got[1].max()) > 10
    for bc in (1, 4):
        again = run(*args, block_chunk=bc)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), bc


def test_density_bound_catches_a_perturbed_pair(monkeypatch):
    """The bound is an error model, not a slack: one pair's dW made 1e-4
    too large (relative) moves div v out of it.  The pair is the one whose
    term stands out most against its target's bound."""
    want, run, args, terms, bounds = _density_case(False)
    ratio = terms["div"] / bounds[3][:, :, None].clamp(min=1e-300)
    b, g, s = np.unravel_index(int(torch.argmax(ratio)), ratio.shape)
    assert float(ratio[b, g, s]) * 1e-4 > 2
    orig = tsph.kernel_wk_dwk

    def perturbed(u, hinv, k=tsph.K3D):
        wk, dwk = orig(u, hinv, k)
        dwk = dwk.clone()
        dwk[b, g, s] *= 1 + 1e-4
        return wk, dwk

    monkeypatch.setattr(tsph, "kernel_wk_dwk", perturbed)
    nb = args[0].shape[0]
    assert "divv" in _density_misses(want, run(*args, block_chunk=nb),
                                     bounds)


@pytest.mark.parametrize("limiter,comoving,periodic", [
    (True, False, False), (False, False, True), (True, True, True)])
def test_hydro_pass_matches(limiter, comoving, periodic, monkeypatch):
    j, t, tgt, jc, tc, fl, box = _pass_inputs(periodic, seed=9)
    facs = (0.53, 1.7, 2.3) if comoving else (1.0, 1.0, 1.0)
    order = np.asarray(j.order)
    orig = np.where(tgt >= 0, order[np.maximum(tgt, 0)], len(order))
    want = jsph.hydro_pass(j, jnp.asarray(tgt), jc,
                           *(jnp.asarray(fl[k]) for k in fl),
                           jnp.asarray(orig), *facs, 0.8, box_size=box,
                           use_limiter=limiter)
    fields = [T(fl[k]) for k in fl]

    def run(tg, cands, block_chunk=None):
        return tsph.hydro_pass_torch(t, tg, cands, *fields, *facs, 0.8,
                                     box_size=box, use_limiter=limiter,
                                     block_chunk=block_chunk)

    got = run(T(tgt), tc)
    # the terms of a pair's force: the kernel gradient's monomials
    with monkeypatch.context() as m:
        m.setattr(tsph, "kernel_wk_dwk", _kernel_monomials)
        acc_s, dent_s, _ = _per_pair_abs(run, T(tgt), tc.cand)
    for w, g, sc in ((want[0], got[0], acc_s), (want[1], got[1], dent_s)):
        w = np.asarray(w)
        assert np.all(np.abs(g.numpy() - w) <= 1e-5 * sc.numpy() + 1e-30)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6)
    assert float(got[0].abs().max()) > 0 and float(got[2].max()) > 0
    assert float(got[1].abs().max()) > 0
    for bc in (1, 5):
        again = run(T(tgt), tc, block_chunk=bc)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), bc


def test_hsml_update_branches():
    """Entries reaching: too few (Newton grow, x1.26 grow), too many
    (Newton shrink, /1.26 shrink), bisection, the collapse guard, the
    min-Hsml clamp and its stop, converged, inactive."""
    des, dev, hmin = 33.0, 3.0, 0.05
    rows = [
        # hsml, left, right, wngb, dhsml, rho, active
        (1.0, 0.0, 0.0, 25.0, -2.0, 1.0, True),    # few, Newton grow
        (1.0, 0.0, 0.0, 5.0, -2.0, 1.0, True),     # few, far: x1.26
        (1.0, 0.0, 0.0, 45.0, -2.0, 1.0, True),    # many, Newton shrink
        (1.0, 0.0, 0.0, 90.0, -2.0, 1.0, True),    # many, far: /1.26
        (1.0, 0.8, 0.0, 45.0, -2.0, 1.0, True),    # bracketed: bisection
        (1.0, 0.0, 1.5, 20.0, -2.0, 1.0, True),    # bracketed: bisection
        (1.0, 1.0, 1.0005, 20.0, -2.0, 1.0, True),  # collapsed window
        (0.055, 0.0, 0.0, 60.0, -2.0, 1.0, True),  # shrink to the clamp
        (0.0505, 0.0, 0.0, 60.0, -2.0, 1.0, True),  # at the minimum: stop
        (1.0, 0.0, 0.0, 34.0, -2.0, 1.0, True),    # converged
        (1.0, 0.0, 0.0, 5.0, -2.0, 1.0, False),    # inactive
        (1.0, 0.0, 0.0, 25.0, -2.7, 1.0, True),    # wild derivative
    ]
    cols = [np.array(c, np.float32) for c in zip(*rows[:])]
    active = np.array([r[6] for r in rows])
    want = jsph.hsml_update(*(jnp.asarray(c) for c in cols[:6]), des, dev,
                            hmin, jnp.asarray(active))
    got = tsph.hsml_update(*(T(c) for c in cols[:6]), des, dev, hmin,
                           T(active))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    conv = got[3].numpy()
    assert conv.tolist() == [False] * 6 + [True, False, True, True, True,
                                           False]
    h = got[0].numpy()
    np.testing.assert_allclose(h[[1, 3, 7, 11]], [1.26, 1 / 1.26, hmin, 1.26],
                               rtol=1e-6)


def _jittered_gas(n_side=10, seed=3):
    rng = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / n_side * BOX
    pos = np.mod(g + rng.normal(0, 0.1 * BOX / n_side, g.shape), BOX)
    vel = rng.normal(0, 0.5, g.shape)
    return pos.astype(np.float32), vel.astype(np.float32)


def test_hydro_solver_density_matches(monkeypatch):
    from ngravs_tpu.config import SimulationConfig as JConfig
    from ngravs_tpu.particles import Particles as JParticles
    from ngravs_tpu.particles import SphState as JSph
    from ngravs_tpu_torch.config import SimulationConfig as TConfig
    from ngravs_tpu_torch.interop import sph_from_numpy
    from ngravs_tpu_torch.particles import Particles as TParticles

    pos, vel = _jittered_gas()
    n = len(pos)
    kw = dict(periodic=True, box_size=BOX, no_gravity=True, des_num_ngb=33,
              max_num_ngb_deviation=2, tree_group_size=64,
              tree_bucket_size=BUCKET, softening=(0.01,) * 6)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    mass = np.full(n, 1.0 / n, np.float32)
    # a poor first guess, so the iteration takes several sweeps
    h0 = np.float32(0.6 * BOX / 10)
    jp = JParticles.create(pos, vel, mass, np.arange(n), np.zeros(n),
                           jcfg.type_to_grav)
    js = JSph.zeros(n).replace(hsml=jnp.full(n, h0),
                               vel_pred=jnp.asarray(vel),
                               entropy=jnp.full(n, 0.3))
    j = jtree.build_tree(jp.pos, jp.mass, jp.grav, jnp.full(n, 0.1),
                         jnp.zeros(n), js.hsml, depth=DEPTH, n_gravs=1,
                         bucket=BUCKET, box_size=BOX)
    calls = []
    real = jsph.density_pass

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(jsph, "density_pass", counting)
    want = jsph.HydroSolver(jcfg, None).density(j, jp, js, 0, n, DEPTH, 1e-3)

    t = octree_from_numpy({f: np.asarray(getattr(j, f)) for f in j._fields},
                          "cpu")
    tp = TParticles.create(pos, vel, mass, np.arange(n), np.zeros(n),
                           tcfg.type_to_grav, device="cpu")
    ts = sph_from_numpy({f: np.asarray(getattr(js, f))
                         for f in ("entropy", "density", "hsml", "pressure",
                                   "dt_entropy", "hydro_accel", "vel_pred",
                                   "div_vel", "curl_vel",
                                   "dhsml_density_factor", "max_signal_vel",
                                   "num_ngb")}, "cpu")
    solver = tsph.HydroSolver(tcfg, None)
    got = solver.density(t, tp, ts, 0, n, DEPTH, 1e-3)
    assert solver.trace.counts["sph.density_iters"] == len(calls) >= 3
    for name in ("hsml", "density", "num_ngb", "pressure"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, err_msg=name)
    for name in ("div_vel", "curl_vel", "dhsml_density_factor"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    wngb = got.num_ngb.numpy()
    assert np.abs(wngb - 33).max() <= 2 + 1e-4
