"""Gravitational accelerations by direct summation.

Open boxes: the softened Newtonian sum over every source.  Periodic
boxes: the Ewald sum, nearest image in real space and the structure
factors in k-space, with the uniform background of each species taken
out (k = 0), as a TreePM mesh takes it out.  Softening is Gadget-2's
cubic spline (forcetree.c, `h = max(h_target, h_source)`).

The laws are the configuration's wiring: "newton" makes every pair
Newtonian; "newton_yukawa" keeps Newton within a gravity and makes pairs
of different gravities Yukawa, with the screening mass 60 per box length
of the ngravs reference code (ngravs.c:42), Newtonian inside the
softening.  The Yukawa force at half a box is e^-30 of its value at the
mean spacing, so its periodic sum is the nearest image.

`long_range_accel` is the long-range part of the TreePM split alone, the
force a particle-mesh solver is meant to give.

`dtype` is float64 for the reference; the control passes a lower one.
"""

from __future__ import annotations

import math

import torch

YUKAWA_IMASS = 60.0
EWALD_ALPHA_BOX = 8.0   # alpha L: erfc(alpha L / 2) ~ 1.5e-8, one image
EWALD_KMAX2 = 144       # |n|^2 of the k-space sum: e^(-(pi n / 8)^2) < 3e-10
# Gadget-2's split scale in mesh cells (ASMTH), and the smoothing below
# which a mode of the long-range sum is left out
PM_ASMTH = 1.25
PM_KEEP = 1e-7


def spline_factor(h, r):
    """Gadget's softened 1/r^3 for r < h (forcetree.c, ngravs.c
    `plummer`)."""
    u = r / h
    h3 = h * h * h
    lo = 10.666666666667 + u * u * (32.0 * u - 38.4)
    hi = (21.333333333333 - 48.0 * u + 38.4 * u * u
          - 10.666666666667 * u * u * u - 0.066666666667 / (u * u * u))
    return torch.where(u < 0.5, lo, hi) / h3


def _chunks(n: int, size: int):
    return [(i, min(i + size, n)) for i in range(0, n, size)]


def open_accel(pos, mass, hsoft, tgt, G: float, dtype=torch.float64,
               pairs: int = 1 << 26):
    """Softened Newtonian accelerations of the particles `tgt` (indices)
    from every particle, all laws Newton."""
    x, m, h = pos.to(dtype), mass.to(dtype), hsoft.to(dtype)
    xt, ht = x[tgt], h[tgt]
    out = torch.zeros(len(tgt), 3, dtype=dtype, device=pos.device)
    step = max(1, pairs // max(x.shape[0], 1))
    for t0, t1 in _chunks(len(tgt), step):
        d = x[None, :, :] - xt[t0:t1, None, :]
        r2 = (d * d).sum(-1)
        r = torch.sqrt(r2)
        hh = torch.maximum(ht[t0:t1, None], h[None, :])
        self_pair = torch.arange(x.shape[0], device=pos.device)[None, :] \
            == tgt[t0:t1, None]
        safe = torch.where(self_pair, torch.ones_like(r), r)
        fac = torch.where(safe >= hh, 1.0 / (safe * safe * safe),
                          spline_factor(hh, safe))
        fac = torch.where(self_pair, torch.zeros_like(fac), fac) * m[None, :]
        out[t0:t1] = (fac[..., None] * d).sum(1)
    return out * G


def _kvectors(box: float, kmax2: int, device, dtype):
    """Half of the k-space lattice 2 pi n / L, 0 < |n|^2 <= kmax2 (each
    pair +-n counted once)."""
    m = int(math.isqrt(kmax2))
    r = torch.arange(-m, m + 1, device=device)
    n = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    n2 = (n * n).sum(-1)
    half = (n[:, 0] > 0) | ((n[:, 0] == 0) & (n[:, 1] > 0)) \
        | ((n[:, 0] == 0) & (n[:, 1] == 0) & (n[:, 2] > 0))
    n = n[half & (n2 <= kmax2)]
    return n.to(dtype) * (2 * math.pi / box)


def periodic_accel(pos, mass, grav, hsoft, tgt, box: float, wiring: str,
                   G: float, dtype=torch.float64, pairs: int = 1 << 25):
    """Periodic accelerations of the particles `tgt`: Newton within a
    gravity by the Ewald sum, Yukawa between gravities (`wiring`
    "newton_yukawa") or Newton between them too ("newton")."""
    if wiring not in ("newton", "newton_yukawa"):
        raise ValueError(f"no reference for the wiring {wiring!r}")
    dev = pos.device
    L = float(box)
    alpha = EWALD_ALPHA_BOX / L
    ym = YUKAWA_IMASS / L
    x, m, h = pos.to(dtype), mass.to(dtype), hsoft.to(dtype)
    g = grav.long()
    if wiring == "newton":
        g = torch.zeros_like(g)
    xt, ht, gt = x[tgt], h[tgt], g[tgt]
    n = x.shape[0]
    out = torch.zeros(len(tgt), 3, dtype=dtype, device=dev)
    two_over_sqrtpi = 2.0 / math.sqrt(math.pi)
    idx = torch.arange(n, device=dev)
    step = max(1, pairs // max(n, 1))
    # real space, nearest image
    for t0, t1 in _chunks(len(tgt), step):
        d = x[None, :, :] - xt[t0:t1, None, :]
        d = d - L * torch.round(d / L)
        r2 = (d * d).sum(-1)
        self_pair = idx[None, :] == tgt[t0:t1, None]
        r = torch.sqrt(torch.where(self_pair, torch.ones_like(r2), r2))
        ir3 = 1.0 / (r * r * r)
        hh = torch.maximum(ht[t0:t1, None], h[None, :])
        soft = spline_factor(hh, r)
        same = gt[t0:t1, None] == g[None, :]
        ar = alpha * r
        real = (torch.special.erfc(ar)
                + two_over_sqrtpi * ar * torch.exp(-ar * ar)) * ir3
        newton = torch.where(r >= hh, real, real - ir3 + soft)
        yuk = torch.where(r >= hh, torch.exp(-ym * r) * (ym * r + 1.0) * ir3,
                          soft)
        fac = torch.where(same, newton, yuk)
        fac = torch.where(self_pair, torch.zeros_like(fac), fac) * m[None, :]
        out[t0:t1] = (fac[..., None] * d).sum(1)
    # k-space: the Newtonian part within each gravity
    k = _kvectors(L, EWALD_KMAX2, dev, dtype)
    k2 = (k * k).sum(-1)
    w = (4 * math.pi / L ** 3) * 2.0 * torch.exp(-k2 / (4 * alpha * alpha)) \
        / k2
    kstep = max(1, pairs // max(k.shape[0], 1))
    for gi in torch.unique(gt).tolist():
        src = torch.nonzero(g == gi).squeeze(1)
        c = torch.zeros(k.shape[0], dtype=dtype, device=dev)
        s = torch.zeros_like(c)
        for s0, s1 in _chunks(len(src), kstep):
            ph = x[src[s0:s1]] @ k.T
            ms = m[src[s0:s1], None]
            c = c + (ms * torch.cos(ph)).sum(0)
            s = s + (ms * torch.sin(ph)).sum(0)
        sel = torch.nonzero(gt == gi).squeeze(1)
        for t0, t1 in _chunks(len(sel), kstep):
            ph = xt[sel[t0:t1]] @ k.T
            amp = w * (s * torch.cos(ph) - c * torch.sin(ph))
            out[sel[t0:t1]] += amp @ k
    return out * G


def _laws(grav, wiring: str):
    """The gravities the laws see: "newton" makes every pair one gravity."""
    if wiring not in ("newton", "newton_yukawa"):
        raise ValueError(f"no reference for the wiring {wiring!r}")
    g = grav.long()
    return torch.zeros_like(g) if wiring == "newton" else g


def _cis(n, theta):
    """cos and sin of n * theta: [len(n), len(theta)] each."""
    ph = n[:, None] * theta[None, :]
    return torch.cos(ph), torch.sin(ph)


def long_range_accel(pos, mass, grav, tgt, box: float, wiring: str,
                     G: float, pmgrid: int, dtype=torch.float64,
                     chunk: int = 4096):
    """The long-range accelerations of the particles `tgt` under Gadget-2's
    TreePM split at rs = PM_ASMTH box / pmgrid: each law's periodic
    potential, 4 pi / k^2 (Newton, within a gravity) or 4 pi / (k^2 +
    mu^2) (Yukawa, between gravities under "newton_yukawa"; the screened
    Ewald split), times exp(-(k^2 + mu^2) rs^2), the k = 0 mode left out.
    Summed exactly over the modes |n_i| <= M, where the smoothing falls to
    PM_KEEP, by separable exponentials: the structure factor of each
    gravity, then the series at each target."""
    dev = pos.device
    L = float(box)
    rs = PM_ASMTH * L / int(pmgrid)
    kf = 2 * math.pi / L
    M = int(math.ceil(math.sqrt(-math.log(PM_KEEP)) / (kf * rs)))
    K = 2 * M + 1
    n = torch.arange(-M, M + 1, device=dev).to(dtype)
    th = (pos.double() * kf).to(dtype)         # [N, 3] phases of k_f
    m = mass.to(dtype)
    g = _laws(grav, wiring)
    gt = g[tgt]
    # structure factors S_g(n) = sum_j m_j e^{i k_n x_j}, real and imaginary
    S = {}
    for gi in torch.unique(g).tolist():
        src = torch.nonzero(g == gi).squeeze(1)
        sr = torch.zeros(K * K, K, dtype=dtype, device=dev)
        si = torch.zeros_like(sr)
        for s0, s1 in _chunks(len(src), chunk):
            j = src[s0:s1]
            cx, sx = _cis(n, th[j, 0])
            cy, sy = _cis(n, th[j, 1])
            cz, sz = _cis(n, th[j, 2])
            ar, ai = cx * m[j], sx * m[j]
            tr = (ar[:, None] * cy[None] - ai[:, None] * sy[None]) \
                .reshape(K * K, -1)
            ti = (ar[:, None] * sy[None] + ai[:, None] * cy[None]) \
                .reshape(K * K, -1)
            sr += tr @ cz.T - ti @ sz.T
            si += tr @ sz.T + ti @ cz.T
        S[gi] = (sr.reshape(K, K, K), si.reshape(K, K, K))
    nx, ny, nz = torch.meshgrid(n, n, n, indexing="ij")
    k2 = (nx * nx + ny * ny + nz * nz).double() * kf * kf
    mu = YUKAWA_IMASS / L
    out = torch.zeros(len(tgt), 3, dtype=dtype, device=dev)
    for tg in torch.unique(gt).tolist():
        # F(n) = sum over source gravities of the law's kernel times
        # conj(S): the target gravity's smoothed potential in k-space
        fr = torch.zeros(K, K, K, dtype=torch.float64, device=dev)
        fi = torch.zeros_like(fr)
        for sg, (sr, si) in S.items():
            q2 = k2 + (0.0 if sg == tg else mu * mu)
            ker = torch.where(k2 > 0, 4 * math.pi
                              * torch.exp(-q2 * rs * rs) / q2, 0.0)
            fr += ker * sr.double()
            fi -= ker * si.double()
        fr, fi = fr.to(dtype), fi.to(dtype)
        sel = torch.nonzero(gt == tg).squeeze(1)
        for t0, t1 in _chunks(len(sel), 512):
            t = tgt[sel[t0:t1]]
            cx, sx = _cis(n, th[t, 0])
            cy, sy = _cis(n, th[t, 1])
            cz, sz = _cis(n, th[t, 2])
            for a, na in enumerate((nx, ny, nz)):
                wr, wi = (na * fr).reshape(K * K, K), \
                    (na * fi).reshape(K * K, K)
                # sum over n_z, then n_y, then n_x of W(n) e^{i k_n x_t}
                ur = (wr @ cz - wi @ sz).reshape(K, K, -1)
                ui = (wr @ sz + wi @ cz).reshape(K, K, -1)
                vr = (ur * cy[None] - ui * sy[None]).sum(1)
                vi = (ur * sy[None] + ui * cy[None]).sum(1)
                im = (vr * sx + vi * cx).sum(0)
                out[sel[t0:t1], a] = -im * kf / L ** 3
    return out * G
