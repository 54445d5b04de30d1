"""Gadget-2's SPH sums, by brute force over a grid of cells.

density.c (density, weighted neighbour count, the grad-h factor, div v
and curl v) and hydra.c (pressure force, artificial viscosity with the
Balsara switch and the viscosity limiter) for a set of gas particles of a
periodic box, in the cubic spline kernel of allvars.h.  The smoothing
lengths are the ones being judged: `density` takes them as given, and the
caller checks each neighbour count against the configuration's window.
"""

from __future__ import annotations

import math

import torch

NORM_COEFF = 4.0 / 3.0 * math.pi
KC1, KC2, KC3 = 2.546479089470, 15.278874536822, 45.836623610466
KC4, KC5, KC6 = 30.557749073644, 5.092958178941, -15.278874536822


def kernel(u, hinv):
    """W and dW/dr of the cubic spline at u = r / h, zero for u >= 1."""
    h3 = hinv * hinv * hinv
    h4 = h3 * hinv
    omu = 1.0 - u
    wk = torch.where(u < 0.5, h3 * (KC1 + KC2 * (u - 1.0) * u * u),
                     h3 * KC5 * omu * omu * omu)
    dwk = torch.where(u < 0.5, h4 * u * (KC3 * u - KC4), h4 * KC6 * omu * omu)
    inside = u < 1.0
    return torch.where(inside, wk, 0.0), torch.where(inside, dwk, 0.0)


class Grid:
    """Gas particles binned in cells at least `radius` wide, so that every
    neighbour within `radius` of a point lies in its cell or the 26 around
    it (all particles when the box holds fewer than 3 cells a side)."""

    def __init__(self, pos, box: float, radius: float):
        self.box = float(box)
        self.n = pos.shape[0]
        self.nc = int(self.box // float(radius))
        dev = pos.device
        if self.nc < 3:
            self.table = torch.arange(self.n, device=dev)[None, :]
            return
        cell = self._cells(pos)
        order = torch.argsort(cell)
        counts = torch.bincount(cell, minlength=self.nc ** 3)
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(self.n, device=dev) - start[cell[order]]
        self.table = torch.full((self.nc ** 3, int(counts.max())), -1,
                                dtype=torch.long, device=dev)
        self.table[cell[order], rank] = order

    def _ijk(self, pos):
        c = torch.floor(torch.remainder(pos.double(), self.box)
                        / self.box * self.nc).long()
        return torch.clamp(c, 0, self.nc - 1)

    def _cells(self, pos):
        c = self._ijk(pos)
        return (c[:, 0] * self.nc + c[:, 1]) * self.nc + c[:, 2]

    def candidates(self, pos):
        """[Q, C] indices of the particles near each point, -1 padded."""
        if self.nc < 3:
            return self.table.expand(pos.shape[0], -1)
        c = self._ijk(pos)
        r = torch.arange(-1, 2, device=pos.device)
        off = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                          -1).reshape(-1, 3)
        nb = torch.remainder(c[:, None, :] + off[None], self.nc)
        cell = (nb[..., 0] * self.nc + nb[..., 1]) * self.nc + nb[..., 2]
        return self.table[cell].reshape(pos.shape[0], -1)


def _pairs(x, box, q, cand):
    """Minimum-image separations x[q] - x[cand] ([Q, C, 3]), r, and the
    valid mask."""
    valid = cand >= 0
    c = torch.clamp(cand, min=0)
    d = x[q][:, None, :] - x[c]
    d = d - box * torch.round(d / box)
    r = torch.sqrt((d * d).sum(-1))
    return d, r, valid, c


def density(x, v, m, h, q, grid: Grid, box: float, chunk: int = 2048):
    """density.c for the gas particles `q`, each at its own smoothing
    length h[q]: (rho, weighted neighbour count, grad-h factor f, div v,
    curl v), each [len(q)]."""
    outs = []
    for i0 in range(0, len(q), chunk):
        qi = q[i0:i0 + chunk]
        d, r, valid, c = _pairs(x, box, qi, grid.candidates(x[qi]))
        hi = h[qi][:, None]
        hinv = 1.0 / hi
        u = r * hinv
        wk, dwk = kernel(u, hinv)
        wk = torch.where(valid, wk, 0.0)
        dwk = torch.where(valid, dwk, 0.0)
        mj = m[c]
        rho = (mj * wk).sum(1)
        wngb = NORM_COEFF * wk.sum(1) * hi[:, 0] ** 3
        dh = -(mj * (3.0 * hinv * wk + u * dwk)).sum(1)
        fac = torch.where(r > 0, mj * dwk / torch.where(r > 0, r, 1.0), 0.0)
        dv = v[qi][:, None, :] - v[c]
        divv = -(fac * (d * dv).sum(-1)).sum(1)
        rot = torch.stack([
            (fac * (d[..., 2] * dv[..., 1] - d[..., 1] * dv[..., 2])).sum(1),
            (fac * (d[..., 0] * dv[..., 2] - d[..., 2] * dv[..., 0])).sum(1),
            (fac * (d[..., 1] * dv[..., 0] - d[..., 0] * dv[..., 1])).sum(1)],
            -1)
        f = 1.0 / (1.0 + h[qi] * dh / (3.0 * rho))
        outs.append((rho, wngb, f, divv / rho,
                     torch.linalg.vector_norm(rot, dim=-1) / rho))
    return tuple(torch.cat(o) for o in zip(*outs))


def hydro(x, v, m, h, rho, pres, f, divv, curl, dt, q, grid: Grid,
          box: float, facs, visc_const: float, gamma: float,
          chunk: int = 2048):
    """hydra.c's accelerations of the gas particles `q`; every per-particle
    field is indexed by particle and must hold the partners' values too
    (the neighbours within max(h_i, h_j))."""
    fac_mu, fac_vsic_fix, hubble_a2 = facs
    cs = torch.sqrt(gamma * pres / rho)
    balsara = divv.abs() / (divv.abs() + curl + 1e-4 * cs / fac_mu / h)
    out = []
    for i0 in range(0, len(q), chunk):
        qi = q[i0:i0 + chunk]
        d, r, valid, c = _pairs(x, box, qi, grid.candidates(x[qi]))
        hi, hj = h[qi][:, None], h[c]
        valid = valid & (c != qi[:, None]) & ((r < hi) | (r < hj))
        rs = torch.where(r > 0, r, 1.0)
        _, dwi = kernel(r / hi, 1.0 / hi)
        _, dwj = kernel(r / hj, 1.0 / hj)
        dv = v[qi][:, None, :] - v[c]
        vdotr2 = (d * dv).sum(-1) + hubble_a2 * r * r
        mu = fac_mu * vdotr2 / rs
        vsig = cs[qi][:, None] + cs[c] - 3.0 * mu
        visc = 0.25 * visc_const * vsig * (-mu) \
            / (0.5 * (rho[qi][:, None] + rho[c])) \
            * (balsara[qi][:, None] + balsara[c])
        dwsum = dwi + dwj
        dtp = torch.maximum(dt[qi][:, None], dt[c])
        lim_ok = (dtp > 0) & (dwsum < 0)
        limit = 0.5 * fac_vsic_fix * vdotr2 / (
            0.5 * (m[qi][:, None] + m[c]) * torch.where(lim_ok, dwsum, -1.0)
            * rs * torch.where(dtp > 0, dtp, 1.0))
        visc = torch.where(lim_ok, torch.minimum(visc, limit), visc)
        visc = torch.where(vdotr2 < 0, visc, 0.0)
        por2_i = (pres[qi] / rho[qi] ** 2 * f[qi])[:, None]
        por2_j = pres[c] / rho[c] ** 2 * f[c]
        hfc = m[c] * (0.5 * visc * dwsum + por2_i * dwi + por2_j * dwj) / rs
        hfc = torch.where(valid, hfc, 0.0)
        out.append(-(hfc[..., None] * d).sum(1))
    return torch.cat(out)
