"""Periodic particle-mesh (PM) long-range gravity (port of
`ngravs_tpu/ops/pm.py`).

The reference's `pm_periodic.c` (pmforce_periodic :204, pmpotential_periodic
:798) as torch ops: CIC assignment by `index_add_` on the flattened grid,
one `torch.fft.rfftn` per source gravity, the per-pair ngravs Green's
function with the Gaussian split and the CIC deconvolution
(pm_periodic.c:436-520), the inverse transform, the 4th-order finite
difference gradient (pm_periodic.c:686-726) or the spectral one, optional
grid interlacing, and CIC readout at the receivers.  The multipliers are
built on the host in f64 from each law's `greens`, as the JAX package
builds them.  On a GPU `index_add_` is atomic, so the assigned mass, and
with it every PM force, varies from run to run in the last bits.

Units: Green's functions take k in mesh cells in [-PMGRID/2, PMGRID/2],
normalised so the Newtonian 4 pi G/k_phys^2 becomes 1/k_mesh^2
(ngravs.c:818-824); the physical factor G/(pi L) enters at the end
(pm_periodic.c:232-238).
"""

from __future__ import annotations

import math

import numpy as np
import torch

ASMTH = 1.25   # Makefile.reference default; cfg.asmth overrides
RCUT = 4.5


def _corners(pos, pmgrid: int, box: float, shift: float):
    """Cell indices and weights of the CIC cloud: for each axis the lower
    and upper cell and their weights."""
    fac = pmgrid / box
    u = pos * fac + shift
    i0 = torch.floor(u).to(torch.int64)
    d = u - i0.to(u.dtype)
    i0 = torch.remainder(i0, pmgrid)
    i1 = torch.remainder(i0 + 1, pmgrid)
    return [((i0[..., a], 1 - d[..., a]), (i1[..., a], d[..., a]))
            for a in range(3)]


def cic_assign(pos, weight, pmgrid: int, box: float, shift: float = 0.0):
    """Cloud-in-cell mass assignment -> [pmgrid]^3 grid
    (pm_periodic.c:297-331); `shift` (in cells) staggers the grid for
    interlacing."""
    cx, cy, cz = _corners(pos, pmgrid, box, shift)
    grid = torch.zeros(pmgrid ** 3, dtype=weight.dtype, device=weight.device)
    for bx, wx in cx:
        for by, wy in cy:
            for bz, wz in cz:
                grid.index_add_(0, (bx * pmgrid + by) * pmgrid + bz,
                                weight * wx * wy * wz)
    return grid.reshape(pmgrid, pmgrid, pmgrid)


def cic_readout(grid, pos, pmgrid: int, box: float, shift: float = 0.0):
    """Trilinear interpolation of a grid at particle positions
    (pm_periodic.c:728-763)."""
    cx, cy, cz = _corners(pos, pmgrid, box, shift)
    flat = grid.reshape(-1)
    out = torch.zeros(pos.shape[:-1], dtype=grid.dtype, device=grid.device)
    for bx, wx in cx:
        for by, wy in cy:
            for bz, wz in cz:
                out = out + flat[(bx * pmgrid + by) * pmgrid + bz] \
                    * wx * wy * wz
    return out


def _kgrid(pmgrid: int):
    """Mesh-cell wavenumbers in the rfftn layout: kx, ky full, kz half."""
    k = np.fft.fftfreq(pmgrid) * pmgrid        # [-G/2, G/2)
    kz = np.arange(pmgrid // 2 + 1)
    return k[:, None, None], k[None, :, None], kz[None, None, :]


def _deconv_smth(law, pmgrid: int, asmth_cells: float) -> np.ndarray:
    """k-space multiplier greens * exp(-k2 asmth2) / CIC-window^4
    (pm_periodic.c:456-515), f64 [G, G, G/2+1].  The Green's function is
    evaluated in f32, as the JAX package evaluates it."""
    kx, ky, kz = _kgrid(pmgrid)
    k2 = kx * kx + ky * ky + kz * kz
    kmag = np.sqrt(k2)
    sinc = lambda t: np.where(t == 0, 1.0, np.sin(np.pi * t / pmgrid)
                              / np.where(t == 0, 1.0, np.pi * t / pmgrid))
    ff = sinc(kx) * sinc(ky) * sinc(kz)
    asmth2 = (2 * math.pi * asmth_cells / pmgrid) ** 2
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    greens = law.greens(t32(k2), t32(kmag)).double().numpy()
    smth = greens * np.exp(-k2 * asmth2) / np.maximum(ff, 1e-8) ** 4
    smth[0, 0, 0] = 0.0  # kill the DC mode (pm_periodic.c:519-520)
    return smth


class PMSolver:
    """Periodic PM force and potential for an ngravs wiring, on one device.

    The per-pair k-space multipliers are built once on the host in f64 and
    kept in f32 on `device`; `forces` shares one rfftn per source gravity,
    and receivers whose law from a source is the same object share its
    convolution and gradient."""

    def __init__(self, wiring, pmgrid: int, box: float, n_gravs: int,
                 g_const: float, asmth_cells: float = ASMTH,
                 gradient: str = "fd4", interlace: bool = False,
                 device="cpu"):
        if gradient not in ("fd4", "spectral"):
            raise ValueError(f"unknown PM gradient {gradient!r}")
        self.pmgrid = int(pmgrid)
        self.box = float(box)
        self.n_gravs = n_gravs
        self.G = float(g_const)
        self.asmth_cells = float(asmth_cells)
        self.asmth = asmth_cells * box / pmgrid        # length units
        self.rcut = RCUT * self.asmth
        self.gradient = gradient
        self.device = torch.device(device)
        smth = np.stack([np.stack([
            _deconv_smth(wiring.law(tg, sg), self.pmgrid, asmth_cells)
            for sg in range(n_gravs)]) for tg in range(n_gravs)])
        self.smth = torch.as_tensor(smth, dtype=torch.float32,
                                    device=self.device)  # [NG,NG,G,G,G/2+1]
        # receiver groups per source, by law identity (pm.py:122-131)
        self.recv_groups = []
        for sg in range(n_gravs):
            groups = {}
            for tg in range(n_gravs):
                groups.setdefault(id(wiring.law(tg, sg)), []).append(tg)
            self.recv_groups.append(sorted(groups.values()))
        g = self.pmgrid
        kx, ky, kz = _kgrid(g)
        if gradient == "spectral":
            # ik differentiation, Nyquist zeroed (physical wavenumbers)
            kfac = 2 * math.pi / box

            def kz_(k):
                k = np.where(np.abs(k) == g // 2, 0.0, k)
                return torch.as_tensor(k * kfac, dtype=torch.float32,
                                       device=self.device)

            self.kvec = (kz_(kx), kz_(ky), kz_(kz))
        # grid interlacing: a half-cell-staggered second assignment whose
        # phase-aligned average cancels the odd aliases; Nyquist planes are
        # zeroed (the half-cell shift is sign-ambiguous there)
        self.interlace = bool(interlace)
        if self.interlace:
            ph = np.exp(1j * math.pi * (kx + ky + kz) / g)
            self.phase = torch.as_tensor(ph, dtype=torch.complex64,
                                         device=self.device)
            nyq = ((np.abs(kx) == g // 2) | (np.abs(ky) == g // 2)
                   | (kz == g // 2))
            self.nyqmask = torch.as_tensor(np.where(nyq, 0.0, 1.0),
                                           dtype=torch.float32,
                                           device=self.device)

    def _phi_k(self, pos, mass, grav, sg):
        w = torch.where(grav == sg, mass, 0.0)
        rho_k = torch.fft.rfftn(cic_assign(pos, w, self.pmgrid, self.box))
        if self.interlace:
            rho2_k = torch.fft.rfftn(
                cic_assign(pos, w, self.pmgrid, self.box, shift=0.5))
            rho_k = 0.5 * (rho_k + self.phase * rho2_k) * self.nyqmask
        return rho_k

    def _read_field(self, f_k, pos):
        """Inverse-transform a k-space field and interpolate it at the
        particles (interlaced: the average of both grids' readouts)."""
        g = self.pmgrid
        out = cic_readout(torch.fft.irfftn(f_k, s=(g, g, g)), pos, g,
                          self.box)
        if self.interlace:
            f_b = torch.fft.irfftn(f_k * torch.conj(self.phase),
                                   s=(g, g, g))
            out = 0.5 * (out + cic_readout(f_b, pos, g, self.box, shift=0.5))
        return out

    def _recv(self, grav, tgs):
        recv = grav == tgs[0]
        for tg in tgs[1:]:
            recv = recv | (grav == tg)
        return recv

    def forces(self, pos, mass, grav):
        """PM accelerations [N,3] (times G), all gravity pairs: psi =
        (G N^3 / (pi L)) irfftn(rho_k * multiplier) is minus the physical
        potential, and acc = +grad(psi)."""
        g = self.pmgrid
        fac = self.G / (math.pi * self.box) * (g ** 3)
        h = self.box / g
        acc = torch.zeros_like(pos)
        for sg in range(self.n_gravs):
            rho_k = self._phi_k(pos, mass, grav, sg)
            for tgs in self.recv_groups[sg]:
                conv = rho_k * self.smth[tgs[0], sg]
                recv = self._recv(grav, tgs)
                if self.gradient == "spectral":
                    for dim in range(3):
                        a = self._read_field(1j * self.kvec[dim] * conv, pos)
                        acc[:, dim] += torch.where(recv, a * fac, 0.0)
                    continue
                psis = [(torch.fft.irfftn(conv, s=(g, g, g)), 0.0)]
                if self.interlace:
                    psis.append((torch.fft.irfftn(
                        conv * torch.conj(self.phase), s=(g, g, g)), 0.5))
                for dim in range(3):
                    # 4th-order centred difference (pm_periodic.c:686-726)
                    a = 0.0
                    for psi, shift in psis:
                        d1 = (torch.roll(psi, -1, dims=dim)
                              - torch.roll(psi, 1, dims=dim))
                        d2 = (torch.roll(psi, -2, dims=dim)
                              - torch.roll(psi, 2, dims=dim))
                        grad = (4.0 / 3 * d1 - 1.0 / 6 * d2) / (2 * h)
                        a = a + cic_readout(grad, pos, g, self.box,
                                            shift=shift) / len(psis)
                    acc[:, dim] += torch.where(recv, a * fac, 0.0)
        return acc

    def potential(self, pos, mass, grav):
        """PM potential [N] (times G), pmpotential_periodic
        (pm_periodic.c:798)."""
        g = self.pmgrid
        fac = self.G / (math.pi * self.box) * (g ** 3)
        pot = torch.zeros(pos.shape[0], dtype=pos.dtype, device=pos.device)
        for sg in range(self.n_gravs):
            rho_k = self._phi_k(pos, mass, grav, sg)
            for tgs in self.recv_groups[sg]:
                recv = self._recv(grav, tgs)
                v = self._read_field(rho_k * self.smth[tgs[0], sg], pos)
                pot = pot - torch.where(recv, v * fac, 0.0)
        return pot
