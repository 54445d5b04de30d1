"""Slab-decomposed particle mesh over the ranks (port of
`ngravs_tpu/parallel/pm_sharded.py`).

The reference's FFTW-MPI machinery (pm_periodic.c:54-790) as the JAX
package rebuilt it: the PMGRID^3 grid is split into x-slabs, one a rank,
and no rank ever holds more than its slab and a few ghost planes.

  reference mechanism                        -> here
  ---------------------------------------------------------------------
  CIC patch assignment + patch->slab         -> route each particle to the
  exchange (pm_periodic.c:297-427)              owner of its lower CIC
                                                plane (one all_to_all of
                                                packed rows), fixed-order
                                                CIC into the slab, the
                                                upper boundary plane sent
                                                up the ring
  rfftwnd_mpi forward/inverse with its       -> rfft(z) + fft(y) on the
  all-to-all (pm_periodic.c:433,525)            slab, an all_to_all x<->y
                                                transpose, fft(x); the
                                                inverse mirrored (torch.fft,
                                                cuFFT on the card)
  the Green's multiply                       -> the single-device solver's
  (pm_periodic.c:436-520)                       multiplier, this rank's
                                                y-chunk of it
  slab->patch ghost exchange                 -> +-2 boundary planes over
  (pm_periodic.c:533-670)                       the ring for the 4th-order
                                                difference, +1 for readout
  CIC readout, patches back to owners        -> slab-local readout at the
  (pm_periodic.c:728-763)                       routed particles, one
                                                all_to_all back

One forward transform a source gravity; receivers with the same law share
a convolution, as `ops/pm.py` does on one device.  The single-device
solver's options carry over: grid interlacing (each grid's particles are
routed by their own lower plane) and the spectral gradient.  Each cell's
CIC sum is in a fixed order (`fixed_order_index_add`), so a run repeats
bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.tree import fixed_order_index_add


class Routed(NamedTuple):
    pos: torch.Tensor       # [K*cap, 3] particles of my slab (and padding)
    mass: torch.Tensor
    grav: torch.Tensor      # int32
    valid: torch.Tensor     # bool
    dest: torch.Tensor      # [n] where each local particle went ...
    rank: torch.Tensor      # [n] ... and in which slot


def _fft_forward_sharded(mesh, slab):
    """Distributed rfftn of x-slabs [S, G, G] real -> [G, G/K, G/2+1]
    complex: kx whole, ky split over the ranks, kz the half spectrum."""
    k = mesh.size
    spec = torch.fft.rfft(slab, dim=2)                 # z: local
    spec = torch.fft.fft(spec, dim=1)                  # y: local
    s, g, gz = spec.shape
    blocks = spec.reshape(s, k, g // k, gz).permute(1, 0, 2, 3)
    recv = mesh.all_to_all(torch.view_as_real(blocks.contiguous()))
    spec = torch.view_as_complex(recv.contiguous()).reshape(g, g // k, gz)
    return torch.fft.fft(spec, dim=0)                  # x: now local


def _fft_inverse_sharded(mesh, spec, g: int):
    """Inverse of `_fft_forward_sharded`: [G, G/K, G/2+1] -> [S, G, G]."""
    k = mesh.size
    spec = torch.fft.ifft(spec, dim=0)                 # x
    _, cy, gz = spec.shape
    blocks = spec.reshape(k, g // k, cy, gz)
    recv = torch.view_as_complex(
        mesh.all_to_all(torch.view_as_real(blocks.contiguous())).contiguous())
    spec = recv.permute(1, 0, 2, 3).reshape(g // k, g, gz)
    spec = torch.fft.ifft(spec, dim=1)                 # y
    return torch.fft.irfft(spec, n=g, dim=2)           # z


class ShardedPMSolver:
    """Periodic PM forces and potential over the ranks.

    Reuses the per-pair k-space multipliers of the single-device solver
    (`ops/pm.py:_deconv_smth`) and its interlacing and gradient options;
    `forces(pos, mass, grav)` takes this rank's particles.  Each rank's
    grid memory is O(PMGRID^3 / K)."""

    def __init__(self, base_pm, mesh, n_gravs: int):
        g = base_pm.pmgrid
        k = mesh.size
        if g % k:
            raise ValueError("PMGRID must be divisible by the mesh size")
        if g // k < 2:
            raise ValueError("PMGRID must give every rank at least two "
                             "planes (the 4th-order difference takes its "
                             "+-2 ghost planes from the neighbouring slabs)")
        self.pm = base_pm
        self.mesh = mesh
        self.n_dev = k
        self.n_gravs = n_gravs
        self.s = g // k
        self.cy = g // k
        my = mesh.rank
        ys = slice(my * self.cy, (my + 1) * self.cy)
        dev = mesh.device
        self.smth = base_pm.smth[:, :, :, ys, :].contiguous().to(dev)
        self.shifts = (0.0, 0.5) if base_pm.interlace else (0.0,)
        if base_pm.interlace:
            self.phase = base_pm.phase[:, ys, :].contiguous().to(dev)
            self.nyqmask = base_pm.nyqmask[:, ys, :].contiguous().to(dev)
        if base_pm.gradient == "spectral":
            kx, ky, kz = base_pm.kvec
            self.kvec = (kx.to(dev), ky[:, ys, :].contiguous().to(dev),
                         kz.to(dev))

    # ------------------------------------------------------------------
    # particle <-> slab routing (the patch <-> slab exchange)
    # ------------------------------------------------------------------
    def _route_out(self, pos, mass, grav, shift: float) -> Routed:
        """Send every local particle to the rank owning the x-plane of its
        lower CIC cell (on the grid staggered by `shift` cells).  Each
        rank reserves n slots for each destination, as the JAX solver
        does."""
        g, box, k, s = self.pm.pmgrid, self.pm.box, self.n_dev, self.s
        n = pos.shape[0]
        fac = g / box
        x0 = torch.remainder(torch.floor(pos[:, 0] * fac + shift)
                             .to(torch.int64), g)
        dest = x0 // s
        onehot = dest[:, None] == torch.arange(k, device=pos.device)[None]
        rank = (torch.cumsum(onehot.to(torch.int64), dim=0) - 1) \
            .gather(1, dest[:, None])[:, 0]
        # the gravity index travels as its value, exact in any float type
        payload = torch.cat([pos, mass[:, None].to(pos.dtype),
                             grav[:, None].to(pos.dtype),
                             torch.ones(n, 1, dtype=pos.dtype,
                                        device=pos.device)], dim=1)
        send = torch.zeros(k, n, 6, dtype=pos.dtype, device=pos.device)
        send[dest, rank] = payload
        r = self.mesh.all_to_all(send).reshape(k * n, 6)
        return Routed(pos=r[:, 0:3], mass=r[:, 3],
                      grav=r[:, 4].to(torch.int32),
                      valid=r[:, 5] > 0, dest=dest, rank=rank)

    def _route_back(self, values, rt: Routed):
        """Per-routed-particle values [K*cap, C] back to their owners."""
        k = self.n_dev
        r, c = values.shape
        back = self.mesh.all_to_all(values.reshape(k, r // k, c))
        return back[rt.dest, rt.rank]

    def _cells(self, rpos, shift: float):
        """Lower cells (x relative to my slab) and CIC weights."""
        g, box = self.pm.pmgrid, self.pm.box
        u = rpos * (g / box) + shift
        i0 = torch.floor(u).to(torch.int64)
        d = u - i0.to(u.dtype)
        i0 = torch.remainder(i0, g)
        ix0 = i0[:, 0] - self.mesh.rank * self.s
        iy0, iz0 = i0[:, 1], i0[:, 2]
        return ((ix0, 1 - d[:, 0]), (ix0 + 1, d[:, 0])), \
            ((iy0, 1 - d[:, 1]), (torch.remainder(iy0 + 1, g), d[:, 1])), \
            ((iz0, 1 - d[:, 2]), (torch.remainder(iz0 + 1, g), d[:, 2]))

    def _cic_slab(self, rt: Routed, w, shift: float):
        """CIC of routed particles into my [S, G, G] slab; the upper
        boundary plane belongs to the next slab and goes up the ring."""
        g, s = self.pm.pmgrid, self.s
        cx, cy, cz = self._cells(rt.pos, shift)
        # padding rows are parked past the slab with weight zero
        (bx0, wx0), (_, wx1) = cx
        bx0 = torch.where(rt.valid, bx0, s + 1)
        cx = ((bx0, wx0), (bx0 + 1, wx1))
        w = torch.where(rt.valid, w, 0.0)
        cells, vals = [], []
        for bx, wx in cx:
            for by, wy in cy:
                for bz, wz in cz:
                    cells.append((bx * g + by) * g + bz)
                    vals.append(w * wx * wy * wz)
        sub = torch.zeros((s + 3) * g * g, dtype=w.dtype, device=w.device)
        sub = fixed_order_index_add(sub, torch.cat(cells), torch.cat(vals))
        sub = sub.reshape(s + 3, g, g)
        extra = self.mesh.ring(sub[s], 1)
        slab = sub[:s].clone()
        slab[0] += extra
        return slab

    def _readout(self, grid_p, rt: Routed, recv, shift: float):
        """Trilinear readout of an [S+1, G, G] slab (+1 upper ghost plane)
        at the routed positions."""
        g, s = self.pm.pmgrid, self.s
        cx, cy, cz = self._cells(rt.pos, shift)
        (bx0, wx0), (_, wx1) = cx
        bx0 = torch.clamp(bx0, 0, s - 1)       # padding rows clamp
        cx = ((bx0, wx0), (bx0 + 1, wx1))
        flat = grid_p.reshape(-1)
        out = torch.zeros(rt.pos.shape[0], dtype=grid_p.dtype,
                          device=grid_p.device)
        for bx, wx in cx:
            for by, wy in cy:
                for bz, wz in cz:
                    out = out + flat[(bx * g + by) * g + bz] * wx * wy * wz
        return torch.where(recv, out, 0.0)

    def _with_upper_ghost(self, field):
        up = self.mesh.ring(field[0].contiguous(), -1)
        return torch.cat([field, up[None]], dim=0)

    # ------------------------------------------------------------------
    def _rho_k(self, routes, sg: int):
        """This rank's y-chunk of the source gravity's density spectrum
        (interlaced: the phase-aligned average of both grids')."""
        rho = []
        for rt, shift in zip(routes, self.shifts):
            w = torch.where(rt.grav == sg, rt.mass, 0.0)
            rho.append(_fft_forward_sharded(self.mesh,
                                            self._cic_slab(rt, w, shift)))
        if len(rho) == 1:
            return rho[0]
        return 0.5 * (rho[0] + self.phase * rho[1]) * self.nyqmask

    def _grids(self, conv):
        """The real-space field of a k-space chunk on each grid."""
        g = self.pm.pmgrid
        out = [_fft_inverse_sharded(self.mesh, conv, g)]
        if len(self.shifts) > 1:
            out.append(_fft_inverse_sharded(
                self.mesh, conv * torch.conj(self.phase), g))
        return out

    def _recv(self, rt: Routed, tgs):
        recv = rt.grav == tgs[0]
        for tg in tgs[1:]:
            recv = recv | (rt.grav == tg)
        return recv & rt.valid

    def _route_all(self, pos, mass, grav):
        return [self._route_out(pos, mass, grav, sh) for sh in self.shifts]

    def forces(self, pos, mass, grav):
        """PM accelerations [n, 3] (times G) of this rank's particles."""
        g, box = self.pm.pmgrid, self.pm.box
        fac = self.pm.G / (math.pi * box) * (g ** 3)
        h = box / g
        s = self.s
        nl = len(self.shifts)
        routes = self._route_all(pos, mass, grav)
        racc = [torch.zeros(rt.pos.shape[0], 3, dtype=pos.dtype,
                            device=pos.device) for rt in routes]
        for sg in range(self.n_gravs):
            rho_k = self._rho_k(routes, sg)
            for tgs in self.pm.recv_groups[sg]:
                conv = rho_k * self.smth[tgs[0], sg]
                recvs = [self._recv(rt, tgs) for rt in routes]
                if self.pm.gradient == "spectral":
                    for dim in range(3):
                        fields = self._grids(1j * self.kvec[dim] * conv)
                        for i, (rt, sh) in enumerate(zip(routes,
                                                         self.shifts)):
                            a = self._readout(
                                self._with_upper_ghost(fields[i]), rt,
                                recvs[i], sh)
                            racc[i][:, dim] += a / nl * fac
                    continue
                for i, (psi, rt, sh) in enumerate(zip(self._grids(conv),
                                                      routes, self.shifts)):
                    psi_p = torch.cat([self.mesh.ring(psi[-2:].contiguous(),
                                                      1), psi,
                                       self.mesh.ring(psi[:2].contiguous(),
                                                      -1)], dim=0)
                    for dim in range(3):
                        # 4th-order centred difference (pm_periodic.c:686)
                        if dim == 0:
                            d1 = psi_p[3:s + 3] - psi_p[1:s + 1]
                            d2 = psi_p[4:s + 4] - psi_p[0:s]
                        else:
                            d1 = (torch.roll(psi, -1, dims=dim)
                                  - torch.roll(psi, 1, dims=dim))
                            d2 = (torch.roll(psi, -2, dims=dim)
                                  - torch.roll(psi, 2, dims=dim))
                        grad = (4.0 / 3 * d1 - 1.0 / 6 * d2) / (2 * h)
                        a = self._readout(self._with_upper_ghost(grad), rt,
                                          recvs[i], sh)
                        racc[i][:, dim] += a / nl * fac
        out = self._route_back(racc[0], routes[0])
        for rv, rt in zip(racc[1:], routes[1:]):
            out = out + self._route_back(rv, rt)
        return out

    def potential(self, pos, mass, grav):
        """PM potential [n] (times G) of this rank's particles
        (pmpotential_periodic, pm_periodic.c:798)."""
        g, box = self.pm.pmgrid, self.pm.box
        fac = self.pm.G / (math.pi * box) * (g ** 3)
        nl = len(self.shifts)
        routes = self._route_all(pos, mass, grav)
        rpot = [torch.zeros(rt.pos.shape[0], 1, dtype=pos.dtype,
                            device=pos.device) for rt in routes]
        for sg in range(self.n_gravs):
            rho_k = self._rho_k(routes, sg)
            for tgs in self.pm.recv_groups[sg]:
                fields = self._grids(rho_k * self.smth[tgs[0], sg])
                for i, (rt, sh) in enumerate(zip(routes, self.shifts)):
                    v = self._readout(self._with_upper_ghost(fields[i]), rt,
                                      self._recv(rt, tgs), sh)
                    rpot[i][:, 0] -= v / nl * fac
        out = self._route_back(rpot[0], routes[0])
        for rv, rt in zip(rpot[1:], routes[1:]):
            out = out + self._route_back(rv, rt)
        return out[:, 0]
