"""Direct O(N^2) multi-gravity summation (port of `ngravs_tpu/ops/direct.py`).

The reference's direct summation (`force_treeevaluate_direct`,
forcetree.c:3428-3548): the accuracy oracle for the tree walk and the
small-N path of the solver.  Targets are processed in chunks of `chunk` rows;
each chunk evaluates all sources at once as a [chunk, Ns] tile, one pass per
unique law of the wiring.  In a periodic box every pair takes the minimum
image and, given the lattice tables, the Ewald correction
(forcetree.c:3471-3530): the exact periodic force, the oracle of TreePM.  A
target subset (`tgt_idx`) lets the oracle be sampled on a large system.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.wiring import GravityWiring


class ParticleSlice(NamedTuple):
    """A bundle of per-particle tensors for pairwise sums."""
    pos: torch.Tensor     # [n,3]
    mass: torch.Tensor    # [n]
    grav: torch.Tensor    # [n] int32
    fsoft: torch.Tensor   # [n] force softening h
    gid: torch.Tensor     # [n] int32 global index (-1 = padding)


def _min_image(dx, box):
    # as ngravs_tpu/ops/direct.py:43-44 writes it (the pair kernel
    # multiplies by 1/box instead)
    return dx - box * torch.round(dx / box)


def _pair_fac(wiring: GravityWiring, tm, sm, gt, gs, r2, r, h, nsrc,
              want_pot):
    """Force (and optionally potential) factor over a [C, Ns] tile, one pass
    per unique law, dispatched by (target, source) gravity masks."""
    groups = wiring.unique_laws()
    multi = len(groups) > 1
    fac = torch.zeros_like(r)
    pot = torch.zeros_like(r) if want_pot else None
    for law, slots in groups:
        f_k = law.force_factor(tm, sm, r2, r, h, nsrc)
        p_k = law.potential_factor(tm, sm, r2, r, h, nsrc) if want_pot \
            else None
        if not multi:
            fac, pot = f_k, p_k
            continue
        mk = torch.zeros_like(r, dtype=torch.bool)
        for (i, j) in slots:
            mk = mk | ((gt[:, None] == i) & (gs[None, :] == j))
        fac = torch.where(mk, f_k, fac)
        if want_pot:
            pot = torch.where(mk, p_k, pot)
    return fac, pot


def pairwise_forces(wiring: GravityWiring, tgt: ParticleSlice,
                    src: ParticleSlice, box: float = 0.0, chunk: int = 1024,
                    want_pot: bool = True, lattice_tables=None,
                    dtype=torch.float32):
    """Forces of all sources on all targets; returns (acc [Nt,3], pot [Nt]).

    G=1 (the caller multiplies, as in gravtree.c:337-341); the potential
    uses the tree-walk sign convention (negative for attraction).  Self
    pairs are excluded by gid equality; padding rows (gid == -1) get zeros.
    `box` > 0 takes the minimum image; `lattice_tables`
    (`lattice.build_lattice_tables`) add the Ewald correction.  `dtype`:
    the arithmetic's (float64 for an oracle whose own rounding must stay
    below the error it measures).
    """
    nt = tgt.pos.shape[0]
    if dtype != torch.float32:
        cast = lambda s: s._replace(pos=s.pos.to(dtype),
                                    mass=s.mass.to(dtype),
                                    fsoft=s.fsoft.to(dtype))
        tgt, src = cast(tgt), cast(src)
        if lattice_tables is not None:
            lattice_tables = lattice_tables.to(dtype)
    if lattice_tables is not None:
        from .lattice import corner_table, lattice_correction
        corners = corner_table(lattice_tables)
    acc = torch.zeros(nt, 3, dtype=dtype, device=tgt.pos.device)
    pot = torch.zeros(nt, dtype=dtype, device=tgt.pos.device)
    for c0 in range(0, nt, chunk):
        sl = slice(c0, min(c0 + chunk, nt))
        pt = tgt.pos[sl]
        tgid = tgt.gid[sl]
        # per-axis [C,Ns] planes; accumulate against dx directly (the
        # matmul form cancels catastrophically in f32 for |x| >> |dx|)
        dxs = [src.pos[None, :, d] - pt[:, None, d] for d in range(3)]
        if box > 0:
            dxs = [_min_image(d, box) for d in dxs]
        r2 = dxs[0] * dxs[0] + dxs[1] * dxs[1] + dxs[2] * dxs[2]
        r = torch.sqrt(r2)
        h = torch.maximum(tgt.fsoft[sl][:, None], src.fsoft[None, :])
        valid = (tgid[:, None] >= 0) & (tgid[:, None] != src.gid[None, :]) \
            & (src.gid[None, :] >= 0)
        fac, p = _pair_fac(wiring, tgt.mass[sl][:, None], src.mass[None, :],
                           tgt.grav[sl], src.grav, r2, r, h,
                           torch.ones_like(r), want_pot)
        fac = torch.where(valid, fac, 0.0)
        acc[sl] = torch.stack([torch.sum(fac * dxs[d], dim=-1)
                               for d in range(3)], dim=-1)
        if want_pot:
            pot[sl] = torch.sum(torch.where(valid, p, 0.0), dim=1)
        if lattice_tables is not None:
            # the periodic lattice (Ewald) correction of every pair
            pidx = tgt.grav[sl][:, None].long() * wiring.n_gravs \
                + src.grav[None, :].long()
            fc = lattice_correction(
                lattice_tables, 2 * (lattice_tables.shape[1] - 1) / box,
                dxs[0], dxs[1], dxs[2], pidx, corners)
            sm = torch.where(valid, src.mass[None, :], 0.0)
            acc[sl] += torch.stack([torch.sum(sm * fc[d], dim=-1)
                                    for d in range(3)], dim=-1)
            if want_pot:
                pot[sl] += torch.sum(sm * fc[3], dim=-1)
    return acc, pot


def direct_forces(wiring: GravityWiring, pos, mass, grav, fsoft,
                  tgt_idx: Optional[torch.Tensor] = None,
                  box: float = 0.0, chunk: int = 1024, want_pot: bool = True,
                  lattice_tables=None, dtype=torch.float32):
    """All-sources-on-selected-targets wrapper over `pairwise_forces`
    (`tgt_idx`: [Nt] global indices, -1 = padding)."""
    n = pos.shape[0]
    src = ParticleSlice(pos=pos, mass=mass, grav=grav, fsoft=fsoft,
                        gid=torch.arange(n, dtype=torch.int32,
                                         device=pos.device))
    if tgt_idx is None:
        tgt = src
    else:
        safe = tgt_idx.clamp(min=0).long()
        tgt = ParticleSlice(pos=pos[safe], mass=mass[safe], grav=grav[safe],
                            fsoft=fsoft[safe],
                            gid=torch.where(tgt_idx >= 0, safe, -1)
                            .to(torch.int32))
    return pairwise_forces(wiring, tgt, src, box=box, chunk=chunk,
                           want_pot=want_pot, lattice_tables=lattice_tables,
                           dtype=dtype)
