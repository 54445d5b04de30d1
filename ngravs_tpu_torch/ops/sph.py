"""SPH: density + smoothing-length iteration and entropy-formulation
hydrodynamic forces (port of `ngravs_tpu/ops/sph.py`; reference density.c,
hydra.c, ngb.c).

 * **Neighbour gathering** replaces the `ngb.c` range searches: gas targets
   are processed in Morton-contiguous blocks; a frontier walk over the
   octree keeps every node whose cell lies within the block's search radius
   (plus the node's own hmax for the symmetric "pairs" search,
   ngb_treefind_pairs, ngb.c:64-177) and dumps terminal nodes' particles
   into a per-block candidate list.  The lists are the JAX package's
   element for element (the same frontier order, the same compaction).

 * **Density** (`density_evaluate`, density.c:467-599): cubic-spline W/dW
   sums over the candidates masked by r < h_i, giving rho, weighted
   neighbour number, dhsml factor, div v and curl v.

 * **Smoothing-length iteration** (density.c:289-426): the Newton step with
   Left/Right bisection safeguards as a masked update; the host loops
   sweeps until every active gas particle's weighted neighbour count is
   within DesNumNgb +- MaxNumNgbDeviation.

 * **Hydro force** (`hydro_evaluate`, hydra.c:353-555): symmetric pressure
   + Monaghan-Balsara viscosity pair force with the Balsara switch, the
   viscosity limiter and signal-velocity tracking.

Under `jax.jit` XLA fuses the dense [blocks, G, S] intermediates of the two
passes.  In the port `density_pass` and `hydro_pass` take CUDA tensors to
K2, two hand-written kernels (`csrc/sph.cu`: one CTA a target block, which
loops over its own candidates and keeps its sums in registers), built with
nvcc for sm_90a at first use into `build/` and loaded through ctypes as
K1 is; each launch counts `k2.density` / `k2.hydro` in the trace of the
innermost open span.  CPU tensors take the plain twins
(`density_pass_torch`, `hydro_pass_torch`), which materialise the
intermediates and so run over chunks of target blocks whose working set
stays under a byte budget; every sum runs along S inside one block, so
the chunking changes no result.  There is no fallback from one to the
other.  The gather runs in chunks on either device; the host reads
nothing inside a chunk loop.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import NamedTuple

import torch

from ..constants import (KERNEL_COEFF_1, KERNEL_COEFF_2, KERNEL_COEFF_3,
                         KERNEL_COEFF_4, KERNEL_COEFF_5, KERNEL_COEFF_6)
from ..trace import Trace, blocking
from ..trace import current as current_trace
from . import pairwise
from .tree import Octree, _append_rows, _compact_rows

NORM_COEFF = 4.0 / 3 * math.pi   # allvars.h NORM_COEFF (volume of unit ball)
NUMDIMS = 3
MAXITER = 150                    # allvars.h:97
# working-set budgets of one chunk of target blocks, in bytes
PASS_BYTES = 2 << 30
GATHER_BYTES = 1 << 30
# [G, S] f32 temporaries alive at once in one block of each pass, and bytes
# per candidate slot of the gather (int64 positions, masks, copies)
_DENSITY_TEMPS, _HYDRO_TEMPS, _GATHER_SLOT_BYTES = 24, 48, 40


class Kernel(NamedTuple):
    """SPH kernel normalization (allvars.h:107-125): 3D by default;
    TWODIMS uses the 2D-normalized coefficients (x 5/7), NORM_COEFF = pi,
    and divides by the z column thickness (density.c:492-496)."""
    c1: float = KERNEL_COEFF_1
    c2: float = KERNEL_COEFF_2
    c3: float = KERNEL_COEFF_3
    c4: float = KERNEL_COEFF_4
    c5: float = KERNEL_COEFF_5
    c6: float = KERNEL_COEFF_6
    norm: float = NORM_COEFF
    ndims: int = 3
    zfac: float = 1.0            # 1/boxSize_Z under TWODIMS

    @staticmethod
    def twodims(box_z: float) -> "Kernel":
        f = 5.0 / 7
        return Kernel(c1=f * KERNEL_COEFF_1, c2=f * KERNEL_COEFF_2,
                      c3=f * KERNEL_COEFF_3, c4=f * KERNEL_COEFF_4,
                      c5=f * KERNEL_COEFF_5, c6=f * KERNEL_COEFF_6,
                      norm=math.pi, ndims=2,
                      zfac=1.0 / box_z if box_z > 0 else 1.0)


K3D = Kernel()


def _hinv_pow(hinv, k: Kernel):
    hinv3 = hinv * hinv * hinv if k.ndims == 3 else hinv * hinv * k.zfac
    return hinv3, hinv3 * hinv


def kernel_wk_dwk(u, hinv, k: Kernel = K3D):
    """Gadget's cubic spline W and dW at u = r/h (density.c:541-550)."""
    hinv3, hinv4 = _hinv_pow(hinv, k)
    lo_wk = hinv3 * (k.c1 + k.c2 * (u - 1) * u * u)
    lo_dwk = hinv4 * u * (k.c3 * u - k.c4)
    omu = 1.0 - u
    hi_wk = hinv3 * k.c5 * omu * omu * omu
    hi_dwk = hinv4 * k.c6 * omu * omu
    wk = torch.where(u < 0.5, lo_wk, hi_wk)
    dwk = torch.where(u < 0.5, lo_dwk, hi_dwk)
    inside = u < 1.0
    return torch.where(inside, wk, 0.0), torch.where(inside, dwk, 0.0)


def _box3(box):
    """Normalize a box spec to a per-axis tuple or None (non-periodic)."""
    if box is None:
        return None
    if isinstance(box, (int, float)):
        return (float(box),) * 3 if box > 0 else None
    t = tuple(float(b) for b in box)
    return t if any(b > 0 for b in t) else None


def _min_image(dxs, box):
    """Minimum image per periodic axis.  torch.round, like jnp.round,
    rounds half to even; the divisor is a tensor on the data's device so
    the card divides too (a host scalar would become a reciprocal
    multiply)."""
    b = _box3(box)
    if b is None:
        return dxs
    out = []
    for i, d in enumerate(dxs):
        if b[i] > 0:
            bt = blocking(torch.tensor, b[i], dtype=d.dtype,
                          device=d.device)
            d = d - b[i] * torch.round(d / bt)
        out.append(d)
    return out


def _chunks(nb: int, per_block: int, budget: int, block_chunk):
    """Slices of target blocks whose working set fits `budget` bytes (or
    `block_chunk` blocks each when given)."""
    cb = block_chunk or max(1, budget // max(per_block, 1))
    return [slice(c0, min(c0 + cb, nb)) for c0 in range(0, nb, cb)]


class SphCandidates(NamedTuple):
    cand: torch.Tensor      # [nb, CAP] int32 sorted-particle indices (-1 pad)
    n_cand: torch.Tensor    # [nb] int32
    overflow: torch.Tensor  # scalar bool
    max_cand: torch.Tensor  # scalar int32


def make_sph_gather(depth: int, bucket: int, cand_cap: int = 4096,
                    frontier_cap: int = 2048, box_size=0.0,
                    group_size: int = 64, pairs: bool = False,
                    block_chunk: int | None = None):
    """Per-block neighbour-candidate gather over the octree.

    pairs=False: candidates within `radius` of the block bbox (gather mode,
    ngb_treefind_variable).  pairs=True: also open nodes whose own hmax
    reaches the block (scatter-aware, ngb_treefind_pairs).  `box_size` may
    be a scalar or a per-axis (bx, by, bz) tuple (ngb.c:22-49)."""
    box = _box3(box_size)
    width = cand_cap // max(bucket, 1) + frontier_cap
    slots = max(width * bucket, min(8 ** depth, frontier_cap) * 8)

    def bbox_gap(point, lo_b, hi_b):
        g = torch.maximum(lo_b - point, point - hi_b)
        if box is not None:
            bv = blocking(torch.tensor, box, dtype=point.dtype,
                          device=point.device)
            gp = torch.maximum(lo_b - point - bv, point + bv - hi_b)
            gm = torch.maximum(lo_b - point + bv, point - bv - hi_b)
            g = torch.minimum(g, torch.minimum(gp, gm))
        return g

    def gather_blocks(tree: Octree, tgt_sorted, radius):
        nb = tgt_sorted.shape[0]
        dev = tgt_sorted.device
        safe = torch.clamp(tgt_sorted, min=0).long()
        tvalid = tgt_sorted >= 0
        tpos = tree.pos_s[safe]
        big = blocking(torch.tensor, 1e30, dtype=tpos.dtype, device=dev)
        lo = torch.amin(torch.where(tvalid[..., None], tpos, big), dim=1)
        hi = torch.amax(torch.where(tvalid[..., None], tpos, -big), dim=1)
        rad = torch.amax(torch.where(tvalid, radius, 0.0), dim=1)   # [nb]

        leaf_list = torch.full((nb, width), -1, dtype=torch.int32,
                               device=dev)
        n_leaves = torch.zeros(nb, dtype=torch.int32, device=dev)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        frontier = torch.zeros((nb, 1), dtype=torch.int32, device=dev)
        j8 = torch.arange(8, dtype=torch.int32, device=dev)
        for lvl in range(depth + 1):
            f = frontier.shape[1]
            nvalid = frontier >= 0
            nid = torch.clamp(frontier, min=0).long()
            center = tree.node_center[nid]
            terminal = tree.node_terminal[nid]
            cell_len = tree.root_len / (1 << lvl)
            gap = bbox_gap(center, lo[:, None, :], hi[:, None, :])
            reach = rad[:, None, None] + 0.5 * cell_len
            if pairs:
                reach = reach + tree.node_hmax[nid][..., None]
            near = torch.all(gap <= reach, dim=-1) & nvalid
            leaf_here = near & terminal
            expand = near & ~terminal
            leaf_list, n_leaves = _append_rows(
                leaf_list, n_leaves, torch.where(leaf_here, frontier, -1))
            if lvl < depth:
                c0 = tree.node_child0[nid]
                nc = tree.node_nchild[nid]
                cand_f = c0[..., None] + j8
                cvalid = expand[..., None] & (j8 < nc[..., None])
                nxt = min(8 ** (lvl + 1), frontier_cap)
                frontier, fcount = _compact_rows(
                    cand_f.reshape(nb, f * 8), cvalid.reshape(nb, f * 8), nxt)
                overflow = overflow | torch.any(fcount > nxt)
        overflow = overflow | torch.any(n_leaves > width)

        # expand leaves into particle candidates (gas only: hsml > 0)
        llv = leaf_list >= 0
        lls = torch.clamp(leaf_list, min=0).long()
        lstart = tree.node_start[lls]
        lcount = torch.where(llv, tree.node_pcount[lls], 0)
        jj = torch.arange(bucket, dtype=torch.int32, device=dev)
        pidx = lstart[..., None] + jj
        pvalid = llv[..., None] & (jj < lcount[..., None])
        pvalid = pvalid & (tree.hsml_s[torch.clamp(
            pidx, max=tree.hsml_s.shape[0] - 1).long()] > 0)
        pidx = torch.where(pvalid, pidx, -1).reshape(nb, -1)
        cand, n_cand = _compact_rows(pidx, pidx >= 0, cand_cap)
        overflow = overflow | torch.any(n_cand > cand_cap)
        return cand, n_cand, overflow

    def gather(tree: Octree, tgt_sorted, radius) -> SphCandidates:
        """tgt_sorted: [nb, G] sorted gas indices (-1 pad); radius: [nb, G]
        per-target search radii (h_i)."""
        parts = [gather_blocks(tree, tgt_sorted[sl], radius[sl])
                 for sl in _chunks(tgt_sorted.shape[0],
                                   slots * _GATHER_SLOT_BYTES, GATHER_BYTES,
                                   block_chunk)]
        cand = torch.cat([c for c, _, _ in parts])
        n_cand = torch.cat([n for _, n, _ in parts])
        overflow = torch.stack([o for _, _, o in parts]).any()
        return SphCandidates(cand, n_cand, overflow, torch.amax(n_cand))

    return gather


def _density_blocks(tree: Octree, tgt_sorted, hsml, vel_pred_t, cand,
                    vel_pred_all, box_size, kernel: Kernel):
    safe_t = torch.clamp(tgt_sorted, min=0).long()
    tpos = tree.pos_s[safe_t]                       # [nb,G,3]
    sv = torch.clamp(cand, min=0).long()
    cvalid = cand >= 0
    spos = tree.pos_s[sv]                           # [nb,S,3]
    smass = torch.where(cvalid, tree.mass_s[sv], 0.0)
    svel = vel_pred_all[sv]                         # [nb,S,3]

    dxs = [tpos[:, :, None, d] - spos[:, None, :, d] for d in range(3)]
    dxs = _min_image(dxs, box_size)
    r2 = dxs[0] ** 2 + dxs[1] ** 2 + dxs[2] ** 2    # [nb,G,S]
    r = torch.sqrt(r2)
    hinv = 1.0 / torch.clamp(hsml, min=1e-30)
    u = r * hinv[:, :, None]
    wk, dwk = kernel_wk_dwk(u, hinv[:, :, None], kernel)
    inside = (u < 1.0) & cvalid[:, None, :] & (tgt_sorted >= 0)[:, :, None]
    wk = torch.where(inside, wk, 0.0)
    dwk = torch.where(inside, dwk, 0.0)

    m = smass[:, None, :]
    rho = torch.sum(m * wk, dim=-1)
    hinv3_t, _ = _hinv_pow(hinv, kernel)    # weighted ngb = norm*wk/hinv3
    wngb = kernel.norm * torch.sum(wk, dim=-1) \
        / torch.clamp(hinv3_t, min=1e-37)
    dhsml = torch.sum(-m * (kernel.ndims * hinv[:, :, None] * wk + u * dwk),
                      dim=-1)
    fac = torch.where(r > 0, m * dwk / torch.clamp(r, min=1e-30), 0.0)
    dvs = [vel_pred_t[:, :, None, d] - svel[:, None, :, d] for d in range(3)]
    vdotr = dxs[0] * dvs[0] + dxs[1] * dvs[1] + dxs[2] * dvs[2]
    divv = -torch.sum(fac * vdotr, dim=-1)
    rotv = torch.stack([
        torch.sum(fac * (dxs[2] * dvs[1] - dxs[1] * dvs[2]), dim=-1),
        torch.sum(fac * (dxs[0] * dvs[2] - dxs[2] * dvs[0]), dim=-1),
        torch.sum(fac * (dxs[1] * dvs[0] - dxs[0] * dvs[1]), dim=-1)],
        dim=-1)
    return rho, wngb, dhsml, divv, rotv


def density_pass(tree: Octree, tgt_sorted, hsml, vel_pred_t,
                 cands: SphCandidates, vel_pred_all, box_size=0.0,
                 kernel: Kernel = K3D):
    """Density sums for gas targets (density_evaluate, density.c:467-599).

    tgt_sorted [nb,G] sorted indices; hsml [nb,G]; vel_pred_t [nb,G,3];
    cands [nb,S] sorted candidate indices; vel_pred_all [N,3] in SORTED
    order.  Returns (rho, wngb, dhsml, divv, rotv[3]) each [nb,G].  CUDA
    tensors launch K2's density kernel, CPU tensors take
    `density_pass_torch`."""
    if tgt_sorted.device.type == "cpu":
        return density_pass_torch(tree, tgt_sorted, hsml, vel_pred_t, cands,
                                  vel_pred_all, box_size, kernel)
    return _density_cuda(tree, tgt_sorted, hsml, vel_pred_t, cands,
                         vel_pred_all, box_size, kernel)


def density_pass_torch(tree: Octree, tgt_sorted, hsml, vel_pred_t,
                       cands: SphCandidates, vel_pred_all, box_size=0.0,
                       kernel: Kernel = K3D, block_chunk: int | None = None):
    """`density_pass`'s plain twin, on any device: `_density_blocks` over
    chunks of target blocks."""
    nb, g = tgt_sorted.shape
    per_block = _DENSITY_TEMPS * g * cands.cand.shape[1] * 4
    parts = [_density_blocks(tree, tgt_sorted[sl], hsml[sl], vel_pred_t[sl],
                             cands.cand[sl], vel_pred_all, box_size, kernel)
             for sl in _chunks(nb, per_block, PASS_BYTES, block_chunk)]
    return tuple(torch.cat(xs) for xs in zip(*parts))


def hsml_update(hsml, left, right, wngb, dhsml, rho, des_ngb, max_dev,
                min_hsml, active, ndims: int = 3):
    """One Newton/bisection smoothing-length update (density.c:289-426).

    Returns (hsml', left', right', converged)."""
    dhsml_fac = 1.0 / (1 + hsml * dhsml
                       / (ndims * torch.clamp(rho, min=1e-37)))
    low = wngb < des_ngb - max_dev      # too few neighbours -> grow
    high = wngb > des_ngb + max_dev     # too many -> shrink
    # window-collapse guard (density.c:321-328); a particle pinned at the
    # minimum smoothing length with too few neighbours also stops
    stuck = (left > 0) & (right > 0) & ((right - left) < 1e-3 * left)
    # too many neighbours at the minimum smoothing length cannot shrink:
    # stop (the || clause of density.c:326-328)
    bad = (low | (high & (hsml > 1.01 * min_hsml))) & ~stuck & active

    new_left = torch.where(bad & low, torch.maximum(hsml, left), left)
    new_right = torch.where(bad & high,
                            torch.where(right > 0, torch.minimum(hsml, right),
                                        hsml), right)

    # bisection when bracketed, else Newton-ish step (density.c:65-95)
    both = (new_left > 0) & (new_right > 0)
    h_bis = (0.5 * (new_left ** 3 + new_right ** 3)) ** (1.0 / 3)
    safe_newton = (torch.abs(wngb - des_ngb) < 0.5 * des_ngb) & \
        (torch.abs(dhsml_fac) <= 2.0)  # guard wild derivative
    h_newt = hsml * (1 - (wngb - des_ngb)
                     / (ndims * torch.clamp(wngb, min=1e-30)) * dhsml_fac)
    h_grow = torch.where(safe_newton & (new_right == 0), h_newt, hsml * 1.26)
    h_shrink = torch.where(safe_newton & (new_left == 0), h_newt,
                           hsml / 1.26)
    h_new = torch.where(both, h_bis,
                        torch.where(new_right == 0, h_grow, h_shrink))
    h_new = torch.clamp(h_new, min=min_hsml)
    hsml = torch.where(bad, h_new, hsml)
    return hsml, new_left, new_right, ~bad


def _hydro_blocks(tree: Octree, tgt_sorted, cand, hsml_all, rho_all,
                  pres_all, f_all, vel_all, csnd_all, divv_all, curl_all,
                  dt_all, fac_mu, fac_vsic_fix, hubble_a2, visc_const,
                  box_size, use_limiter: bool, kernel: Kernel):
    safe_t = torch.clamp(tgt_sorted, min=0).long()
    tvalid = tgt_sorted >= 0
    tpos = tree.pos_s[safe_t]
    h_i = hsml_all[safe_t]
    rho_i = rho_all[safe_t]
    p_over_rho2_i = pres_all[safe_t] / torch.clamp(rho_i, min=1e-37) ** 2 \
        * f_all[safe_t]
    cs_i = csnd_all[safe_t]
    vel_i = vel_all[safe_t]
    # Balsara switch f1 (hydra.c:380-382)
    f1 = torch.abs(divv_all[safe_t]) / (
        torch.abs(divv_all[safe_t]) + curl_all[safe_t]
        + 0.0001 * cs_i / fac_mu / torch.clamp(h_i, min=1e-30))
    dt_i = dt_all[safe_t]

    sv = torch.clamp(cand, min=0).long()
    cvalid = cand >= 0
    spos = tree.pos_s[sv]
    smass = tree.mass_s[sv]
    h_j = hsml_all[sv]
    rho_j = rho_all[sv]
    p_over_rho2_j = pres_all[sv] / torch.clamp(rho_j, min=1e-37) ** 2
    cs_j = csnd_all[sv]
    vel_j = vel_all[sv]
    f2 = torch.abs(divv_all[sv]) / (
        torch.abs(divv_all[sv]) + curl_all[sv]
        + 0.0001 * cs_j / fac_mu / torch.clamp(h_j, min=1e-30))
    dt_j = dt_all[sv]

    dxs = [tpos[:, :, None, d] - spos[:, None, :, d] for d in range(3)]
    dxs = _min_image(dxs, box_size)
    r2 = dxs[0] ** 2 + dxs[1] ** 2 + dxs[2] ** 2
    r = torch.sqrt(r2)
    notself = sv[:, None, :] != safe_t[:, :, None]
    pairmask = ((r2 < h_i[:, :, None] ** 2) | (r2 < h_j[:, None, :] ** 2)) \
        & cvalid[:, None, :] & tvalid[:, :, None] & notself

    dvs = [vel_i[:, :, None, d] - vel_j[:, None, :, d] for d in range(3)]
    vdotr = dxs[0] * dvs[0] + dxs[1] * dvs[1] + dxs[2] * dvs[2]
    vdotr2 = vdotr + hubble_a2 * r2

    hinv_i = 1.0 / torch.clamp(h_i, min=1e-30)
    u_i = r * hinv_i[:, :, None]
    _, dwk_i = kernel_wk_dwk(u_i, hinv_i[:, :, None], kernel)
    dwk_i = torch.where(r2 < h_i[:, :, None] ** 2, dwk_i, 0.0)
    hinv_j = 1.0 / torch.clamp(h_j, min=1e-30)
    u_j = r * hinv_j[:, None, :]
    _, dwk_j = kernel_wk_dwk(u_j, hinv_j[:, None, :], kernel)
    dwk_j = torch.where(r2 < h_j[:, None, :] ** 2, dwk_j, 0.0)

    cs_sum = cs_i[:, :, None] + cs_j[:, None, :]
    r_safe = torch.clamp(r, min=1e-30)
    mu_ij = fac_mu * vdotr2 / r_safe                       # negative
    vsig = cs_sum - 3 * mu_ij
    approaching = (vdotr2 < 0) & pairmask
    max_signal = torch.amax(torch.where(pairmask, cs_sum, 0.0), dim=-1)
    max_signal = torch.maximum(
        max_signal, torch.amax(torch.where(approaching, vsig, 0.0), dim=-1))

    rho_ij = 0.5 * (rho_i[:, :, None] + rho_j[:, None, :])
    visc = 0.25 * visc_const * vsig * (-mu_ij) \
        / torch.clamp(rho_ij, min=1e-37) \
        * (f1[:, :, None] + f2[:, None, :])
    dwk_sum = dwk_i + dwk_j
    if use_limiter:
        # viscosity limiter (hydra.c:513-519); dropped under
        # NOVISCOSITYLIMITER (hydra.c:511)
        dt_pair = torch.maximum(dt_i[:, :, None], dt_j[:, None, :])
        lim_ok = (dt_pair > 0) & (dwk_sum < 0)
        m_sum = 0.5 * (tree.mass_s[safe_t][:, :, None] + smass[:, None, :])
        limiter = 0.5 * fac_vsic_fix * vdotr2 / (
            m_sum * torch.where(lim_ok, dwk_sum, -1.0)
            * r_safe * torch.where(dt_pair > 0, dt_pair, 1.0))
        visc = torch.where(lim_ok, torch.minimum(visc, limiter), visc)
    visc = torch.where(approaching, visc, 0.0)

    hfc_visc = 0.5 * smass[:, None, :] * visc * dwk_sum / r_safe
    hfc = hfc_visc + smass[:, None, :] * (
        p_over_rho2_i[:, :, None] * dwk_i
        + (p_over_rho2_j * f_all[sv])[:, None, :] * dwk_j) / r_safe
    hfc = torch.where(pairmask, hfc, 0.0)
    hfc_visc = torch.where(pairmask, hfc_visc, 0.0)

    acc = torch.stack([-torch.sum(hfc * dxs[d], dim=-1) for d in range(3)],
                      dim=-1)
    dt_entropy = torch.sum(0.5 * hfc_visc * vdotr2, dim=-1)
    return acc, dt_entropy, max_signal


def hydro_pass(tree: Octree, tgt_sorted, cands: SphCandidates,
               hsml_all, rho_all, pres_all, f_all, vel_all, csnd_all,
               divv_all, curl_all, dt_all, fac_mu, fac_vsic_fix, hubble_a2,
               visc_const, box_size=0.0, use_limiter: bool = True,
               kernel: Kernel = K3D):
    """Hydro pair force (hydro_evaluate, hydra.c:353-555).

    All *_all arrays are in SORTED particle order (gathered by candidate
    index); per-target values are looked up through tgt_sorted.  The
    comoving factors are host floats.  Returns (acc [nb,G,3], dt_entropy
    [nb,G], max_signal_vel [nb,G]).  CUDA tensors launch K2's hydro
    kernel, CPU tensors take `hydro_pass_torch`."""
    args = (tree, tgt_sorted, cands, hsml_all, rho_all, pres_all, f_all,
            vel_all, csnd_all, divv_all, curl_all, dt_all, fac_mu,
            fac_vsic_fix, hubble_a2, visc_const, box_size, use_limiter,
            kernel)
    if tgt_sorted.device.type == "cpu":
        return hydro_pass_torch(*args)
    return _hydro_cuda(*args)


def hydro_pass_torch(tree: Octree, tgt_sorted, cands: SphCandidates,
                     hsml_all, rho_all, pres_all, f_all, vel_all, csnd_all,
                     divv_all, curl_all, dt_all, fac_mu, fac_vsic_fix,
                     hubble_a2, visc_const, box_size=0.0,
                     use_limiter: bool = True, kernel: Kernel = K3D,
                     block_chunk: int | None = None):
    """`hydro_pass`'s plain twin, on any device: `_hydro_blocks` over
    chunks of target blocks."""
    nb, g = tgt_sorted.shape
    per_block = _HYDRO_TEMPS * g * cands.cand.shape[1] * 4
    parts = [_hydro_blocks(tree, tgt_sorted[sl], cands.cand[sl], hsml_all,
                           rho_all, pres_all, f_all, vel_all, csnd_all,
                           divv_all, curl_all, dt_all, fac_mu, fac_vsic_fix,
                           hubble_a2, visc_const, box_size, use_limiter,
                           kernel)
             for sl in _chunks(nb, per_block, PASS_BYTES, block_chunk)]
    return tuple(torch.cat(xs) for xs in zip(*parts))


# ---------------------------------------------------------------------------
# K2: the two passes as CUDA kernels (csrc/sph.cu)
# ---------------------------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "sph.cu")
# every product and sum rounded on its own, as the twins' torch operations
_NVCC_FLAGS = ("-fmad=false",)
# the kernels' limits: targets a block, threads a CTA, lanes a target
MAX_GROUP, MAX_THREADS, MAX_LANES = 256, 256, 8
_lib = None


class _Spline(ctypes.Structure):
    _fields_ = [(c, ctypes.c_float) for c in
                ("c1", "c2", "c3", "c4", "c5", "c6", "zfac")] \
        + [("ndims", ctypes.c_int)]


class _HydroFactors(ctypes.Structure):
    _fields_ = [("fac_mu", ctypes.c_float), ("hubble_a2", ctypes.c_float),
                ("visc", ctypes.c_float), ("vsic", ctypes.c_float),
                ("use_limiter", ctypes.c_int)]


def build_library(verbose: bool = False) -> str:
    """Build `csrc/sph.cu` as K1 is built (`pairwise.build_library`,
    cached by content hash); returns the library's path."""
    return pairwise.build_library(verbose, src=_CSRC, flags=_NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ngravs_sph_density.restype = i
        lib.ngravs_sph_density.argtypes = (
            [p] * 8 + [i] * 4 + [ctypes.POINTER(_Spline)] + [f] * 3
            + [p, p])
        lib.ngravs_sph_hydro.restype = i
        lib.ngravs_sph_hydro.argtypes = (
            [p] * 14 + [i] * 4 + [ctypes.POINTER(_Spline)] + [f] * 3
            + [ctypes.POINTER(_HydroFactors), p, p])
        _lib = lib
    return _lib


def launch_lanes(group: int) -> int:
    """Threads a target in K2's CTA of one target block: the most, up to
    8, that keep the CTA within 256 threads (4 for the blocks of 64 of a
    tree group of 256).  Raises ValueError, before any launch, for a group
    the kernels do not take."""
    if not 0 < group <= MAX_GROUP:
        raise ValueError(f"K2 takes blocks of 1 to {MAX_GROUP} targets, "
                         f"not {group}")
    lanes = MAX_LANES
    while group * lanes > MAX_THREADS:
        lanes //= 2
    return lanes


def spline_args(kernel: Kernel) -> _Spline:
    """The `Kernel` tuple as K2 takes it: its six coefficients, zfac and
    ndims (norm stays with the wrapper's finishing step)."""
    return _Spline(kernel.c1, kernel.c2, kernel.c3, kernel.c4, kernel.c5,
                   kernel.c6, kernel.zfac, kernel.ndims)


def box_args(box_size) -> tuple:
    """The per-axis periodic box as K2 takes it, 0 for an open axis."""
    return _box3(box_size) or (0.0,) * 3


def hydro_args(fac_mu, fac_vsic_fix, hubble_a2, visc_const,
               use_limiter: bool) -> _HydroFactors:
    """The hydro pass's host floats as K2 takes them: the twin's scalar
    products 0.25 visc_const and 0.5 fac_vsic_fix in double precision,
    each rounded to float32 once, as torch rounds a Python scalar."""
    return _HydroFactors(fac_mu, hubble_a2, 0.25 * visc_const,
                         0.5 * fac_vsic_fix, int(bool(use_limiter)))


def _kernel_inputs(tensors: dict, dev):
    """The tensors a K2 launch reads, made contiguous; raises ValueError on
    a dtype, device or leading size the kernels do not take."""
    out = {}
    for name, (t, dtype, lead) in tensors.items():
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"K2: {name} must be {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if lead is not None and tuple(t.shape[:len(lead)]) != lead:
            raise ValueError(f"K2: {name} must be {list(lead)} + ..., got "
                             f"{list(t.shape)}")
        out[name] = t.contiguous()
    return out


def _cand_inputs(tgt_sorted, cands: SphCandidates, tree: Octree):
    """The inputs both kernels read; raises ValueError off the card."""
    if cands.n_cand is None or cands.cand.dim() != 2:
        raise ValueError("K2 reads [nb, S] candidates and their counts "
                         "n_cand")
    if tgt_sorted.device.type != "cuda":
        raise ValueError(f"no SPH kernel for device {tgt_sorted.device}")
    nb, g = tgt_sorted.shape
    i32, f32 = torch.int32, torch.float32
    n = tree.mass_s.shape[0]
    return dict(tgt=(tgt_sorted, i32, (nb, g)),
                cand=(cands.cand, i32, (nb,)),
                n_cand=(cands.n_cand, i32, (nb,)),
                pos=(tree.pos_s, f32, (n, 3)), mass=(tree.mass_s, f32, (n,)))


def _launch(fn, name: str, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"K2 {name} launch failed: cudaError {err}")
    tr = current_trace()
    if tr is not None:
        tr.count("k2." + name)


def _density_cuda(tree: Octree, tgt_sorted, hsml, vel_pred_t,
                  cands: SphCandidates, vel_pred_all, box_size,
                  kernel: Kernel):
    dev = tgt_sorted.device
    nb, g = tgt_sorted.shape
    n = tree.mass_s.shape[0]
    f32 = torch.float32
    x = _kernel_inputs(dict(
        _cand_inputs(tgt_sorted, cands, tree),
        vel=(vel_pred_all, f32, (n, 3)), hsml=(hsml, f32, (nb, g)),
        vel_t=(vel_pred_t, f32, (nb, g, 3))), dev)
    lanes = launch_lanes(g)
    out = torch.empty(nb, g, 7, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        _launch(_library().ngravs_sph_density, "density",
                x["pos"].data_ptr(), x["mass"].data_ptr(),
                x["vel"].data_ptr(), x["tgt"].data_ptr(),
                x["hsml"].data_ptr(), x["vel_t"].data_ptr(),
                x["cand"].data_ptr(), x["n_cand"].data_ptr(), nb, g,
                x["cand"].shape[1], lanes, ctypes.byref(spline_args(kernel)),
                *box_args(box_size), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    # the twin's finishing step (weighted ngb = norm * sum W / hinv^3)
    hinv = 1.0 / torch.clamp(hsml, min=1e-30)
    hinv3_t, _ = _hinv_pow(hinv, kernel)
    wngb = kernel.norm * out[..., 1] / torch.clamp(hinv3_t, min=1e-37)
    return out[..., 0], wngb, out[..., 2], out[..., 3], out[..., 4:7]


def _hydro_cuda(tree: Octree, tgt_sorted, cands: SphCandidates, hsml_all,
                rho_all, pres_all, f_all, vel_all, csnd_all, divv_all,
                curl_all, dt_all, fac_mu, fac_vsic_fix, hubble_a2,
                visc_const, box_size, use_limiter: bool, kernel: Kernel):
    dev = tgt_sorted.device
    nb, g = tgt_sorted.shape
    n = tree.mass_s.shape[0]
    f32 = torch.float32
    fields = dict(hsml=hsml_all, rho=rho_all, pres=pres_all, fdh=f_all,
                  vel=vel_all, csnd=csnd_all, divv=divv_all, curl=curl_all,
                  dt=dt_all)
    x = _kernel_inputs(dict(
        _cand_inputs(tgt_sorted, cands, tree),
        **{k: (v, f32, (n, 3) if k == "vel" else (n,))
           for k, v in fields.items()}), dev)
    lanes = launch_lanes(g)
    out = torch.empty(nb, g, 5, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        _launch(_library().ngravs_sph_hydro, "hydro",
                x["pos"].data_ptr(), x["mass"].data_ptr(),
                *(x[k].data_ptr() for k in fields), x["tgt"].data_ptr(),
                x["cand"].data_ptr(), x["n_cand"].data_ptr(), nb, g,
                x["cand"].shape[1], lanes, ctypes.byref(spline_args(kernel)),
                *box_args(box_size),
                ctypes.byref(hydro_args(fac_mu, fac_vsic_fix, hubble_a2,
                                        visc_const, use_limiter)),
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return out[..., 0:3], out[..., 3], out[..., 4]


# ---------------------------------------------------------------------------
# Orchestration (density() + hydro_force() drivers, density.c:56 / hydra.c:50)
# ---------------------------------------------------------------------------

def _bucket(n: int, minimum: int = 64) -> int:
    return max(minimum, 1 << math.ceil(math.log2(max(n, 1))))


def _scatter(dst, orig, valid, val):
    """dst with val written at the original indices of the valid targets
    (the JAX `.at[orig].set(mode="drop")` with padding at index N)."""
    out = dst.clone()

    def put():
        out[orig[valid]] = val[valid]
    blocking(put)
    return out


SPLIT_LEVEL = 3   # SPH target blocks stay within cells of this level


class HydroSolver:
    """Host-side driver for the SPH passes over the shared octree.

    `trace` (the run's timers and counters, a fresh one if not given)
    counts the passes: `sph.density_iters`, `sph.hydro_passes` and
    `sph.cap_growths`; the density iterations are the span `sph.density`,
    the hydro gather and pass `sph.hydro`."""

    def __init__(self, cfg, units, trace: Trace | None = None):
        self.cfg = cfg
        self.trace = trace if trace is not None else Trace()
        self.units = units
        self.min_gas_hsml = cfg.min_gas_hsml_fractional * \
            cfg.softening[0] * 2.8  # MinGasHsml (gravtree.c:517)
        self.group = cfg.tree_group_size // 4 or 64
        self.cand_cap = 4096
        self.frontier_cap = 2048
        # blocks kept within one cell of up to this level of the root
        # (None: the active gas blocked as it comes in sorted order).  A
        # block across a jump of the Morton curve (between two clumps, or
        # over a rank's domain) would span the gap, and its neighbour walk
        # would grow the candidate cap of every block
        # (tools/port_studies/sph_clumps.py)
        self.split_level = SPLIT_LEVEL
        # TWODIMS: 2D-normalized kernel, column density / boxSize_Z
        # (allvars.h:117-125, density.c:492-496)
        self.kernel = Kernel.twodims(cfg.box_sizes[2]) if cfg.twodims \
            else K3D

    def _gather(self, depth: int, pairs: bool):
        return make_sph_gather(
            depth=depth, bucket=self.cfg.tree_bucket_size,
            cand_cap=self.cand_cap, frontier_cap=self.frontier_cap,
            box_size=self.cfg.box_sizes, group_size=self.group, pairs=pairs)

    def _grow_cap(self, cands: SphCandidates):
        """The candidate cap, or, when the candidates fit and the walk's
        frontier overflowed (a block spread over a jump of the Morton
        curve), the frontier cap."""
        read = self.trace.read
        if int(read(cands.max_cand)) <= self.cand_cap:
            self.frontier_cap *= 2
        else:
            self.cand_cap = max(self.cand_cap * 2,
                                _bucket(int(read(cands.max_cand)) * 5 // 4))
        self.trace.count("sph.cap_growths")

    def _blocks(self, tree: Octree, p, ti_current, n_gas_active_max,
                mask=None):
        """Active-gas targets in sorted order, blocked [nb, G]; `mask`
        ([N] bool in the tree's sorted order) keeps a subset of them."""
        mask_s = (p.ti_endstep == ti_current)[tree.order.long()] \
            & (tree.hsml_s > 0)
        if mask is not None:
            mask_s = mask_s & mask
        if self.split_level is not None:
            return self._split_blocks(
                tree, self.trace.blocking(torch.nonzero, mask_s)
                .squeeze(1).to(torch.int32))
        size = _bucket(n_gas_active_max, self.group)
        tgt = self.trace.blocking(torch.nonzero, mask_s) \
            .squeeze(1).to(torch.int32)[:size]
        size += (-size) % self.group
        tgt = torch.cat([tgt, tgt.new_full((size - tgt.shape[0],), -1)])
        return tgt.reshape(-1, self.group)

    def split_level_for(self, n: int) -> int:
        """The level `_split_blocks` keeps n targets' blocks within: the
        deepest up to `split_level` whose cells hold 2 blocks or more on
        average, so that the padding stays a small part."""
        lvl = 0
        while lvl < self.split_level \
                and n >= 2 * self.group * 8 ** (lvl + 1):
            lvl += 1
        return lvl

    def _split_blocks(self, tree: Octree, tgt):
        """Sorted targets blocked so that no block straddles a cell of
        level `split_level_for(n)` of the root: each run of targets in one
        cell is padded to whole blocks.  A block across a jump of the
        Morton curve would span the box, and its neighbour walk would
        overflow the frontier (and grow the candidate cap for every
        block)."""
        g, n, dev = self.group, tgt.shape[0], tgt.device
        if n == 0:
            return tgt.new_full((1, g), -1)
        cells = 1 << self.split_level_for(n)
        c = torch.clamp(((tree.pos_s[tgt.long()] - tree.corner)
                         / tree.root_len * cells).long(), 0, cells - 1)
        new = torch.ones(n, dtype=torch.bool, device=dev)
        new[1:] = torch.any(c[1:] != c[:-1], dim=1)
        run = torch.cumsum(new, 0) - 1
        starts = self.trace.blocking(torch.nonzero, new).squeeze(1)
        lens = torch.diff(starts, append=self.trace.blocking(
            starts.new_tensor, [n]))
        padded = (lens + g - 1) // g * g
        slot = (torch.cumsum(padded, 0) - padded)[run] \
            + torch.arange(n, device=dev) - starts[run]
        out = tgt.new_full((int(self.trace.read(torch.sum(padded))),), -1)
        out[slot] = tgt
        return out.reshape(-1, g)

    def _targets(self, tree, p, ti_current, n_active, mask=None):
        tgt = self._blocks(tree, p, ti_current, n_active, mask)
        valid = tgt >= 0
        safe = torch.clamp(tgt, min=0).long()
        orig = torch.where(valid, tree.order.long()[safe], p.n)
        return tgt, valid, safe, orig

    # ------------------------------------------------------------------
    def density(self, tree: Octree, p, sph, ti_current, n_active, depth,
                tbi: float, mask=None, ghosts=None):
        """Smoothing-length iteration + density sums for active gas.

        `mask` ([N] bool, sorted order) keeps a subset of the active gas
        as targets, `n_active` bounding their count.  `ghosts(tgt, hsml,
        active)` adds the sums over neighbours the tree does not hold
        (a multi-device step's ghost rows): raw (rho, sum W, dhsml, div v,
        rot v [3]) a target, each [nb, G], every iteration.

        Returns the updated SphState (hsml, density, divvel, curlvel,
        dhsml factor, num_ngb, pressure)."""
        cfg = self.cfg
        box = cfg.box_sizes
        tgt, active, safe, orig = self._targets(tree, p, ti_current,
                                                n_active, mask)
        order = tree.order.long()
        hsml = torch.where(active, sph.hsml[order][safe], 0.0)
        vel_pred_all = sph.vel_pred[order]
        vpt = vel_pred_all[safe]
        left = torch.zeros_like(hsml)
        right = torch.zeros_like(hsml)
        rho = wngb = dhsml = divv = rotv = None

        tr = self.trace
        with tr.span("sph.density"):
            for _ in range(MAXITER):
                cands = self._gather(depth, False)(tree, tgt, hsml)
                if bool(tr.read(cands.overflow)):
                    self._grow_cap(cands)
                    continue
                rho, wngb, dhsml, divv, rotv = density_pass(
                    tree, tgt, hsml, vpt, cands, vel_pred_all, box_size=box,
                    kernel=self.kernel)
                if ghosts is not None:
                    grho, gwn, gdh, gdv, grv = ghosts(tgt, hsml, active)
                    rho, dhsml = rho + grho, dhsml + gdh
                    divv, rotv = divv + gdv, rotv + grv
                    hinv3, _ = _hinv_pow(1.0 / torch.clamp(hsml, min=1e-30),
                                         self.kernel)
                    wngb = wngb + self.kernel.norm * gwn \
                        / torch.clamp(hinv3, min=1e-37)
                tr.count("sph.density_iters")
                new_hsml, left, right, conv = hsml_update(
                    hsml, left, right, wngb, dhsml, rho,
                    float(cfg.des_num_ngb), float(cfg.max_num_ngb_deviation),
                    self.min_gas_hsml, active, ndims=self.kernel.ndims)
                done = bool(tr.read(torch.all(conv | ~active)))
                hsml = new_hsml
                if done:
                    break

        # finalize (density.c:289-308)
        rho_safe = torch.clamp(rho, min=1e-37)
        dhsml_fac = 1.0 / (1 + hsml * dhsml / (self.kernel.ndims * rho_safe))
        curl = torch.sqrt(torch.sum(rotv ** 2, dim=-1)) / rho_safe
        divv = divv / rho_safe
        oc = torch.clamp(orig, max=p.n - 1)
        ti_beg = p.ti_begstep[oc]
        ti_end = p.ti_endstep[oc]
        dt_entr = (ti_current - (ti_beg + ti_end) // 2).to(torch.float32) \
            * tbi
        pressure = (sph.entropy[oc] + sph.dt_entropy[oc] * dt_entr) \
            * rho_safe ** cfg.gamma

        def scat(dst, val):
            return _scatter(dst, orig, active, val)

        return sph.replace(
            hsml=scat(sph.hsml, hsml), density=scat(sph.density, rho),
            div_vel=scat(sph.div_vel, divv),
            curl_vel=scat(sph.curl_vel, curl),
            dhsml_density_factor=scat(sph.dhsml_density_factor, dhsml_fac),
            num_ngb=scat(sph.num_ngb, wngb),
            pressure=scat(sph.pressure, pressure))

    # ------------------------------------------------------------------
    def hydro_inputs(self, tree: Octree, p, sph, tbi: float,
                     time_now: float):
        """The per-particle fields of `hydro_pass` in sorted order (gas
        rows meaningful) and its comoving factors (fac_mu, fac_vsic_fix,
        hubble_a2): hydra.c:65-95."""
        cfg, units = self.cfg, self.units
        gm1 = cfg.gamma_minus1
        if cfg.comoving_integration:
            a = time_now
            h2 = (cfg.omega0 / a ** 3
                  + (1 - cfg.omega0 - cfg.omega_lambda) / a ** 2
                  + cfg.omega_lambda)
            hubble_a = units.hubble * math.sqrt(h2)
            facs = (a ** (3 * gm1 / 2) / a, hubble_a * a ** (3 * gm1),
                    a * a * hubble_a)
        else:
            facs = (1.0, 1.0, 1.0)
        order = tree.order.long()
        rho_all = torch.clamp(sph.density[order], min=1e-37)
        pres_all = sph.pressure[order]
        fields = (sph.hsml[order], rho_all, pres_all,
                  sph.dhsml_density_factor[order], sph.vel_pred[order],
                  torch.sqrt(cfg.gamma * pres_all / rho_all),
                  sph.div_vel[order], sph.curl_vel[order],
                  (p.ti_endstep[order] - p.ti_begstep[order])
                  .to(torch.float32) * tbi)
        return fields, facs

    def hydro(self, tree: Octree, p, sph, ti_current, n_active, depth,
              tbi: float, time_now: float, mask=None, ghosts=None):
        """Hydro force pass for active gas (hydro_force, hydra.c:50).
        `mask` as for `density`; `ghosts(tgt, safe, fields, facs)` adds
        the pair sums over ghost rows: (acc [nb, G, 3], dt_entropy,
        max_signal_vel), the last two [nb, G], before the finalisation."""
        cfg = self.cfg
        gm1 = cfg.gamma_minus1
        tgt, valid, safe, orig = self._targets(tree, p, ti_current, n_active,
                                               mask)
        fields, (fac_mu, fac_vsic_fix, hubble_a2) = self.hydro_inputs(
            tree, p, sph, tbi, time_now)
        hsml_all, rho_all = fields[0], fields[1]
        with self.trace.span("sph.hydro"):
            for _ in range(4):
                cands = self._gather(depth, True)(tree, tgt, hsml_all[safe])
                if not bool(self.trace.read(cands.overflow)):
                    break
                self._grow_cap(cands)
            acc, dtent, maxsig = hydro_pass(
                tree, tgt, cands, *fields, fac_mu, fac_vsic_fix, hubble_a2,
                cfg.art_bulk_visc_const, box_size=cfg.box_sizes,
                use_limiter=not cfg.no_viscosity_limiter, kernel=self.kernel)
            if ghosts is not None:
                gacc, gde, gms = ghosts(tgt, safe, fields,
                                        (fac_mu, fac_vsic_fix, hubble_a2))
                acc, dtent = acc + gacc, dtent + gde
                maxsig = torch.maximum(maxsig, gms)
        self.trace.count("sph.hydro_passes")
        # finalize (hydra.c:317-320) with the COMOVING density; under
        # IsothermEqs gamma-1 = 0 and DtEntropy stays 0
        rho_t = rho_all[safe]
        dtent = dtent * gm1 / (hubble_a2 * rho_t ** gm1)

        oc = torch.clamp(orig, max=p.n - 1)
        if cfg.sph_bnd_particles:
            # SPH_BND_PARTICLES (hydra.c:321-328): ID == 0 marks fixed
            # wall particles; no hydro acceleration or entropy change
            bnd = p.pid[oc] == 0
            acc = torch.where(bnd[..., None], 0.0, acc)
            dtent = torch.where(bnd, 0.0, dtent)

        return sph.replace(
            hydro_accel=_scatter(sph.hydro_accel, orig, valid, acc),
            dt_entropy=_scatter(sph.dt_entropy, orig, valid, dtent),
            max_signal_vel=_scatter(sph.max_signal_vel, orig, valid, maxsig))
