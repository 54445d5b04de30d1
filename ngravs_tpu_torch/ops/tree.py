"""Barnes-Hut octree build (port of `ngravs_tpu/ops/tree.py:53-465`).

Rebuild of the reference's `force_treebuild` (forcetree.c:61-763): particles
are Morton-sorted; every tree level is the set of occupied cells of a
uniform grid at that depth, found as runs of the sorted level keys, with
per-gravity monopoles (mass, CM, count — the ngravs extension of
forcetree.c:499-701) from one segmented reduction per level.  Particles
below their terminal (bucket) node are excluded from deeper levels.

The node layout, the leaf-chunk table and the walk target blocks are the
JAX package's exactly, so a tree built by either package can be walked by
the other (see `interop.octree_from_numpy`).  The float segment sums
(`fixed_order_index_add`) take an order fixed by the data, the same on
every device, so a build repeats bit for bit on the card and gives the
CPU's bits; node moments match the JAX package to f32 rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..trace import blocking
from .morton import (MAX_DEPTH, decode_center, level_key2, morton_keys2,
                     sort_by_keys2)

INT32_MAX = 2**31 - 1


class Octree(NamedTuple):
    """Linearized multi-level octree (levels concatenated; static offsets).

    Per-node tensors have length M = sum of per-level caps; invalid/padding
    nodes have pcount == 0.  Field meanings are those of the JAX package's
    `Octree` (ngravs_tpu/ops/tree.py:53-107)."""
    corner: torch.Tensor       # [3] root cell corner
    root_len: torch.Tensor     # scalar root cell side
    node_center: torch.Tensor  # [M,3]
    node_level: torch.Tensor   # [M] int32
    node_cm: torch.Tensor      # [M,NG,3]
    node_vel: torch.Tensor     # [M,NG,3] mass-weighted mean velocity
    node_mass: torch.Tensor    # [M,NG]
    node_count: torch.Tensor   # [M,NG] particle count per gravity
    node_maxsoft: torch.Tensor  # [M] max force-softening of members
    node_hmax: torch.Tensor    # [M] max SPH smoothing length of members
    node_start: torch.Tensor   # [M] int32 first sorted particle
    node_pcount: torch.Tensor  # [M] int32
    node_terminal: torch.Tensor  # [M] bool (bucket leaf: walk stops here)
    node_child0: torch.Tensor  # [M] int32
    node_nchild: torch.Tensor  # [M] int32
    node_parent: torch.Tensor  # [M] int32 (-1 at the root / invalid)
    node_chunk0: torch.Tensor  # [M] int32 first leaf chunk (real leaves)
    node_nchunk: torch.Tensor  # [M] int32 leaf chunk count
    leaf_row: torch.Tensor     # [N] int32 leaf-table row of each sorted particle
    n_chunk_rows: torch.Tensor  # scalar int32 leaf-table rows used
    blk_start: torch.Tensor    # [NGRP] int32 walk block first sorted index
    blk_cnt: torch.Tensor      # [NGRP] int32 particles in block (0 pad)
    blk_level: torch.Tensor    # [NGRP] int32 tree level of the group node
    n_blocks: torch.Tensor     # scalar int32 live blocks (> NGRP: overflow)
    pblk: torch.Tensor         # [N] int32 block id of each sorted particle
    order: torch.Tensor        # [N] int32 sorted -> original index
    pos_s: torch.Tensor        # [N,3]
    vel_s: torch.Tensor        # [N,3]
    mass_s: torch.Tensor       # [N]
    grav_s: torch.Tensor       # [N] int32
    fsoft_s: torch.Tensor      # [N]
    aold_s: torch.Tensor       # [N] ErrTolForceAcc * OldAcc (relative criterion)
    hsml_s: torch.Tensor       # [N] SPH smoothing length (0 for non-gas)
    khi_s: torch.Tensor        # [N] int32 sorted dual Morton keys
    klo_s: torch.Tensor        # [N] int32

    @property
    def n_nodes(self) -> int:
        return self.node_level.shape[0]


def level_caps(n: int, depth: int, max_nodes: int | None = None,
               bucket: int | None = None):
    """Per-level node caps: occupied cells <= min(8^l, N), and with `bucket`
    <= 8*ceil(N/(bucket+1)) + 8 (only non-terminal cells have children)."""
    caps = []
    for lvl in range(depth + 1):
        c = min(8**lvl, n)
        if bucket is not None:
            c = min(c, 8 * ((n + bucket) // (bucket + 1)) + 8)
        if max_nodes is not None:
            c = min(c, max_nodes)
        caps.append(((c + 7) // 8) * 8 if lvl else 1)
    return caps


def _p2(x: int, minimum: int) -> int:
    return max(minimum, 1 << int(math.ceil(math.log2(max(int(x), 1)))))


def fixed_order_index_add(out, index, src):
    """`out.index_add_(0, index, src)` with each slot's terms summed in an
    order fixed by the data alone, the same on every device (on a GPU
    `index_add_` is atomic and sums in the order threads arrive).  The
    terms are sorted stably by slot; a segmented inclusive scan (log2 n
    rounds of shifted adds within runs of one slot) leaves each run's sum
    at its last element, which is added to its slot.  torch's
    deterministic `index_add_` also repeats, but serialises each slot's
    run: 18x slower on a 2 x 64^3 tree build on an H100 (PERF.md §6)."""
    n = index.shape[0]
    if n == 0:
        return out
    order = torch.sort(index, stable=True).indices
    key = index[order]
    v = src[order]
    col = (-1,) + (1,) * (v.dim() - 1)
    d = 1
    while d < n:
        v[d:] += torch.where((key[d:] == key[:-d]).reshape(col), v[:-d], 0.0)
        d *= 2
    slots = torch.arange(out.shape[0], device=out.device)
    last = torch.clamp(torch.searchsorted(key, slots, right=True) - 1, min=0)
    out += torch.where((key[last] == slots).reshape(col), v[last], 0.0)
    return out


def _segment_sum(vals, seg, nseg: int):
    """Integer segment sums (exact in any order)."""
    out = torch.zeros((nseg,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg, vals)


def _counts(segc, cap: int):
    """Members per cell (slot `cap` collects the non-live particles); a
    scatter-add, so the device is not asked for the index maximum."""
    ones = torch.ones_like(segc, dtype=torch.int32)
    return _segment_sum(ones, segc, cap + 1)[:cap]


def _segment_max0(vals, seg, nseg: int):
    """Per-segment max, 0 for empty segments (callers mask those anyway)."""
    out = torch.zeros(nseg, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, "amax", include_self=False)


def _run_segments(hk, lk, live, cap: int):
    """Rank every live particle by the run of its (sorted) level key: the
    occupied cells of this level.  Returns (is_new, seg) with seg == cap for
    non-live particles."""
    n = hk.shape[0]
    change = torch.ones(n, dtype=torch.bool, device=hk.device)
    change[1:] = (hk[1:] != hk[:-1]) | (lk[1:] != lk[:-1])
    is_new = change & live
    seg = torch.cumsum(is_new, 0, dtype=torch.int64) - 1
    seg = torch.where(live, seg, cap)
    return is_new, seg


def _moments(mass_s, mpos, mvel, grav_s, seg, live, cap: int, n_gravs: int):
    """Per-(cell, gravity) mass, mass-weighted position and velocity sums,
    and member counts: one fixed-order sum of the eight columns."""
    nseg = cap * n_gravs + 1
    sid = torch.where(live, seg * n_gravs + grav_s.long(), cap * n_gravs)
    sid = sid.clamp(max=nseg - 1)
    cols = torch.cat([mass_s[:, None], mpos, mvel,
                      torch.ones_like(mass_s)[:, None]], dim=1)
    out = torch.zeros(nseg, 8, dtype=cols.dtype, device=cols.device)
    sums = fixed_order_index_add(out, sid, cols)[:-1].reshape(
        cap, n_gravs, 8)
    return sums[..., 0], sums[..., 1:4], sums[..., 4:7], sums[..., 7]


def _cm_vel(m_g, mx_g, mv_g, center):
    pos_m = m_g[..., None] > 0
    safe = torch.clamp(m_g[..., None], min=1e-37)
    cm = torch.where(pos_m, mx_g / safe, center[:, None, :])
    vbar = torch.where(pos_m, mv_g / safe, 0.0)
    return cm, vbar


def build_tree(pos, mass, grav, fsoft, aold, hsml=None,
               depth: int = 8, n_gravs: int = 1, bucket: int = 32,
               box_size: float = 0.0, group_size: int = 64,
               group_thresh: int | None = None,
               ngrp_cap: int | None = None, vel=None,
               corner=None, root_len=None) -> Octree:
    """Construct the octree (force_treebuild, forcetree.c:61-763).

    Periodic runs pass box_size > 0: the root cell is the box itself
    (positions already wrapped).  Otherwise the root is the particle
    bounding cube (domain_findExtent, domain.c:882), unless `corner` and
    `root_len` give it (a shard's tree on the global root cell)."""
    if depth > MAX_DEPTH:
        raise ValueError(f"depth {depth} > {MAX_DEPTH}")
    dev = pos.device
    n = pos.shape[0]
    if corner is not None:
        corner = torch.as_tensor(corner, dtype=pos.dtype, device=dev)
        root_len = torch.as_tensor(root_len, dtype=pos.dtype, device=dev)
    elif box_size > 0:
        corner = torch.zeros(3, dtype=pos.dtype, device=dev)
        root_len = blocking(torch.tensor, box_size, dtype=pos.dtype,
                            device=dev)
    else:
        lo = torch.amin(pos, dim=0)
        hi = torch.amax(pos, dim=0)
        root_len = torch.amax(hi - lo) * 1.0001 + 1e-30
        corner = (lo + hi) / 2 - root_len / 2
    inv_len = 1.0 / root_len

    if hsml is None:
        hsml = torch.zeros_like(mass)
    if vel is None:
        vel = torch.zeros_like(pos)
    khi, klo = morton_keys2(pos, corner, inv_len, depth)
    order = sort_by_keys2(khi, klo)
    khi_s, klo_s = khi[order], klo[order]
    pos_s, mass_s, vel_s = pos[order], mass[order], vel[order]
    grav_s = grav[order].to(torch.int32)
    fsoft_s, aold_s, hsml_s = fsoft[order], aold[order], hsml[order]

    caps = level_caps(n, depth, bucket=bucket)
    offsets = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)

    centers, levels, cms, masses, counts, maxsofts = [], [], [], [], [], []
    starts, pcounts, terminals, child0s, nchilds = [], [], [], [], []
    hmaxs, vels = [], []
    parents = [torch.full((1,), -1, dtype=torch.int32, device=dev)]
    prev = None  # (start_padded, pcount) of the previous level

    mpos = mass_s[:, None] * pos_s
    mvel = mass_s[:, None] * vel_s
    arange_n = torch.arange(n, dtype=torch.int64, device=dev)
    # shallowest terminal ancestor of each particle + rank within it
    term_node = torch.full((n,), -1, dtype=torch.int64, device=dev)
    term_rank = torch.zeros(n, dtype=torch.int64, device=dev)
    # shallowest GROUP ancestor: the walk's target blocks
    grp_node = torch.full((n,), -1, dtype=torch.int64, device=dev)
    gthr = max(group_thresh if group_thresh is not None
               else 4 * group_size, bucket)

    for lvl in range(depth + 1):
        cap = caps[lvl]
        hk, lk = level_key2(khi_s, klo_s, depth, lvl)
        live = term_node < 0
        is_new, seg = _run_segments(hk, lk, live, cap)
        # run heads write their cell's key and start; every other particle
        # writes the junk slot `cap`, which is cut off
        segc = seg.clamp(max=cap)
        sidx = torch.where(is_new, segc, cap)
        uniq_h = torch.full((cap + 1,), INT32_MAX, dtype=torch.int32,
                            device=dev)
        uniq_l = uniq_h.clone()
        uniq_h[sidx] = hk
        uniq_l[sidx] = lk
        uniq_h, uniq_l = uniq_h[:cap], uniq_l[:cap]
        # padding start = n so child ranges can be found by searchsorted
        start = torch.full((cap + 1,), n, dtype=torch.int32, device=dev)
        start[sidx] = arange_n.to(torch.int32)
        start = start[:cap]
        pcount = _counts(segc, cap)
        valid = pcount > 0
        m_g, mx_g, mv_g, c_g = _moments(mass_s, mpos, mvel, grav_s, seg,
                                        live, cap, n_gravs)
        msoft = torch.where(valid, _segment_max0(fsoft_s, segc, cap + 1)[:cap],
                            0.0)
        mhmax = torch.where(valid, _segment_max0(hsml_s, segc, cap + 1)[:cap],
                            0.0)

        center = decode_center(torch.where(valid, uniq_h, 0),
                               torch.where(valid, uniq_l, 0),
                               depth, lvl, corner, root_len)
        cm, vbar = _cm_vel(m_g, mx_g, mv_g, center)
        terminal = ((pcount <= bucket) | (lvl == depth)) & valid

        # assign particles to their shallowest terminal ancestor
        segk = seg.clamp(max=cap - 1)
        newly = live & terminal[segk]
        term_node = torch.where(newly, int(offsets[lvl]) + seg, term_node)
        term_rank = torch.where(newly, arange_n - start[segk].long(),
                                term_rank)
        # ... and to their shallowest GROUP ancestor (<= gthr particles)
        grouplike = valid & ((pcount <= gthr) | (lvl == depth))
        newly_g = (grp_node < 0) & grouplike[segk] & live
        grp_node = torch.where(newly_g, int(offsets[lvl]) + seg, grp_node)

        if prev is not None:
            # children of the previous level cover the same particle range:
            # find them by range position (starts ascend, padding at n)
            p_start, p_pcount = prev
            lo_c = torch.searchsorted(start, p_start).to(torch.int32)
            hi_c = torch.searchsorted(
                start, p_start + torch.clamp(p_pcount, min=1)).to(torch.int32)
            child0s.append(int(offsets[lvl]) + lo_c)
            nchilds.append(hi_c - lo_c)
            par = torch.searchsorted(p_start, start, right=True) \
                .to(torch.int32) - 1
            parents.append(torch.where(
                valid, int(offsets[lvl - 1]) + torch.clamp(par, min=0),
                -1).to(torch.int32))

        centers.append(center)
        levels.append(torch.full((cap,), lvl, dtype=torch.int32, device=dev))
        cms.append(cm)
        vels.append(vbar)
        masses.append(m_g)
        counts.append(c_g)
        maxsofts.append(msoft)
        hmaxs.append(mhmax)
        starts.append(torch.where(valid, start, 0))
        pcounts.append(pcount)
        terminals.append(terminal)
        prev = (start, pcount)

    # deepest level has no children
    child0s.append(torch.zeros(caps[depth], dtype=torch.int32, device=dev))
    nchilds.append(torch.zeros(caps[depth], dtype=torch.int32, device=dev))

    # leaf-chunk table layout over the real leaves (shallowest terminal
    # nodes): each owns ceil(pcount/8) aligned 8-row chunks
    pcount_all = torch.cat(pcounts)
    m_total = pcount_all.shape[0]
    real_leaf = torch.zeros(m_total, dtype=torch.bool, device=dev)
    blocking(real_leaf.__setitem__, term_node, True)
    nchunk = torch.where(real_leaf, (pcount_all + 7) // 8, 0).to(torch.int32)
    chunk0 = (torch.cumsum(nchunk, 0) - nchunk).to(torch.int32)
    leaf_row = (chunk0[term_node].long() * 8 + term_rank).to(torch.int32)
    n_chunk_rows = (torch.sum(nchunk) * 8).to(torch.int32)

    # walk target blocks: split every group node into ceil(pcount/G)
    # blocks of <= G consecutive sorted particles
    grp_node = torch.where(grp_node < 0, term_node, grp_node)
    start_all = torch.cat(starts)
    level_all = torch.cat(levels)
    ngrp = int(ngrp_cap) if ngrp_cap else _p2(max(n // 8, 1024), 1024)
    is_grp = torch.zeros(m_total, dtype=torch.bool, device=dev)
    blocking(is_grp.__setitem__, grp_node, True)
    nblk_n = torch.where(is_grp, (pcount_all + group_size - 1) // group_size,
                         0).to(torch.int64)
    blk_base = torch.cumsum(nblk_n, 0) - nblk_n
    n_blocks = torch.sum(nblk_n)
    # run id of every block slot; slots past the live blocks repeat the
    # last node, as jnp.repeat(total_repeat_length=...) does, and are
    # masked below
    runid = blocking(torch.repeat_interleave,
                     torch.arange(m_total, device=dev), nblk_n)[:ngrp]
    if runid.shape[0] < ngrp:
        runid = torch.cat([runid, torch.full((ngrp - runid.shape[0],),
                                             m_total - 1, device=dev)])
    giota = torch.arange(ngrp, device=dev)
    k_in = giota - blk_base[runid]
    live_b = giota < torch.clamp(n_blocks, max=ngrp)
    blk_start = torch.where(live_b, start_all[runid] + k_in * group_size,
                            n).to(torch.int32)
    blk_cnt = torch.where(
        live_b, torch.clamp(pcount_all[runid] - k_in * group_size,
                            0, group_size), 0).to(torch.int32)
    blk_level = torch.where(live_b, level_all[runid], 0).to(torch.int32)
    pblk = blk_base[grp_node] \
        + (arange_n - start_all[grp_node]) // group_size
    pblk = torch.clamp(pblk, max=ngrp - 1).to(torch.int32)

    return Octree(
        corner=corner, root_len=root_len,
        node_center=torch.cat(centers), node_level=torch.cat(levels),
        node_cm=torch.cat(cms), node_vel=torch.cat(vels),
        node_mass=torch.cat(masses), node_count=torch.cat(counts),
        node_maxsoft=torch.cat(maxsofts), node_hmax=torch.cat(hmaxs),
        node_start=torch.cat(starts), node_pcount=pcount_all,
        node_terminal=torch.cat(terminals),
        node_child0=torch.cat(child0s), node_nchild=torch.cat(nchilds),
        node_parent=torch.cat(parents),
        node_chunk0=chunk0, node_nchunk=nchunk, leaf_row=leaf_row,
        n_chunk_rows=n_chunk_rows,
        blk_start=blk_start, blk_cnt=blk_cnt, blk_level=blk_level,
        n_blocks=n_blocks.to(torch.int32), pblk=pblk,
        order=order.to(torch.int32), pos_s=pos_s, vel_s=vel_s,
        mass_s=mass_s, grav_s=grav_s, fsoft_s=fsoft_s, aold_s=aold_s,
        hsml_s=hsml_s, khi_s=khi_s, klo_s=klo_s)


def refresh_tree(tree: Octree, pos, mass, grav, fsoft, aold, hsml,
                 depth: int, n_gravs: int, bucket: int,
                 vel=None) -> Octree:
    """Re-aggregate node moments on the cached tree structure: cell
    assignment and children stay frozen (as the reference does not
    re-insert particles until the next domain decomposition, predict.c:83-90)
    while per-gravity CMs, masses, counts and softening/hmax maxima and the
    sorted particle fields are recomputed from the current positions."""
    n = pos.shape[0]
    order = tree.order.long()
    pos_s, mass_s = pos[order], mass[order]
    vel_s = vel[order] if vel is not None else torch.zeros_like(pos_s)
    grav_s = grav[order].to(torch.int32)
    fsoft_s, aold_s, hsml_s = fsoft[order], aold[order], hsml[order]
    mpos = mass_s[:, None] * pos_s
    mvel = mass_s[:, None] * vel_s
    caps = level_caps(n, depth, bucket=bucket)
    offsets = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)

    cms, masses, counts, maxsofts, hmaxs, vels = [], [], [], [], [], []
    done = torch.zeros(n, dtype=torch.bool, device=pos.device)
    for lvl in range(depth + 1):
        cap = caps[lvl]
        lsl = slice(int(offsets[lvl]), int(offsets[lvl + 1]))
        hk, lk = level_key2(tree.khi_s, tree.klo_s, depth, lvl)
        # the same live-masked run ranking as build_tree: the cached keys
        # reproduce the frozen cell/slot assignment
        live = ~done
        _, seg = _run_segments(hk, lk, live, cap)
        m_g, mx_g, mv_g, c_g = _moments(mass_s, mpos, mvel, grav_s, seg,
                                        live, cap, n_gravs)
        pc = tree.node_pcount[lsl]
        segc = seg.clamp(max=cap)
        msoft = torch.where(pc > 0, _segment_max0(fsoft_s, segc, cap + 1)[:cap],
                            0.0)
        mh = torch.where(pc > 0, _segment_max0(hsml_s, segc, cap + 1)[:cap],
                         0.0)
        cm, vbar = _cm_vel(m_g, mx_g, mv_g, tree.node_center[lsl])
        cms.append(cm)
        vels.append(vbar)
        masses.append(m_g)
        counts.append(c_g)
        maxsofts.append(msoft)
        hmaxs.append(mh)
        terminal = (_counts(segc, cap) <= bucket) \
            | (lvl == depth)
        done = done | (live & terminal[seg.clamp(max=cap - 1)])

    return tree._replace(
        node_cm=torch.cat(cms), node_vel=torch.cat(vels),
        node_mass=torch.cat(masses), node_count=torch.cat(counts),
        node_maxsoft=torch.cat(maxsofts), node_hmax=torch.cat(hmaxs),
        pos_s=pos_s, vel_s=vel_s, mass_s=mass_s, grav_s=grav_s,
        fsoft_s=fsoft_s, aold_s=aold_s, hsml_s=hsml_s)


def drift_tree(tree: Octree, dd) -> Octree:
    """Drift the tree between re-aggregations: node CMs move with their
    mass-weighted mean velocities and sorted particle positions with their
    own (the reference's dynamic tree updates, predict.c:83-90)."""
    return tree._replace(node_cm=tree.node_cm + tree.node_vel * dd,
                         pos_s=tree.pos_s + tree.vel_s * dd)


# ---------------------------------------------------------------------------
# Row compaction (ngravs_tpu/ops/tree.py:467-510): a cumsum gives each valid
# entry its slot; entries past the cap, and invalid ones, are written to one
# spare column that is cut off afterwards (the JAX scatter's mode="drop").
# Stable: valid entries keep their order.
# ---------------------------------------------------------------------------

def _put_rows(buf, idx, vals):
    """buf[b, :cap] with vals written at idx[b, k] <= cap (cap = spare)."""
    b, cap = buf.shape
    out = torch.cat([buf, buf.new_full((b, 1), -1)], dim=1)
    rows = torch.arange(b, device=buf.device)[:, None].expand_as(idx)
    out.index_put_((rows, idx), vals.to(out.dtype))
    return out[:, :cap]


def _compact_rows(vals, valid, out_size: int):
    """Push valid entries left in each row; pad with -1.  Returns
    ([B, out_size] values, [B] int32 valid counts, including those past
    out_size)."""
    pos = torch.cumsum(valid, dim=1) - 1
    idx = torch.where(valid, pos, out_size).clamp_(max=out_size)
    out = torch.full((vals.shape[0], out_size), -1, dtype=vals.dtype,
                     device=vals.device)
    return (_put_rows(out, idx, vals),
            valid.sum(dim=1, dtype=torch.int32))


def _append_rows(buf, n_in, new):
    """Append the valid entries of `new` (-1 = invalid) to each row of `buf`
    (n_in valid entries on the left).  Returns (buf', total counts
    including entries dropped past the cap)."""
    cap = buf.shape[1]
    valid = new >= 0
    pos = n_in[:, None].long() + torch.cumsum(valid, dim=1) - 1
    idx = torch.where(valid, pos, cap).clamp_(max=cap)
    return (_put_rows(buf, idx, new),
            n_in + valid.sum(dim=1, dtype=torch.int32))


def _append_rows2(buf_a, n_in, new_a, buf_b, new_b):
    """`_append_rows` of `new_a` with the co-indexed `new_b` written to a
    parallel buffer at the same positions."""
    cap = buf_a.shape[1]
    valid = new_a >= 0
    pos = n_in[:, None].long() + torch.cumsum(valid, dim=1) - 1
    idx = torch.where(valid, pos, cap).clamp_(max=cap)
    return (_put_rows(buf_a, idx, new_a), _put_rows(buf_b, idx, new_b),
            n_in + valid.sum(dim=1, dtype=torch.int32))
