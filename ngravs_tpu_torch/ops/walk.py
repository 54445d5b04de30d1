"""Fused Barnes-Hut walk: octet traversal + K1 pair evaluation.

Port of `ngravs_tpu/ops/walk.py`, all of it: any wiring (with the
accumulator count rows), open or periodic boxes, the periodic pure-tree
walk with its lattice (Ewald) pass, and the TreePM short-range walk with
the closed-form truncation or, for a wiring with a law that has none, the
tabulated transition.  The production force path: the reference's hot
loop `force_treeevaluate` (forcetree.c:1244) as one pass over batches of
target blocks.

 1. **Octet traversal** — tree nodes are laid out in 8-aligned SIBLING
    OCTETS (all 8 child slots of a parent; `build_octet_layout`).  The
    level-synchronous frontier of each target block holds octet ids; every
    level gathers the frontier's octet rows, runs the conservative
    per-SUBGROUP opening tests of forcetree.c:1437-1473 (BH or relative
    criterion, plus the "intersects" rule), and each opened node emits its
    one child-octet id into the next frontier.
 2. **Unified 8-row chunk lists** — accepted octets (NG gravity-major
    monopole chunks with 8-bit row masks) and opened leaves (aligned
    particle chunks) become runs of chunks of one packed source table;
    each block's runs expand into a chunk list, and one gather fills the
    packed [B, 8, S] source buffer (masked rows get gid -1).
 3. **Pair evaluation** — the buffer goes to `pairwise_eval` (K1).
    Under TreePM whole subtrees beyond Rcut are discarded during the
    traversal (forcetree.c:1828-1862).

The table layouts, caps and overflow contract (`FusedWalkResult`) are the
JAX package's: a tree and its tables packed by either package are
bit-identical, and the interaction counts match exactly.  Caps are
per-block; exceeding one sets `.overflow` and the caller grows it
(the analog of Gadget growing TreeAllocFactor, forcetree.c:3176).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.wiring import GravityWiring
from ..trace import Trace, blocking
from .lattice import corner_table, lattice_correction, lattice_eval_cuda
from .pairwise import (FCOUNT, FMASS, FSOFT, FX, FY, FZ, IGID, IGRAV,
                       pairwise_eval)
from .shortrange import longrange_force_factor, longrange_pot_factor
from .tree import Octree, level_caps

INT32_MAX = 2**31 - 1
# target subgroups of a block, each with its own bounding box in the opening
# tests (the JAX walk's count: the same nodes open on both sides)
SUBGROUPS = 4

# walk-table columns (before the per-gravity block)
WCX, WCY, WCZ, WFLAGS, WCHOCT, WCHUNK0, WNCHUNK, WSOFT = range(8)
# working set of the torch passes over the packed buffer: chunks of target
# blocks whose f32 [G, S] temporaries (about _PASS_TEMPS of them live at a
# time) fit PASS_BYTES
PASS_BYTES = 1 << 30
_PASS_TEMPS = 80


def _rup(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bits(a: torch.Tensor) -> torch.Tensor:
    """int32 values as f32 bit patterns (a reinterpretation, never a cast)."""
    return a.to(torch.int32).view(torch.float32)


class WalkTables(NamedTuple):
    """Packed walk/source tables + octet layout, cacheable across steps
    (the layout depends only on the tree structure)."""
    slot8: torch.Tensor      # [M] int32 global octet slot (-1 dead)
    child_oct: torch.Tensor  # [M] int32 child octet id (-1 none)
    layout_ovf: torch.Tensor  # scalar bool
    wtab8: torch.Tensor      # [n_oct, 8*W] octet walk rows
    wvel8: torch.Tensor      # [n_oct, 8*NG*3] cm drift velocities
    gsrc: torch.Tensor       # [NC, 64] packed source rows (8 per chunk)
    gvel: torch.Tensor       # [NC, 24] source row drift velocities


class FusedWalkResult(NamedTuple):
    acc: torch.Tensor        # [Nt, 3] sorted-target order (G = 1)
    pot: torch.Tensor        # [Nt]
    ninteract: torch.Tensor  # [Nt] int32 valid pair interactions
    overflow: torch.Tensor   # scalar bool — any cap exceeded
    max_ent: torch.Tensor    # scalar peak per-block records
    max_chunk: torch.Tensor  # scalar peak per-block unified chunks
    max_rows: torch.Tensor   # scalar peak per-block mono octet records
    max_frontier: torch.Tensor  # [depth+1] peak per-level slots (8*oct)
    layout_ovf: torch.Tensor  # scalar bool — the octet layout overflowed


# ---------------------------------------------------------------------------
# Octet layout
# ---------------------------------------------------------------------------

def octet_counts(n: int, depth: int, bucket: int, octet_caps=None):
    """Per-level OCTET caps: octets at level l+1 = level-l nodes with
    children, each holding > bucket particles; `octet_caps` overrides with
    measured demand (tuple[depth+1])."""
    if octet_caps is not None:
        caps = [int(c) for c in octet_caps]
        if len(caps) != depth + 1:
            raise ValueError(f"octet_caps has {len(caps)} levels, "
                             f"depth is {depth}")
        return caps
    caps = level_caps(n, depth, bucket=bucket)
    nt_max = n // (bucket + 1) + 1
    noct = [1]
    for lvl in range(1, depth + 1):
        noct.append(max(1, min(8 ** (lvl - 1), caps[lvl - 1], nt_max)))
    return noct


def measure_octet_demand(tree: Octree, n: int, depth: int, bucket: int,
                         trace: Trace | None = None):
    """Actual octets per level of a built tree (one host fetch, through
    `trace` when given)."""
    caps = level_caps(n, depth, bucket=bucket)
    offs = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    has = (tree.node_nchild > 0) & (tree.node_pcount > 0)
    has = (trace.read(has) if trace is not None else has.cpu()).numpy()
    out = [1]
    for lvl in range(1, depth + 1):
        out.append(max(1, int(has[offs[lvl - 1]:offs[lvl]].sum())))
    return out


def frontier_slot_caps(n: int, depth: int, bucket: int, octet_caps=None):
    """Per-level frontier demand bounds in SLOT units (8 * octets)."""
    return [8 * c for c in octet_counts(n, depth, bucket, octet_caps)]


def build_octet_layout(tree: Octree, n: int, depth: int, bucket: int,
                       octet_caps=None):
    """Returns (slot8 [M] global slot id or -1, child_oct [M] global child
    octet id or -1, ovf bool).  Children of one parent occupy the 8 slots of
    one octet; a parent's octet rank is its rank among same-level nodes with
    children (build_tree packs child ranges in ascending parent order)."""
    dev = tree.node_pcount.device
    caps = level_caps(n, depth, bucket=bucket)
    offs = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    noct = octet_counts(n, depth, bucket, octet_caps)
    ooffs = np.concatenate([[0], np.cumsum(noct)]).astype(np.int64)
    m = int(offs[-1])

    slot8 = torch.full((m,), -1, dtype=torch.int32, device=dev)
    blocking(slot8.__setitem__, 0, 0)
    child_oct = torch.full((m,), -1, dtype=torch.int32, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for lvl in range(depth + 1):
        sl = slice(int(offs[lvl]), int(offs[lvl + 1]))
        valid = tree.node_pcount[sl] > 0
        if lvl < depth:
            has = (tree.node_nchild[sl] > 0) & valid
            crank = torch.cumsum(has, 0, dtype=torch.int32) - 1
            child_oct[sl] = torch.where(has & (crank < noct[lvl + 1]),
                                        int(ooffs[lvl + 1]) + crank, -1)
            ovf = ovf | (torch.sum(has) > noct[lvl + 1])
        if lvl >= 1:
            par = tree.node_parent[sl].long()
            pc = tree.node_center[par.clamp(min=0)]
            c = tree.node_center[sl]
            octant = ((c[:, 0] > pc[:, 0]).to(torch.int32)
                      | ((c[:, 1] > pc[:, 1]).to(torch.int32) << 1)
                      | ((c[:, 2] > pc[:, 2]).to(torch.int32) << 2))
            po = child_oct[par.clamp(min=0)]
            slot8[sl] = torch.where(valid & (par >= 0) & (po >= 0),
                                    8 * po + octant, -1)
    return slot8, child_oct, ovf


def walk_table_width(n_gravs: int, accumulator: bool = False) -> int:
    """Columns of the octet walk table, padded to a multiple of 8."""
    return _rup(8 + 4 * n_gravs + (n_gravs if accumulator else 0), 8)


def pack_walk_table8(tree: Octree, slot8, child_oct, n_gravs: int,
                     n_oct: int, accumulator: bool = False):
    """[n_oct, 8*W] octet walk table: center xyz, flags, child_oct, chunk0,
    nchunk, maxsoft, then per-gravity (cm xyz, mass) [, per-gravity
    count].  flags: bit0 terminal, bits 1..NG per-gravity mass>0, bits 8..
    node level.  Dead slots are all-zero.  Also the [n_oct, 8*NG*3] CM
    velocity table."""
    flags = tree.node_terminal.to(torch.int32)
    for g in range(n_gravs):
        flags = flags | ((tree.node_mass[:, g] > 0).to(torch.int32) << (1 + g))
    flags = flags | (tree.node_level << 8)
    cols = [tree.node_center[:, 0], tree.node_center[:, 1],
            tree.node_center[:, 2], _bits(flags), _bits(child_oct),
            _bits(tree.node_chunk0), _bits(tree.node_nchunk),
            tree.node_maxsoft]
    for g in range(n_gravs):
        cols += [tree.node_cm[:, g, 0], tree.node_cm[:, g, 1],
                 tree.node_cm[:, g, 2], tree.node_mass[:, g]]
    if accumulator:
        cols += [torch.clamp(tree.node_count[:, g], min=1.0)
                 for g in range(n_gravs)]
    w = walk_table_width(n_gravs, accumulator)
    cols += [torch.zeros_like(tree.node_maxsoft)] * (w - len(cols))
    m = tree.node_maxsoft.shape[0]
    # dead nodes write the junk row n_oct*8, which is cut off
    idx = torch.where(slot8 >= 0, slot8, n_oct * 8).long()
    tbl = torch.zeros(n_oct * 8 + 1, w, dtype=torch.float32,
                      device=slot8.device)
    tbl[idx] = torch.stack(cols, dim=1)
    vtbl = torch.zeros(n_oct * 8 + 1, n_gravs * 3, dtype=torch.float32,
                       device=slot8.device)
    vtbl[idx] = tree.node_vel.reshape(m, n_gravs * 3)
    return (tbl[:-1].reshape(n_oct, 8 * w),
            vtbl[:-1].reshape(n_oct, 8 * n_gravs * 3))


def source_table_layout(n: int, n_oct: int, n_gravs: int,
                        leaf_factor: float):
    """Row layout of the packed source table: leaf-particle chunks, then
    gravity-major octet monopole rows (row of (octet o, gravity g, slot s)
    = nstart + o*8*NG + g*8 + s), then 8 null + 8 junk rows."""
    cap2 = _rup(max(int(n * leaf_factor) + 8, n), 8)
    nstart = cap2
    rows = cap2 + n_oct * 8 * n_gravs + 16
    null_row = rows - 16
    return cap2, nstart, rows, null_row


def pack_source_table(tree: Octree, slot8, n_gravs: int, n_oct: int,
                      leaf_factor: float, accumulator: bool = False):
    """[R/8, 64] packed sources, 8 rows of x, y, z, mass, soft, count, grav,
    gid per chunk (grav/gid as int32 bit patterns).  Leaf particles sit in
    aligned 8-row chunks; node monopoles gravity-major per octet.  Also the
    [R/8, 24] row velocities."""
    dev = tree.pos_s.device
    n = tree.pos_s.shape[0]
    m = tree.node_mass.shape[0]
    ng = n_gravs
    cap2, _, rows, _ = source_table_layout(n, n_oct, ng, leaf_factor)
    neg1 = lambda k: torch.full((k,), -1, dtype=torch.int32, device=dev)

    # ---- leaf region: one row per sorted particle at its leaf row
    lr = torch.where(tree.leaf_row < cap2, tree.leaf_row, cap2).long()
    leaf = torch.zeros(cap2 + 1, 8, dtype=torch.float32, device=dev)
    leaf[:, IGID] = _bits(neg1(cap2 + 1))
    leaf[lr] = torch.stack(
        [tree.pos_s[:, 0], tree.pos_s[:, 1], tree.pos_s[:, 2], tree.mass_s,
         tree.fsoft_s, torch.ones_like(tree.mass_s), _bits(tree.grav_s),
         _bits(torch.arange(n, device=dev))], dim=1)
    lvel = torch.zeros(cap2 + 1, 3, dtype=torch.float32, device=dev)
    lvel[lr] = tree.vel_s

    # ---- mono region: row q = (o*NG + g)*8 + s gathers its node's moments
    slots_total = n_oct * 8
    inv_slot = torch.full((slots_total + 1,), m, dtype=torch.int64,
                          device=dev)
    inv_slot[torch.where(slot8 >= 0, slot8, slots_total).long()] = \
        torch.arange(m, device=dev)
    q = torch.arange(slots_total * ng, device=dev)
    o_q = q // (8 * ng)
    g_q = (q % (8 * ng)) // 8
    s_q = q % 8
    node = inv_slot[o_q * 8 + s_q]
    dead = node >= m
    nodec = node.clamp(max=m - 1)
    mg = torch.where(dead, 0.0, tree.node_mass[nodec, g_q])
    ok = ~dead & (mg > 0)
    cm = tree.node_cm[nodec, g_q]
    # the accumulator's count row: members per (node, gravity), >= 1
    cg = torch.clamp(torch.where(dead, 1.0, tree.node_count[nodec, g_q]),
                     min=1.0) if accumulator else torch.ones_like(mg)
    mono = torch.stack(
        [cm[:, 0], cm[:, 1], cm[:, 2], mg, tree.node_maxsoft[nodec],
         cg, _bits(g_q),
         _bits(torch.where(ok, -2, -1))], dim=1)
    mvel = torch.where(dead[:, None], 0.0, tree.node_vel[nodec, g_q])

    tail = torch.zeros(16, 8, dtype=torch.float32, device=dev)
    tail[:, IGID] = _bits(neg1(16))
    tbl = torch.cat([leaf[:cap2], mono, tail])
    vtbl = torch.cat([lvel[:cap2], mvel,
                      torch.zeros(16, 3, dtype=torch.float32, device=dev)])
    return tbl.reshape(rows // 8, 64), vtbl.reshape(rows // 8, 24)


def pack_walk_tables(tree: Octree, n: int, depth: int, bucket: int,
                     n_gravs: int, leaf_factor: float,
                     accumulator: bool = False, layout=None,
                     octet_caps=None) -> WalkTables:
    """Derive the octet layout (unless `layout` carries one from the same
    tree structure) and pack both tables."""
    n_oct = int(np.sum(octet_counts(n, depth, bucket, octet_caps)))
    if layout is None:
        layout = build_octet_layout(tree, n, depth, bucket, octet_caps)
    slot8, child_oct, oovf = layout
    gsrc, gvel = pack_source_table(tree, slot8, n_gravs, n_oct, leaf_factor,
                                   accumulator)
    wtab8, wvel8 = pack_walk_table8(tree, slot8, child_oct, n_gravs, n_oct,
                                    accumulator)
    return WalkTables(slot8=slot8, child_oct=child_oct, layout_ovf=oovf,
                      wtab8=wtab8, wvel8=wvel8, gsrc=gsrc, gvel=gvel)


def drift_walk_tables(wt: WalkTables, dd, n_gravs: int) -> WalkTables:
    """Drift the packed tables between re-aggregations
    (ngravs_tpu/ops/walk.py:398-418), the packed analog of the reference's
    dynamic tree update (predict.c:83-90): source rows move with their row
    velocities, the walk table's per-gravity CMs with the node CM
    velocities.  Cell centres, masses, softening and the grav/gid bit
    patterns are not touched."""
    gsrc = wt.gsrc.clone()
    rows = gsrc.view(-1, 8, 8)
    rows[:, :, 0:3] += wt.gvel.view(-1, 8, 3) * dd
    wtab8 = wt.wtab8.clone()
    n_oct = wtab8.shape[0]
    w = wtab8.shape[1] // 8
    cg = wtab8.view(n_oct, 8, w)[:, :, 8:8 + 4 * n_gravs] \
        .view(n_oct, 8, n_gravs, 4)
    cg[..., 0:3] += wt.wvel8.view(n_oct, 8, n_gravs, 3) * dd
    return wt._replace(gsrc=gsrc, wtab8=wtab8)


def normalize_frontier_caps(frontier_caps, depth: int):
    """Per-level frontier caps (SLOT units) as a tuple[depth+1];
    int -> clamped 8^l."""
    if isinstance(frontier_caps, (int, np.integer)):
        return tuple(min(int(frontier_caps), 8 ** min(lvl, 10))
                     for lvl in range(depth + 1))
    caps = tuple(int(c) for c in frontier_caps)
    if len(caps) != depth + 1:
        raise ValueError(f"frontier caps have {len(caps)} levels, "
                         f"depth is {depth}")
    return caps


# ---------------------------------------------------------------------------
# Torch passes over the packed [B, 8, S] buffer (the JAX walk runs both in
# XLA, outside its Pallas kernel: `pallas_ok`, ngravs_tpu/ops/walk.py:508)
# ---------------------------------------------------------------------------

def _block_chunks(nb: int, s: int, g: int, block_chunk):
    """Slices of target blocks whose temporaries fit PASS_BYTES (or
    `block_chunk` blocks each).  Every sum runs along S inside a block, so
    the chunking changes no bit."""
    cb = block_chunk or max(1, PASS_BYTES // (4 * _PASS_TEMPS * g * max(s, 1)))
    return [slice(c0, min(c0 + cb, nb)) for c0 in range(0, nb, cb)]


def _pair_geometry(targets, sp, sl, n_src, g, box_size):
    """Target columns [b, G, 1], the valid-pair mask and the (minimum
    image) displacements source - target [b, G, S] of a block chunk."""
    col = lambda k: targets[k].reshape(-1, g, 1)[sl]
    tgid = col("gid")
    sgid = sp[:, IGID, :].view(torch.int32)[:, None, :]
    live = torch.arange(sp.shape[2], device=sp.device)[None, None, :] \
        < n_src.reshape(-1, 1, 1)[sl]
    valid = live & (sgid != -1) & (tgid >= 0) & (sgid != tgid)
    d = [sp[:, None, f, :] - col(k) for f, k in ((FX, "x"), (FY, "y"),
                                                (FZ, "z"))]
    if box_size > 0:
        d = [x - box_size * torch.round(x * (1.0 / box_size)) for x in d]
    return col, valid, d


def tabulated_pair_eval(targets: dict, spacked: torch.Tensor,
                        n_src: torch.Tensor, want_pot: bool = True, *,
                        wiring, box_size: float, sr_ftab, sr_ptab,
                        asmth: float, block_chunk: int | None = None):
    """The TreePM short-range pair sums with the tabulated transition
    (ngravs_tpu/ops/walk.py:564-600, forcetree.c:1958-2027): each law's
    `force_factor_tpm` / `potential_factor_tpm` with the long-range part
    interpolated from the f64-built tables of its (target, source) gravity
    pair, 0 beyond u = 3.  The interface of `pairwise_eval` (targets
    [B*G, 1] columns, spacked [B, 8, S], n_src [B, 1]); runs on the
    tensors' device in chunks of target blocks.  Returns acc [B*G, 3], pot
    [B*G] (zeros without want_pot), nia [B*G] int32."""
    groups = wiring.unique_laws()
    ng = wiring.n_gravs
    use_count = wiring.accumulator
    ntab = int(sr_ftab.shape[-1])
    ftab = sr_ftab.reshape(ng * ng, ntab)
    ptab = sr_ptab.reshape(ng * ng, ntab)
    nb, _, s = spacked.shape
    g = targets["x"].shape[0] // nb
    dev = spacked.device
    acc = torch.zeros(nb, g, 3, dtype=torch.float32, device=dev)
    pot = torch.zeros(nb, g, dtype=torch.float32, device=dev)
    nia = torch.zeros(nb, g, dtype=torch.int32, device=dev)
    for sl in _block_chunks(nb, s, g, block_chunk):
        sp = spacked[sl]
        col, valid, d = _pair_geometry(targets, sp, sl, n_src, g, box_size)
        tg, tm = col("grav"), col("mass")
        sg = sp[:, IGRAV, :].view(torch.int32)[:, None, :]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        r = torch.sqrt(r2)
        h = torch.maximum(col("fsoft"), sp[:, None, FSOFT, :])
        sm = sp[:, None, FMASS, :]
        n = sp[:, None, FCOUNT, :] if use_count else 1.0
        pair = tg * ng + sg
        lr, inside = longrange_force_factor(ftab, asmth, ntab, r, pair)
        lrp = longrange_pot_factor(ptab, asmth, ntab, r, pair)[0] \
            if want_pot else None
        fac = torch.zeros_like(r2)
        pf = torch.zeros_like(r2) if want_pot else None
        for law, slots in groups:
            f_k = law.force_factor_tpm(tm, sm, r2, r, h, n, lr)
            p_k = law.potential_factor_tpm(tm, sm, r2, r, h, n, lrp) \
                if want_pot else None
            if len(groups) == 1:
                fac, pf = f_k, p_k
                break
            mk = torch.zeros_like(valid)
            for i, j in slots:
                mk = mk | ((tg == i) & (sg == j))
            fac = torch.where(mk, f_k, fac)
            if want_pot:
                pf = torch.where(mk, p_k, pf)
        # masked by a select: an invalid pair's factor may be inf/NaN
        ok = valid & inside
        acc[sl] = torch.stack([torch.sum(torch.where(ok, fac * x, 0.0),
                                         dim=-1) for x in d], dim=-1)
        if want_pot:
            pot[sl] = torch.sum(torch.where(ok, pf, 0.0), dim=-1)
        nia[sl] = torch.sum(valid, dim=-1, dtype=torch.int32)
    return acc.reshape(nb * g, 3), pot.reshape(nb * g), nia.reshape(nb * g)


def lattice_pass(targets: dict, spacked: torch.Tensor, n_src: torch.Tensor,
                 tables: torch.Tensor, n_gravs: int, box_size: float,
                 want_pot: bool = True, corners=None):
    """The periodic pure-tree walk's lattice (Ewald) correction over the
    same packed buffer and interaction set as the pair sums: CUDA tensors
    launch K3 (`lattice.lattice_eval_cuda`, one launch over the whole
    batch, n_src read on the card), CPU tensors take the twin
    `lattice_pass_torch` (`corners`: its `lattice.corner_table(tables)`
    when the caller keeps one).  Returns (acc [B*G, 3], pot [B*G], zeros
    without `want_pot`), to be added to the pair sums."""
    if spacked.device.type == "cuda":
        return lattice_eval_cuda(targets, spacked, n_src, tables, n_gravs,
                                 box_size, want_pot)
    return lattice_pass_torch(targets, spacked, n_src, tables, n_gravs,
                              box_size, want_pot, corners=corners)


def lattice_pass_torch(targets: dict, spacked: torch.Tensor,
                       n_src: torch.Tensor, tables: torch.Tensor,
                       n_gravs: int, box_size: float, want_pot: bool = True,
                       corners=None):
    """K3's plain twin (ngravs_tpu/ops/walk.py:969-1008; the reference's
    second walk, forcetree.c:2077-2432): sources with gid -1 are dropped,
    nodes (gid -2) kept, self pairs excluded; each pair adds source mass
    times the trilinear lattice correction of its (target, source) gravity
    pair at the minimum-image displacement.  Runs on the tensors' device
    in chunks of target blocks.  `corners`: `lattice.corner_table(tables)`
    when the caller keeps one."""
    nb, _, s = spacked.shape
    g = targets["x"].shape[0] // nb
    dev = spacked.device
    fac_intp = 2 * (tables.shape[1] - 1) / box_size
    if corners is None:
        corners = corner_table(tables)
    acc = torch.zeros(nb, g, 3, dtype=torch.float32, device=dev)
    pot = torch.zeros(nb, g, dtype=torch.float32, device=dev)
    for sl in _block_chunks(nb, s, g, None):
        sp = spacked[sl]
        col, valid, d = _pair_geometry(targets, sp, sl, n_src, g, box_size)
        pidx = col("grav") * n_gravs \
            + sp[:, IGRAV, :].view(torch.int32)[:, None, :]
        fcx, fcy, fcz, pc = lattice_correction(tables, fac_intp, *d, pidx,
                                               corners)
        # masked by a select: rows past n_src are not read
        sm = sp[:, None, FMASS, :]
        acc[sl] = torch.stack([torch.sum(torch.where(valid, sm * f, 0.0),
                                         dim=-1)
                               for f in (fcx, fcy, fcz)], dim=-1)
        if want_pot:
            pot[sl] = torch.sum(torch.where(valid, sm * pc, 0.0), dim=-1)
    return acc.reshape(nb * g, 3), pot.reshape(nb * g)


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------

def make_fused_walk(wiring: GravityWiring, n_gravs: int, *,
                    depth: int, bucket: int = 32,
                    group_size: int = 64,
                    batch_blocks: int = 128,
                    chunk_cap: int = 512,
                    frontier_cap=2048,
                    theta: float = 0.5,
                    opening: str = "relative",
                    box_size: float = 0.0,
                    leaf_factor: float = 2.0,
                    want_pot: bool = True,
                    lattice_tables=None,
                    treepm: dict | None = None,
                    octet_caps=None,
                    pair_eval=pairwise_eval,
                    trace: Trace | None = None):
    """Build the fused walk.  Returns fn(tree, tgt_sorted, opening_override,
    tables) -> FusedWalkResult.  `chunk_cap`: per-block unified 8-row source
    chunks; `frontier_cap`: per-level frontier slots per block (int or
    tuple).  `box_size` > 0 walks a periodic box (minimum image), and
    with `lattice_tables` ([NG*NG, EN+1, EN+1, EN+1, 4], `lattice.
    build_lattice_tables`) it is the periodic pure-tree walk, whose
    lattice pass corrects the minimum-image pair sums to the periodic
    force.  `treepm`: dict(asmth, rcut) makes it the TreePM short-range
    walk; a wiring with a law that has no closed-form truncation also
    needs the transition tables sr_ftab and sr_ptab
    (`shortrange.shortrange_tables`).  `pair_eval` is the pair evaluation
    (K1 by default; a test or a benchmark may pass the plain twin).
    `trace`: the caller's timers and counters (`trace.py`; a fresh one if
    not given): each batch counts `walk.batches`, its traversal is the
    span `walk.traverse` and its pair evaluation (with the lattice or
    tabulated pass) `walk.k1`, the lattice pass inside it `walk.lattice`.

    One host read per call, the number of active target blocks, and one a
    batch for the torch passes (the tabulated evaluation, the lattice
    pass's twin off the card): the length of the batch's longest source
    list."""
    if trace is None:
        trace = Trace()
    groups = wiring.unique_laws()
    periodic = box_size > 0
    # All or nothing, as the JAX walk's `closed_form`
    # (ngravs_tpu/ops/walk.py:503): if any law lacks the closed-form
    # truncation, every pair takes the tabulated transition in torch ops
    # instead of K1, which has closed forms only.  The wiring alone
    # decides; no failed kernel build or launch leads here.
    tabulated = treepm is not None and not all(
        law.kernel_shortrange() is not None for law, _ in groups)
    if tabulated and not all(k in treepm for k in ("sr_ftab", "sr_ptab")):
        raise ValueError(
            "TreePM with a law that has no closed-form truncation needs the "
            "transition tables: treepm=dict(asmth, rcut, sr_ftab, sr_ptab)")
    rcut = float(treepm["rcut"]) if treepm is not None else 0.0
    pair_kw = dict(wiring=wiring, box_size=float(box_size),
                   accumulator=wiring.accumulator,
                   treepm_asmth=(float(treepm["asmth"])
                                 if treepm is not None else 0.0))
    # the twin's corner table, built once a walk (K3 reads the tables)
    corners = corner_table(lattice_tables) \
        if lattice_tables is not None \
        and lattice_tables.device.type != "cuda" else None
    if tabulated:
        tab_kw = dict(wiring=wiring, box_size=float(box_size),
                      sr_ftab=treepm["sr_ftab"], sr_ptab=treepm["sr_ptab"],
                      asmth=float(treepm["asmth"]))
    G = group_size
    NG = n_gravs
    B = batch_blocks
    S = SUBGROUPS
    GS = G // S
    CL = chunk_cap                   # unified chunks per block (mono+leaf)
    if G % S or G % 8:
        raise ValueError(f"group size {G} must split into {S} subgroups "
                         "and 8-row chunks")
    W = walk_table_width(NG, wiring.accumulator)
    fcaps_l = normalize_frontier_caps(frontier_cap, depth)
    foct_l = tuple(max(1, (c + 7) // 8) for c in fcaps_l)
    big = 1e30

    def _gap(point, lo_b, hi_b):
        g = torch.maximum(lo_b - point, point - hi_b)
        if periodic:
            gp = torch.maximum(lo_b - point - box_size,
                               point + box_size - hi_b)
            gm = torch.maximum(lo_b - point + box_size,
                               point - box_size - hi_b)
            g = torch.minimum(g, torch.minimum(gp, gm))
        return g

    def _walk_batch(tree, wtab8, gsrc8, layout, tgt, rel, n_static):
        """One batch of B blocks: traversal -> chunk lists -> pair eval.
        `tgt`: dict of [B, G] target columns."""
        dev = wtab8.device
        init_lvl = min(2, depth)
        noct = octet_counts(n_static, depth, bucket, octet_caps)
        ooffs = np.concatenate([[0], np.cumsum(noct)]).astype(np.int64)
        cap2, nstart, rows, null_row = layout
        null_chunk = null_row // 8
        wtab8_i = wtab8.view(torch.int32)
        pow2 = (1 << torch.arange(8, device=dev, dtype=torch.int32))
        garange = torch.arange(NG, device=dev, dtype=torch.int32)

        tgid = tgt["gid"]
        tvalid = tgid >= 0
        blk_ok = tvalid.any(dim=1)
        tpos = torch.stack([tgt["x"], tgt["y"], tgt["z"]], dim=-1)

        # per-subgroup bounding boxes + relative-criterion aold minima
        tpos_s = tpos.reshape(B, S, GS, 3)
        tval_s = tvalid.reshape(B, S, GS)
        lo_b = torch.amin(torch.where(tval_s[..., None], tpos_s, big), dim=2)
        hi_b = torch.amax(torch.where(tval_s[..., None], tpos_s, -big), dim=2)
        sub_ok = tval_s.any(dim=2)                        # [B, S]
        lo_b = torch.where(sub_ok[..., None], lo_b, big)
        hi_b = torch.where(sub_ok[..., None], hi_b, -big)
        aold_sub = torch.amin(torch.where(tval_s, tgt["aold"].reshape(
            B, S, GS), big), dim=2)                       # [B, S]

        ovf = tree.n_chunk_rows > cap2
        nc_ls, c0_ls = [], []        # leaf records (chunk0, nchunk runs)
        mo_ls, ml_ls, mm_ls = [], [], []  # mono records (start, len, masks)
        lvl_live = [torch.zeros((), dtype=torch.int64, device=dev)] \
            * (depth + 1)

        # shallow real leaves (above the init level) go straight to the
        # leaf lists
        if init_lvl > 0:
            n_sho = int(ooffs[init_lvl])
            swn = wtab8_i[:n_sho].reshape(n_sho * 8, W)
            s_fl = swn[:, WFLAGS]
            s_nch = swn[:, WNCHUNK]
            s_term = ((s_fl & 1) > 0) & ((s_fl & 255) != 0)
            s_ok = blk_ok[:, None] & (s_term & (s_nch > 0))[None, :]
            nc_ls.append(torch.where(s_ok, s_nch[None, :], 0).long())
            c0_ls.append(swn[:, WCHUNK0].long()[None, :].expand(
                B, n_sho * 8))

        # initial frontier: every live block x every init-level octet
        Fo = min(int(noct[init_lvl]), foct_l[init_lvl])
        foct = (int(ooffs[init_lvl]) + torch.arange(
            Fo, dtype=torch.int32, device=dev))[None, :].expand(B, Fo)
        nlive = torch.where(blk_ok, min(int(noct[init_lvl]), Fo), 0)
        if int(noct[init_lvl]) > Fo:
            ovf = ovf | True

        with trace.span("walk.traverse"):
            for lvl in range(init_lvl, depth + 1):
                Fo = int(foct.shape[1])
                F = Fo * 8
                live_o = torch.arange(Fo, device=dev)[None, :] < nlive[:, None]
                lvl_live[lvl] = torch.amax(nlive) * 8

                wn = wtab8[torch.where(live_o, foct, 0).long()] \
                    .reshape(B, F, W)
                wn_i = wn.view(torch.int32)
                live = live_o.repeat_interleave(8, dim=1)       # [B, F]
                flags = wn_i[:, :, WFLAGS]
                valid = live & ((flags & 255) != 0)
                terminal = (flags & 1) > 0
                nch = wn_i[:, :, WNCHUNK]
                # nodes under a real shallow leaf carry moments but no chunks;
                # the preamble already summed those leaves
                valid = valid & ~(terminal & (nch == 0))
                center = wn[:, :, WCX:WCZ + 1]
                cg = wn[:, :, 8:8 + 4 * NG].reshape(B, F, NG, 4)
                cm = cg[..., 0:3]
                m_g = cg[..., 3]
                cell_len = tree.root_len * 2.0 ** -lvl

                # per-subgroup opening tests [B, F, S]: every gravity and axis
                # in one tensor [B, F, S, NG, 3], the squares summed x, y, z
                # in that order (a few launches a level, not dozens)
                dd = torch.clamp(_gap(cm[:, :, None], lo_b[:, None, :, None],
                                      hi_b[:, None, :, None]), min=0.0)
                sq = dd * dd
                d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]       # [B, F, S, NG]
                r2min = torch.clamp(torch.amin(torch.where(
                    m_g[:, :, None, :] > 0, d2, big), dim=-1), max=big)
                mtot = torch.sum(m_g, dim=-1)                   # [B, F]

                if rel:
                    must_open_s = (mtot[:, :, None] * cell_len * cell_len
                                   > r2min * r2min * aold_sub[:, None, :])
                else:
                    must_open_s = cell_len * cell_len > r2min * (theta * theta)
                # the target subgroup intersects the node: always open; under
                # TreePM a node beyond Rcut of every subgroup is discarded with
                # its whole subtree
                gx = _gap(center[:, :, None], lo_b[:, None], hi_b[:, None])
                inter = torch.all(gx < 0.6 * cell_len, dim=-1)  # [B, F, S]
                must_open_s = must_open_s | inter
                if rcut > 0:
                    byd = torch.any(gx - 0.5 * cell_len > rcut, dim=-1)
                    valid = valid & ~torch.all(byd, dim=-1)
                must_open = torch.any(must_open_s & sub_ok[:, None, :], dim=-1)
                accept = valid & ~must_open
                rest = valid & must_open
                leaf_here = rest & terminal
                expand = rest & ~terminal

                # accepted octet records: NG-chunk runs + per-gravity 8-bit
                # slot masks (accepted AND mass>0)
                acc_o = accept.reshape(B, Fo, 8)
                hasg = ((flags.reshape(B, Fo, 8)[..., None]
                         >> (1 + garange)) & 1) > 0         # [B, Fo, 8, NG]
                mbits = torch.sum((acc_o[..., None] & hasg).to(torch.int32)
                                  * pow2[None, None, :, None], dim=2,
                                  dtype=torch.int32)           # [B, Fo, NG]
                mo_ls.append(nstart // 8 + foct.long() * NG)
                ml_ls.append(torch.where(acc_o.any(dim=2), NG, 0))
                mm_ls.append(mbits)
                nc_ls.append(torch.where(leaf_here, nch, 0).long())
                c0_ls.append(wn_i[:, :, WCHUNK0].long())

                if lvl == depth:
                    break  # depth-level nodes are terminal by construction

                # expand: each opened node emits ONE child octet id, compacted
                # selected-first by a stable sort
                Fn = min(foct_l[lvl + 1], int(noct[lvl + 1]))
                co = wn_i[:, :, WCHOCT]
                exp_ok = expand & (co >= 0)
                total = torch.sum(exp_ok, dim=1)
                order = torch.sort((~exp_ok).to(torch.uint8), dim=1,
                                   stable=True).indices
                co_sorted = torch.gather(co, 1, order)
                if co_sorted.shape[1] >= Fn:
                    foct = co_sorted[:, :Fn]
                else:
                    foct = torch.cat([co_sorted, torch.zeros(
                        B, Fn - co_sorted.shape[1], dtype=torch.int32,
                        device=dev)], dim=1)
                nlive = torch.clamp(total, max=Fn)
                ovf = ovf | torch.any(total > Fn)

        # ------------------------------------------------------------
        # Unified chunk list: every record is a contiguous chunk run
        # (start, len); grid position i of block b lies in run k, the first
        # run whose cumulative end exceeds i, at chunk start[k] + i - pos0[k]
        # ------------------------------------------------------------
        starts = torch.cat(mo_ls + c0_ls, dim=1)           # [B, T]
        lens = torch.cat(ml_ls + nc_ls, dim=1)
        mms = torch.cat(mm_ls, dim=1)                      # [B, Tm, NG]
        T = starts.shape[1]
        Tm = int(mms.shape[1])
        cum = torch.cumsum(lens, dim=1)
        n_uch = cum[:, -1]
        pos0 = cum - lens
        ovf = ovf | torch.any(n_uch > CL)
        uiota = torch.arange(CL, device=dev)
        k = torch.searchsorted(cum, uiota.expand(B, CL).contiguous(),
                               right=True)
        kc = k.clamp(max=T - 1)
        off = uiota - torch.gather(pos0, 1, kc)
        in_list = uiota[None, :] < n_uch[:, None]
        uch = torch.gather(starts, 1, kc) + off
        uch = torch.where(in_list & (uch >= 0) & (uch < rows // 8), uch,
                          null_chunk)
        # per-chunk 8-bit row masks: mono runs carry their gravity's mask,
        # leaf chunks are fully live
        in_mono = in_list & (k < Tm)
        midx = (kc.clamp(max=Tm - 1) * NG + off.clamp(0, NG - 1))
        um8 = torch.where(in_mono, torch.gather(
            mms.reshape(B, Tm * NG), 1, midx), 255)

        n_mono = torch.sum(lens[:, :Tm], dim=1) // NG
        stats = torch.stack([torch.amax(torch.sum(lens > 0, dim=1)),
                             torch.amax(n_uch), torch.amax(n_mono)])
        lvls = torch.stack(lvl_live)

        # gather the packed [B, 8, CL*8] buffer: fields on rows, sources
        # along the last axis; masked rows get gid = -1
        ubuf = gsrc8[uch].reshape(B, CL, 8, 8).permute(0, 3, 1, 2) \
            .reshape(B, 8, CL * 8).contiguous()
        bit = ((um8[:, :, None] >> torch.arange(8, device=dev)) & 1) > 0
        ubuf_i = ubuf.view(torch.int32)
        ubuf_i[:, IGID, :] = torch.where(bit.reshape(B, CL * 8),
                                         ubuf_i[:, IGID, :], -1)

        flat = lambda a: a.reshape(B * G, 1).contiguous()
        targets = dict(x=flat(tgt["x"]), y=flat(tgt["y"]), z=flat(tgt["z"]),
                       mass=flat(tgt["mass"]), grav=flat(tgt["grav"]),
                       fsoft=flat(tgt["fsoft"]), gid=flat(tgid))
        n_src = (torch.clamp(n_uch, max=CL) * 8).to(torch.int32).reshape(B, 1)
        with trace.span("walk.k1"):
            lbuf = ubuf
            if tabulated or corners is not None:
                # the torch passes read the batch's live rows only: the
                # buffer cut at its longest list (one host read a batch;
                # the JAX walk's loop also runs to the largest n_src); K3
                # reads n_src on the card
                live = max(8, -(-int(trace.read(torch.amax(n_src))) // 8)
                           * 8)
                lbuf = ubuf[:, :, :live]
            if tabulated:
                a3, pp, nv = tabulated_pair_eval(targets, lbuf, n_src,
                                                 want_pot, **tab_kw)
            else:
                a3, pp, nv = pair_eval(targets, ubuf, n_src, want_pot,
                                       **pair_kw)
            if lattice_tables is not None:
                with trace.span("walk.lattice"):
                    la, lp = lattice_pass(targets, lbuf, n_src,
                                          lattice_tables, NG,
                                          float(box_size), want_pot,
                                          corners=corners)
                a3 = a3 + la
                if want_pot:
                    pp = pp + lp
        return a3.reshape(B, G, 3), pp.reshape(B, G), nv.reshape(B, G), \
            ovf, stats, lvls

    rel_default = opening == "relative"

    def fused_forces(tree: Octree, tgt_sorted: torch.Tensor,
                     opening_override: str | None = None,
                     tables: WalkTables | None = None) -> FusedWalkResult:
        """Forces on sorted-order target indices (-1 padding).  Targets are
        processed by the tree's aligned blocks (<= G consecutive sorted
        particles in one cell); only blocks holding a requested target are
        walked, in batches of B ordered by depth (a density proxy)."""
        rel = rel_default if opening_override is None else \
            opening_override == "relative"
        dev = tree.pos_s.device
        n = tree.pos_s.shape[0]
        noct = octet_counts(n, depth, bucket, octet_caps)
        n_oct = int(np.sum(noct))
        layout = source_table_layout(n, n_oct, NG, leaf_factor)
        if tables is None:
            tables = pack_walk_tables(tree, n, depth, bucket, NG,
                                      leaf_factor,
                                      accumulator=wiring.accumulator,
                                      octet_caps=octet_caps)
        gsrc8 = tables.gsrc
        wtab8 = tables.wtab8
        ngrp = int(tree.blk_start.shape[0])

        tgt = tgt_sorted.long()
        tlive = tgt >= 0
        act = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        blocking(act.__setitem__, torch.where(tlive, tgt, n), True)
        act = act[:n]
        blk_act = torch.zeros(ngrp + 1, dtype=torch.bool, device=dev)
        blocking(blk_act.__setitem__,
                 torch.where(act, tree.pblk.long(), ngrp), True)
        blk_act = blk_act[:ngrp] & (tree.blk_cnt > 0)
        nact = int(trace.read(torch.sum(blk_act)))       # the host read
        sort_key = torch.where(blk_act, -tree.blk_level.long(), INT32_MAX)
        sorted_ids = torch.sort(sort_key, stable=True).indices
        nbatch = (nact + B - 1) // B
        blk_ids = torch.full((nbatch * B,), -1, dtype=torch.int64, device=dev)
        blk_ids[:nact] = sorted_ids[:nact]

        ovf = tables.layout_ovf | (tree.n_blocks > ngrp)
        stats = torch.zeros(3, dtype=torch.int64, device=dev)
        lvl_max = torch.zeros(depth + 1, dtype=torch.int64, device=dev)
        # result rows (+1 junk row for padding slots); the interaction
        # count travels as an f32 value
        buf = torch.zeros(n + 1, 5, dtype=torch.float32, device=dev)
        giota = torch.arange(G, device=dev)
        for bi in range(nbatch):
            trace.count("walk.batches")
            ids = blk_ids[bi * B:(bi + 1) * B]
            vb = ids >= 0
            ids0 = ids.clamp(min=0)
            st = tree.blk_start[ids0].long()
            cnt = torch.where(vb, tree.blk_cnt[ids0], 0)
            slots = st[:, None] + giota[None, :]            # [B, G]
            in_blk = giota[None, :] < cnt[:, None]
            safe = torch.where(in_blk, slots, 0).clamp(max=n - 1)
            tb = dict(x=tree.pos_s[safe, 0], y=tree.pos_s[safe, 1],
                      z=tree.pos_s[safe, 2], mass=tree.mass_s[safe],
                      fsoft=tree.fsoft_s[safe], grav=tree.grav_s[safe],
                      gid=torch.where(in_blk, slots, -1).to(torch.int32),
                      aold=tree.aold_s[safe])
            a3, pp, nv, ovf1, stats1, lvl1 = _walk_batch(
                tree, wtab8, gsrc8, layout, tb, rel, n)
            rows = torch.where(in_blk, slots, n).reshape(-1)
            buf[rows] = torch.cat([a3, pp[..., None],
                                   nv[..., None].to(torch.float32)],
                                  dim=-1).reshape(-1, 5)
            ovf = ovf | ovf1
            stats = torch.maximum(stats, stats1)
            lvl_max = torch.maximum(lvl_max, lvl1)

        out = torch.where(tlive[:, None], buf[tgt.clamp(min=0)], 0.0)
        return FusedWalkResult(
            acc=out[:, 0:3], pot=out[:, 3],
            ninteract=out[:, 4].to(torch.int32), overflow=ovf,
            max_ent=stats[0], max_chunk=stats[1], max_rows=stats[2],
            max_frontier=lvl_max, layout_ovf=tables.layout_ovf)

    return fused_forces
