"""Morton (Z-order) keys for octree construction (port of
`ngravs_tpu/ops/morton.py`).

The reference orders particles along a Peano-Hilbert curve (peano.c:356) so
tree nodes are contiguous array ranges; Morton order has the same property
and keeps key<->cell math to bit tricks.  Keys are dual int32 words (hi =
levels 1..10, lo = levels 11..depth), so the tree can go to depth 20 (the
reference's BITS_PER_DIMENSION=18, allvars.h:34), and the bit layout is the
JAX package's, so both packages sort particles identically.
"""

from __future__ import annotations

import torch

MAX_DEPTH = 20
HI_DEPTH = 10


def _part1by2(x):
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact1by2(x):
    """Inverse of _part1by2."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def morton_encode(cell: torch.Tensor) -> torch.Tensor:
    """[N,3] int cell coords (< 2^10) -> [N] int32 Morton keys."""
    cell = cell.to(torch.int32)
    return (_part1by2(cell[..., 0])
            | (_part1by2(cell[..., 1]) << 1)
            | (_part1by2(cell[..., 2]) << 2))


def morton_decode(key: torch.Tensor) -> torch.Tensor:
    """[N] int32 keys -> [N,3] int32 cell coords (10 levels)."""
    return torch.stack([_compact1by2(key), _compact1by2(key >> 1),
                        _compact1by2(key >> 2)], dim=-1)


def morton_keys2(pos, corner, inv_len, depth: int):
    """Positions -> dual (hi, lo) int32 Morton keys at `depth` levels.

    hi covers levels 1..min(depth,10); lo covers levels 11..depth (zero when
    depth <= 10), computed from the residual fraction so f32 precision is
    not lost at deep levels.
    """
    if depth > MAX_DEPTH:
        raise ValueError(f"depth {depth} > {MAX_DEPTH}")
    lo_bits = max(0, depth - HI_DEPTH)
    hi_bits = depth - lo_bits
    f = (pos - corner) * inv_len                    # in [0,1)
    fh = f * float(1 << hi_bits)
    c_hi = torch.clamp(torch.floor(fh).to(torch.int32), 0, (1 << hi_bits) - 1)
    hi = morton_encode(c_hi)
    if lo_bits:
        res = fh - c_hi.to(fh.dtype)                # residual in [0,1)
        c_lo = torch.clamp(
            torch.floor(res * float(1 << lo_bits)).to(torch.int32),
            0, (1 << lo_bits) - 1)
        lo = morton_encode(c_lo)
    else:
        lo = torch.zeros_like(hi)
    return hi, lo


def level_key2(hi, lo, depth: int, lvl: int):
    """Dual key truncated to level `lvl`: returns (hk, lk)."""
    lo_bits = max(0, depth - HI_DEPTH)
    if lvl <= depth - lo_bits:
        return hi >> (3 * (depth - lo_bits - lvl)), torch.zeros_like(lo)
    return hi, lo >> (3 * (depth - lvl))


def decode_center(hk, lk, depth: int, lvl: int, corner, root_len):
    """Cell center of a level-`lvl` node given its truncated dual key."""
    lo_bits = max(0, depth - HI_DEPTH)
    hi_lvls = depth - lo_bits
    if lvl <= hi_lvls:
        coord = morton_decode(hk)
    else:
        coord = (morton_decode(hk) << (lvl - hi_lvls)) + morton_decode(lk)
    cell_len = root_len / float(1 << lvl)
    return corner + (coord.to(root_len.dtype) + 0.5) * cell_len


def sort_by_keys2(hi, lo) -> torch.Tensor:
    """Stable permutation sorting by (hi, lo) lexicographically; both words
    are non-negative, so one int64 key hi << 32 | lo orders them."""
    key = (hi.to(torch.int64) << 32) | lo.to(torch.int64)
    return torch.sort(key, stable=True).indices
