"""Barnes-Hut gravity over the ranks (port of
`ngravs_tpu/parallel/tree_sharded.py`).

The reference's distributed tree machinery (domain decomposition,
pseudo-particle exchange and export/import bunches; domain.c,
forcetree.c:345-431,766-819, gravtree.c:102-285) as the JAX package
rebuilt it, in two designs:

* the replicated step (`ReplicatedTreeStep`, JAX's
  `make_sharded_tree_step`): one all_gather of the
  drifted sources, the same octree built on every rank, each rank walking
  its contiguous slice of the Morton-sorted targets, one all_gather of the
  results;
* the locally-essential-tree step (`LetTreeStep`, JAX's
  `make_let_tree_step`): a tree over the
  rank's own particles on the shared root cell, a sender-driven cut of it
  for every other rank shipped in one all_to_all, and the received rows
  summed densely on top of the local walk.  No rank holds another's
  particle set.

Both walk with the port's fused walk (`ops/walk.py:make_fused_walk`),
whose pair evaluation is K1 on the card.  (The JAX replicated step calls
its two-phase walk, `ngravs_tpu/ops/tree.py:make_tree_forces`; its own LET
step and single-device solver call the fused walk, and the two agree
within the tree's approximation.)  The walk's caps grow on the rank that
overflows them, and the walk is retried there, as the single-device solver
does.  The LET exchange's caps overflow on the sender: every rank learns
it (one int32 pmax), the caps grow to twice the largest rank's demand,
and the exchange alone is repeated on the same trees (the JAX runner
re-runs the whole step with doubled caps).  Under the relative criterion
a run whose OldAcc is still zero starts with a geometric pass, as the
reference does (accel.c:48-52).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..constants import SOFTFAC_SPLINE
from ..integrate.kdk import box_wrap, drift, pm_kick
from ..integrate.timeline import pm_window_update, timebase_interval
from ..ops.morton import morton_keys2, sort_by_keys2
from ..ops.solver import GravitySolver, apply_cosmo_corrections
from ..ops.tree import _compact_rows, build_tree
from .mesh import (INERT_ENDSTEP, Mesh, gather_rows, make_mode_kick,
                   sharded_dt_displacement, take_rows)


EC = 512    # LET rows are evaluated in multiples of this, and shipped so


class StepResult(NamedTuple):
    p: object               # this rank's particles after the step
    min_end: int            # next global sync point (pmin of ti_endstep)
    n_active: int           # particles active at ti_next, all ranks
    pm_beg: int             # the PM window after the step
    pm_end: int


def _bits(v: int, dev) -> torch.Tensor:
    return torch.tensor([v], dtype=torch.int32, device=dev) \
        .view(torch.float32)[0]


def walk_targets(solver: GravitySolver, tree, tgt_sorted, opening: str,
                 want_pot: bool):
    """The fused walk of `tree` for sorted-order targets (-1 padding) with
    the single-device solver's cap management: caps clamped to the tree,
    octet caps measured on first use and on a layout overflow, grown to
    measured demand and retried on an overflow, tightened once."""
    n = tree.pos_s.shape[0]
    solver.clamp_caps(n)
    need = int(tree.n_chunk_rows)
    cap2 = ((int(n * solver.leaf_factor) + 8 + 7) // 8) * 8
    if need > cap2:
        solver.leaf_factor = need * 1.25 / n
    if solver.octet_caps is None:
        solver._measure_octets(tree, n)
    for _ in range(8):
        res = solver._walk(want_pot)(tree, tgt_sorted,
                                     opening_override=opening)
        ovf, lovf, mc = (int(x) for x in torch.stack(
            [res.overflow.long(), res.layout_ovf.long(),
             res.max_chunk.long()]).cpu())
        mf = res.max_frontier.cpu().numpy()
        if not ovf:
            if not solver._tightened:
                solver._tightened = True
                solver.tighten_caps(mc, mf)
            return res
        if lovf:
            solver._measure_octets(tree, n)
        solver.grow_caps(mc, mf)
    raise RuntimeError(f"tree walk caps still overflowing at {solver.fcaps}")


class _TreeStepBase:
    """What the replicated and the LET step share: drift, cosmological
    corrections, PM, the kick with the special modes, the PM window and
    the sync-point reduction.  Under PMGRID `pm_step` picks the variant
    that recomputes the long-range force and applies the PM kick (called
    with the PM window) or the one that holds accel_pm."""

    def __init__(self, cfg, units, wiring, tables, mesh: Mesh,
                 opening=None, pm_step=True, solver=None):
        self.cfg, self.units, self.wiring = cfg, units, wiring
        self.tables, self.mesh = tables, mesh
        dev = mesh.device
        self.G = units.G
        if solver is None:
            solver = GravitySolver(
                cfg, wiring, np.array(cfg.softening, np.float32)
                * SOFTFAC_SPLINE, units.G, hubble=units.hubble, device=dev)
        self.solver = solver
        if opening is None:
            opening = "bh" if cfg.type_of_opening_criterion == 0 \
                else "relative"
        self.opening = opening
        self._rel_ready = opening != "relative"
        self.fsoft_by_type = torch.as_tensor(
            np.array(cfg.softening, np.float32) * SOFTFAC_SPLINE, device=dev)
        self.soft_table = torch.as_tensor(
            np.array(cfg.softening, np.float32), device=dev)
        self.tbi = timebase_interval(cfg)
        self.pm_sharded = None
        if cfg.pmgrid:
            from .pm_sharded import ShardedPMSolver
            self.pm_sharded = ShardedPMSolver(solver.pm, mesh, cfg.n_gravs)
        self.pm_update = bool(cfg.pmgrid) and pm_step
        self.want_pot = bool(cfg.output_potential
                             or cfg.compute_potential_energy)
        self.mode_kick, self.n_mode_extras = make_mode_kick(
            cfg, units, tables, self.soft_table, mesh)

    def _gravity(self, p, mass, fsoft, opening):
        """(acc, pot, interactions) in G = 1 units in local order."""
        raise NotImplementedError

    def _bootstrap_needed(self, p) -> bool:
        if self._rel_ready:
            return False
        mx = self.mesh.pmax(torch.amax(p.old_acc).reshape(1))
        self._rel_ready = True
        return float(mx[0]) == 0.0

    def __call__(self, p, ti_current: int, ti_next: int, time_next: float,
                 *rest) -> StepResult:
        cfg, mesh = self.cfg, self.mesh
        if self.pm_update:
            pm_beg, pm_end, extras = int(rest[0]), int(rest[1]), rest[2:]
        else:
            pm_beg = pm_end = 0
            extras = rest
        # drift all local particles to the sync point (predict.c:31)
        p = box_wrap(cfg, drift(p, self.tables, ti_current, ti_next))
        live = p.pid >= 0
        fsoft = self.fsoft_by_type[p.ptype.long()]
        mass = torch.where(live, p.mass, 0.0)     # padding rows are inert
        accel_pm = p.accel_pm
        if self.pm_update:
            # long-range PM forces (pmforce_periodic, pm_periodic.c:204)
            accel_pm = self.pm_sharded.forces(p.pos, mass, p.grav)
        corr = self.solver._corr

        def corrected(acc, pot):
            acc, amag, pot = apply_cosmo_corrections(
                corr, p.pos, mass, p.grav, acc * self.G, pot * self.G)
            if cfg.pmgrid:
                # OldAcc includes the PM part (gravtree.c:322-330)
                amag = torch.linalg.norm(acc + accel_pm, dim=-1)
            return acc, amag, pot

        if self._bootstrap_needed(p):
            # the relative criterion needs OldAcc (accel.c:48-52)
            acc0, pot0, _ = self._gravity(p, mass, fsoft, "bh")
            p = p.replace(old_acc=corrected(acc0, pot0)[1])
        acc, pot, nia = self._gravity(p, mass, fsoft, self.opening)
        acc, amag, pot = corrected(acc, pot)
        if self.pm_sharded is not None and self.want_pot:
            # long-range PM potential (potential.c:268-306)
            pot = pot + self.pm_sharded.potential(p.pos, mass, p.grav)
        n_act = torch.sum((p.ti_endstep == ti_next) & live)
        p = p.replace(accel=acc, potential=pot, accel_pm=accel_pm,
                      old_acc=amag,
                      # measured work for the next decomposition
                      # (GravCost, forcetree.c:1595 / domain.c:859-862)
                      grav_cost=nia.to(p.grav_cost.dtype))
        # the kick (timestep.c), with the cross-rank displacement
        # constraint (timestep.c:587-651) and the special modes
        dt_disp = sharded_dt_displacement(cfg, self.units, p, time_next,
                                          mesh)
        p = self.mode_kick(p, ti_next, dt_disp, time_next, extras)
        if self.pm_update:
            # the PM kick over the midpoint window (timestep.c:350-408)
            tstart, tend, pm_beg, pm_end = pm_window_update(
                ti_next, pm_beg, pm_end, dt_disp, float(self.tbi))
            p = pm_kick(p, self.tables, tstart, tend)
        stats = mesh.all_gather(torch.stack([
            torch.amin(p.ti_endstep),
            n_act.to(torch.int32)]).to(torch.int32)[None]).cpu()
        return StepResult(p, int(stats[:, 0].min()), int(stats[:, 1].sum()),
                          pm_beg, pm_end)


class ReplicatedTreeStep(_TreeStepBase):
    """drift -> all_gather the sources -> the same tree on every rank ->
    walk my slice of the Morton-sorted targets -> all_gather the results,
    unsort by tree.order, keep my rows -> corrections, PM, kick, pmin.

    Called as step(p, ti_current, ti_next, time_next[, pm_beg, pm_end],
    *mode_extras) -> StepResult (the PM window for the PM-step variant
    under PMGRID)."""

    def _gravity(self, p, mass, fsoft, opening):
        cfg, mesh, solver = self.cfg, self.mesh, self.solver
        nloc = p.pos.shape[0]
        dev = p.pos.device
        aold = cfg.err_tol_force_acc * p.old_acc / self.G  # G = 1 units
        rows = mesh.all_gather(torch.cat([
            p.pos, mass[:, None], fsoft[:, None], aold[:, None],
            p.grav.view(torch.float32)[:, None],
            p.pid.view(torch.float32)[:, None]], dim=1))
        # rows in particle-ID order: the tree (and so every force) does not
        # depend on which rank holds which particle, so a resumed run,
        # decomposed anew, continues bit for bit
        perm = torch.argsort(rows[:, 7].contiguous().view(torch.int32),
                             stable=True)
        rows = rows[perm]
        grav_f = rows[:, 6].contiguous().view(torch.int32)
        pid_f = rows[:, 7].contiguous().view(torch.int32)
        # the identical build on every rank (forcetree.c:61); the open
        # box's root cube spans every row, padding at the origin included
        tree = build_tree(rows[:, 0:3], rows[:, 3], grav_f, rows[:, 4],
                          rows[:, 5], depth=solver.depth,
                          n_gravs=cfg.n_gravs, bucket=cfg.tree_bucket_size,
                          box_size=solver.box,
                          group_size=cfg.walk_group_size)
        # my contiguous slice of the sorted targets, padding rows skipped
        slot = mesh.rank * nloc + torch.arange(nloc, device=dev)
        tgt = torch.where(pid_f[tree.order[slot].long()] >= 0, slot, -1)
        res = walk_targets(solver, tree, tgt, opening, self.want_pot)
        out = mesh.all_gather(torch.cat([
            res.acc, res.pot[:, None],
            res.ninteract.to(torch.float32)[:, None]], dim=1))
        full = torch.empty_like(out)
        full[perm[tree.order.long()]] = out
        mine = full[mesh.rank * nloc:(mesh.rank + 1) * nloc]
        return mine[:, 0:3], mine[:, 3], mine[:, 4]


# --------------------------------------------------------------------------
# domain decomposition
# --------------------------------------------------------------------------

def reshard_by_morton(p, mesh: Mesh, box: float = 0.0):
    """Domain decomposition (domain.c:62 + peano.c:36): sort all rows by
    Morton key and hand each rank a contiguous, equally-sized key range.
    Gather + the same sort on every rank + my slice, as the JAX package
    does (its open-box key cube spans every row, padding included)."""
    nloc = p.pos.shape[0]
    pf = gather_rows(mesh, p)
    if box > 0:
        corner = torch.zeros(3, dtype=pf.pos.dtype, device=pf.pos.device)
        inv_len = 1.0 / box
    else:
        lo = torch.amin(pf.pos, dim=0)
        hi = torch.amax(pf.pos, dim=0)
        root_len = torch.amax(hi - lo) * 1.0001 + 1e-30
        corner = (lo + hi) / 2 - root_len / 2
        inv_len = 1.0 / root_len
    khi, klo = morton_keys2(pf.pos, corner, inv_len, 10)
    order = sort_by_keys2(khi, klo)
    return take_rows(pf, order[mesh.rank * nloc:(mesh.rank + 1) * nloc])


def cost_split(pos: np.ndarray, w: np.ndarray, n_dev: int,
               alloc_factor: float, box: float):
    """The host decomposition (domain_sumCost + domain_findSplit,
    domain.c:347,823-877): the Morton order of the rows, the contiguous
    bounds of equal work under the capacity ceil(N/K * alloc_factor)
    (PartAllocFactor, allocate.c:103), and that capacity."""
    from .domain_native import morton_argsort_host, weighted_split_host
    pos = np.asarray(pos, np.float32)
    if box > 0:
        corner = np.zeros(3)
        inv_len = 1.0 / box
    else:
        lo = pos.min(axis=0).astype(np.float64)
        hi = pos.max(axis=0).astype(np.float64)
        root_len = (hi - lo).max() * 1.0001 + 1e-30
        corner = (lo + hi) / 2 - root_len / 2
        inv_len = 1.0 / root_len
    order = morton_argsort_host(pos, corner, inv_len)
    n = order.shape[0]
    cap = int(math.ceil(n / n_dev * alloc_factor))
    bounds = weighted_split_host(np.asarray(w, np.float64)[order], n_dev,
                                 cap)
    return order, bounds, cap


def block_of(obj, rows: np.ndarray, cap: int, device):
    """`obj`'s rows `rows` padded to `cap` inert rows (zeros, pid -1,
    ti_endstep past the horizon), on `device`."""
    m = rows.shape[0]
    idx = torch.as_tensor(rows, dtype=torch.long)
    kw = {}
    for f in dataclasses.fields(obj):
        a = getattr(obj, f.name)
        out = torch.zeros((cap,) + tuple(a.shape[1:]), dtype=a.dtype)
        out[:m] = a.cpu()[idx]
        if f.name == "pid":
            out[m:] = -1
        elif f.name == "ti_endstep":
            out[m:] = INERT_ENDSTEP
        kw[f.name] = out.to(device)
    return type(obj)(**kw)


def decompose(p, mesh: Mesh, alloc_factor: float = 1.25, box: float = 0.0):
    """The work-balanced split of the GLOBAL live particles `p` (every
    rank holds the same rows): this rank's block, capacity
    ceil(N/K * alloc_factor), weights w_i = 1 + GravCost_i (times
    domain.c:859-862).  Returns this rank's particles."""
    w = 1.0 + p.grav_cost.cpu().numpy().astype(np.float64)
    order, bounds, cap = cost_split(p.pos.cpu().numpy(), w, mesh.size,
                                    alloc_factor, box)
    rows = order[bounds[mesh.rank]:bounds[mesh.rank + 1]]
    return block_of(p, rows, cap, mesh.device)


def reshard_by_cost(p, mesh: Mesh, alloc_factor: float = 1.25,
                    box: float = 0.0):
    """Work-balanced domain decomposition of the ranks' shards: every rank
    gathers the equal-capacity shards, drops the padding rows, and
    computes the same host order and split (`cost_split`), so every
    particle goes to the rank JAX's `reshard_by_cost` gives it on the same
    live rows.  Capacity comes from the live count (JAX's counts its
    padding rows too, so its capacity grows by alloc_factor at every
    re-decomposition).  Returns this rank's particles."""
    pf = gather_rows(mesh, p)
    pf = take_rows(pf, torch.nonzero(pf.pid >= 0).squeeze(1))
    return decompose(pf, mesh, alloc_factor, box)


# --------------------------------------------------------------------------
# the locally-essential tree
# --------------------------------------------------------------------------

def make_let_exchange(*, mesh: Mesh, NG, EXN, EXP, RCAP, theta, opening,
                      sr_cutoff, periodic, box):
    """The sender-driven LET cut and its all_to_all (forcetree.c:345-431,
    766-819 + gravtree.c:102-285 rebuilt sender-driven).

    Returns exchange(tree, boxes_lo, boxes_hi, aold_min, nloc) -> (recv
    [K*RCAP, 8] packed source rows, this rank's int32 [overflow, node
    rows wanted, particle rows wanted] for its largest receiver).
    Row fields: x, y, z, mass, maxsoft, count, grav (bits), tag (bits; -2
    node monopole, -3 particle, -1 dead)."""
    K = mesh.size

    def _box_gap(lo_a, hi_a, lo_b, hi_b):
        g = torch.maximum(lo_b - hi_a, lo_a - hi_b)
        if periodic:
            gp = torch.maximum(lo_b - hi_a - box, lo_a - hi_b + box)
            gm = torch.maximum(lo_b - hi_a + box, lo_a - hi_b - box)
            g = torch.minimum(g, torch.minimum(gp, gm))
        return g

    def exchange(tree, boxes_lo, boxes_hi, aold_min, nloc):
        dev = tree.pos_s.device
        m_tot = torch.sum(tree.node_mass, dim=-1)            # [M]
        M = m_tot.shape[0]
        cl = tree.root_len * (2.0 ** -tree.node_level.to(torch.float32))
        half = 0.5 * cl[:, None]
        d2 = torch.zeros(M, K, dtype=torch.float32, device=dev)
        inter = torch.ones(M, K, dtype=torch.bool, device=dev)
        for ax in range(3):
            ga = _box_gap(tree.node_center[:, ax, None] - half,
                          tree.node_center[:, ax, None] + half,
                          boxes_lo[None, :, ax], boxes_hi[None, :, ax])
            d2 = d2 + torch.clamp(ga, min=0.0) ** 2
            inter = inter & (ga < 0.1 * cl[:, None])
        openable = ((cl * cl)[:, None] > d2 * (theta * theta)) | inter
        if opening == "relative":
            openable = openable | ((m_tot * cl * cl)[:, None]
                                   > d2 * d2 * aold_min[None, :])
        valid = tree.node_pcount > 0
        par = torch.clamp(tree.node_parent, min=0).long()
        par_open = torch.where((tree.node_parent >= 0)[:, None],
                               openable[par], True)
        exp_mono = valid[:, None] & ~openable & par_open
        exp_leaf = valid[:, None] & tree.node_terminal[:, None] & openable
        # never export to myself (the local walk covers it)
        notme = (torch.arange(K, device=dev) != mesh.rank)[None, :]
        exp_mono = exp_mono & notme
        exp_leaf = exp_leaf & notme
        if sr_cutoff > 0:
            # TreePM: the short-range factor vanishes past the cutoff, so
            # rows beyond it never ship (forcetree.c:1828-1862)
            within = d2 < np.float32(sr_cutoff * sr_cutoff)
            exp_mono = exp_mono & within
            exp_leaf = exp_leaf & within

        # ---- compact per receiver + pack rows ----------------------------
        nodes = torch.arange(M, dtype=torch.int32, device=dev)[None, :] \
            .expand(K, M)
        nid_m, cnt_m = _compact_rows(nodes, exp_mono.T, EXN)   # [K, EXN]
        nid_l, cnt_l = _compact_rows(nodes, exp_leaf.T, EXN)
        ovf = (torch.amax(cnt_m) > EXN) | (torch.amax(cnt_l) > EXN)
        neg1 = _bits(-1, dev)
        safe_m = torch.clamp(nid_m, min=0).long()
        rows_m = []
        for g in range(NG):
            mg = tree.node_mass[safe_m, g]                     # [K, EXN]
            okg = (nid_m >= 0) & (mg > 0)
            rows_m.append(torch.stack(
                [tree.node_cm[safe_m, g, 0], tree.node_cm[safe_m, g, 1],
                 tree.node_cm[safe_m, g, 2], torch.where(okg, mg, 0.0),
                 tree.node_maxsoft[safe_m],
                 torch.clamp(tree.node_count[safe_m, g], min=1.0),
                 _bits(g, dev).expand_as(mg),
                 torch.where(okg, _bits(-2, dev), neg1)], dim=-1))
        rows_m = torch.cat(rows_m, dim=1)                     # [K, EXN*NG, 8]

        # leaf particle expansion: the ranges (start, pcount <= bucket)
        safe_l = torch.clamp(nid_l, min=0).long()
        st_l = torch.where(nid_l >= 0, tree.node_start[safe_l], 0).long()
        pc_l = torch.where(nid_l >= 0, tree.node_pcount[safe_l], 0).long()
        cum = torch.cumsum(pc_l, dim=1)
        tot_p = cum[:, -1]
        ovf = ovf | (torch.amax(tot_p) > EXP)
        piota = torch.arange(EXP, device=dev)[None, :].expand(K, EXP)
        j = torch.clamp(torch.searchsorted(cum, piota.contiguous(),
                                           right=True), max=EXN - 1)
        pidx = st_l.gather(1, j) + piota - (cum.gather(1, j)
                                            - pc_l.gather(1, j))
        plive = piota < tot_p[:, None]
        pidx = torch.where(plive, torch.clamp(pidx, max=nloc - 1), 0)
        prow = torch.stack(
            [tree.pos_s[pidx, 0], tree.pos_s[pidx, 1], tree.pos_s[pidx, 2],
             torch.where(plive, tree.mass_s[pidx], 0.0), tree.fsoft_s[pidx],
             torch.ones_like(tree.mass_s[pidx]),
             tree.grav_s[pidx].view(torch.float32),
             torch.where(plive, _bits(-3, dev), neg1)], dim=-1)

        send = torch.cat([rows_m, prow], dim=1)
        pad = RCAP - send.shape[1]
        if pad:
            padrow = torch.zeros(K, pad, 8, dtype=torch.float32, device=dev)
            padrow[:, :, 7] = neg1
            send = torch.cat([send, padrow], dim=1)
        recv = mesh.all_to_all(send.contiguous()).reshape(K * RCAP, 8)
        return recv, torch.stack([
            ovf.to(torch.int32),
            torch.maximum(torch.amax(cnt_m), torch.amax(cnt_l)),
            torch.amax(tot_p).to(torch.int32)])

    return exchange


def make_let_remote_eval(*, wiring, treepm_asmth: float, lattice_tables,
                         fac_intp, NG, periodic, box, tchunk: int = 1024,
                         cutoff: float = 0.0, want_pot: bool = True):
    """The dense evaluation of received LET rows on the local targets (the
    import half of gravtree.c:102-285; the closed-form TreePM truncation
    of forcetree.c:1958-2027; the Ewald lattice pass of
    forcetree.c:2077-2432 in a periodic pure-tree box), in torch ops as
    the JAX package runs it in XLA.  Dead rows are dropped first; the
    targets go in chunks of `tchunk` (Morton-sorted, so compact), and with
    a TreePM `cutoff` a chunk sees only the rows within it of its bounding
    box (the rest contribute exactly zero); each tile of about 2^22 pairs
    (rows in multiples of EC) is summed, then the tiles in order.

    Returns eval(recv [R, 8], tpos [n, 3], tgrav, tsoft, tmass) -> [n, 4]
    (ax, ay, az, pot) in G = 1 units; the potential column is zero unless
    `want_pot`."""
    groups = wiring.unique_laws()
    multi = len(groups) > 1
    inv2a = 0.5 / treepm_asmth if treepm_asmth > 0 else 0.0
    corners = None
    if lattice_tables is not None:
        from ..ops.lattice import corner_table, lattice_correction
        corners = corner_table(lattice_tables)

    def min_image(d):
        if not periodic:
            return d
        return d - box * torch.round(d * (1.0 / box))

    def law_fp(law, tm, sm, r2, r, h, sc):
        if inv2a == 0.0:
            return (law.force_factor(tm, sm, r2, r, h, sc),
                    law.potential_factor(tm, sm, r2, r, h, sc)
                    if want_pot else None)
        # closed-form TreePM truncation (forcetree.c:1958-2027)
        u = r * inv2a
        sf, sp = law.kernel_shortrange()
        unsoft = law.accel(tm, sm, r2, r, sc) * sf(u) \
            / torch.clamp(r, min=1e-37)
        soft = law.spline(tm, sm, h, r, sc)
        inside = u < 3.0
        f_k = torch.where(inside, torch.where(r >= h, unsoft, soft), 0.0)
        if not want_pot:
            return f_k, None
        punsoft = -law.potential(tm, sm, r2, r, sc) * sp(u)
        psoft = law.spline_pot(tm, sm, h, r, sc)
        p_k = torch.where(inside, torch.where(r >= h, punsoft, psoft), 0.0)
        return f_k, p_k

    def chunk(src, tpos, tgrav, tsoft, tmass):
        sg = src[:, 6].contiguous().view(torch.int32)
        dx = min_image(src[None, :, 0] - tpos[:, 0:1])
        dy = min_image(src[None, :, 1] - tpos[:, 1:2])
        dz = min_image(src[None, :, 2] - tpos[:, 2:3])
        r2 = dx * dx + dy * dy + dz * dz
        r = torch.sqrt(r2)
        h = torch.maximum(tsoft[:, None], src[None, :, 4])
        sm = src[None, :, 3]
        sc = src[None, :, 5].expand_as(r) if wiring.accumulator \
            else torch.ones_like(r)
        tm = tmass[:, None]
        fac = torch.zeros_like(r)
        pk = torch.zeros_like(r) if want_pot else None
        for law, slots in groups:
            f_k, p_k = law_fp(law, tm, sm, r2, r, h, sc)
            if not multi:
                fac, pk = f_k, p_k
                continue
            mk = torch.zeros_like(r, dtype=torch.bool)
            for (i, jj) in slots:
                mk = mk | ((tgrav[:, None] == i) & (sg[None, :] == jj))
            fac = torch.where(mk, f_k, fac)
            if want_pot:
                pk = torch.where(mk, p_k, pk)
        out = torch.stack([torch.sum(fac * dx, dim=1),
                           torch.sum(fac * dy, dim=1),
                           torch.sum(fac * dz, dim=1),
                           torch.sum(pk, dim=1) if want_pot
                           else torch.zeros_like(r[:, 0])], dim=1)
        if lattice_tables is not None:
            # the lattice (Ewald) correction of the remote rows, as the
            # local walk's lattice pass applies it
            pidx = tgrav[:, None].long() * NG + sg[None, :].long()
            fcx, fcy, fcz, pc = lattice_correction(
                lattice_tables, fac_intp, dx, dy, dz, pidx, corners)
            smv = sm.expand_as(r)
            out = out + torch.stack([torch.sum(smv * fcx, dim=1),
                                     torch.sum(smv * fcy, dim=1),
                                     torch.sum(smv * fcz, dim=1),
                                     torch.sum(smv * pc, dim=1)], dim=1)
        return out

    def near(src, tpos):
        """The rows within `cutoff` of the targets' bounding box."""
        lo, hi = torch.amin(tpos, dim=0), torch.amax(tpos, dim=0)
        d2 = torch.zeros(src.shape[0], dtype=src.dtype, device=src.device)
        for ax in range(3):
            x = src[:, ax]
            g = torch.maximum(lo[ax] - x, x - hi[ax])
            if periodic:
                g = torch.minimum(g, torch.minimum(
                    torch.maximum(lo[ax] - x - box, x + box - hi[ax]),
                    torch.maximum(lo[ax] - x + box, x - box - hi[ax])))
            d2 = d2 + torch.clamp(g, min=0.0) ** 2
        return src[torch.nonzero(d2 < cutoff * cutoff).squeeze(1)]

    def remote_eval(recv, tpos, tgrav, tsoft, tmass):
        nt = tpos.shape[0]
        sid = recv[:, 7].contiguous().view(torch.int32)
        src = recv[torch.nonzero(sid != -1).squeeze(1)]
        out = torch.zeros(nt, 4, dtype=torch.float32, device=tpos.device)
        # tiles of about 2^22 pairs: rows in whole multiples of EC
        step = EC * max(1, (1 << 22) // (EC * max(1, min(tchunk, nt))))
        for t0 in range(0, nt, tchunk):
            t = slice(t0, min(t0 + tchunk, nt))
            rows = near(src, tpos[t]) if cutoff > 0 else src
            acc = out[t]
            for c0 in range(0, rows.shape[0], step):
                acc = acc + chunk(rows[c0:c0 + step], tpos[t], tgrav[t],
                                  tsoft[t], tmass[t])
            out[t] = acc
        return out

    return remote_eval


class LetTreeStep(_TreeStepBase):
    """The locally-essential-tree step: per-rank memory o(N_total).

      1. every rank builds an octree over its own particles, on the shared
         global root cell (pmin / pmax of the live bounding boxes);
      2. for every receiver rank r, the sender evaluates its nodes densely
         against r's whole bounding box and exports the locally essential
         cut: a node as a monopole row where r cannot open it but could
         open its parent (both opening rules and the intersect rule),
         opened terminal nodes as their particles; the cut partitions the
         sender's mass;
      3. one all_to_all ships the packed rows; the receiver adds them as
         direct sources for all its targets on top of the exact fused walk
         of its own tree.

    Collisionless; pure tree (open or periodic with the Ewald lattice
    pass) or TreePM with the closed-form truncation.  Called as
    `ReplicatedTreeStep`; `caps`: a dict(expn, expp) of the exchange caps
    that several steps may share, grown in place."""

    def __init__(self, cfg, units, wiring, tables, mesh, opening=None,
                 pm_step=True, solver=None, caps=None):
        super().__init__(cfg, units, wiring, tables, mesh, opening=opening,
                         pm_step=pm_step, solver=solver)
        self.box = cfg.box_size if cfg.periodic else 0.0
        treepm = self.solver.treepm
        sr_cutoff = 0.0
        if treepm is not None:
            # short-range factors vanish past u = r/(2 asmth) = 3
            # (forcetree.c:1962-2026): rows past the cutoff need not ship
            sr_cutoff = 6.0 * treepm["asmth"]
            if not all(law.kernel_shortrange() is not None
                       for law, _ in wiring.unique_laws()):
                raise NotImplementedError(
                    "LET TreePM needs closed-form short-range kernels for "
                    "every wired law (remote rows are evaluated densely)")
        self.sr_cutoff = sr_cutoff
        lat = self.solver.lattice_tables
        self.remote_eval = make_let_remote_eval(
            wiring=wiring,
            treepm_asmth=treepm["asmth"] if treepm is not None else 0.0,
            lattice_tables=lat,
            fac_intp=(2 * (lat.shape[1] - 1) / self.box
                      if lat is not None else 0.0),
            NG=cfg.n_gravs, periodic=self.box > 0, box=self.box,
            cutoff=sr_cutoff, want_pot=self.want_pot)
        # the exchange caps (JAX's first expn_cap / expp_cap), a dict the
        # runner shares between its step variants
        self.caps = caps if caps is not None else dict(expn=4096, expp=8192)
        self.rows_received = None
        self.cap_retries = 0

    def _exchange(self, opening: str):
        """The exchange at the current caps (rounded up to 8 and to whole
        evaluation chunks, as the JAX step rounds them)."""
        ng = self.cfg.n_gravs
        exn = ((self.caps["expn"] + 7) // 8) * 8
        exp = ((self.caps["expp"] + 7) // 8) * 8
        rcap = ((exn * ng + exp + EC - 1) // EC) * EC
        return make_let_exchange(
            mesh=self.mesh, NG=ng, EXN=exn, EXP=exp, RCAP=rcap,
            theta=self.cfg.err_tol_theta, opening=opening,
            sr_cutoff=self.sr_cutoff, periodic=self.box > 0, box=self.box)

    def _gravity(self, p, mass, fsoft, opening):
        cfg, mesh, solver = self.cfg, self.mesh, self.solver
        nloc = p.pos.shape[0]
        dev = p.pos.device
        aold = cfg.err_tol_force_acc * p.old_acc / self.G
        live = p.pid >= 0
        big = 1e30
        lo_l = torch.amin(torch.where(live[:, None], p.pos, big), dim=0)
        hi_l = torch.amax(torch.where(live[:, None], p.pos, -big), dim=0)
        if self.box > 0:
            corner = torch.zeros(3, dtype=p.pos.dtype, device=dev)
            root_len = torch.tensor(self.box, dtype=p.pos.dtype, device=dev)
        else:
            ext = mesh.pmin(torch.cat([lo_l, -hi_l]))
            glo, ghi = ext[:3], -ext[3:]
            root_len = torch.amax(ghi - glo) * 1.0001 + 1e-30
            corner = (glo + ghi) / 2 - root_len / 2
        info = mesh.all_gather(torch.cat([
            lo_l, hi_l, torch.amin(torch.where(live, aold, big))[None]])[None])
        # the local tree over my particles only, on the global root cell
        tree = build_tree(p.pos, mass, p.grav, fsoft, aold,
                          depth=solver.depth, n_gravs=cfg.n_gravs,
                          bucket=cfg.tree_bucket_size,
                          group_size=cfg.walk_group_size,
                          corner=corner, root_len=root_len)
        for _ in range(6):
            recv, flags = self._exchange(opening)(
                tree, info[:, 0:3], info[:, 3:6], info[:, 6], nloc)
            ovf, node_rows, part_rows = (
                int(x) for x in mesh.pmax(flags).cpu())
            if not ovf:
                break
            # bunch-buffer growth (allocate.c:44-76), to twice the demand
            self.cap_retries += 1
            self.caps["expn"] = max(self.caps["expn"], 2 * node_rows + 8)
            self.caps["expp"] = max(self.caps["expp"], 2 * part_rows + 8)
        else:
            raise RuntimeError(f"LET exchange caps kept overflowing at "
                               f"{self.caps}")
        # live rows received this step (read by the runner's statistics)
        self.rows_received = torch.sum(
            recv[:, 7].contiguous().view(torch.int32) != -1)
        tgt = torch.where(live[tree.order.long()],
                          torch.arange(nloc, device=dev), -1)
        res = walk_targets(solver, tree, tgt, opening, self.want_pot)
        remote = self.remote_eval(recv, tree.pos_s, tree.grav_s,
                                  tree.fsoft_s, tree.mass_s)
        acc_s = res.acc + remote[:, 0:3]
        pot_s = res.pot + remote[:, 3]
        inv = torch.empty(nloc, dtype=torch.long, device=dev)
        inv[tree.order.long()] = torch.arange(nloc, device=dev)
        return acc_s[inv], pot_s[inv], \
            res.ninteract.to(torch.float32)[inv]
