"""Gravity solver front-end: octree, TreePM or direct summation.

Port of `ngravs_tpu/ops/solver.py`: the reference's `gravity_tree()`
(gravtree.c:27) as a host-side orchestrator.  Build (or refresh) the tree
from all particles, walk it for the active targets, scatter accelerations
back times G (gravtree.c:337-341) with the cosmological corrections; or
take the exact direct sweep for small N.  Under PMGRID the walk is the
TreePM short-range walk and `pm_forces` gives the long-range part
(long_range_force, longrange.c:56); TreePM never takes the direct sweep,
which would count the long range twice.

Cap management: the walk's per-block caps are fixed sizes; the solver grows
a cap the walk reports overflowing, to measured demand, and retries — the
analog of Gadget growing TreeAllocFactor (forcetree.c:3176).  The host
reads the overflow flag and demand statistics once per pass.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..config import SimulationConfig
from ..models.wiring import GravityWiring
from .direct import direct_forces
from .morton import MAX_DEPTH
from .pairwise import pairwise_eval
from .tree import build_tree, refresh_tree
from .walk import (frontier_slot_caps, make_fused_walk, measure_octet_demand,
                   normalize_frontier_caps, octet_counts)


class CosmoCorrections:
    """Static cosmological correction factors (gravtree.c:302-316,344-358;
    potential.c:251-258,310-337).  H = 0 (Newtonian units) disables all."""

    def __init__(self, fac_acc_com, fac_acc_lam, fac_pot_r2,
                 madelung_by_grav):
        self.fac_acc_com = fac_acc_com
        self.fac_acc_lam = fac_acc_lam
        self.fac_pot_r2 = fac_pot_r2
        self.madelung_by_grav = madelung_by_grav


def cosmo_corrections(cfg, G: float, hubble: float,
                      lattice_tables=None) -> CosmoCorrections:
    H2 = hubble * hubble
    open_box = not cfg.periodic and not cfg.pmgrid
    # comoving open box: acc += 0.5 H^2 Omega0 pos (pre-G in the
    # reference, so it feeds OldAcc; post-G here, same value)
    fac_acc_com = (0.5 * H2 * cfg.omega0
                   if open_box and cfg.comoving_integration else 0.0)
    # Newtonian coordinates with vacuum energy: acc += OmegaLambda H^2 pos
    # (added after OldAcc in the reference)
    fac_acc_lam = (cfg.omega_lambda * H2
                   if open_box and not cfg.comoving_integration else 0.0)
    # potential r^2 terms (potential.c:310-337): comoving open box
    # -0.5 Omega0 H^2 r^2; Newtonian -0.5 OmegaLambda H^2 r^2 (any box)
    if cfg.comoving_integration:
        fac_pot_r2 = -0.5 * cfg.omega0 * H2 if not cfg.periodic else 0.0
    else:
        fac_pot_r2 = -0.5 * cfg.omega_lambda * H2
    # comoving periodic with lattice tables: the per-gravity Madelung
    # ("LatticeZero") potential term -G psi0[g,g] m^(2/3)
    # (3 Omega0 H^2 / (8 pi G))^(1/3) (potential.c:251-258); the table
    # origin holds the Madelung constant rescaled by 1/L
    madelung = None
    if (cfg.comoving_integration and cfg.periodic
            and lattice_tables is not None and H2 > 0):
        ng = cfg.n_gravs
        t = lattice_tables.detach().cpu().numpy()
        psi0 = t.reshape(ng, ng, *t.shape[1:])[
            np.arange(ng), np.arange(ng), 0, 0, 0, 3] * cfg.box_size
        rho_fac = (cfg.omega0 * 3 * H2 / (8 * math.pi * G)) ** (1.0 / 3)
        madelung = torch.as_tensor(G * psi0 * rho_fac, dtype=torch.float32)
    return CosmoCorrections(fac_acc_com, fac_acc_lam, fac_pot_r2, madelung)


def apply_cosmo_corrections(c: CosmoCorrections, pos, mass, grav, acc, pot):
    """Corrections on G-multiplied (acc, pot) rows.  Returns (acc,
    old_acc_magnitude, pot): the comoving Omega0 term is inside OldAcc, the
    Lambda term is not (gravtree.c:304-315, 344-358)."""
    if c.fac_acc_com:
        acc = acc + c.fac_acc_com * pos
    amag = torch.sqrt(torch.sum(acc * acc, dim=-1))
    if c.fac_acc_lam:
        acc = acc + c.fac_acc_lam * pos
    if c.fac_pot_r2:
        pot = pot + c.fac_pot_r2 * torch.sum(pos * pos, dim=-1)
    if c.madelung_by_grav is not None:
        pot = pot - c.madelung_by_grav.to(pot.device)[grav.long()] \
            * mass ** (2.0 / 3)
    return acc, amag, pot


def _bucket(n: int, minimum: int = 256) -> int:
    return max(minimum, 1 << math.ceil(math.log2(max(n, 1))))


class GravitySolver:
    """Gravity for one simulation configuration, on the particles' device."""

    def __init__(self, cfg: SimulationConfig, wiring: GravityWiring,
                 fsoft_by_type, g_const: float, hubble: float = 0.0,
                 device="cpu"):
        if cfg.adaptive_gravsoft_forgas:
            raise NotImplementedError(
                "ADAPTIVE_GRAVSOFT_FORGAS needs SPH, not yet ported to "
                "ngravs_tpu_torch (ROADMAP Queue 1 item 16)")
        self.cfg = cfg
        self.wiring = wiring
        self.G = float(g_const)
        self.fsoft_by_type = torch.as_tensor(np.asarray(fsoft_by_type,
                                                        np.float32))
        # the walk's pair evaluation (K1a); a benchmark may swap in the twin
        self.pair_eval = pairwise_eval
        self.depth = cfg.tree_depth
        self._fat_warned = False
        self._rel_ready = False
        self._tightened = False
        # cached tree for Gadget's rebuild cadence: a full rebuild only
        # after TreeDomainUpdateFrequency * N force computations
        # (domain.c:76); between rebuilds moments are refreshed in place
        self._tree_cache = None
        self._forces_since_build = 0
        # per-block walk caps: unified chunk list and per-level frontier
        self.fcaps = dict(
            chunk=_bucket(cfg.walk_chunk_cap, 64),
            frontier=normalize_frontier_caps(cfg.walk_frontier_cap,
                                             self.depth))
        self.leaf_factor = 2.0  # leaf-chunk table rows per particle
        # measured per-level octet caps (set from the first built tree)
        self.octet_caps = None
        self.box = cfg.box_size if cfg.periodic else 0.0
        # periodic pure-tree runs need the lattice (Ewald) tables
        # (begrun.c:47-49); the port's walk has no lattice pass yet, so
        # such runs are refused by the walk (ROADMAP Queue 1 item 13)
        self.lattice_tables = None
        # TreePM: the PM solver and the short-range walk's split scale
        # and cut (long_range_init, longrange.c:20); the walk takes the
        # laws' closed-form truncation
        self.pm = None
        self.treepm = None
        if cfg.pmgrid:
            from .pm import PMSolver
            if cfg.ngravs_treepm_xition_check:
                raise NotImplementedError(
                    "the TreePM transition-table dump needs the tabulated "
                    "transition, not yet ported to ngravs_tpu_torch "
                    "(ROADMAP Queue 1 item 14)")
            self.pm = PMSolver(wiring, cfg.pmgrid, cfg.box_size, cfg.n_gravs,
                               g_const, asmth_cells=cfg.asmth,
                               gradient=cfg.pm_gradient,
                               interlace=cfg.pm_interlace, device=device)
            self.pm.rcut = cfg.rcut * self.pm.asmth
            self.treepm = dict(asmth=self.pm.asmth, rcut=self.pm.rcut)
        self._corr = cosmo_corrections(cfg, self.G, hubble,
                                       self.lattice_tables)

    # ------------------------------------------------------------------
    def clamp_caps(self, n: int):
        """Clamp the walk caps to their theoretical maxima for an
        n-particle tree; demand can never exceed these."""
        bucket = self.cfg.tree_bucket_size
        slot_caps = frontier_slot_caps(n, self.depth, bucket=bucket)
        n_oct = int(np.sum(octet_counts(n, self.depth, bucket)))
        cap2 = ((int(n * self.leaf_factor) + 8 + 7) // 8) * 8
        fc = self.fcaps
        fc["chunk"] = min(fc["chunk"],
                          _bucket(cap2 // 8 + 1 + n_oct * self.cfg.n_gravs,
                                  64))
        fl = normalize_frontier_caps(fc["frontier"], self.depth)
        fc["frontier"] = tuple(min(f, c) for f, c in zip(fl, slot_caps))

    def grow_caps(self, max_chunk: int, lvl_demand) -> None:
        """Resize the caps to measured peak demand (+25% margin).  A level
        whose demand reached its cap was truncated: at least double it."""
        fc = self.fcaps
        fc["chunk"] = max(fc["chunk"], _bucket(int(max_chunk) * 5 // 4, 64))
        fl = list(normalize_frontier_caps(fc["frontier"], self.depth))
        for lvl, d in enumerate(np.asarray(lvl_demand).reshape(-1)):
            if lvl > self.depth:
                break
            d = int(d)
            if d >= fl[lvl]:
                fl[lvl] = min(max(fl[lvl] * 2, _bucket(d * 5 // 4, 64)),
                              8 ** min(lvl, 10))
        fc["frontier"] = tuple(fl)

    def tighten_caps(self, max_chunk: int, lvl_demand) -> None:
        """Shrink caps toward measured demand (+25%): walk cost grows with
        the caps."""
        tight = lambda mx: _bucket(int(mx) * 5 // 4, 64)
        fc = self.fcaps
        fc["chunk"] = min(fc["chunk"], tight(max_chunk))
        fl = list(normalize_frontier_caps(fc["frontier"], self.depth))
        for lvl, d in enumerate(np.asarray(lvl_demand).reshape(-1)):
            if lvl > self.depth:
                break
            fl[lvl] = min(fl[lvl], tight(int(d)))
        fc["frontier"] = tuple(fl)

    def _walk(self, want_pot: bool):
        cfg = self.cfg
        return make_fused_walk(
            self.wiring, n_gravs=cfg.n_gravs, depth=self.depth,
            bucket=cfg.tree_bucket_size, group_size=cfg.walk_group_size,
            batch_blocks=cfg.walk_batch_blocks,
            chunk_cap=self.fcaps["chunk"], frontier_cap=self.fcaps["frontier"],
            theta=cfg.err_tol_theta, opening="relative",
            box_size=self.box, leaf_factor=self.leaf_factor,
            want_pot=want_pot, lattice_tables=self.lattice_tables,
            treepm=self.treepm, octet_caps=self.octet_caps,
            pair_eval=self.pair_eval)

    def _measure_octets(self, tree, n: int) -> None:
        """Octet caps from the built tree's per-level occupancy, with a 1.5x
        margin (rounded up to 8) so drifted refreshes do not overflow."""
        bucket = self.cfg.tree_bucket_size
        demand = measure_octet_demand(tree, n, self.depth, bucket)
        bound = octet_counts(n, self.depth, bucket)
        self.octet_caps = tuple(min(b, ((d * 3 // 2 + 7) // 8) * 8)
                                for d, b in zip(demand, bound))

    def _fsoft(self, p):
        return self.fsoft_by_type.to(p.device)[p.ptype.long()]

    def _scatter(self, p, orig, acc, pot, want_pot: bool, ninteract=None):
        """Write G-scaled, corrected target rows back (original order)."""
        acc, amag, pot = apply_cosmo_corrections(
            self._corr, p.pos[orig], p.mass[orig], p.grav[orig],
            acc * self.G, pot * self.G)
        accel = p.accel.clone()
        accel[orig] = acc
        old_acc = p.old_acc.clone()
        old_acc[orig] = amag
        kw = dict(accel=accel, old_acc=old_acc)
        if want_pot:
            potential = p.potential.clone()
            potential[orig] = pot
            kw["potential"] = potential
        if ninteract is not None:
            cost = p.grav_cost.clone()
            cost[orig] = ninteract.to(cost.dtype)
            kw["grav_cost"] = cost
        return p.replace(**kw)

    def uses_direct(self, n: int) -> bool:
        """Whether compute() takes the exact O(N^2) path for n particles
        (an explicitly requested tree solver is honored at any n; TreePM
        never takes it)."""
        if self.treepm is not None:
            return False
        if self.cfg.solver == "direct":
            return True
        if self.cfg.solver == "tree":
            return False
        return (n <= 2 * self.cfg.tree_group_size
                or n <= self.cfg.direct_crossover)

    def pm_forces(self, p):
        """Long-range PM accelerations of ALL particles (long_range_force,
        longrange.c:56 -> pmforce_periodic)."""
        return self.pm.forces(p.pos, p.mass, p.grav)

    # ------------------------------------------------------------------
    def compute(self, p, ti_current: int, n_active: int,
                opening: str = "relative", want_pot: bool = False):
        """Forces for the active set (ti_endstep == ti_current); returns
        (particles', n_interactions, tree or None).

        `want_pot=False` (the default force pass) skips the potential and
        leaves p.potential stale, like the reference (potentials refresh
        only in compute_potential passes)."""
        fsoft = self._fsoft(p)
        if self.uses_direct(p.n):
            tgt = torch.nonzero(p.ti_endstep == ti_current).squeeze(1)
            acc, pot = direct_forces(
                self.wiring, p.pos, p.mass, p.grav, fsoft,
                tgt_idx=tgt.to(torch.int32), box=self.box,
                chunk=min(1024, _bucket(max(tgt.shape[0], 1))),
                want_pot=True, lattice_tables=self.lattice_tables)
            p = self._scatter(p, tgt, acc, pot, want_pot=True)
            return p, tgt.shape[0] * p.n, None

        if self.cfg.type_of_opening_criterion == 0:
            opening = "bh"
        elif opening == "relative" and not self._rel_ready:
            # the relative criterion needs a prior acceleration; with
            # OldAcc == 0 it would open every node.  The reference
            # bootstraps with the geometric criterion (accel.c:48-52)
            if float(torch.amax(p.old_acc)) == 0.0:
                opening = "bh"
            else:
                self._rel_ready = True
        self.clamp_caps(p.n)
        bucket = self.cfg.tree_bucket_size
        aold = self.cfg.err_tol_force_acc * p.old_acc / self.G  # G=1 units
        hsml = torch.zeros_like(p.mass)
        can_refresh = (self._tree_cache is not None
                       and self._forces_since_build
                       < self.cfg.tree_domain_update_frequency * p.n)
        while True:
            if can_refresh:
                tree = refresh_tree(self._tree_cache, p.pos, p.mass, p.grav,
                                    fsoft, aold, hsml, depth=self.depth,
                                    n_gravs=self.cfg.n_gravs, bucket=bucket)
                break
            tree = build_tree(p.pos, p.mass, p.grav, fsoft, aold, hsml,
                              depth=self.depth, n_gravs=self.cfg.n_gravs,
                              bucket=bucket, box_size=self.box,
                              group_size=self.cfg.walk_group_size)
            # largest bucket-leaf occupancy: > bucket means the depth limit
            # truncates leaf evaluation (fat leaf) -> deepen
            fat = torch.amax(torch.where(tree.node_terminal,
                                         tree.node_pcount, 0))
            fat_v, need = (int(x) for x in
                           torch.stack([fat, tree.n_chunk_rows]).cpu())
            cap2 = ((int(p.n * self.leaf_factor) + 8 + 7) // 8) * 8
            if need > cap2:
                self.leaf_factor = need * 1.25 / p.n
            if fat_v <= bucket and self.depth >= 1:
                break
            if self.depth >= MAX_DEPTH:
                if not self._fat_warned:
                    warnings.warn(
                        f"octree bucket leaves still hold {fat_v} > {bucket} "
                        f"particles at the maximum depth {MAX_DEPTH}; "
                        "near-coincident particles will interact via "
                        "softened truncated leaves")
                    self._fat_warned = True
                break
            # fat leaves: deepen the tree; octet and frontier caps are
            # depth-shaped, so both restart from the configured values
            self.depth = min(self.depth + 3, MAX_DEPTH)
            self.octet_caps = None
            self.fcaps["frontier"] = normalize_frontier_caps(
                self.cfg.walk_frontier_cap, self.depth)
            self.clamp_caps(p.n)
        if self.octet_caps is None:
            self._measure_octets(tree, p.n)
        tgt_sorted = torch.nonzero(
            (p.ti_endstep == ti_current)[tree.order.long()]).squeeze(1)
        for _ in range(8):
            res = self._walk(want_pot)(tree, tgt_sorted,
                                       opening_override=opening)
            head = torch.stack([res.overflow.long(), res.layout_ovf.long(),
                                res.max_chunk.long()]).cpu()
            ovf, lovf, mc = (int(x) for x in head)
            mf = res.max_frontier.cpu().numpy()
            if not ovf:
                # shrink caps toward measured demand once per run
                if not self._tightened:
                    self._tightened = True
                    self.tighten_caps(mc, mf)
                break
            # only an octet-LAYOUT overflow needs an octet re-measure
            if lovf:
                self._measure_octets(tree, p.n)
            self.grow_caps(mc, mf)
        else:
            raise RuntimeError(
                f"tree walk caps still overflowing at {self.fcaps}")
        orig = tree.order[tgt_sorted].long()
        p = self._scatter(p, orig, res.acc, res.pot, want_pot, res.ninteract)
        n_ia = int(torch.sum(res.ninteract))
        if can_refresh:
            self._forces_since_build += min(n_active, p.n)
        else:
            self._forces_since_build = min(n_active, p.n)
        self._tree_cache = tree
        return p, n_ia, tree
