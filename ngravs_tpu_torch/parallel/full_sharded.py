"""The replicated TreePM + SPH step over the ranks (port of
`ngravs_tpu/parallel/full_sharded.py`, BASELINE config 5: multi-species
cosmological TreePM + SPH over the ranks).

One whole iteration of the reference's main loop (run.c:32-132) with every
MPI exchange it performs, as the JAX package rebuilt it:

  reference mechanism                         -> here
  --------------------------------------------------------------------
  drift + SPH prediction (predict.c:31-104)   -> local updates
  tree build + pseudo-particle moment
  exchange (forcetree.c:61,766-819)           -> all_gather the sources +
                                                 the same tree on every
                                                 rank, in particle-ID order
  short-range tree walk with export/import    -> the fused walk (K1) of my
  bunches (gravtree.c:102-285)                   slice of the sorted targets
  PM with the FFTW-MPI slab exchange          -> `ShardedPMSolver`
  SPH density + h iteration with export
  bunches (density.c:56-426)                  -> `HydroSolver.density` on my
                                                 slice of the sorted active
                                                 gas, the whole gas state
                                                 gathered
  force_update_hmax (forcetree.c:1134)        -> `update_node_hmax`
  hydro force exchange (hydra.c:50-304)       -> `HydroSolver.hydro`, the
                                                 same slice
  kick + timestep (timestep.c:24-408)         -> local masked kick
  MPI_Allreduce(min Ti_endstep) (run.c:165)   -> pmin

The SPH targets of a rank are a contiguous slice of the active gas in the
replicated tree's sorted order, in whole blocks, not the rank's own rows
(JAX's choice): the tree is built in particle-ID order, so the blocks, and
so every sum, do not depend on which rank holds which particle, and a run
resumed from a restart file, decomposed anew, continues bit for bit.  Each
pass's outputs travel in one all_gather, as the walk's do.  The SPH
candidate caps grow on the rank that overflows them (a local retry: the
passes hold no collective).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..integrate.kdk import box_wrap, drift, predict_sph
from ..ops.morton import level_key2
from ..ops.sph import HydroSolver
from ..ops.tree import (_counts, _run_segments, _segment_max0, level_caps)
from ..particles import SphState
from .tree_sharded import ReplicatedTreeStep, _bits

# the gathered gas columns besides vel_pred [3] and the step's ticks
GAS_COLS = ("hsml", "entropy", "dt_entropy", "density", "pressure",
            "dhsml_density_factor", "div_vel", "curl_vel")
# the density pass's outputs, then the hydro pass's
DENSITY_OUT = ("hsml", "density", "num_ngb", "div_vel", "curl_vel",
               "dhsml_density_factor", "pressure")
HYDRO_OUT = ("hydro_accel", "dt_entropy", "max_signal_vel")


def update_node_hmax(tree, depth: int, bucket: int):
    """Every node's hmax recomputed from tree.hsml_s (force_update_hmax,
    forcetree.c:1134-1240): a segmented max a level over the tree's own
    run segmentation (the structure frozen, as `build_tree` made it: a
    particle below its terminal node leaves the deeper levels)."""
    n = tree.hsml_s.shape[0]
    caps = level_caps(n, depth, bucket=bucket)
    offsets = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    hmaxs = []
    done = torch.zeros(n, dtype=torch.bool, device=tree.hsml_s.device)
    for lvl in range(depth + 1):
        cap = caps[lvl]
        hk, lk = level_key2(tree.khi_s, tree.klo_s, depth, lvl)
        live = ~done
        _, seg = _run_segments(hk, lk, live, cap)
        segc = seg.clamp(max=cap)
        pc = tree.node_pcount[int(offsets[lvl]):int(offsets[lvl + 1])]
        hmaxs.append(torch.where(
            pc > 0, _segment_max0(tree.hsml_s, segc, cap + 1)[:cap], 0.0))
        terminal = (_counts(segc, cap) <= bucket) | (lvl == depth)
        done = done | (live & terminal[seg.clamp(max=cap - 1)])
    return tree._replace(node_hmax=torch.cat(hmaxs))


def at_sync_point(step, p, sph, ti: int):
    """The state a step's passes see at the sync point `ti` of a run that
    is already there (the drift and the gas prediction from `ti` to `ti`,
    as JAX's throwaway step makes them), with the tree inputs: (p, sph,
    mass, fsoft, aold, hsml)."""
    cfg = step.cfg
    sph = predict_sph(cfg, p, sph, step.tables, ti, ti)
    p = box_wrap(cfg, drift(p, step.tables, ti, ti))
    live = p.pid >= 0
    mass = torch.where(live, p.mass, 0.0)
    fsoft = step.fsoft_by_type[p.ptype.long()]
    aold = cfg.err_tol_force_acc * p.old_acc / step.G
    hsml = torch.where((p.ptype == 0) & live, sph.hsml, 0.0)
    return p, sph, mass, fsoft, aold, hsml


def gas_targets(p, sph, ti: int):
    """This rank's rows that the SPH passes at `ti` update: active gas
    with a smoothing length."""
    return (p.ptype == 0) & (p.pid >= 0) & (p.ti_endstep == ti) \
        & (sph.hsml > 0)


class ReplicatedFullStep(ReplicatedTreeStep):
    """The replicated step with gas: gravity as `ReplicatedTreeStep` (the
    tree built with the gathered smoothing lengths), then the SPH passes
    on this rank's slice of the sorted active gas.

    Called as step(p, ti_current, ti_next, time_next[, pm_beg, pm_end],
    *mode_extras, sph=sph) -> StepResult with `.sph`.  `hydro`: a
    `HydroSolver` the runner shares between the step variants (its
    candidate cap).  The SPH passes are the span `sph` of the rank's trace
    (`mesh.trace`), ending synchronised."""

    def __init__(self, cfg, units, wiring, tables, mesh, opening=None,
                 pm_step=True, solver=None, hydro=None):
        super().__init__(cfg, units, wiring, tables, mesh, opening=opening,
                         pm_step=pm_step, solver=solver)
        self.hydro = hydro if hydro is not None \
            else HydroSolver(cfg, units, trace=mesh.trace)

    def density_only(self, p, sph, ti: int):
        """The density pass alone for the gas active at `ti` (the
        smoothing-length iteration; no gravity, no hydro, no kick): the
        densities JAX's runner takes from a throwaway step to turn the
        IC's internal energy into entropy (init.c:170-174)."""
        p, sph, mass, fsoft, aold, hsml = at_sync_point(self, p, sph, ti)
        self._build(p, mass, fsoft, aold, hsml)
        return self._sph(p, sph, ti, None)

    def _sph_forces(self, p, sph, ti_next: int, time_next: float):
        return self._sph(p, sph, ti_next, time_next)

    # ------------------------------------------------------------------
    def _gathered(self, p, sph):
        """The whole gas state in the tree's row (particle-ID) order, as
        the passes read it: (particles view, SphState)."""
        f32 = torch.float32
        rows = self.mesh.all_gather(torch.cat(
            [sph.vel_pred] + [getattr(sph, k)[:, None] for k in GAS_COLS]
            + [p.ti_begstep.view(f32)[:, None],
               p.ti_endstep.view(f32)[:, None]], dim=1))[self._perm]
        n = rows.shape[0]
        col = {k: rows[:, 3 + i].contiguous() for i, k in enumerate(GAS_COLS)}
        z = torch.zeros(n, dtype=f32, device=rows.device)
        sg = SphState(vel_pred=rows[:, 0:3].contiguous(),
                      hydro_accel=torch.zeros_like(rows[:, 0:3]),
                      max_signal_vel=z, num_ngb=z, **col)
        k = 3 + len(GAS_COLS)
        pg = SimpleNamespace(
            ti_begstep=rows[:, k].contiguous().view(torch.int32),
            ti_endstep=rows[:, k + 1].contiguous().view(torch.int32),
            pid=self._pid_f, n=n)
        return pg, sg

    def _slice(self, tree, pg, ti: int):
        """My contiguous slice of the sorted active gas, in whole blocks of
        the solver's group: ([N] bool in sorted order, my count, the slice
        length), or None when no gas is active."""
        mesh = self.mesh
        act = (pg.ti_endstep == ti)[tree.order.long()] & (tree.hsml_s > 0)
        n_act = int(torch.sum(act))
        if n_act == 0:
            return None
        g = self.hydro.group
        per = -(-n_act // (mesh.size * g)) * g
        pos = torch.cumsum(act, 0) - 1
        lo = mesh.rank * per
        mask = act & (pos >= lo) & (pos < lo + per)
        return mask, max(0, min(per, n_act - lo)), per

    def _share(self, tree, sel, full: SphState, names):
        """Every rank's pass outputs (fields `names` of the targets it
        ran) written into the whole state `full`: one all_gather."""
        mask, _, per = sel
        orig = tree.order[torch.nonzero(mask).squeeze(1)].long()
        width = lambda a: int(np.prod(a.shape[1:]))
        cols = [getattr(full, k)[orig].reshape(orig.shape[0],
                                               width(getattr(full, k)))
                for k in names]
        out = torch.cat(cols + [orig.to(torch.int32).view(torch.float32)
                                [:, None]], dim=1)
        pad = out.new_zeros(per - out.shape[0], out.shape[1])
        pad[:, -1] = _bits(-1, pad.device)
        got = self.mesh.all_gather(torch.cat([out, pad]))
        idx = got[:, -1].contiguous().view(torch.int32)
        got = got[idx >= 0]
        idx = idx[idx >= 0].long()
        upd, c = {}, 0
        for k in names:
            a = getattr(full, k)
            w = width(a)
            a = a.clone()
            a[idx] = got[:, c:c + w].reshape((-1,) + tuple(a.shape[1:]))
            upd[k] = a
            c += w
        return full.replace(**upd)

    def _sph(self, p, sph, ti: int, time_next):
        """The density pass (and with `time_next` the hydro pass) of the
        active gas at `ti` on the tree of the last build."""
        with self.mesh.trace.span("sph"):
            cfg, mesh, hs = self.cfg, self.mesh, self.hydro
            tree = self._tree
            depth, tbi = self.solver.depth, float(self.tbi)
            pg, full = self._gathered(p, sph)
            sel = self._slice(tree, pg, ti)
            if sel is None:
                return sph
            mask, n_mine, _ = sel
            full = self._share(tree, sel, hs.density(
                tree, pg, full, ti, n_mine, depth, tbi, mask=mask), DENSITY_OUT)
            names = DENSITY_OUT
            if time_next is not None:
                # the node hmax from the converged smoothing lengths
                # (accel.c:60-89, force_update_hmax)
                tree = update_node_hmax(
                    tree._replace(hsml_s=full.hsml[tree.order.long()]), depth,
                    cfg.tree_bucket_size)
                full = self._share(tree, sel, hs.hydro(
                    tree, pg, full, ti, n_mine, depth, tbi, time_next,
                    mask=mask), HYDRO_OUT)
                names = DENSITY_OUT + HYDRO_OUT
            # my rows back: the targets' new values (the others are unchanged)
            inv = torch.empty_like(self._perm)
            inv[self._perm] = torch.arange(self._perm.shape[0],
                                           device=inv.device)
            nloc = p.pos.shape[0]
            mine = inv[mesh.rank * nloc:(mesh.rank + 1) * nloc]
            tgt = gas_targets(p, sph, ti)
            upd = {}
            for k in names:
                new = getattr(full, k)[mine]
                old = getattr(sph, k)
                upd[k] = torch.where(tgt.reshape((-1,) + (1,) * (old.dim() - 1)),
                                     new, old)
            sph = sph.replace(**upd)
            self.mesh.trace.sync(p.pos.device)
        return sph
