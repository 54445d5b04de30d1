"""The LET TreePM + SPH step: per-rank memory o(N_total) (port of
`ngravs_tpu/parallel/full_let_sharded.py`).

The config-5 structure (multi-species cosmological TreePM + SPH over the
ranks) without the replicated tree.  The reference's export/import bunches
serve gravity and SPH alike (gravtree.c:102-285, density.c:115-285,
hydra.c:124-304); here both are sender-driven exchanges:

  * gravity: `LetTreeStep` (the local tree, the LET cut and its
    all_to_all, the dense evaluation of the received rows);
  * SPH: a sender-driven GHOST exchange.  Every rank ships the gas rows
    that can interact with a receiver's gas: the distance of the row to
    the receiver's gas bounding box is below max(h_row, margin * hmax_r)
    (the sender-driven dual of the reference's receiver-driven neighbour
    export, density.c:115-285).  Round A (x, y, z, vel_pred, mass, hsml)
    goes before the density iteration, round B (those with the converged
    hsml, then rho, P / rho^2 * f, the sound speed, the Balsara factor and
    the step) before the hydro force.  Local neighbours come from the
    local tree's candidate gather (`HydroSolver`); the ghost rows are
    summed densely with the same pair sums (density.c:467-599,
    hydra.c:353-555) on top, every density iteration.

The ghost rows of a rank are culled per chunk of its sorted targets: a
row is kept when its distance to the chunk's bounding box is below the
largest smoothing length of the chunk's targets (and, for the hydro force,
below its own smoothing length).  Every other row contributes exactly zero,
so the culled sums are the dense ones up to f32 summation order.

Caps and the margin contract (JAX's step flags an overflow and its runner
re-runs the step with the same caps; see ROADMAP, Queue 3): the ghost cap
grows to twice the largest rank's demand before a round ships (one pmax),
and when a converged smoothing length exceeds margin * hmax, the margin
grows to cover it (pmax'd), round A ships again and the density iteration
reruns from the step's state.  Every loop that holds a collective is driven
by a pmax'd value, so every rank enters the same collectives.
"""

from __future__ import annotations


import torch

from ..ops.sph import HydroSolver, _min_image, kernel_wk_dwk
from ..ops.tree import _compact_rows
from .full_sharded import (at_sync_point, gas_targets,
                           update_node_hmax)
from .tree_sharded import LetTreeStep

GHOST_CAP, GHOST_MARGIN = 4096, 1.35    # JAX's first caps
GA_F = 8      # round A: x y z vx vy vz mass hsml
GB_F = 13     # round B: round A's, then rho pterm cs f1 dt
TCHUNK = 1024     # targets a culling chunk
PAIRS = 1 << 22   # pairs in one dense tile


def box_gap(x, lo, hi, box: float):
    """Per-axis gap of points x to the interval [lo, hi] (negative
    inside), the periodic images included when box > 0."""
    g = torch.maximum(lo - x, x - hi)
    if box > 0:
        g = torch.minimum(g, torch.minimum(
            torch.maximum(lo - x - box, x + box - hi),
            torch.maximum(lo - x + box, x - box - hi)))
    return g


def ghost_select(pos, is_gas, hsml, gas_lo, gas_hi, hmax_r, rank: int,
                 margin: float, box3):
    """[n, K] bool: local gas row j ships to receiver r when its distance
    to r's gas box is below max(h_j, margin * hmax_r); never to itself."""
    k = gas_lo.shape[0]
    d2 = torch.zeros(pos.shape[0], k, dtype=pos.dtype, device=pos.device)
    for ax in range(3):
        g = box_gap(pos[:, ax, None], gas_lo[None, :, ax],
                    gas_hi[None, :, ax], box3[ax] if box3 else 0.0)
        d2 = d2 + torch.clamp(g, min=0.0) ** 2
    thr = torch.maximum(hsml[:, None], margin * hmax_r[None, :])
    sel = is_gas[:, None] & (d2 < thr * thr)
    return sel & (torch.arange(k, device=pos.device) != rank)[None, :]


def cull(tpos, radius, tvalid, gpos, ghsml, box3, tchunk: int = TCHUNK):
    """For each chunk of `tchunk` targets, the ghost rows (indices into
    gpos, ascending) within reach of the chunk's valid targets: distance to
    their bounding box below max(largest radius, the row's own hsml when
    `ghsml` is given).  One host read."""
    nt = tpos.shape[0]
    nch = -(-nt // tchunk)
    pad = nch * tchunk - nt
    big = 1e30
    tv = torch.cat([tvalid, tvalid.new_zeros(pad)]).reshape(nch, tchunk)
    tp = torch.cat([tpos, tpos.new_zeros(pad, 3)]).reshape(nch, tchunk, 3)
    rd = torch.cat([radius, radius.new_zeros(pad)]).reshape(nch, tchunk)
    lo = torch.amin(torch.where(tv[..., None], tp, big), dim=1)
    hi = torch.amax(torch.where(tv[..., None], tp, -big), dim=1)
    reach = torch.amax(torch.where(tv, rd, 0.0), dim=1)         # [nch]
    d2 = torch.zeros(nch, gpos.shape[0], dtype=gpos.dtype,
                     device=gpos.device)
    for ax in range(3):
        g = box_gap(gpos[None, :, ax], lo[:, ax, None], hi[:, ax, None],
                    box3[ax] if box3 else 0.0)
        d2 = d2 + torch.clamp(g, min=0.0) ** 2
    thr = reach[:, None].expand_as(d2)
    if ghsml is not None:
        thr = torch.maximum(thr, ghsml[None, :])
    keep = (d2 < thr * thr) & torch.any(tv, dim=1)[:, None]
    hit = torch.nonzero(keep)
    counts = torch.bincount(hit[:, 0], minlength=nch).cpu().tolist()
    return torch.split(hit[:, 1], counts)


def _tiles(rows, nt: int):
    step = max(1, PAIRS // max(nt, 1))
    for c0 in range(0, rows.shape[0], step):
        yield rows[c0:c0 + step]


def ghost_density(tpos, tvel, hsml, tvalid, ghosts, kernel, box3,
                  culled: bool = True, tchunk: int = TCHUNK):
    """The ghost-row half of density_evaluate (density.c:467-599) for
    flattened targets: raw (rho, sum W, dhsml, div v, rot v [3]) sums over
    round-A rows `ghosts` [R, GA_F].  `culled=False` sums every row
    against every target (the dense reference)."""
    nt = tpos.shape[0]
    out = torch.zeros(nt, 7, dtype=torch.float32, device=tpos.device)
    if ghosts.shape[0] and bool(torch.any(tvalid)):
        lists = cull(tpos, hsml, tvalid, ghosts[:, 0:3], None, box3,
                     tchunk) if culled else None
        for c, t0 in enumerate(range(0, nt, tchunk)):
            t = slice(t0, min(t0 + tchunk, nt))
            rows = ghosts if lists is None else ghosts[lists[c]]
            acc = out[t]
            for g in _tiles(rows, t.stop - t.start):
                acc = acc + _density_terms(tpos[t], tvel[t], hsml[t],
                                           tvalid[t], g, kernel, box3)
            out[t] = acc
    return (out[:, 0], out[:, 1], out[:, 2], out[:, 3], out[:, 4:7])


def _density_terms(tpos, tvel, hsml, tvalid, g, kern, box3):
    dxs = _min_image([tpos[:, d:d + 1] - g[None, :, d] for d in range(3)],
                     box3)
    r = torch.sqrt(dxs[0] ** 2 + dxs[1] ** 2 + dxs[2] ** 2)
    hinv = 1.0 / torch.clamp(hsml, min=1e-30)
    u = r * hinv[:, None]
    wk, dwk = kernel_wk_dwk(u, hinv[:, None], kern)
    inside = (u < 1.0) & tvalid[:, None]
    wk = torch.where(inside, wk, 0.0)
    dwk = torch.where(inside, dwk, 0.0)
    m = g[None, :, 6]
    fac = torch.where(r > 0, m * dwk / torch.clamp(r, min=1e-30), 0.0)
    dvs = [tvel[:, d:d + 1] - g[None, :, 3 + d] for d in range(3)]
    vdotr = dxs[0] * dvs[0] + dxs[1] * dvs[1] + dxs[2] * dvs[2]
    return torch.stack([
        torch.sum(m * wk, dim=1), torch.sum(wk, dim=1),
        torch.sum(-m * (kern.ndims * hinv[:, None] * wk + u * dwk), dim=1),
        -torch.sum(fac * vdotr, dim=1),
        torch.sum(fac * (dxs[2] * dvs[1] - dxs[1] * dvs[2]), dim=1),
        torch.sum(fac * (dxs[0] * dvs[2] - dxs[2] * dvs[0]), dim=1),
        torch.sum(fac * (dxs[1] * dvs[0] - dxs[0] * dvs[1]), dim=1)], dim=1)


def ghost_hydro(tgt: dict, ghosts, facs, visc_const: float, use_limiter,
                kernel, box3, culled: bool = True, tchunk: int = TCHUNK):
    """The ghost-row half of hydro_evaluate (hydra.c:353-555) for flattened
    targets `tgt` (pos, vel, h, rho, pterm, cs, f1, dt, mass, valid), the
    j-quantities from round-B rows `ghosts` [R, GB_F].  Returns (acc [T,3],
    dt_entropy, max_signal_vel) before the finalisation."""
    nt = tgt["pos"].shape[0]
    dev = tgt["pos"].device
    out = torch.zeros(nt, 4, dtype=torch.float32, device=dev)
    ms = torch.zeros(nt, dtype=torch.float32, device=dev)
    if ghosts.shape[0] and bool(torch.any(tgt["valid"])):
        lists = cull(tgt["pos"], tgt["h"], tgt["valid"], ghosts[:, 0:3],
                     ghosts[:, 7], box3, tchunk) if culled else None
        for c, t0 in enumerate(range(0, nt, tchunk)):
            t = slice(t0, min(t0 + tchunk, nt))
            rows = ghosts if lists is None else ghosts[lists[c]]
            sub = {k: v[t] for k, v in tgt.items()}
            acc, mx = out[t], ms[t]
            for g in _tiles(rows, t.stop - t.start):
                a, m = _hydro_terms(sub, g, facs, visc_const, use_limiter,
                                    kernel, box3)
                acc, mx = acc + a, torch.maximum(mx, m)
            out[t], ms[t] = acc, mx
    return out[:, 0:3], out[:, 3], ms


def _hydro_terms(t, g, facs, visc_const, use_limiter, kern, box3):
    fac_mu, fac_vsic_fix, hubble_a2 = facs
    dxs = _min_image([t["pos"][:, d:d + 1] - g[None, :, d]
                      for d in range(3)], box3)
    r2 = dxs[0] ** 2 + dxs[1] ** 2 + dxs[2] ** 2
    r = torch.sqrt(r2)
    h_i, h_j = t["h"], g[None, :, 7]
    pairmask = ((r2 < h_i[:, None] ** 2) | (r2 < h_j ** 2)) \
        & t["valid"][:, None]
    dvs = [t["vel"][:, d:d + 1] - g[None, :, 3 + d] for d in range(3)]
    vdotr2 = dxs[0] * dvs[0] + dxs[1] * dvs[1] + dxs[2] * dvs[2] \
        + hubble_a2 * r2
    hinv_i = 1.0 / torch.clamp(h_i, min=1e-30)
    _, dwk_i = kernel_wk_dwk(r * hinv_i[:, None], hinv_i[:, None], kern)
    dwk_i = torch.where(r2 < h_i[:, None] ** 2, dwk_i, 0.0)
    hinv_j = 1.0 / torch.clamp(h_j, min=1e-30)
    _, dwk_j = kernel_wk_dwk(r * hinv_j, hinv_j, kern)
    dwk_j = torch.where(r2 < h_j ** 2, dwk_j, 0.0)
    smass, rho_j = g[None, :, 6], g[None, :, 8]
    pterm_j, cs_j, f2, dt_j = (g[None, :, 9], g[None, :, 10],
                               g[None, :, 11], g[None, :, 12])
    cs_sum = t["cs"][:, None] + cs_j
    r_safe = torch.clamp(r, min=1e-30)
    mu_ij = fac_mu * vdotr2 / r_safe
    vsig = cs_sum - 3 * mu_ij
    approaching = (vdotr2 < 0) & pairmask
    mx = torch.maximum(torch.amax(torch.where(pairmask, cs_sum, 0.0), dim=1),
                       torch.amax(torch.where(approaching, vsig, 0.0), dim=1))
    rho_ij = 0.5 * (t["rho"][:, None] + rho_j)
    visc = 0.25 * visc_const * vsig * (-mu_ij) \
        / torch.clamp(rho_ij, min=1e-37) * (t["f1"][:, None] + f2)
    dwk_sum = dwk_i + dwk_j
    if use_limiter:
        dt_pair = torch.maximum(t["dt"][:, None], dt_j)
        lim_ok = (dt_pair > 0) & (dwk_sum < 0)
        m_sum = 0.5 * (t["mass"][:, None] + smass)
        limiter = 0.5 * fac_vsic_fix * vdotr2 / (
            m_sum * torch.where(lim_ok, dwk_sum, -1.0) * r_safe
            * torch.where(dt_pair > 0, dt_pair, 1.0))
        visc = torch.where(lim_ok, torch.minimum(visc, limiter), visc)
    visc = torch.where(approaching, visc, 0.0)
    hfc_visc = 0.5 * smass * visc * dwk_sum / r_safe
    hfc = hfc_visc + smass * (t["pterm"][:, None] * dwk_i
                              + pterm_j * dwk_j) / r_safe
    hfc = torch.where(pairmask, hfc, 0.0)
    hfc_visc = torch.where(pairmask, hfc_visc, 0.0)
    return torch.stack([-torch.sum(hfc * dxs[0], dim=1),
                        -torch.sum(hfc * dxs[1], dim=1),
                        -torch.sum(hfc * dxs[2], dim=1),
                        torch.sum(0.5 * hfc_visc * vdotr2, dim=1)],
                       dim=1), mx


class LetFullStep(LetTreeStep):
    """The LET step with gas: gravity as `LetTreeStep` (the local tree
    built with the smoothing lengths), then the SPH passes of the local
    active gas on the local tree plus the ghost rows of rounds A and B.

    Called as `ReplicatedFullStep`.  `caps` (shared with the runner and the
    other step variant) gains "ghost" and "margin"; `ghost_rows` holds the
    rows received in rounds A and B at the last step, `ghost_retries` and
    `margin_retries` count the cap growths and the density reruns; the
    SPH passes are the span `sph` of the rank's trace."""

    def __init__(self, cfg, units, wiring, tables, mesh, opening=None,
                 pm_step=True, solver=None, caps=None, hydro=None):
        super().__init__(cfg, units, wiring, tables, mesh, opening=opening,
                         pm_step=pm_step, solver=solver, caps=caps)
        self.caps.setdefault("ghost", GHOST_CAP)
        self.caps.setdefault("margin", GHOST_MARGIN)
        self.hydro = hydro if hydro is not None \
            else HydroSolver(cfg, units, trace=mesh.trace)
        self.box3 = tuple(cfg.box_sizes) if cfg.periodic \
            and cfg.box_size > 0 else None
        self.ghost_rows = [0, 0]
        self.ghost_retries = 0
        self.margin_retries = 0

    def density_only(self, p, sph, ti: int):
        """As `ReplicatedFullStep.density_only`, on the local tree with the
        round-A ghosts."""
        p, sph, mass, fsoft, aold, hsml = at_sync_point(self, p, sph, ti)
        self._tree, _ = self._local_tree(p, mass, fsoft, aold, hsml)
        tr = self.mesh.trace
        with tr.span("sph"):
            sph = self._density(p, sph, ti)
            tr.sync(p.pos.device)
        return sph

    def _sph_forces(self, p, sph, ti_next: int, time_next: float):
        tr = self.mesh.trace
        with tr.span("sph"):
            sph = self._density(p, sph, ti_next)
            sph = self._hydro(p, sph, ti_next, time_next)
            tr.sync(p.pos.device)
        return sph

    # ------------------------------------------------------------------
    def _ship(self, sel, fields):
        """The selected rows of `fields` ([n] tensors) to their receivers
        in one all_to_all, the ghost cap first grown to twice the largest
        rank's demand when that exceeds it.  Returns the live rows
        received, [R, len(fields)]."""
        mesh = self.mesh
        need = int(mesh.pmax(torch.amax(torch.sum(sel, dim=0))
                             .to(torch.int32).reshape(1))[0])
        if need > self.caps["ghost"]:
            self.ghost_retries += 1
            self.caps["ghost"] = 2 * need
        cap = ((self.caps["ghost"] + 7) // 8) * 8
        n = sel.shape[0]
        rid, _ = _compact_rows(
            torch.arange(n, device=sel.device)[None, :].expand(mesh.size, n),
            sel.T, cap)                                          # [K, cap]
        ok = rid >= 0
        safe = torch.clamp(rid, min=0)
        send = torch.stack([torch.where(ok, f[safe], 0.0) for f in fields]
                           + [ok.to(torch.float32)], dim=-1)
        recv = mesh.all_to_all(send.contiguous()).reshape(
            mesh.size * cap, len(fields) + 1)
        return recv[recv[:, -1] > 0, :-1]

    def _gas_boxes(self, p, sph, is_gas):
        """Every rank's gas bounding box and largest hsml: [K, 7]."""
        big = 1e30
        pos = p.pos
        return self.mesh.all_gather(torch.cat([
            torch.amin(torch.where(is_gas[:, None], pos, big), dim=0),
            torch.amax(torch.where(is_gas[:, None], pos, -big), dim=0),
            torch.amax(torch.where(is_gas, sph.hsml, 0.0))[None]])[None])

    def _select(self, p, sph, is_gas):
        b = self._boxes
        return ghost_select(p.pos, is_gas, sph.hsml, b[:, 0:3], b[:, 3:6],
                            b[:, 6], self.mesh.rank, self.caps["margin"],
                            self.box3)

    def _density(self, p, sph, ti: int):
        """Round A and the density iteration on the local tree plus the
        ghosts, rerun with a wider margin until every converged smoothing
        length lies within it (the ghost-margin contract)."""
        cfg, mesh, hs, tree = self.cfg, self.mesh, self.hydro, self._tree
        is_gas = (p.ptype == 0) & (p.pid >= 0)
        self._boxes = self._gas_boxes(p, sph, is_gas)
        hmax_l = torch.clamp(self._boxes[mesh.rank, 6], min=1e-30)
        tgt_rows = gas_targets(p, sph, ti)
        n_act = int(torch.sum(tgt_rows))
        order = tree.order.long()
        for _ in range(8):
            ga = self._ship(self._select(p, sph, is_gas), [
                p.pos[:, 0], p.pos[:, 1], p.pos[:, 2], sph.vel_pred[:, 0],
                sph.vel_pred[:, 1], sph.vel_pred[:, 2],
                torch.where(is_gas, p.mass, 0.0), sph.hsml])
            self.ghost_rows[0] = ga.shape[0]
            vel_s = sph.vel_pred[order]

            def ghosts(tgt, hsml, active, ga=ga, vel_s=vel_s):
                safe = torch.clamp(tgt, min=0).long().reshape(-1)
                out = ghost_density(tree.pos_s[safe], vel_s[safe],
                                    hsml.reshape(-1), active.reshape(-1),
                                    ga, hs.kernel, self.box3)
                nb, g = tgt.shape
                return tuple(o.reshape((nb, g) + o.shape[1:]) for o in out)

            new = hs.density(tree, p, sph, ti, n_act, self.solver.depth,
                             float(self.tbi), ghosts=ghosts)
            ratio = torch.amax(torch.where(tgt_rows, new.hsml, 0.0)) / hmax_l
            ratio = float(mesh.pmax(ratio.reshape(1))[0])
            if ratio <= self.caps["margin"]:
                return new
            # the converged h left the export threshold: remote neighbours
            # may be missing; widen the margin and rerun
            self.margin_retries += 1
            self.caps["margin"] = 1.25 * ratio
        raise RuntimeError(f"SPH ghost margin kept growing: {self.caps}")

    def _hydro(self, p, sph, ti: int, time_now: float):
        """Round B (the converged smoothing lengths) and the hydro force on
        the local tree, its node hmax refreshed, plus the ghosts."""
        cfg, hs = self.cfg, self.hydro
        is_gas = (p.ptype == 0) & (p.pid >= 0)
        order = self._tree.order.long()
        tree = update_node_hmax(self._tree._replace(
            hsml_s=torch.where(is_gas, sph.hsml, 0.0)[order]),
            self.solver.depth, cfg.tree_bucket_size)
        _, facs = hs.hydro_inputs(tree, p, sph, float(self.tbi), time_now)
        fac_mu = facs[0]
        rho = torch.clamp(sph.density, min=1e-37)
        cs = torch.sqrt(cfg.gamma * sph.pressure / rho)
        f1 = torch.abs(sph.div_vel) / (
            torch.abs(sph.div_vel) + sph.curl_vel
            + 0.0001 * cs / fac_mu / torch.clamp(sph.hsml, min=1e-30))
        gb = self._ship(self._select(p, sph, is_gas), [
            p.pos[:, 0], p.pos[:, 1], p.pos[:, 2], sph.vel_pred[:, 0],
            sph.vel_pred[:, 1], sph.vel_pred[:, 2],
            torch.where(is_gas, p.mass, 0.0), sph.hsml, rho,
            sph.pressure / rho ** 2 * sph.dhsml_density_factor, cs, f1,
            (p.ti_endstep - p.ti_begstep).to(torch.float32) * self.tbi])
        self.ghost_rows[1] = gb.shape[0]
        use_limiter = not cfg.no_viscosity_limiter

        def ghosts(tgt, safe, fields, facs):
            hsml_all, rho_all, pres_all, f_all, vel_all, csnd_all, \
                divv_all, curl_all, dt_all = fields
            s = safe.reshape(-1)
            h_i, cs_i = hsml_all[s], csnd_all[s]
            t = dict(pos=tree.pos_s[s], vel=vel_all[s], h=h_i,
                     rho=rho_all[s],
                     pterm=pres_all[s] / torch.clamp(rho_all[s], min=1e-37)
                     ** 2 * f_all[s], cs=cs_i,
                     f1=torch.abs(divv_all[s]) / (
                         torch.abs(divv_all[s]) + curl_all[s]
                         + 0.0001 * cs_i / facs[0]
                         / torch.clamp(h_i, min=1e-30)),
                     dt=dt_all[s], mass=tree.mass_s[s],
                     valid=(tgt >= 0).reshape(-1))
            acc, de, ms = ghost_hydro(t, gb, facs, cfg.art_bulk_visc_const,
                                      use_limiter, hs.kernel, self.box3)
            nb, g = tgt.shape
            return acc.reshape(nb, g, 3), de.reshape(nb, g), \
                ms.reshape(nb, g)

        n_act = int(torch.sum(gas_targets(p, sph, ti)))
        return hs.hydro(tree, p, sph, ti, n_act, self.solver.depth,
                        float(self.tbi), time_now, ghosts=ghosts)
