"""What decides `correct`: the port's outputs of the window's last sync
points against the plain reference.

The benchmark hands this module snapshots of the program's state taken
around `Simulation.step()` calls (`Snapshot`: the particles, the gas state,
the tick and the PM window; the program updates its state by replacing
tensors, so a snapshot holds references, not copies) and the cell's
configuration.  The reference works out again, in float64:

- gravity: the accelerations of a sample of the particles kicked at a sync
  point, by the direct sum (open box) or the Ewald sum (periodic box), at
  that sync point's positions; under TreePM the last PM step's, where the
  program's short-range and PM forces were both computed, and there also
  the long-range part of the split alone, against the program's PM force;
- SPH (gas): at the last sync point, the density at the program's
  smoothing length, the weighted neighbour count there, and the hydro
  acceleration, from positions, masses and the entropy and velocities the
  step started from, predicted to the sync point;
- the integrator: the last step's drift of every particle and the kick of
  every velocity, from the state before it, the program's new timesteps
  and PM window, and the drift and kick integrals.

The reference follows the program from its own state where it must: the
smoothing lengths (held to the configuration's neighbour window by
themselves), the state before the last step and the new timesteps.
`Check.control` puts the reference, computed in a lower precision, in the
program's place.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import gravity, sph
from .cosmology import GAMMA, Cosmology

TYPE_NAMES = ("Gas", "Halo", "Disk", "Bulge", "Stars", "Bndry")
SOFTFAC_SPLINE = 2.8


class Snapshot(NamedTuple):
    p: object          # the port's Particles
    sph: object        # the port's SphState or None
    ti: int            # the tick
    pm: tuple          # (PM window begin, end)


class Step(NamedTuple):
    pre: Snapshot
    post: Snapshot
    pm_step: bool


class Record(NamedTuple):
    steps: list        # Step, oldest first: the last sync points
    pm_last: Step | None   # the last PM step, in the window or before it
    stalled: int       # window steps whose tick did not advance


def f32_spacing(v: torch.Tensor) -> torch.Tensor:
    """The distance between float32 numbers at |v| (float64 in and out)."""
    e = torch.frexp(v.abs().clamp(min=torch.finfo(torch.float32).tiny)
                    .double())[1]
    return torch.ldexp(torch.ones_like(v, dtype=torch.float64),
                       (e - 24).to(torch.float64))


def _hsoft(param: dict, ptype) -> torch.Tensor:
    soft = torch.tensor([float(param.get(f"Softening{t}", 0.0))
                         for t in TYPE_NAMES], dtype=torch.float64,
                        device=ptype.device)
    return soft[ptype.long()] * SOFTFAC_SPLINE


def _active(s: Snapshot) -> torch.Tensor:
    """The particles kicked at the snapshot's sync point."""
    return s.p.ti_begstep == s.ti


def _sample(mask: torch.Tensor, k: int, gen: torch.Generator):
    idx = torch.nonzero(mask).squeeze(1)
    if idx.numel() > k:
        pick = torch.randperm(idx.numel(), generator=gen)[:k]
        idx = idx[pick.to(idx.device)].sort().values
    return idx


class Check:
    """The cell's comparison: `config` is the configuration file's dict,
    `spec` the workload's "check" entry (sample sizes), `limits` its
    "limits" entry."""

    def __init__(self, config: dict, spec: dict, limits: dict, seed: int):
        self.param = config["param"]
        self.wiring = config["wiring"]
        self.cosmo = Cosmology(self.param)
        self.box = float(self.param.get("BoxSize", 0.0)) \
            if int(self.param.get("PeriodicBoundariesOn", 0)) else 0.0
        self.pmgrid = int(config["port"].get("pmgrid", 0)) \
            if self.box > 0 else 0
        self.spec = spec
        self.limits = limits
        self.seed = seed

    # -- what the program produced ---------------------------------------
    def gravity_targets(self, rec: Record):
        """[(snapshot, target indices)]: under TreePM the last PM step's
        kicked particles, else those of the last sync points back until
        `grav_targets` are drawn."""
        gen = torch.Generator().manual_seed(self.seed % (1 << 63))
        want = int(self.spec["grav_targets"])
        if rec.pm_last is not None:
            s = rec.pm_last.post
            return [(s, _sample(_active(s), want, gen))]
        out = []
        for st in reversed(rec.steps):
            if want <= 0:
                break
            idx = _sample(_active(st.post), want, gen)
            out.append((st.post, idx))
            want -= idx.numel()
        return out

    def program(self, rec: Record) -> dict:
        targets = self.gravity_targets(rec)
        out = {"grav": [(s.p.accel[i] + s.p.accel_pm[i]).double()
                        for s, i in targets]}
        if self.pmgrid:
            out["pm"] = [s.p.accel_pm[i].double() for s, i in targets]
        last = rec.steps[-1]
        if last.post.sph is not None:
            q = self.gas_targets(last)
            out["density"] = last.post.sph.density[q].double()
            out["hydro"] = last.post.sph.hydro_accel[q].double()
        out["pos"] = last.post.p.pos.double()
        out["vel"] = last.post.p.vel.double()
        return out

    def gas_targets(self, st: Step):
        gas = st.post.p.ptype == 0
        if not bool(torch.all(_active(st.post)[gas])):
            raise ValueError("the SPH check needs every gas particle active "
                             "at the last sync point")
        gen = torch.Generator().manual_seed((self.seed + 1) % (1 << 63))
        return _sample(gas, int(self.spec["gas_targets"]), gen)

    # -- the reference ----------------------------------------------------
    def reference(self, rec: Record, dtype=torch.float64) -> dict:
        """Everything `program` returns, worked out again in `dtype`."""
        targets = self.gravity_targets(rec)
        out = {"grav": [self._gravity(s, i, dtype) for s, i in targets]}
        if self.pmgrid:
            out["pm"] = [gravity.long_range_accel(
                s.p.pos, s.p.mass, s.p.grav, i, self.box, self.wiring,
                self.cosmo.G, self.pmgrid, dtype=dtype).double()
                for s, i in targets]
        last = rec.steps[-1]
        if last.post.sph is not None:
            gas = self._gas(last, dtype)
            out["density"], out["hydro"] = gas["rho_q"], gas["hydro"]
            out["wngb"] = gas["wngb_q"]
        out["pos"], out["vel"] = self._integrate(last, dtype)
        return out

    def _gravity(self, s: Snapshot, idx, dtype):
        p = s.p
        hs = _hsoft(self.param, p.ptype)
        if self.box > 0:
            acc = gravity.periodic_accel(p.pos, p.mass, p.grav, hs, idx,
                                         self.box, self.wiring,
                                         self.cosmo.G, dtype=dtype)
        else:
            acc = gravity.open_accel(p.pos, p.mass, hs, idx, self.cosmo.G,
                                     dtype=dtype)
        return acc.double()

    def _gas(self, st: Step, dtype) -> dict:
        pre, post = st.pre, st.post
        c = self.cosmo
        t0, t1 = pre.ti, post.ti
        gas = torch.nonzero(post.p.ptype == 0).squeeze(1)
        q = self.gas_targets(st)
        x = post.p.pos.to(dtype)
        m = post.p.mass.to(dtype)
        h = post.sph.hsml.to(dtype)
        # velocities predicted to the sync point (predict.c:55-61)
        vel = (pre.sph.vel_pred.double()
               + (pre.p.accel + pre.p.accel_pm).double() * c.gravkick(t0, t1)
               + pre.sph.hydro_accel.double() * c.hydrokick(t0, t1)).to(dtype)
        grid = sph.Grid(x[gas], self.box, float(h[gas].max()))
        # partners of the targets: every gas particle within max(h_i, h_j)
        xg = x[gas]
        cand = grid.candidates(x[q])
        valid = cand >= 0
        d = x[q][:, None, :] - xg[torch.clamp(cand, min=0)]
        d = d - self.box * torch.round(d / self.box)
        r = torch.linalg.vector_norm(d.double(), dim=-1)
        near = valid & ((r < h[q][:, None].double())
                        | (r < h[gas][torch.clamp(cand, min=0)].double()))
        part = torch.unique(torch.cat([q, gas[cand[near]]]))
        # density.c on the targets and their partners, gas indexed by
        # position in `gas`
        pos_in_gas = torch.full((post.p.n,), -1, dtype=torch.long,
                                device=x.device)
        pos_in_gas[gas] = torch.arange(gas.numel(), device=x.device)
        pg = pos_in_gas[part]
        rho, wngb, f, divv, curl = sph.density(
            xg, vel[gas], m[gas], h[gas], pg, grid, self.box)
        ng = gas.numel()
        full = lambda v: torch.zeros(ng, dtype=dtype,
                                     device=x.device).index_put_((pg,), v)
        rho_g, f_g, divv_g, curl_g = (full(v) for v in (rho, f, divv, curl))
        # the pressure as density.c computes it: the entropy the step
        # started from, advanced from the old step's midpoint
        mid = (pre.p.ti_begstep + pre.p.ti_endstep) // 2
        ent = (pre.sph.entropy.double() + pre.sph.dt_entropy.double()
               * (t1 - mid).double() * c.tbi)[gas].to(dtype)
        pres = ent * rho_g ** GAMMA
        dt = ((pre.p.ti_endstep - pre.p.ti_begstep).double() * c.tbi)[gas]
        qg = pos_in_gas[q]
        facs = c.gas_factors(c.time(t1))
        acc = sph.hydro(xg, vel[gas], m[gas], h[gas], rho_g, pres, f_g,
                        divv_g, curl_g, dt.to(dtype), qg, grid, self.box,
                        facs, float(self.param.get("ArtBulkViscConst", 0.8)),
                        GAMMA)
        at = lambda v: v[torch.searchsorted(part, q)]
        return {"rho_q": at(rho).double(), "wngb_q": at(wngb).double(),
                "hydro": acc.double()}

    def _integrate(self, st: Step, dtype):
        """Positions and velocities after the step from the state before it
        (predict.c, timestep.c), with the program's new timesteps."""
        pre, post = st.pre, st.post
        c = self.cosmo
        t0, t1 = pre.ti, post.ti
        x = pre.p.pos.to(dtype) + pre.p.vel.to(dtype) * c.drift(t0, t1)
        if self.box > 0:
            x = torch.remainder(x, self.box)
        act = _active(post)
        tstart = (pre.p.ti_begstep + pre.p.ti_endstep) // 2
        tend = pre.p.ti_endstep + (post.p.ti_endstep - post.p.ti_begstep) // 2
        kg = torch.zeros(post.p.n, dtype=torch.float64, device=x.device)
        kh = torch.zeros_like(kg)
        pairs = torch.stack([tstart, tend], 1)[act]
        for a, b in torch.unique(pairs, dim=0).tolist():
            sel = act & (tstart == a) & (tend == b)
            kg[sel] = c.gravkick(a, b)
            kh[sel] = c.hydrokick(a, b)
        v = pre.p.vel.to(dtype) + post.p.accel.to(dtype) * kg[:, None].to(dtype)
        if post.sph is not None:
            gas = (post.p.ptype == 0)[:, None]
            v = v + torch.where(gas, post.sph.hydro_accel.to(dtype)
                                * kh[:, None].to(dtype), 0.0)
        if st.pm_step:
            (b0, e0), (b1, e1) = pre.pm, post.pm
            v = v + post.p.accel_pm.to(dtype) \
                * c.gravkick((b0 + e0) // 2, e0 + (e1 - b1) // 2)
        return x.double(), v.double()

    # -- the comparison ---------------------------------------------------
    def readings(self, rec: Record, prog: dict, ref: dict) -> dict:
        """The numbers compared, each against its limit."""
        a = torch.cat(prog["grav"])
        b = torch.cat(ref["grav"])
        # the error's norm over the reference's, over all targets: a
        # target whose force nearly cancels would rule a mean of
        # per-target ratios (see `gravity_detail`)
        out = {"gravity_l2_rel": float(torch.linalg.vector_norm(a - b)
                                       / torch.linalg.vector_norm(b))}
        if "pm" in ref:
            a, b = torch.cat(prog["pm"]), torch.cat(ref["pm"])
            out["pm_l2_rel"] = float(torch.linalg.vector_norm(a - b)
                                     / torch.linalg.vector_norm(b))
        if "density" in ref:
            des = float(self.param["DesNumNgb"])
            out["density_max_rel"] = float(torch.max(
                (prog["density"] - ref["density"]).abs() / ref["density"]))
            out["ngb_window_dev"] = float(torch.max(
                (ref["wngb"] - des).abs()))
            out["hydro_rms_rel"] = float(
                torch.linalg.vector_norm(prog["hydro"] - ref["hydro"])
                / torch.linalg.vector_norm(ref["hydro"]))
        last = rec.steps[-1]
        pre = last.pre.p
        dx = prog["pos"] - ref["pos"]
        if self.box > 0:
            dx = dx - self.box * torch.round(dx / self.box)
        # in float32 spacings at the larger of the old coordinate, the new
        # one and the displacement: a sound float32 drift errs by under
        # one, or by up to some hundreds where a tabulated drift factor
        # differs from the integral by ~1e-5; a position left where it
        # was errs by millions
        moved = pre.vel.double() * self.cosmo.drift(last.pre.ti, last.post.ti)
        big = torch.maximum(torch.maximum(pre.pos.double().abs(),
                                          ref["pos"].abs()), moved.abs())
        out["drift_max_ulp"] = float((dx.abs() / f32_spacing(big)).max())
        dv = (prog["vel"] - ref["vel"]).abs().max()
        kick = (ref["vel"] - pre.vel.double()).abs().max()
        out["kick_max_rel"] = float(dv / kick.clamp(min=1e-300))
        out["stalled_steps"] = float(rec.stalled)
        return out

    @staticmethod
    def gravity_detail(prog: dict, ref: dict, worst: int = 5) -> dict:
        """The per-target view of the gravity comparison: the rms of the
        targets' relative errors and the largest of them, each with its
        target's |a| over the median |a|."""
        a, b = torch.cat(prog["grav"]), torch.cat(ref["grav"])
        mag = torch.linalg.vector_norm(b, dim=1)
        rel = torch.linalg.vector_norm(a - b, dim=1) / mag
        top = torch.argsort(rel, descending=True)[:worst]
        med = float(torch.median(mag))
        return {"rms_rel": float(torch.sqrt(torch.mean(rel * rel))),
                "targets": int(rel.numel()),
                "worst": [[float(rel[i]), float(mag[i]) / med]
                          for i in top.tolist()]}

    def judge(self, readings: dict):
        """(correct, {name: {"value", "limit"}}): every reading finite and
        at or below its limit."""
        table = {k: {"value": v, "limit": self.limits[k]}
                 for k, v in readings.items()}
        ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                 for v in table.values())
        return ok, table

    def control(self, rec: Record, ref: dict, dtype=torch.bfloat16) -> dict:
        """The readings of the reference computed in `dtype`, put in the
        program's place."""
        low = self.reference(rec, dtype)
        prog = {"grav": low["grav"], "pos": low["pos"], "vel": low["vel"]}
        if "pm" in low:
            prog["pm"] = low["pm"]
        if "density" in low:
            prog["density"], prog["hydro"] = low["density"], low["hydro"]
        return self.readings(rec, prog, ref)

