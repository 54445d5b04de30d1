"""Gravity wiring: the N_GRAVS x N_GRAVS matrix of force laws.

Port of `ngravs_tpu/models/wiring.py`.  Replaces the reference's
code-as-config `wire_grav_maps()` + function-pointer tables (ngravs.c:64-326)
with a registry of named wirings, `laws[target_gravity][source_gravity]`.

Startup validation reproduces `init_grav_maps` (ngravs_core.c:201-424):
Newton's-3rd-law symmetry of each (i,j)/(j,i) pair probed at a test point,
unless `l3violation` is set.

Only the all-Newton presets are ported; the other presets of the JAX
package need multi-law dispatch in the pair kernel (ROADMAP Queue 2, K1b).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimulationConfig
from . import laws as L

# presets of the JAX package that wait for K1b
_NOT_PORTED = ("bam", "yukawa", "newton_yukawa", "coloyuk", "three_species")


class GravityWiring:
    """An n_gravs x n_gravs matrix of ForceLaw objects, [target][source]."""

    def __init__(self, laws, names=None, accumulator: bool = False):
        self.laws = [list(row) for row in laws]
        self.n_gravs = len(self.laws)
        for row in self.laws:
            if len(row) != self.n_gravs:
                raise ValueError("wiring matrix must be square")
        self.accumulator = accumulator
        self.names = names or [[l.name for l in row] for row in self.laws]

    def law(self, tg: int, sg: int) -> L.ForceLaw:
        return self.laws[tg][sg]

    def unique_laws(self):
        """Group matrix slots by law object identity -> [(law, [(tg,sg),...])].

        The solvers do one pass per unique law, so the all-Newton wiring
        costs a single evaluation with no masks."""
        groups = []
        for tg in range(self.n_gravs):
            for sg in range(self.n_gravs):
                law = self.laws[tg][sg]
                for glaw, slots in groups:
                    if glaw is law:
                        slots.append((tg, sg))
                        break
                else:
                    groups.append((law, [(tg, sg)]))
        return groups

    def pair_index_matrix(self) -> np.ndarray:
        """[n_gravs, n_gravs] int matrix: which unique-law group each pair uses."""
        groups = self.unique_laws()
        m = np.zeros((self.n_gravs, self.n_gravs), np.int32)
        for k, (_, slots) in enumerate(groups):
            for tg, sg in slots:
                m[tg, sg] = k
        return m

    def check_l3_symmetry(self, rtol: float = 1e-6):
        """Newton's 3rd law probe (reference ngravs_core.c:367-421) at the
        reference's probe point (1, 1, .5, 3, 1).  Raises ValueError."""
        t = lambda v: torch.tensor(v, dtype=torch.float32)
        for i in range(self.n_gravs):
            for j in range(i + 1, self.n_gravs):
                a = float(self.laws[i][j].accel(t(1.0), t(1.0), t(0.5), t(3.0), 1))
                b = float(self.laws[j][i].accel(t(1.0), t(1.0), t(0.5), t(3.0), 1))
                if not np.isclose(a, b, rtol=rtol):
                    raise ValueError(
                        f"Newton's 3rd law violated between gravities {i} and {j}: "
                        f"{a} != {b} (set ngravs_l3violation to bypass)")
                s_a = float(self.laws[i][j].spline(t(1.0), t(1.0), t(3.0), t(0.5), 1))
                s_b = float(self.laws[j][i].spline(t(1.0), t(1.0), t(3.0), t(0.5), 1))
                if not np.isclose(s_a, s_b, rtol=rtol):
                    raise ValueError(
                        f"Newton's 3rd law violated in splines between {i} and {j}: "
                        f"{s_a} != {s_b}")


def wire_newton(cfg: SimulationConfig) -> GravityWiring:
    """All-pairs Newton (NGRAVS_STOCK_TESTING, ngravs.c:98-161): must behave
    exactly like unmodified GADGET-2.  One shared law object, so
    `unique_laws()` has one group."""
    n = cfg.n_gravs
    newton = L.Newtonian()
    return GravityWiring([[newton] * n for _ in range(n)])


WIRINGS = {
    "newton": wire_newton,
    "stock": wire_newton,
}


def register_wiring(name: str, fn):
    """Register a user wiring: fn(cfg) -> GravityWiring (the rebuild's
    equivalent of editing wire_grav_maps() in the reference)."""
    WIRINGS[name] = fn


def build_wiring(cfg: SimulationConfig) -> GravityWiring:
    """init_grav_maps equivalent (ngravs_core.c:201-424): build + validate."""
    if cfg.wiring not in WIRINGS:
        if cfg.wiring in _NOT_PORTED:
            raise NotImplementedError(
                f"wiring {cfg.wiring!r} is not yet ported to "
                "ngravs_tpu_torch: it needs multi-law dispatch "
                "(ROADMAP Queue 2, K1b)")
        raise ValueError(f"unknown wiring {cfg.wiring!r}; known: {sorted(WIRINGS)}")
    w = WIRINGS[cfg.wiring](cfg)
    if w.n_gravs != cfg.n_gravs:
        raise ValueError(f"wiring has n_gravs={w.n_gravs}, config says {cfg.n_gravs}")
    if not cfg.ngravs_l3violation:
        w.check_l3_symmetry()
    return w
