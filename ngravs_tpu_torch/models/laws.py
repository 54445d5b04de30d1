"""Gravitational force laws (port of `ngravs_tpu/models/laws.py`).

The reference's ngravs force-law functions (ngravs.c) as objects whose
methods are broadcastable tensor expressions, so one call evaluates a law
over a whole [targets, sources] tile.  Arguments are f32 tensors (or, for
the mass arguments, Python floats); the arithmetic is the JAX package's own,
term by term, so both packages round alike.

Conventions (reference ngravs.c:330-341, 413-419):

 * Signs are the *positive* of the usual acceleration ("attraction is
   positive"): the caller accumulates `acc += (x_source - x_target) * fac`.
 * `accel(tm, sm, r2, r, n)` is the AccelFxns entry: the caller divides by an
   extra r, i.e. fac = accel / r.
 * `spline(tm, sm, h, r, n)` is the AccelSplines entry, used when r < h.
 * `potential` / `spline_pot` mirror PotentialFxns / PotentialSplines.
 * `n` is the node particle count (NGRAVS_ACCUMULATOR); 1 for particles.

Only `Newtonian` is ported; the other laws come with multi-law dispatch
(ROADMAP Queue 2, K1b).
"""

from __future__ import annotations

import math

import torch


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    """1/x where x>0, else 0 — avoids NaNs on masked-out self pairs."""
    return torch.where(x > 0, 1.0 / torch.where(x > 0, x, 1.0), 0.0)


class ForceLaw:
    """Base class: Newtonian defaults, subclasses override."""

    name = "Newton"

    # --- real-space acceleration (AccelFxns semantics) ---
    def accel(self, tm, sm, r2, r, n):
        # reference `newtonian` (ngravs.c:351): source / r^2
        return sm * _safe_inv(r2)

    # --- softened acceleration for r < h (AccelSplines semantics) ---
    def spline(self, tm, sm, h, r, n):
        return plummer_spline(sm, h, r)

    # --- potentials ---
    def potential(self, tm, sm, r2, r, n):
        # reference `newtonian_pot` (ngravs.c:368): source / r
        return sm * _safe_inv(r)

    def spline_pot(self, tm, sm, h, r, n):
        return plummer_spline_pot(sm, h, r)

    # --- periodic k-space Green's functions ---
    def greens(self, k2, k):
        # reference `pgdelta` (ngravs.c:390): 1/k^2
        return _safe_inv(k2)

    def normed_greens(self, k2, k):
        # reference `normed_pgdelta` (ngravs.c:400)
        return torch.ones_like(k2)

    def lattice_kind(self):
        """(kind, params) selecting the lattice correction tables."""
        return "newton", {}

    # --- combined helpers used by the solvers ---
    def force_factor(self, tm, sm, r2, r, h, n):
        """fac such that acc += (x_s - x_t) * fac, softening switch included
        (forcetree.c:1536-1583): unsoftened law / r for r >= h, spline
        below."""
        unsoft = self.accel(tm, sm, r2, r, n) * _safe_inv(r)
        soft = self.spline(tm, sm, h, r, n)
        return torch.where(r >= h, unsoft, soft)

    def potential_factor(self, tm, sm, r2, r, h, n):
        """Signed potential contribution as the tree walk accumulates it
        (forcetree.c:2732-2761): -PotentialFxns for r >= h, +PotentialSplines
        below (the splines are already negative), so Newton gives -sm/r."""
        unsoft = -self.potential(tm, sm, r2, r, n)
        soft = self.spline_pot(tm, sm, h, r, n)
        return torch.where(r >= h, unsoft, soft)

    # --- TreePM short-range variants (forcetree.c:1958-2027, 3104-3145) ---
    def force_factor_tpm(self, tm, sm, r2, r, h, n, lr):
        unsoft = (self.accel(tm, sm, r2, r, n) - sm * lr) * _safe_inv(r)
        soft = self.spline(tm, sm, h, r, n)
        return torch.where(r >= h, unsoft, soft)

    def potential_factor_tpm(self, tm, sm, r2, r, h, n, lrp):
        unsoft = -(self.potential(tm, sm, r2, r, n) - sm * lrp)
        soft = self.spline_pot(tm, sm, h, r, n)
        return torch.where(r >= h, unsoft, soft)

    def kernel_shortrange(self):
        """Closed-form short-range truncation (sf, sp) of u = r / (2 Asmth),
        or None if only the tabulated path works."""
        return None

    def __repr__(self):
        return f"<law {self.name}>"


# ---------------------------------------------------------------------------
# Gadget's cubic-spline softened point mass (reference `plummer`,
# ngravs.c:420-436, and `plummer_pot`, ngravs.c:459-474)
# ---------------------------------------------------------------------------

def plummer_spline(sm, h, r):
    h_inv = _safe_inv(h)
    u = r * h_inv
    h_inv3 = h_inv * h_inv * h_inv
    u_inv3 = _safe_inv(u * u * u)
    lo = 10.666666666667 + u * u * (32.0 * u - 38.4)
    hi = (21.333333333333 - 48.0 * u + 38.4 * u * u
          - 10.666666666667 * u * u * u - 0.066666666667 * u_inv3)
    return sm * h_inv3 * torch.where(u < 0.5, lo, hi)


def plummer_spline_pot(sm, h, r):
    h_inv = _safe_inv(h)
    u = r * h_inv
    u_inv = _safe_inv(u)
    lo = -2.8 + u * u * (5.333333333333 + u * u * (6.4 * u - 9.6))
    hi = (-3.2 + 0.066666666667 * u_inv
          + u * u * (10.666666666667 + u * (-16.0 + u * (9.6 - 2.133333333333 * u))))
    return sm * h_inv * torch.where(u < 0.5, lo, hi)


def _erfcx_pos(x):
    """Scaled complementary error function e^{x^2} erfc(x) for x >= 0 —
    the Abramowitz-Stegun 7.1.26 rational polynomial without the Gaussian
    factor (|rel err| < ~2e-7)."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    return t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))


class Newtonian(ForceLaw):
    name = "Newton"

    def kernel_shortrange(self):
        # classic TreePM truncation: erfc(u) + 2u/sqrt(pi) exp(-u^2),
        # with the A&S 7.1.26 rational erfc
        def erfc_(u):
            return _erfcx_pos(u) * torch.exp(-u * u)

        def sf(u):
            return erfc_(u) + 2 * u / math.sqrt(math.pi) * torch.exp(-u * u)

        return sf, erfc_
