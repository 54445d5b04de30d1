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

All the JAX package's laws are here: `NoneLaw`, `Newtonian`, `NegNewtonian`,
`Yukawa`, `ColoYuk` and the BAM family.  `greens`/`normed_greens` take k in
mesh cells (ngravs.c:382-400); `kernel_shortrange` gives the closed-form
TreePM truncation where one exists.
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


# ---------------------------------------------------------------------------
# Concrete laws
# ---------------------------------------------------------------------------

class NoneLaw(ForceLaw):
    """No interaction (reference `none`, ngravs.c:344)."""
    name = "None"

    def accel(self, tm, sm, r2, r, n):
        return torch.zeros_like(r)

    spline = lambda self, tm, sm, h, r, n: torch.zeros_like(r)
    potential = lambda self, tm, sm, r2, r, n: torch.zeros_like(r)
    spline_pot = lambda self, tm, sm, h, r, n: torch.zeros_like(r)
    greens = lambda self, k2, k: torch.zeros_like(k2)
    normed_greens = lambda self, k2, k: torch.zeros_like(k2)
    lattice_kind = lambda self: ("none", {})


def _erfcx_pos(x):
    """Scaled complementary error function e^{x^2} erfc(x) for x >= 0 —
    the Abramowitz-Stegun 7.1.26 rational polynomial without the Gaussian
    factor (|rel err| < ~2e-7)."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    return t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))


def _erfc_any(x):
    """erfc for any sign via erfc(-x) = 2 - erfc(x)."""
    ax = torch.abs(x)
    e = _erfcx_pos(ax) * torch.exp(-ax * ax)
    return torch.where(x >= 0, e, 2.0 - e)


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


class NegNewtonian(ForceLaw):
    """Inverted Newton for the Hohmann & Wolfarth scenario (ngravs.c:359)."""
    name = "NegNewton"

    def accel(self, tm, sm, r2, r, n):
        return -sm * _safe_inv(r2)

    def spline(self, tm, sm, h, r, n):
        return -plummer_spline(sm, h, r)

    def potential(self, tm, sm, r2, r, n):
        return -sm * _safe_inv(r)

    def spline_pot(self, tm, sm, h, r, n):
        return -plummer_spline_pot(sm, h, r)

    def greens(self, k2, k):
        return -_safe_inv(k2)

    def normed_greens(self, k2, k):
        return -torch.ones_like(k2)

    def lattice_kind(self):
        raise NotImplementedError("NegNewtonian has no periodic wiring")


class Yukawa(ForceLaw):
    """Pure Yukawa force (reference `yukawa`, ngravs.c:856-861).

    ym = yukawa_imass / box_size; accel = s * e^{-ym r} (ym/r + 1/r^2).
    The spline is Plummer, as in the reference's Yukawa wiring
    (ngravs.c:236-245: "the force is Newtonian at small r")."""

    def __init__(self, yukawa_imass: float, box_size: float, pmgrid: int = 0,
                 asmth: float = 1.25):
        self.yukawa_imass = float(yukawa_imass)
        self.box_size = float(box_size)
        self.pmgrid = int(pmgrid)
        self.asmth_cells = float(asmth)
        self.name = f"Yukawa_{yukawa_imass:e}"

    @property
    def ym(self):
        return self.yukawa_imass / self.box_size

    def accel(self, tm, sm, r2, r, n):
        ym = self.ym
        return sm * torch.exp(-r * ym) * (ym * _safe_inv(r) + _safe_inv(r2))

    def potential(self, tm, sm, r2, r, n):
        return sm * torch.exp(-r * self.ym) * _safe_inv(r)

    def greens(self, k2, k):
        # reference `pgyukawa` (ngravs.c:869-878); k in mesh cells, so the
        # screening mass enters as YUKAWA_IMASS/(2 pi), and the Gaussian
        # compensation uses asmth in box units
        ym = self.yukawa_imass / (2 * math.pi)
        asmth2 = ((2 * math.pi * self.asmth_cells / self.pmgrid) ** 2
                  if self.pmgrid else 0.0)
        return 1.0 / (k2 + ym * ym) * torch.exp(
            torch.tensor(-ym * ym * asmth2, dtype=k2.dtype))

    def normed_greens(self, k2, k):
        # reference `normed_pgyukawa` (ngravs.c:880-885): k here is in
        # transition-table units where asmth == 0.5
        ym = self._norm_ym()
        return k2 / (k2 + ym * ym) * torch.exp(
            torch.tensor(-ym * ym * 0.25, dtype=k2.dtype))

    def lattice_kind(self):
        # reference wires yukawa_lattice_force with YUKAWA_IMASS
        # dimensionless per box length (ngravs.c:246-252)
        return "yukawa", {"ym": self.yukawa_imass}

    def kernel_shortrange(self):
        """Closed-form Yukawa TreePM truncation (screened Ewald split,
        Salin-Caillol): with a = Asmth, b = ym*a, u = r/(2a),

          phi_sr = (1/2r) [e^{-mr} erfc(u-b) + e^{mr} erfc(u+b)]
          F_sr   = (A+B)/(2r^2) - (m/2r)(B-A) + e^{-u^2-b^2}/(a sqrt(pi) r)

        (A = e^{-mr} erfc(u-b), B = e^{mr} erfc(u+b) = erfcx(u+b)
        e^{-u^2-b^2}); the e^{mr} erfc(u+b) terms use erfcx to avoid
        overflow.  None without a mesh."""
        if not self.pmgrid:
            return None
        a = self.asmth_cells * self.box_size / self.pmgrid
        m = self.ym
        b = m * a
        sqpi = math.sqrt(math.pi)

        def sp(u):
            # phi_sr / phi_full, phi_full = e^{-mr}/r
            return 0.5 * (_erfc_any(u - b)
                          + _erfcx_pos(u + b) * torch.exp(-(u - b) ** 2))

        def sf(u):
            r = torch.clamp(2.0 * a * u, min=1e-37)
            eub = torch.exp(-u * u - b * b)
            A = torch.exp(-m * r) * _erfc_any(u - b)
            B = _erfcx_pos(u + b) * eub
            f_sr = ((A + B) / (2 * r * r) - (m / (2 * r)) * (B - A)
                    + eub / (a * sqpi * r))
            f_full = torch.exp(-m * r) * (m / r + 1.0 / (r * r))
            return f_sr / torch.clamp(f_full, min=1e-37)

        return sf, sp

    def _norm_ym(self):
        # gridKtoNormK (ngravs_core.c:21-35): mesh-cell wavenumber in the
        # units of the short-range table, where the split scale is 0.5
        if not self.pmgrid:
            return 0.0
        asmth_box = self.asmth_cells / self.pmgrid  # in box units
        return (self.yukawa_imass / (2 * math.pi)) * 2.0 * math.pi \
            * asmth_box * 2.0


class ColoYuk(ForceLaw):
    """Yukawa + Newton sum (reference `coloyuk`, ngravs.c:826-838)."""

    def __init__(self, yukawa_imass: float, box_size: float, pmgrid: int = 0,
                 asmth: float = 1.25):
        self.yuk = Yukawa(yukawa_imass, box_size, pmgrid, asmth)
        self.newton = Newtonian()
        self.name = f"ColoYuk_{yukawa_imass:e}"

    def accel(self, tm, sm, r2, r, n):
        return self.yuk.accel(tm, sm, r2, r, n) \
            + self.newton.accel(tm, sm, r2, r, n)

    def potential(self, tm, sm, r2, r, n):
        return self.yuk.potential(tm, sm, r2, r, n) \
            + self.newton.potential(tm, sm, r2, r, n)

    def greens(self, k2, k):
        return self.yuk.greens(k2, k) + self.newton.greens(k2, k)

    def normed_greens(self, k2, k):
        return self.yuk.normed_greens(k2, k) + self.newton.normed_greens(k2, k)

    def lattice_kind(self):
        return "coloyuk", {"ym": self.yuk.yukawa_imass}

    def kernel_shortrange(self):
        """Sum law: the component closed forms weighted by each component's
        full-range factor (the ratio of a sum is the force-weighted mean of
        the ratios)."""
        ksy = self.yuk.kernel_shortrange()
        if ksy is None:
            return None
        sfn, spn = self.newton.kernel_shortrange()
        sfy, spy = ksy
        a = self.yuk.asmth_cells * self.yuk.box_size / self.yuk.pmgrid
        m = self.yuk.ym

        def sf(u):
            r = torch.clamp(2.0 * a * u, min=1e-37)
            fn = 1.0 / (r * r)
            fy = torch.exp(-m * r) * (m / r + 1.0 / (r * r))
            return (fn * sfn(u) + fy * sfy(u)) / (fn + fy)

        def sp(u):
            r = torch.clamp(2.0 * a * u, min=1e-37)
            pn = 1.0 / r
            py = torch.exp(-m * r) / r
            return (pn * spn(u) + py * spy(u)) / (pn + py)

        return sf, sp


# ---------------------------------------------------------------------------
# BAM (Bose-Einstein "supermacho" halo) laws, arXiv:1408.2702 (reference
# ngravs.c:495-760).  eta sets the internal scale; the accumulator count n
# rescales it by the node's mean mass.
# ---------------------------------------------------------------------------

def _bam_core_force(rho, eta, r):
    """rho*eta^3*(atan(x)/(x^2 eta) - 1/(x eta (1+x^2))), x = r*eta, with
    the 7th-order Taylor form for x < 0.1 (AccelFxns: the caller divides
    by r)."""
    reta = r * eta
    reta2 = reta * reta
    eta3 = eta * eta * eta
    taylor = rho * eta3 * (2.0 * r / 3.0 - 4.0 * reta2 * r / 5.0
                           + 6.0 * reta2 * reta2 * r / 7.0)
    inv_reta2 = _safe_inv(reta2)
    exact = rho * eta3 * (torch.atan(reta) * inv_reta2 * _safe_inv(eta)
                          - _safe_inv(reta * eta * (1 + reta2)))
    return torch.where(reta < 0.1, taylor, exact)


def _bam_core_spline(rho, eta, r):
    """BAM spline: the same force with the extra 1/r divided out."""
    reta = r * eta
    reta2 = reta * reta
    eta3 = eta * eta * eta
    taylor = rho * eta3 * (2.0 / 3.0 - 4.0 * reta2 / 5.0
                           + 6.0 * reta2 * reta2 / 7.0)
    exact = rho * eta3 * (torch.atan(reta) * _safe_inv(reta2 * reta)
                          - _safe_inv(reta2 * (1 + reta2)))
    return torch.where(reta < 0.1, taylor, exact)


def _bam_core_pot(rho, eta, r):
    reta = r * eta
    reta2 = reta * reta
    reta4 = reta2 * reta2
    taylor = rho * eta * (1 - reta2 / 3.0 + reta4 / 5.0 - reta2 * reta4 / 7.0)
    exact = rho * torch.atan(reta) * _safe_inv(r)
    return torch.where(reta < 0.1, taylor, exact)


class BamBam(ForceLaw):
    """BAM-BAM interaction (reference `bambam`, ngravs.c:495-530)."""

    def __init__(self, bam_epsilon: float):
        self.eps = float(bam_epsilon)
        self.name = "BAMBAM"

    def _eta(self, tm, sm, n):
        return 4.0 * math.pi * self.eps / (tm + sm / n)

    def accel(self, tm, sm, r2, r, n):
        rho = 2 * tm * sm / math.pi
        return _bam_core_force(rho, self._eta(tm, sm, n), r)

    def spline(self, tm, sm, h, r, n):
        rho = 2 * tm * sm / math.pi
        return _bam_core_spline(rho, self._eta(tm, sm, n), r)

    def potential(self, tm, sm, r2, r, n):
        rho = 2 * tm * sm / math.pi
        return _bam_core_pot(rho, self._eta(tm, sm, n), r)

    spline_pot = potential

    def lattice_kind(self):
        raise NotImplementedError(
            "BAM laws have no periodic wiring in the reference")


class SourceBamBaryon(BamBam):
    """BAM sources acting on a baryon target (`sourcebambaryon`,
    ngravs.c:590-615)."""

    def __init__(self, bam_epsilon: float):
        super().__init__(bam_epsilon)
        self.name = "SourceBAM"

    def _eta(self, tm, sm, n):
        return 4.0 * math.pi * self.eps * n / sm


class SourceBaryonBam(BamBam):
    """Baryon sources acting on a BAM target (`sourcebaryonbam`,
    ngravs.c:646-671)."""

    def __init__(self, bam_epsilon: float):
        super().__init__(bam_epsilon)
        self.name = "TargetBAM"

    def _eta(self, tm, sm, n):
        return 4.0 * math.pi * self.eps / tm
