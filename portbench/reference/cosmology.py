"""Units, the integer timeline and the integrator's factors, in float64.

Gadget-2's internal units (begrun.c set_units) and its drift and kick
integrals (driftfac.c), integrated here by Gauss-Legendre quadrature on
each interval instead of looked up in a table.
"""

from __future__ import annotations

import math

import numpy as np

GRAVITY_CGS = 6.672e-8
HUBBLE_CGS = 3.2407789e-18      # h / s
TIMEBASE = 1 << 28
GAMMA = 5.0 / 3.0
# Gadget-2's default unit system (kpc/h, 1e10 Msun/h, km/s)
UNITS = {"UnitLength_in_cm": 3.085678e21, "UnitMass_in_g": 1.989e43,
         "UnitVelocity_in_cm_per_s": 1e5}
_NODES, _WEIGHTS = np.polynomial.legendre.leggauss(64)


class Cosmology:
    """The parameterfile's expansion history and timeline."""

    def __init__(self, param: dict):
        unit = {k: float(param.get(k, v)) for k, v in UNITS.items()}
        ul, um = unit["UnitLength_in_cm"], unit["UnitMass_in_g"]
        ut = ul / unit["UnitVelocity_in_cm_per_s"]
        self.G = GRAVITY_CGS / ul ** 3 * um * ut ** 2
        self.H0 = HUBBLE_CGS * ut
        self.comoving = bool(int(param.get("ComovingIntegrationOn", 0)))
        self.omega0 = float(param.get("Omega0", 0.0))
        self.omega_lambda = float(param.get("OmegaLambda", 0.0))
        self.t_begin = float(param["TimeBegin"])
        self.t_max = float(param["TimeMax"])
        if self.comoving:
            self.tbi = (math.log(self.t_max) - math.log(self.t_begin)) \
                / TIMEBASE
        else:
            self.tbi = (self.t_max - self.t_begin) / TIMEBASE

    def time(self, ti: int) -> float:
        """The scale factor (comoving) or the time at tick `ti`."""
        if self.comoving:
            return self.t_begin * math.exp(ti * self.tbi)
        return self.t_begin + ti * self.tbi

    def hubble(self, a):
        return self.H0 * np.sqrt(self.omega0 / a ** 3
                                 + (1 - self.omega0 - self.omega_lambda)
                                 / a ** 2 + self.omega_lambda)

    def _integral(self, power: float, ti0: int, ti1: int) -> float:
        """int da / (H(a) a^power) from tick ti0 to ti1; dt when the run
        is not comoving."""
        if not self.comoving:
            return (ti1 - ti0) * self.tbi
        if ti1 == ti0:
            return 0.0
        x0, x1 = math.log(self.time(ti0)), math.log(self.time(ti1))
        x = 0.5 * (x1 - x0) * _NODES + 0.5 * (x1 + x0)
        a = np.exp(x)
        # da = a dx
        return float(0.5 * (x1 - x0)
                     * np.sum(_WEIGHTS * a / (self.hubble(a) * a ** power)))

    def drift(self, ti0: int, ti1: int) -> float:
        return self._integral(3.0, ti0, ti1)

    def gravkick(self, ti0: int, ti1: int) -> float:
        return self._integral(2.0, ti0, ti1)

    def hydrokick(self, ti0: int, ti1: int) -> float:
        return self._integral(3.0 * GAMMA - 2.0, ti0, ti1)

    def gas_factors(self, a: float):
        """(fac_mu, fac_vsic_fix, hubble_a2) of hydra.c at time `a`."""
        if not self.comoving:
            return 1.0, 1.0, 1.0
        gm1 = GAMMA - 1.0
        ha = float(self.hubble(a))
        return a ** (3 * gm1 / 2) / a, ha * a ** (3 * gm1), a * a * ha
