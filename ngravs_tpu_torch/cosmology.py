"""Kick/drift factor tables (port of `ngravs_tpu/cosmology.py`).

The comoving KDK integrator needs three integrals of the expansion history
over each integer-timeline interval (reference driftfac.c):

    drift:     int da / (H(a) a^3)
    gravkick:  int da / (H(a) a^2)
    hydrokick: int da / (H(a) a^(3*GAMMA-2))

`DriftKickTables` builds them once on the host in float64 (a cumulative
trapezoid on a fine log(a) grid, sampled at the reference's 1000 points)
and looks them up as f32 linear interpolation on whole tensors, as the JAX
package does.  Non-comoving runs use `LinearTables`: every factor is
dt = (ti1 - ti0) * Timebase_interval, with both ticks rounded to f32 first.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import GAMMA_MINUS1, TIMEBASE
from .trace import blocking

DRIFT_TABLE_LENGTH = 1000  # reference allvars.h:95


def _f32(ti, device=None) -> torch.Tensor:
    if isinstance(ti, torch.Tensor):
        return ti.to(torch.float32)
    return blocking(torch.tensor, ti, dtype=torch.float32, device=device)


def hubble_of_a(a, omega0, omega_lambda, hubble):
    """H(a) in internal units (driftfac.c integrands, timestep.c:52-55)."""
    return hubble * np.sqrt(omega0 / a**3 + (1 - omega0 - omega_lambda) / a**2
                            + omega_lambda)


class DriftKickTables:
    """Factor tables over [time_begin, time_max] in log(a)."""

    def __init__(self, time_begin: float, time_max: float,
                 omega0: float, omega_lambda: float, hubble: float,
                 length: int = DRIFT_TABLE_LENGTH, oversample: int = 64,
                 gamma_minus1: float = GAMMA_MINUS1):
        self.log_begin = np.log(time_begin)
        self.log_max = np.log(time_max)
        self.length = length
        # integrate cumulatively on a fine grid, then sample the table
        n_fine = length * oversample
        loga = np.linspace(self.log_begin, self.log_max, n_fine + 1)
        a = np.exp(loga)
        h = hubble_of_a(a, omega0, omega_lambda, hubble)
        # d(integral)/d(loga) = integrand(a) * a
        drift_d = a / (h * a**3)
        grav_d = a / (h * a**2)
        hydro_d = a / (h * a**(3 * gamma_minus1) * a)

        def cumulative(deriv):
            dx = np.diff(loga)
            c = np.concatenate([[0.0], np.cumsum(
                0.5 * dx * (deriv[1:] + deriv[:-1]))])
            return c[::oversample].copy()

        self.drift_table = cumulative(drift_d)
        self.gravkick_table = cumulative(grav_d)
        self.hydrokick_table = cumulative(hydro_d)
        self._host = torch.as_tensor(np.stack(
            [self.drift_table, self.gravkick_table, self.hydrokick_table]),
            dtype=torch.float32)
        self._dev = {}

    def _table(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._dev:
            self._dev[key] = self._host.to(device)
        return self._dev[key]

    def _lookup(self, k: int, ti, device) -> torch.Tensor:
        """Cumulative factor from time_begin to integer time ti."""
        t = self._table(device)[k]
        u = _f32(ti, device) * (self.length / float(TIMEBASE))
        i0 = torch.clamp(u.to(torch.int32), 0, self.length - 1).long()
        frac = u - i0.to(torch.float32)
        return blocking(lambda: t[i0] + (t[i0 + 1] - t[i0]) * frac)

    def _factor(self, k: int, ti0, ti1) -> torch.Tensor:
        dev = next((x.device for x in (ti0, ti1)
                    if isinstance(x, torch.Tensor)), torch.device("cpu"))
        return self._lookup(k, ti1, dev) - self._lookup(k, ti0, dev)

    def drift_factor(self, ti0, ti1) -> torch.Tensor:
        """get_drift_factor (driftfac.c:67): factor for ti0 -> ti1."""
        return self._factor(0, ti0, ti1)

    def gravkick_factor(self, ti0, ti1) -> torch.Tensor:
        return self._factor(1, ti0, ti1)

    def hydrokick_factor(self, ti0, ti1) -> torch.Tensor:
        return self._factor(2, ti0, ti1)


class LinearTables:
    """Non-comoving stand-in: every factor is just dt = (ti1-ti0)*interval."""

    def __init__(self, timebase_interval: float):
        self.timebase_interval = timebase_interval

    def _dt(self, ti0, ti1) -> torch.Tensor:
        return (_f32(ti1) - _f32(ti0)) * self.timebase_interval

    drift_factor = _dt
    gravkick_factor = _dt
    hydrokick_factor = _dt


def make_tables(cfg, units):
    """Comoving -> DriftKickTables, else LinearTables."""
    if cfg.comoving_integration:
        return DriftKickTables(cfg.time_begin, cfg.time_max,
                               cfg.omega0, cfg.omega_lambda, units.hubble,
                               gamma_minus1=cfg.gamma_minus1)
    return LinearTables((cfg.time_max - cfg.time_begin) / TIMEBASE)
