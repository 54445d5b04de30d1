"""A comoving box of gas and dark matter on jittered lattices.

A frozen copy of the IC writer that drove the port's gas-box path
(examples/cosmological_box.py's scheme): n_side^3 gas particles (type 0)
and n_side^3 dark matter particles (type 1) half a cell off, each lattice
jittered by 2% of the spacing, masses matching Omega0 with OmegaBaryon /
Omega0 of it in the gas, unit-variance Gaussian velocities in Gadget's
file convention, and the gas at the parameterfile's InitGasTemp: the
internal energy Gadget-2 gives gas whose file holds none (read_ic.c,
neutral below 1e4 K, ionised above).  Returned as arrays; the benchmark
owns this copy.
"""

from __future__ import annotations

import math

import numpy as np

BOLTZMANN, PROTONMASS = 1.3806e-16, 1.6726e-24   # cgs, Gadget-2's allvars.h
HYDROGEN_MASSFRAC = 0.76
UNIT_VELOCITY = 1e5                               # cm/s


def u_of_temperature(temp: float) -> float:
    """Specific internal energy in (km/s)^2 of an ideal gas (gamma 5/3) of
    primordial composition at `temp` K (read_ic.c)."""
    yhe = (1 - HYDROGEN_MASSFRAC) / (4 * HYDROGEN_MASSFRAC)
    mu = (1 + 4 * yhe) / (2 + 3 * yhe) if temp > 1e4 \
        else (1 + 4 * yhe) / (1 + yhe)
    return BOLTZMANN / PROTONMASS * temp / (2.0 / 3.0) / mu \
        / UNIT_VELOCITY ** 2


def make(spec: dict, param: dict, seed: int, g_int: float,
         hubble: float) -> dict:
    """The IC of `spec` ({"n_side"}) in the box and cosmology of `param`
    from `seed`: pos, vel, mass, pid, ptype, u (numpy)."""
    ns = int(spec["n_side"])
    box = float(param["BoxSize"])
    omega0, omega_b = float(param["Omega0"]), float(param["OmegaBaryon"])
    rng = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(*[np.arange(ns)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / ns * box
    n = len(g)
    gas = np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape), box)
    dm = np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape)
                + 0.5 * box / ns, box)
    m_tot = omega0 * 3 * hubble ** 2 / (8 * math.pi * g_int) * box ** 3
    m_gas = omega_b / omega0 * m_tot / n
    m_dm = (omega0 - omega_b) / omega0 * m_tot / n
    return dict(pos=np.concatenate([gas, dm]).astype(np.float32),
                vel=rng.normal(0, 1.0, (2 * n, 3)).astype(np.float32),
                mass=np.repeat(np.array([m_gas, m_dm], np.float32), n),
                pid=np.arange(1, 2 * n + 1, dtype=np.int64),
                ptype=np.repeat(np.arange(2, dtype=np.int32), n),
                u=np.full(n, u_of_temperature(float(param["InitGasTemp"])),
                         np.float32))
