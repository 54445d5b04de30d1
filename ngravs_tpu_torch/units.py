"""Unit system (reference begrun.c:152-194 `set_units`; port of
`ngravs_tpu/units.py`).

Converts the cgs unit choices from the parameterfile into the internal unit
system and derives G, Hubble, and the minimum specific energy.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import constants as C
from .config import SimulationConfig


@dataclass(frozen=True)
class Units:
    unit_length_in_cm: float
    unit_mass_in_g: float
    unit_velocity_in_cm_per_s: float
    unit_time_in_s: float
    unit_time_in_megayears: float
    unit_density_in_cgs: float
    unit_pressure_in_cgs: float
    unit_cooling_rate_in_cgs: float
    unit_energy_in_cgs: float
    G: float          # gravitational constant, internal units
    hubble: float     # Hubble constant (h=1), internal units
    min_egy_spec: float


def set_units(cfg: SimulationConfig) -> Units:
    ul, um, uv = cfg.unit_length_in_cm, cfg.unit_mass_in_g, cfg.unit_velocity_in_cm_per_s
    ut = ul / uv
    if cfg.gravity_constant_internal == 0:
        G = C.GRAVITY_CGS / ul**3 * um * ut**2
    else:
        G = cfg.gravity_constant_internal
    u_density = um / ul**3
    u_pressure = um / ul / ut**2
    u_energy = um * ul**2 / ut**2
    hubble = C.HUBBLE_CGS * ut

    if cfg.isotherm_eqs:
        # ISOTHERM_EQS: no energy floor (begrun.c:187-188)
        min_egy = 0.0
    else:
        meanweight = 4.0 / (1 + 3 * C.HYDROGEN_MASSFRAC)  # neutral gas
        min_egy = (1.0 / meanweight) * (1.0 / C.GAMMA_MINUS1) \
            * (C.BOLTZMANN / C.PROTONMASS) * cfg.min_gas_temp
        min_egy *= um / u_energy

    return Units(
        unit_length_in_cm=ul,
        unit_mass_in_g=um,
        unit_velocity_in_cm_per_s=uv,
        unit_time_in_s=ut,
        unit_time_in_megayears=ut / C.SEC_PER_MEGAYEAR,
        unit_density_in_cgs=u_density,
        unit_pressure_in_cgs=u_pressure,
        unit_cooling_rate_in_cgs=u_pressure / ut,
        unit_energy_in_cgs=u_energy,
        G=G,
        hubble=hubble,
        min_egy_spec=min_egy,
    )
