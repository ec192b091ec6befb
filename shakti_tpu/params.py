"""Physical constants for the SHAKTI subglacial hydrology model.

JAX re-design of the reference's module-level globals
(reference: source/params.py:4-11).  Instead of import-time globals we use a
frozen, hashable dataclass so that parameter sets can be swapped per-experiment
and passed as *static* arguments into jit-compiled functions (plain Python
floats embed as compile-time constants, which lets XLA fold them).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PhysicalParams:
    """Physical constants (SI units).

    Defaults match reference source/params.py:4-11 exactly.
    """

    g: float = 9.81          # gravitational acceleration [m/s^2]
    rho_i: float = 917.0     # ice density [kg/m^3]
    rho_w: float = 1000.0    # water density [kg/m^3]
    nu: float = 1.787e-6     # kinematic viscosity of water [m^2/s]
    Lh: float = 3.34e5       # latent heat of fusion [J/kg]
    omega: float = 1e-3      # laminar-turbulent transition parameter [-]
    n: float = 3.0           # Glen's flow-law exponent [-]
    A: float = 2.24e-24      # Glen's flow-law coefficient [Pa^-n s^-1]

    def replace(self, **kw) -> "PhysicalParams":
        return dataclasses.replace(self, **kw)


DEFAULT_PARAMS = PhysicalParams()
