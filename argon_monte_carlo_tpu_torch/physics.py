"""Physics constants and derived quantities for hard-sphere argon Monte Carlo.

Layer L0 of the PyTorch port: host floats only, bit-identical to
``argon_monte_carlo_tpu.physics`` (the JAX reference).
Mirrors the reference constant blocks (reference: Open_Air_Cube_MC.py:42-64,
Open_Air_Pore_MC.py:48-76, Temperature_Pore_MC.py:55-96) but factored into a
single dataclass so the three workloads share one definition.

Note the reference uses two slightly different Boltzmann constants:
1.38e-23 in the cube/pore-v1 scripts and 1.38064852e-23 in the
temperature-pore script (Temperature_Pore_MC.py:60).  ``boltzmann`` is
therefore a field, not a module constant, and each workload config picks the
value its reference script used.
"""

from __future__ import annotations

import dataclasses
import math


# Exact values used by every reference script.
ARGON_MASS = 6.63e-26  # kg
AR_MOLAR_MASS = 0.039948  # kg/mol
MOLECULES_PER_MOLE = 6.02214179e23  # Avogadro (reference value)
IDEAL_GAS_CONST = 8.3145  # J/(mol K)
BOLTZMANN_CUBE = 1.38e-23  # cube + pore v1 scripts
BOLTZMANN_TEMP_PORE = 1.38064852e-23  # temperature-pore script
SIGMA = 3.6e-19  # collision cross-section, m^2
PRESSURE = 101325.0  # Pa
TEMP_AMBIENT = 298.0  # K


@dataclasses.dataclass(frozen=True)
class GasPhysics:
    """Argon hard-sphere gas parameters and derived quantities.

    All derived quantities follow the reference formulas exactly, including
    the RMS-speed formula labelled "mean speed" (kept for fidelity; see
    Open_Air_Cube_MC.py:54).
    """

    mass: float = ARGON_MASS
    molar_mass: float = AR_MOLAR_MASS
    molecules_per_mole: float = MOLECULES_PER_MOLE
    ideal_gas_const: float = IDEAL_GAS_CONST
    boltzmann: float = BOLTZMANN_CUBE
    temp_ambient: float = TEMP_AMBIENT
    sigma: float = SIGMA
    pressure: float = PRESSURE
    # Collision radius multiplier (reference keeps it at 1.0 but comments
    # about a possible +15%; Open_Air_Cube_MC.py:50).
    collision_radius_factor: float = 1.0

    # --- derived geometry of the molecule ---
    @property
    def argon_radius(self) -> float:
        # r = sqrt(sigma / 4 pi)  (Open_Air_Cube_MC.py:49)
        return math.sqrt(self.sigma / (4.0 * math.pi))

    @property
    def collision_radius(self) -> float:
        return self.argon_radius * self.collision_radius_factor

    @property
    def collision_range(self) -> float:
        # Centre distance below which two spheres overlap.
        return 2.0 * self.collision_radius

    # --- derived kinetic quantities ---
    @property
    def lambda_mfp(self) -> float:
        # Analytic mean free path (Open_Air_Cube_MC.py:53).
        return self.boltzmann * self.temp_ambient / (
            math.sqrt(2.0) * self.sigma * self.pressure
        )

    @property
    def v_mean(self) -> float:
        # Reference calls this "mean speed" but uses the RMS formula
        # sqrt(3RT/M) (Open_Air_Cube_MC.py:54).  Kept verbatim.
        return math.sqrt(
            3.0 * self.ideal_gas_const * self.temp_ambient / self.molar_mass
        )

    @property
    def a_shape(self) -> float:
        # Maxwell-Boltzmann scale parameter sqrt(kT/m)
        # (Open_Air_Cube_MC.py:56).
        return math.sqrt(self.boltzmann * self.temp_ambient / self.mass)

    @property
    def tau(self) -> float:
        # Mean free time (Open_Air_Cube_MC.py:61).
        return self.lambda_mfp / self.v_mean

    # --- gas amount ---
    def num_molecules(self, volume: float) -> int:
        """Ideal-gas molecule count for a volume at ambient T and P.

        N = round(PV/(RT) * N_A)  (Open_Air_Cube_MC.py:55-57).
        """
        num_moles = volume * self.pressure / (
            self.ideal_gas_const * self.temp_ambient
        )
        return int(round(num_moles * self.molecules_per_mole))

    def kinetic_energy(self, speed: float) -> float:
        # Temperature_Pore_MC.py:128-129
        return 0.5 * self.mass * speed * speed


# Physics instances matching each reference script exactly.
CUBE_PHYSICS = GasPhysics(boltzmann=BOLTZMANN_CUBE)
PORE_PHYSICS = GasPhysics(boltzmann=BOLTZMANN_CUBE)
TEMPERATURE_PORE_PHYSICS = GasPhysics(boltzmann=BOLTZMANN_TEMP_PORE)
