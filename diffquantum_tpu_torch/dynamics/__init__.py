from .hamiltonian import ControlledHamiltonian, TermStructure
from .propagator import evolve, reference_n_steps, time_grid, trotter
from .lindblad import (CollapseSet, StructuredNoise, amplitude_damping,
                       dephasing, density_from_trajectories,
                       evolve_dephasing_trajectories, evolve_lindblad,
                       evolve_lindblad_structured, evolve_mcwf,
                       evolve_mcwf_structured, expectation_rho,
                       score_surrogate)
