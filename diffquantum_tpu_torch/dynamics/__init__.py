from .hamiltonian import ControlledHamiltonian, TermStructure
from .propagator import evolve, reference_n_steps, time_grid, trotter
