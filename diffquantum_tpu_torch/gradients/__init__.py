from .adjoint import energy_and_grad, fidelity_and_grad
from .fd import fd_energy_grad
from .mc import (envelope_sensitivity, mc_energy_grad, mc_energy_grad_batch,
                 mc_grads_per_sample)
