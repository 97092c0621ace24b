from .adjoint import energy_and_grad
