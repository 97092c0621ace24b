"""Central finite-difference gradients — the port of
:mod:`diffquantum_tpu.gradients.fd`, the reference's comparison baseline
(``compute_energy_grad_FD``, `sim_plain.py:308-353`): for every
coefficient (k, j), two forward simulations at ``c ± delta e_kj`` and
``(E_p - E_m) / (2 delta)``.

All ``2 * n_controls * n_basis`` perturbed simulations run as ONE batched
evolution with per-member coefficients (on the card, one K2 forward of
288 members for the 12-qubit ring MaxCut), not a loop. Like the JAX
package, it integrates over the true horizon [0, T] (the reference's FD
path fixes its grid to [0, 1], `sim_plain.py:320`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dynamics.propagator import evolve
from .mc import check_sampled_size
from ..measure import Measurement, measure
from ..ops.cpx import CP


def fd_energy_grad(ham, envelope, measurement: Measurement,
                   coeff: torch.Tensor, psi0: CP, T: float,
                   generator: Optional[torch.Generator], n_steps: int,
                   backend: str = "auto", delta: float = 1e-3,
                   sampling: bool = False, noisy: bool = False,
                   per_pauli: int = 100, precision: str = "full",
                   t_sample: str = "left") -> torch.Tensor:
    """Central-difference gradient over all coefficients, one batched
    evolution; shaped like ``coeff``. ``generator`` draws the shots and
    noise of a sampled or noisy measurement (None when exact)."""
    check_sampled_size(ham, "the FD gradient")
    shape = coeff.shape
    n_params = coeff.numel()
    flat = coeff.reshape(-1)
    eye = torch.eye(n_params, dtype=coeff.dtype, device=coeff.device) * delta
    all_coeffs = torch.cat([flat[None, :] + eye, flat[None, :] - eye],
                           dim=0).reshape((2 * n_params,) + tuple(shape))
    batch = CP(psi0.re.expand(2 * n_params, -1),
               psi0.im.expand(2 * n_params, -1))
    psi = evolve(ham, envelope, all_coeffs, batch, 0.0, T, horizon=T,
                 n_steps=n_steps, backend=backend, precision=precision,
                 t_sample=t_sample)
    e = measure(measurement, psi, generator, sampling, noisy, per_pauli)
    return ((e[:n_params] - e[n_params:]) / (2.0 * delta)).reshape(
        shape).to(coeff.dtype)
