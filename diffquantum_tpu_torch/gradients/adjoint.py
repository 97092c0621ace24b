"""Adjoint (reverse-mode) gradients through the propagator — the port of
:func:`diffquantum_tpu.gradients.adjoint.energy_and_grad`.

One forward and one reverse pass give the exact gradient. On the fused
engine the reverse pass is K1's adjoint kernel, which rebuilds the state
step by step instead of storing it (O(1) memory in the step count).
"""
from __future__ import annotations

import torch

from ..dynamics.propagator import evolve
from ..measure import Measurement, diag_expectation


def energy_and_grad(ham, envelope, m, coeff: torch.Tensor, psi0, T: float,
                    n_steps: int, backend: str = "auto",
                    precision: str = "full", t_sample: str = "left"):
    """(<psi(T)|M|psi(T)>, d/dcoeff) by reverse-mode autodiff.

    ``m``: a diagonal :class:`~..measure.Measurement` or a raw diagonal
    vector (tensor). Dense operators, Pauli-string sums and targets are
    not ported yet (ROADMAP.md, Queue 1 item 13)."""
    if isinstance(m, Measurement):
        diag = m.diag
    elif isinstance(m, torch.Tensor):
        diag = m
    else:
        raise NotImplementedError(
            f"energy_and_grad takes a diagonal Measurement or vector; "
            f"{type(m).__name__} objectives are not ported yet "
            "(ROADMAP.md, Queue 1 item 13)")
    c = coeff.detach().requires_grad_(True)
    with torch.enable_grad():
        psi = evolve(ham, envelope, c, psi0, 0.0, T, horizon=T,
                     n_steps=n_steps, backend=backend, precision=precision,
                     t_sample=t_sample)
        loss = diag_expectation(diag, psi)
        (g,) = torch.autograd.grad(loss, c)
    return loss.detach(), g
