"""Adjoint (reverse-mode) gradients through the propagator — the port of
:mod:`diffquantum_tpu.gradients.adjoint` (``energy_and_grad``,
``fidelity_and_grad``).

One forward and one reverse pass give the exact gradient. On the fused
engine the reverse pass is the adjoint kernel of K1-K6, which rebuilds
the state step by step instead of storing it (O(1) memory in the step
count); on the dense 'apply' backend it is K7's backward per step, from
the step inputs autograd keeps (O(T) states).
"""
from __future__ import annotations

import torch

from ..dynamics.propagator import evolve
from ..measure import (Measurement, diag_expectation, exact_expectation,
                       target_overlap_prob)
from ..ops import cpx
from ..ops.cpx import CP


def _objective(m, psi: CP) -> torch.Tensor:
    """<psi|M|psi> (exact) for a dense CP operator, a real diagonal
    tensor or a Measurement (its diagonal, target, Pauli strings or
    matrix)."""
    if isinstance(m, CP):
        return exact_expectation(m, psi)
    if isinstance(m, torch.Tensor):
        return diag_expectation(m, psi)
    if isinstance(m, Measurement):
        if m.diag is not None:
            return diag_expectation(m.diag, psi)
        if m.target is not None:
            return target_overlap_prob(m.target, psi)
        if m.strings is not None:
            return m.strings.expectation(psi)
        return exact_expectation(m.matrix, psi)
    raise TypeError(
        f"energy_and_grad takes a Measurement, a dense CP operator or a "
        f"diagonal tensor, not {type(m).__name__}")


def _value_and_grad(loss_of_psi, ham, envelope, coeff, psi0, T, n_steps,
                    backend, precision, t_sample):
    c = coeff.detach().requires_grad_(True)
    with torch.enable_grad():
        psi = evolve(ham, envelope, c, psi0, 0.0, T, horizon=T,
                     n_steps=n_steps, backend=backend, precision=precision,
                     t_sample=t_sample)
        loss = loss_of_psi(psi)
        (g,) = torch.autograd.grad(loss, c)
    return loss.detach(), g


def energy_and_grad(ham, envelope, m, coeff: torch.Tensor, psi0, T: float,
                    n_steps: int, backend: str = "auto",
                    precision: str = "full", t_sample: str = "left"):
    """(<psi(T)|M|psi(T)>, d/dcoeff) by reverse-mode autodiff. ``m``: a
    Measurement (its exact path), a dense CP operator or a real diagonal
    tensor."""
    return _value_and_grad(lambda psi: _objective(m, psi), ham, envelope,
                           coeff, psi0, T, n_steps, backend, precision,
                           t_sample)


def fidelity_and_grad(ham, envelope, target: CP, coeff: torch.Tensor,
                      psi0, T: float, n_steps: int, backend: str = "auto",
                      precision: str = "full", t_sample: str = "left"):
    """(1 - |<target|psi(T)>|^2, d/dcoeff) by reverse-mode autodiff."""
    return _value_and_grad(
        lambda psi: 1.0 - cpx.abs2(cpx.vdot(target, psi)), ham, envelope,
        coeff, psi0, T, n_steps, backend, precision, t_sample)
