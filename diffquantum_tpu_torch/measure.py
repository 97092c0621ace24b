"""Measurement objectives — the port of the diagonal part of
:mod:`diffquantum_tpu.measure`.

A diagonal observable (any cut or Ising cost) needs no operator: its
expectation is ``sum_j |psi_j|^2 diag_j``. Shot-sampled measurement draws
computational-basis outcomes from |psi|^2 per term
(:func:`stochastic_measure_diag`), and noisy measurement adds the
reference's Gaussian noise of scale |value|/5
(:func:`measurement_noise`); both draw from an explicit
``torch.Generator`` where the JAX package takes a PRNG key, so the two
packages agree in distribution, not draw by draw. Dense operators,
rank-1 targets and Pauli-string sums wait for slice 3 (ROADMAP.md,
Queue 1 item 13); their constructors raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .ops import cpx
from .ops.cpx import CP
from .utils.device import resolve_device

NOISE_REL_SCALE = 0.2  # reference: np.random.normal(scale=|v|/5)

_UNPORTED_MSG = ("dense, target and Pauli-string measurement objectives "
                 "are not ported yet (ROADMAP.md, Queue 1 item 13)")


def diag_expectation(diag: torch.Tensor, psi: CP) -> torch.Tensor:
    """<psi|diag(w)|psi> = sum |psi|^2 w over the last axis."""
    return torch.sum(cpx.abs2(psi) * diag, dim=-1)


@dataclasses.dataclass(frozen=True)
class DiagonalTermSet:
    """Weighted diagonal terms: weights [n_terms], diags [n_terms, d]."""

    weights: torch.Tensor
    diags: torch.Tensor

    @classmethod
    def create(cls, terms: Sequence[tuple[np.ndarray, float]],
               dtype=torch.float32, device="cuda") -> "DiagonalTermSet":
        """terms: (diag_vector, weight) pairs."""
        dev = resolve_device(device)
        ws = torch.tensor([w for _, w in terms], dtype=dtype, device=dev)
        ds = torch.as_tensor(np.stack([np.asarray(d) for d, _ in terms]),
                             dtype=dtype, device=dev)
        return cls(weights=ws, diags=ds)

    @property
    def n_terms(self) -> int:
        return self.weights.shape[0]


def stochastic_measure_diag(terms: DiagonalTermSet, psi: CP,
                            generator: torch.Generator,
                            per_pauli: int = 100) -> torch.Tensor:
    """Finite-shot estimate for diagonal terms: independent ``per_pauli``
    computational-basis draws from |psi|^2 per term (the reference's
    per-term sampling, `sim_plain.py:104-116`), then
    ``sum_t w_t mean(diag_t[draws])``. psi [d] gives a scalar, [..., d]
    one estimate per state. The draws come from ``generator`` on psi's
    device (``torch.multinomial`` with replacement), where the JAX
    package draws ``jax.random.categorical``."""
    probs = cpx.abs2(psi)
    lead = probs.shape[:-1]
    d = probs.shape[-1]
    n_terms = terms.n_terms
    draws = torch.multinomial(probs.reshape(-1, d), n_terms * per_pauli,
                              replacement=True, generator=generator)
    draws = draws.reshape(-1, n_terms, per_pauli)     # [S, t, shots]
    vals = torch.gather(terms.diags.expand(draws.shape[0], n_terms, d), -1,
                        draws)
    est = torch.sum(terms.weights * vals.mean(dim=-1), dim=-1)
    return est.reshape(lead)


def measurement_noise(value: torch.Tensor, generator: torch.Generator,
                      rel_scale: float = NOISE_REL_SCALE) -> torch.Tensor:
    """value + N(0, |value| * rel_scale) — `sim_plain.py:283-284`."""
    sigma = torch.abs(value) * rel_scale
    return value + sigma * torch.randn(value.shape, generator=generator,
                                       dtype=value.dtype,
                                       device=value.device)


@dataclasses.dataclass(frozen=True)
class Measurement:
    """A diagonal measurement objective with the reference's sampling and
    noise switches (`sim_plain.py:30-31`). ``terms`` is the optional
    decomposition that sampled measurement reads; without it the diagonal
    is sampled as one term."""

    diag: torch.Tensor
    terms: Optional[DiagonalTermSet] = None
    sampling: bool = False
    noisy: bool = False
    per_pauli: int = 100

    @classmethod
    def create(cls, *args, **kw):
        raise NotImplementedError(_UNPORTED_MSG)

    @classmethod
    def create_target(cls, *args, **kw):
        raise NotImplementedError(_UNPORTED_MSG)

    @classmethod
    def create_strings(cls, *args, **kw):
        raise NotImplementedError(_UNPORTED_MSG)

    @classmethod
    def create_diagonal(cls, diag, diag_terms=None, dtype=torch.float32,
                        device="cuda", **kw) -> "Measurement":
        """Matrix-free diagonal observable: ``diag`` is the length-d real
        diagonal; ``diag_terms`` optional (diag_vector, weight) pairs."""
        dev = resolve_device(device)
        term_set = DiagonalTermSet.create(diag_terms, dtype=dtype,
                                          device=dev) if diag_terms else None
        return cls(diag=torch.as_tensor(np.asarray(diag), dtype=dtype,
                                        device=dev),
                   terms=term_set, **kw)

    def expectation(self, psi: CP,
                    generator: Optional[torch.Generator] = None):
        """Measured value of <psi|M|psi> (leading batch dims kept),
        honoring the sampling/noise flags; ``generator`` (on psi's
        device) is required when either is set."""
        return measure(self, psi, generator, self.sampling, self.noisy,
                       self.per_pauli)


def measure(m: Measurement, psi: CP, generator, sampling: bool,
            noisy: bool, per_pauli: int = 100) -> torch.Tensor:
    """<psi|M|psi> of a diagonal measurement, shot-sampled and/or with
    Gaussian noise as asked (the flags of the caller, as the JAX
    package's estimators pass their own)."""
    if (sampling or noisy) and generator is None:
        raise ValueError("sampled or noisy measurement needs a "
                         "torch.Generator")
    if sampling:
        terms = m.terms
        if terms is None:  # sample the diagonal as ONE term
            terms = DiagonalTermSet(weights=torch.ones(
                (1,), dtype=m.diag.dtype, device=m.diag.device),
                diags=m.diag[None, :])
        val = stochastic_measure_diag(terms, psi, generator, per_pauli)
    else:
        val = diag_expectation(m.diag, psi)
    if noisy:
        val = measurement_noise(val, generator)
    return val
