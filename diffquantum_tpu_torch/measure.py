"""Measurement objectives — the port of :mod:`diffquantum_tpu.measure`:
dense operators, diagonal observables and rank-1 targets.

- a dense Hermitian M (CP [d, d]): ``Re <psi|M|psi>``
  (:func:`exact_expectation`), shot-sampled per weighted term in each
  term's eigenbasis (:class:`PauliTermSet`, :func:`stochastic_measure`);
- a diagonal observable (any cut or Ising cost) needs no operator:
  ``sum_j |psi_j|^2 diag_j``, sampled by computational-basis draws per
  term (:func:`stochastic_measure_diag`);
- a rank-1 target ``|t><t|`` (the fidelity objective): ``|<t|psi>|^2``,
  sampled as Bernoulli trials (:func:`sampled_target_prob`).

Noisy measurement adds the reference's Gaussian noise of scale |value|/5
(:func:`measurement_noise`). Every draw comes from an explicit
``torch.Generator`` where the JAX package takes a PRNG key, so the two
packages agree in distribution, not draw by draw. Pauli-string sums
(``create_strings``) wait for ROADMAP.md, Queue 1: Pauli-string
objectives, and raise.
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

_UNPORTED_MSG = ("Pauli-string measurement objectives (create_strings, "
                 "PauliStringSet) are not ported yet (ROADMAP.md, Queue 1: "
                 "Pauli-string objectives)")


def exact_expectation(m: CP, psi: CP) -> torch.Tensor:
    """Re <psi|M|psi> for a dense M [d, d] (psi may carry batch dims)."""
    mp = cpx.matvec(m, psi)
    return torch.sum(psi.re * mp.re + psi.im * mp.im, dim=-1)


@dataclasses.dataclass(frozen=True)
class PauliTermSet:
    """A measurement operator as weighted Hermitian terms with their
    eigensystems: weights [n_terms], evals [n_terms, d], estates CP
    [n_terms, d, d] (eigenvectors as columns)."""

    weights: torch.Tensor
    evals: torch.Tensor
    estates: CP

    @classmethod
    def create(cls, terms: Sequence[tuple[np.ndarray, float]],
               dtype=torch.float32, device="cuda") -> "PauliTermSet":
        """From (matrix, weight) pairs; one host eigendecomposition per
        term."""
        dev = resolve_device(device)
        ws, evs, ests = [], [], []
        for m, w in terms:
            ev, es = np.linalg.eigh(np.asarray(m))
            ws.append(float(w))
            evs.append(ev)
            ests.append(es)
        return cls(weights=torch.tensor(ws, dtype=dtype, device=dev),
                   evals=torch.as_tensor(np.stack(evs), dtype=dtype,
                                         device=dev),
                   estates=cpx.from_complex(np.stack(ests), dtype=dtype,
                                            device=dev))

    @property
    def n_terms(self) -> int:
        return self.weights.shape[0]


def stochastic_measure(terms: PauliTermSet, psi: CP,
                       generator: torch.Generator,
                       per_pauli: int = 100) -> torch.Tensor:
    """Finite-shot estimate of sum_t w_t <psi|P_t|psi>: per term, the Born
    distribution over its eigenstates |<e_j|psi>|^2, ``per_pauli`` draws
    (``torch.multinomial`` with replacement, where the JAX package draws
    ``jax.random.categorical``) and ``w_t mean(eval_t[draws])``. psi [d]
    gives a scalar, [..., d] one estimate per state."""
    er = terms.estates.re.transpose(-1, -2)          # [t, j, d]
    ei = terms.estates.im.transpose(-1, -2)
    amp_re = torch.einsum("tjd,...d->...tj", er, psi.re) \
        + torch.einsum("tjd,...d->...tj", ei, psi.im)
    amp_im = torch.einsum("tjd,...d->...tj", er, psi.im) \
        - torch.einsum("tjd,...d->...tj", ei, psi.re)
    probs = amp_re * amp_re + amp_im * amp_im        # [..., t, d]
    lead, (n_terms, d) = probs.shape[:-2], probs.shape[-2:]
    draws = torch.multinomial(probs.reshape(-1, d), per_pauli,
                              replacement=True, generator=generator)
    draws = draws.reshape(-1, n_terms, per_pauli)
    vals = torch.gather(terms.evals.expand(draws.shape[0], n_terms, d), -1,
                        draws)
    est = torch.sum(terms.weights * vals.mean(dim=-1), dim=-1)
    return est.reshape(lead)


def target_overlap_prob(target: CP, psi: CP) -> torch.Tensor:
    """|<t|psi>|^2 (psi may carry batch dims): the rank-1 projector's
    expectation, matrix-free."""
    return cpx.abs2(cpx.vdot(target, psi))


def sampled_target_prob(target: CP, psi: CP, generator: torch.Generator,
                        shots: int = 100) -> torch.Tensor:
    """Finite-shot estimate of |<t|psi>|^2: ``shots`` Bernoulli trials
    with success probability p, the frequency."""
    p = torch.clamp(target_overlap_prob(target, psi), 0.0, 1.0)
    u = torch.rand((shots,) + tuple(p.shape), generator=generator,
                   dtype=p.dtype, device=p.device)
    return torch.mean((u < p).to(p.dtype), dim=0)


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
    """A measurement objective — a dense operator (``matrix``), a
    diagonal (``diag``) or a rank-1 target (``target``) — with the
    reference's sampling and noise switches (`sim_plain.py:30-31`).
    ``terms`` is the decomposition that sampled measurement reads (a
    :class:`PauliTermSet` for a dense operator, a
    :class:`DiagonalTermSet` for a diagonal; without one a diagonal is
    sampled as one term)."""

    diag: Optional[torch.Tensor] = None
    terms: Optional[object] = None
    sampling: bool = False
    noisy: bool = False
    per_pauli: int = 100
    matrix: Optional[CP] = None
    target: Optional[CP] = None

    @classmethod
    def create(cls, matrix, terms=None, dtype=torch.float32, device="cuda",
               **kw) -> "Measurement":
        """From a host complex operator [d, d], with an optional
        (matrix, weight) term list for sampled measurement."""
        dev = resolve_device(device)
        term_set = PauliTermSet.create(terms, dtype=dtype, device=dev) \
            if terms else None
        return cls(matrix=cpx.from_complex(np.asarray(matrix), dtype=dtype,
                                           device=dev), terms=term_set, **kw)

    @classmethod
    def create_target(cls, target, dtype=torch.float32, device="cuda",
                      **kw) -> "Measurement":
        """Matrix-free rank-1 projector M = |t><t| from a target state:
        ``target`` a host complex [d] array or a CP pair (kept as it
        is)."""
        t = target if isinstance(target, CP) else cpx.from_complex(
            np.asarray(target), dtype=dtype, device=resolve_device(device))
        return cls(target=t, **kw)

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
    """<psi|M|psi>, shot-sampled and/or with Gaussian noise as asked (the
    flags of the caller, as the JAX package's estimators pass their
    own)."""
    if (sampling or noisy) and generator is None:
        raise ValueError("sampled or noisy measurement needs a "
                         "torch.Generator")
    if sampling:
        if m.target is not None:
            val = sampled_target_prob(m.target, psi, generator, per_pauli)
        elif isinstance(m.terms, PauliTermSet):
            val = stochastic_measure(m.terms, psi, generator, per_pauli)
        elif m.terms is not None or m.diag is not None:
            terms = m.terms
            if terms is None:  # sample the diagonal as ONE term
                terms = DiagonalTermSet(weights=torch.ones(
                    (1,), dtype=m.diag.dtype, device=m.diag.device),
                    diags=m.diag[None, :])
            val = stochastic_measure_diag(terms, psi, generator, per_pauli)
        else:
            raise ValueError(
                "sampling measurement needs a term decomposition: pass "
                "terms=/diag_terms= at construction (or use create_target)")
    elif m.diag is not None:
        val = diag_expectation(m.diag, psi)
    elif m.target is not None:
        val = target_overlap_prob(m.target, psi)
    else:
        val = exact_expectation(m.matrix, psi)
    if noisy:
        val = measurement_noise(val, generator)
    return val
