"""Measurement objectives — the port of the diagonal part of
:mod:`diffquantum_tpu.measure`.

A diagonal observable (any cut or Ising cost) needs no operator: its
expectation is ``sum_j |psi_j|^2 diag_j``. Shot-sampled and noisy
measurement wait for slice 2 (ROADMAP.md, Queue 1 item 10); asking for
them raises. Dense operators, rank-1 targets and Pauli-string sums wait
for slice 3 (Queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .ops import cpx
from .ops.cpx import CP
from .utils.device import resolve_device

_SAMPLED_MSG = ("shot-sampled and noisy measurement are not ported yet "
                "(ROADMAP.md, Queue 1 item 10)")


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


@dataclasses.dataclass(frozen=True)
class Measurement:
    """A diagonal measurement objective. ``terms`` keeps the optional
    decomposition that sampled measurement will read."""

    diag: torch.Tensor
    terms: Optional[DiagonalTermSet] = None
    sampling: bool = False
    noisy: bool = False

    def __post_init__(self):
        if self.sampling or self.noisy:
            raise NotImplementedError(_SAMPLED_MSG)

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

    def expectation(self, psi: CP) -> torch.Tensor:
        """Exact <psi|M|psi> (leading batch dims kept)."""
        return diag_expectation(self.diag, psi)
