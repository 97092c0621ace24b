"""Controlled-Hamiltonian container H(t) = H0 + sum_k u_k(t) H_k — the
port of :mod:`diffquantum_tpu.dynamics.hamiltonian`, structured form only.

A structured Hamiltonian stores metadata, not operators: each control
term is a diagonal, a single-qubit 2x2 local or a hop pair
(:class:`TermStructure`). That is all the product-formula engines need.
Dense construction (``create``) and ``detect_structure`` come with the
dense backends (ROADMAP.md, Queue 1 items 12 and 13).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def spectral_norm_bound(m: np.ndarray) -> float:
    """Exact spectral norm for Hermitian inputs, Frobenius bound else."""
    m = np.asarray(m)
    if m.size == 0:
        return 0.0
    if np.allclose(m, m.conj().T, atol=1e-10):
        return float(np.max(np.abs(np.linalg.eigvalsh(m))))
    return float(np.linalg.norm(m))


@dataclasses.dataclass(frozen=True, eq=False)
class TermStructure:
    """Structure tag for one control term (compares by identity).

    kind:
      - 'diag': diagonal term; ``diag`` is the length-d real diagonal.
      - '1q'  : single-qubit operator ``local`` (2x2 complex) on ``qubit``
                (0 = MSB in the kron ordering).
      - 'hop' : ``X_i X_j + Y_i Y_j`` on sites (``qubit``, ``qubit2``).
    """

    kind: str
    qubit: int = -1
    local: Optional[np.ndarray] = None
    diag: Optional[np.ndarray] = None
    qubit2: int = -1


@dataclasses.dataclass(frozen=True, eq=False)
class ControlledHamiltonian:
    """Structure-only H(t) with static norm metadata. ``dtype`` is the real
    dtype states evolve in. Host-side analysis results (the term split,
    the routing decision) and device tables are memoized per instance in
    ``_memo``."""

    h0_norm: float
    hs_norms: tuple[float, ...]
    structure: tuple[TermStructure, ...]
    h0_structure: TermStructure
    n_qubits: int
    dtype: torch.dtype = torch.float32
    _memo: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False)

    @classmethod
    def create(cls, *args, **kw):
        raise NotImplementedError(
            "dense ControlledHamiltonian.create is not ported yet "
            "(ROADMAP.md, Queue 1 item 12); use create_structured")

    @classmethod
    def create_structured(cls, dim: int,
                          structure: Sequence[TermStructure],
                          h0_structure: Optional[TermStructure] = None,
                          dtype=torch.float32) -> "ControlledHamiltonian":
        """Matrix-free construction from structure metadata."""
        if h0_structure is None:
            h0_structure = TermStructure(kind="diag", diag=np.zeros(dim))
        norms = []
        for st in structure:
            if st.kind == "diag":
                norms.append(float(np.max(np.abs(st.diag))))
            elif st.kind == "1q":
                norms.append(spectral_norm_bound(st.local))
            elif st.kind == "hop":
                norms.append(2.0)   # ||XX + YY|| = 2
            else:
                raise ValueError(
                    "structured terms must be 'diag', '1q' or 'hop'")
        h0_norm = float(np.max(np.abs(h0_structure.diag))) \
            if h0_structure.kind == "diag" else spectral_norm_bound(
                h0_structure.local)
        return cls(h0_norm=h0_norm, hs_norms=tuple(norms),
                   structure=tuple(structure), h0_structure=h0_structure,
                   n_qubits=int(round(np.log2(dim))), dtype=dtype)

    @property
    def is_structured_only(self) -> bool:
        return True

    @property
    def dim(self) -> int:
        return 2**self.n_qubits

    @property
    def n_controls(self) -> int:
        return len(self.hs_norms)

    def norm_bound(self, u_max: Sequence[float]) -> float:
        """Static bound on ||H(t)|| given per-control amplitude bounds."""
        return self.h0_norm + float(
            sum(abs(u) * n for u, n in zip(u_max, self.hs_norms)))
