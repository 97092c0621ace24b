"""Controlled-Hamiltonian container H(t) = H0 + sum_k u_k(t) H_k — the
port of :mod:`diffquantum_tpu.dynamics.hamiltonian`.

Two forms. A structured Hamiltonian (:meth:`ControlledHamiltonian.
create_structured`) stores metadata, not operators: each control term is
a diagonal, a single-qubit 2x2 local or a hop pair
(:class:`TermStructure`), which is all the product-formula engines need.
A dense one (:meth:`ControlledHamiltonian.create`) holds H0 [d, d] and
the stacked controls Hs [n_controls, d, d] as CP planes on its device,
for the dense propagator backends ('expm', 'apply'); it may carry
structure tags too, given or found by :func:`detect_structure`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import cpx
from ..ops.cpx import CP
from ..utils.device import resolve_device


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
      - 'dense': no structure (only :func:`classify_operator` returns it).
    """

    kind: str
    qubit: int = -1
    local: Optional[np.ndarray] = None
    diag: Optional[np.ndarray] = None
    qubit2: int = -1


def classify_operator(m: np.ndarray, tol: float = 1e-10) -> TermStructure:
    """Classify one dense operator as 'diag', '1q' (I x..x G x..x I) or
    'dense' (host numpy, once at construction)."""
    m = np.asarray(m, dtype=np.complex128)
    d = m.shape[0]
    if np.max(np.abs(m - np.diag(np.diagonal(m)))) <= tol \
            and np.max(np.abs(np.diagonal(m).imag)) <= tol:
        return TermStructure(kind="diag", diag=np.real(np.diagonal(m)).copy())
    n = int(round(np.log2(d)))
    if 2**n == d:
        for q in range(n):
            left, right = 2**q, 2 ** (n - q - 1)
            g = m.reshape(left, 2, right, left, 2, right)[0, :, 0, 0, :, 0]
            if np.allclose(m, np.kron(np.eye(left),
                                      np.kron(g, np.eye(right))), atol=tol):
                return TermStructure(kind="1q", qubit=q, local=g.copy())
    return TermStructure(kind="dense")


def detect_structure(H0, Hs, tol: float = 1e-10):
    """(structure, h0_structure) tags for dense inputs, or (None, None)
    when some term is neither diagonal nor single-qubit or H0 is not
    diagonal (no partial tags)."""
    h0 = classify_operator(H0, tol)
    if h0.kind != "diag":
        return None, None
    tags = tuple(classify_operator(h, tol) for h in Hs)
    if any(t.kind == "dense" for t in tags):
        return None, None
    return tags, h0


@dataclasses.dataclass(frozen=True, eq=False)
class ControlledHamiltonian:
    """H(t) with static norm metadata: structure-only (``H0``/``Hs`` None)
    or dense (``H0`` CP [d, d], ``Hs`` CP [n_controls, d, d] on the
    device, ``structure`` optional). ``dtype`` is the real dtype states
    evolve in. Host-side analysis results (the term split, the routing
    decision) and device tables are memoized per instance in ``_memo``."""

    h0_norm: float
    hs_norms: tuple[float, ...]
    structure: Optional[tuple[TermStructure, ...]]
    h0_structure: Optional[TermStructure]
    n_qubits: int
    dtype: torch.dtype = torch.float32
    H0: Optional[CP] = None
    Hs: Optional[CP] = None
    _memo: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False)

    @classmethod
    def create(cls, H0, Hs: Sequence, dtype=torch.float32,
               structure: Optional[Sequence[TermStructure]] = None,
               h0_structure: Optional[TermStructure] = None,
               auto_structure: bool = False,
               device="cuda") -> "ControlledHamiltonian":
        """Dense H0 and controls from host (complex) numpy operators, on
        ``device``. ``dtype`` is the real storage dtype;
        ``auto_structure=True`` runs :func:`detect_structure` when no
        tags are given."""
        dev = resolve_device(device)
        H0_np = np.asarray(H0, dtype=np.complex128)
        Hs_np = np.stack([np.asarray(h, dtype=np.complex128) for h in Hs]) \
            if len(Hs) else np.zeros((0,) + H0_np.shape, dtype=np.complex128)
        if auto_structure and structure is None:
            structure, h0_structure = detect_structure(H0_np, Hs_np)
        d = H0_np.shape[0]
        n_qubits = int(round(np.log2(d))) if d & (d - 1) == 0 else -1
        return cls(
            h0_norm=spectral_norm_bound(H0_np),
            hs_norms=tuple(spectral_norm_bound(h) for h in Hs_np),
            structure=tuple(structure) if structure is not None else None,
            h0_structure=h0_structure, n_qubits=n_qubits, dtype=dtype,
            H0=cpx.from_complex(H0_np, dtype=dtype, device=dev),
            Hs=cpx.from_complex(Hs_np, dtype=dtype, device=dev))

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
        return self.H0 is None

    @property
    def dim(self) -> int:
        if self.is_structured_only:
            return 2**self.n_qubits
        return self.H0.shape[-1]

    @property
    def n_controls(self) -> int:
        return len(self.hs_norms)

    def norm_bound(self, u_max: Sequence[float]) -> float:
        """Static bound on ||H(t)|| given per-control amplitude bounds."""
        return self.h0_norm + float(
            sum(abs(u) * n for u, n in zip(u_max, self.hs_norms)))

    def at(self, u_t: torch.Tensor) -> CP:
        """Dense H(t) = H0 + sum_k u_k H_k for amplitudes u_t [...,
        n_controls] (one product with the [n_controls, d*d] stack, so a
        whole time grid [T, n_controls] reads Hs once): CP [..., d, d]."""
        if self.is_structured_only:
            raise ValueError("at() needs dense operators; this "
                             "ControlledHamiltonian is structure-only")
        if self.n_controls == 0:
            shape = tuple(u_t.shape[:-1]) + tuple(self.H0.shape)
            return CP(self.H0.re.expand(shape), self.H0.im.expand(shape))
        mix = cpx.tensordot_weights(u_t.to(self.dtype), self.Hs)
        return cpx.add(self.H0, mix)
