"""Host-side (numpy) operator helpers — a copy of
:mod:`diffquantum_tpu.ops.linalg`. They run once at problem construction,
not on the hot path. Qubit 0 is the most significant bit of
an amplitude index (the kron ordering)."""
from __future__ import annotations

import functools

import numpy as np
import torch

I2 = np.eye(2, dtype=np.complex128)
X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=np.complex128)
Y = np.array([[0.0, -1.0j], [1.0j, 0.0]], dtype=np.complex128)
Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=np.complex128)

PAULIS = {"I": I2, "X": X, "Y": Y, "Z": Z}


def find_state(final_state) -> tuple[int, np.ndarray]:
    """Most-probable computational basis state and the Born distribution.
    Accepts a CP pair (of tensors or arrays) or a complex vector."""
    if hasattr(final_state, "re"):
        re, im = (_host(final_state.re), _host(final_state.im))
        prob = re.reshape(-1) ** 2 + im.reshape(-1) ** 2
    else:
        prob = np.abs(_host(final_state).reshape(-1)) ** 2
    return int(np.argmax(prob)), prob


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):  # torch tensor, possibly on the card
        return a.detach().cpu().numpy()
    return np.asarray(a)


def uniform_superposition(n_qubits: int) -> np.ndarray:
    """|+>^n as a dense vector."""
    d = 2**n_qubits
    return np.full((d,), 1.0 / np.sqrt(d), dtype=np.complex128)


@functools.lru_cache(maxsize=None)
def _zz_diag_cache(n_qubits: int, i: int, j: int) -> np.ndarray:
    bits = np.arange(2**n_qubits)
    bi = (bits >> (n_qubits - 1 - i)) & 1
    bj = (bits >> (n_qubits - 1 - j)) & 1
    return np.where(bi == bj, 1.0, -1.0)


def zz_diagonal(n_qubits: int, i: int, j: int) -> np.ndarray:
    """Diagonal of Z_i Z_j as a length-2^n real vector."""
    return _zz_diag_cache(n_qubits, i, j)


def z_diagonal(n_qubits: int, i: int) -> np.ndarray:
    bits = np.arange(2**n_qubits)
    bi = (bits >> (n_qubits - 1 - i)) & 1
    return np.where(bi == 0, 1.0, -1.0)


def multi_kron(*ops) -> np.ndarray:
    """Kronecker product of a sequence of operators."""
    ret = np.array([[1.0 + 0.0j]])
    for q in ops:
        ret = np.kron(ret, np.asarray(q))
    return ret


def multi_dot(*ops):
    """Chained matrix product, left to right."""
    ret = None
    for q in ops:
        ret = q if ret is None else ret @ q
    return ret


def pauli_string(spec: str) -> np.ndarray:
    """Dense operator of a Pauli string such as ``"ZIZI"``."""
    return multi_kron(*[PAULIS[c] for c in spec])


def op_on_qubits(op: np.ndarray, qubits, n_qubits: int,
                 op_single: np.ndarray | None = None) -> np.ndarray:
    """``op`` (or ``op_single`` when given) on each qubit in ``qubits``,
    identity elsewhere."""
    single = op if op_single is None else op_single
    return multi_kron(*[single if j in qubits else I2
                        for j in range(n_qubits)])


def basis_state(index: int, dim: int) -> np.ndarray:
    psi = np.zeros((dim,), dtype=np.complex128)
    psi[index] = 1.0
    return psi


def dagger(a):
    """Conjugate transpose of the last two axes (a numpy array or a
    complex torch tensor)."""
    if isinstance(a, torch.Tensor):
        return a.conj().transpose(-1, -2)
    return np.conjugate(np.swapaxes(a, -1, -2))


def is_hermitian(a: np.ndarray, atol: float = 1e-9) -> bool:
    return bool(np.allclose(a, np.conjugate(np.asarray(a)).T, atol=atol))
