"""Pulse-level VQE for the transverse-field Ising model — the port of
:mod:`diffquantum_tpu.models.tfim`:

    H_c = -J sum_i Z_i Z_{i+1} - h sum_i X_i

is not diagonal, so it runs on the matrix-free Pauli-string measurement
(:class:`..measure.PauliStringSet`). The open chain is solvable by
Jordan-Wigner free fermions, a ground-truth energy at any size:
``E0 = -sum singular_values(A)`` with ``A_ii = h, A_{i,i+1} = J``.

Controls mirror the QAOA layout: a ZZ drive per bond and an X drive per
site, structure-tagged, so the fused engines take it at scale.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dynamics.hamiltonian import ControlledHamiltonian, TermStructure
from ..measure import Measurement
from ..ops import cpx, linalg
from ..ops.cpx import CP
from ..pulses.envelope import SimpleEnvelope
from ..utils.device import resolve_device


def exact_ground_energy(n: int, J: float = 1.0, h: float = 1.0) -> float:
    """Free-fermion ground energy of the open-chain TFIM (exact at any
    n)."""
    a = np.zeros((n, n))
    np.fill_diagonal(a, h)
    for i in range(n - 1):
        a[i, i + 1] = J
    return float(-np.sum(np.linalg.svd(a, compute_uv=False)))


@dataclasses.dataclass
class TfimProblem:
    n_qubits: int
    J: float
    h: float
    ham: ControlledHamiltonian
    envelope: SimpleEnvelope
    measurement: Measurement
    psi0: CP
    T: float
    exact_ground: float


def build_tfim(n_qubits: int, J: float = 1.0, h: float = 1.0,
               n_basis: int = 6, basis: str = "bspline",
               omega0: float = np.pi, omega1: float = np.pi,
               n_layers: int = 1, dtype=torch.float32,
               sampling: bool = False, noisy: bool = False,
               dense: bool | None = None, device="cuda") -> TfimProblem:
    """The TFIM problem on ``device``. ``dense=None`` picks dense
    operators up to 8 qubits and the structured form beyond, as
    ``build_maxcut`` does. The cost observable is always the Pauli-string
    set (it has off-diagonal X terms)."""
    dev = resolve_device(device)
    d = 2**n_qubits
    if dense is None:
        dense = n_qubits <= 8
    bonds = [(i, i + 1) for i in range(n_qubits - 1)]

    def _label(kind: str, sites: tuple) -> str:
        return "".join(kind if q in sites else "I" for q in range(n_qubits))

    string_terms = [(_label("Z", (i, j)), -J) for (i, j) in bonds]
    string_terms += [(_label("X", (q,)), -h) for q in range(n_qubits)]
    meas = Measurement.create_strings(string_terms, dtype=dtype, device=dev,
                                      sampling=sampling, noisy=noisy)

    omegas, structure = [], []
    for (i, j) in bonds:
        omegas.append(omega0)
        structure.append(TermStructure(
            kind="diag", diag=linalg.zz_diagonal(n_qubits, i, j)))
    for q in range(n_qubits):
        omegas.append(omega1)
        structure.append(TermStructure(kind="1q", qubit=q, local=linalg.X))
    env = SimpleEnvelope(basis=basis, n_basis=n_basis, omegas=tuple(omegas))

    h0_tag = TermStructure(kind="diag", diag=np.zeros(d))
    if dense:
        Hs = [np.diag(linalg.zz_diagonal(n_qubits, i, j)) for (i, j) in bonds]
        Hs += [linalg.op_on_qubits(linalg.X, [q], n_qubits)
               for q in range(n_qubits)]
        ham = ControlledHamiltonian.create(
            np.zeros((d, d)), Hs, dtype=dtype, structure=structure,
            h0_structure=h0_tag, device=dev)
    else:
        ham = ControlledHamiltonian.create_structured(
            d, structure, h0_structure=h0_tag, dtype=dtype)

    T = float(np.pi * (1.0 / omega0 + 1.0 / omega1) * n_layers)
    psi0 = cpx.from_complex(linalg.uniform_superposition(n_qubits),
                            dtype=dtype, device=dev)
    return TfimProblem(n_qubits=n_qubits, J=J, h=h, ham=ham, envelope=env,
                       measurement=meas, psi0=psi0, T=T,
                       exact_ground=exact_ground_energy(n_qubits, J, h))
