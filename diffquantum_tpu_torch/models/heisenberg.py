"""Pulse-level VQE for the XXZ Heisenberg chain — the port of
:mod:`diffquantum_tpu.models.heisenberg`, the second non-diagonal model
family on the Pauli-string measurement:

    H_c = J sum_i ( X_i X_{i+1} + Y_i Y_{i+1} + Delta Z_i Z_{i+1} )

The open chain's ground energy comes from dense diagonalization for
small n (the tests' oracle); ``build_heisenberg`` works at any size
matrix-free.

Controls: the X and Y quadrature pair per site (a same-qubit
non-commuting pair, which the engines run in palindromic order) and a
ZZ drive per bond, structure-tagged for the fused engines.
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


@dataclasses.dataclass
class HeisenbergProblem:
    n_qubits: int
    J: float
    delta: float
    ham: ControlledHamiltonian
    envelope: SimpleEnvelope
    measurement: Measurement
    psi0: CP
    T: float


def cost_terms(n: int, J: float, delta: float) -> list[tuple[str, float]]:
    """(label, weight) Pauli strings of the XXZ chain cost."""
    def lbl(kind, i, j):
        return "".join(kind if q in (i, j) else "I" for q in range(n))
    out = []
    for i in range(n - 1):
        out.append((lbl("X", i, i + 1), J))
        out.append((lbl("Y", i, i + 1), J))
        out.append((lbl("Z", i, i + 1), J * delta))
    return out


def exact_ground_energy(n: int, J: float = 1.0, delta: float = 1.0) -> float:
    """Dense-diagonalization oracle (n <= ~12)."""
    m = sum(w * linalg.pauli_string(lbl) for lbl, w in
            cost_terms(n, J, delta))
    return float(np.linalg.eigvalsh(m)[0])


def build_heisenberg(n_qubits: int, J: float = 1.0, delta: float = 1.0,
                     n_basis: int = 6, basis: str = "bspline",
                     omega0: float = np.pi, omega1: float = np.pi,
                     n_layers: int = 2, dtype=torch.float32,
                     sampling: bool = False, noisy: bool = False,
                     dense: bool | None = None,
                     device="cuda") -> HeisenbergProblem:
    """The XXZ problem on ``device``; ``dense`` as in ``build_tfim``."""
    dev = resolve_device(device)
    d = 2**n_qubits
    if dense is None:
        dense = n_qubits <= 8
    bonds = [(i, i + 1) for i in range(n_qubits - 1)]

    meas = Measurement.create_strings(cost_terms(n_qubits, J, delta),
                                      dtype=dtype, device=dev,
                                      sampling=sampling, noisy=noisy)

    omegas, structure = [], []
    for (i, j) in bonds:
        omegas.append(omega0)
        structure.append(TermStructure(
            kind="diag", diag=linalg.zz_diagonal(n_qubits, i, j)))
    for q in range(n_qubits):
        for local in (linalg.X, linalg.Y):
            omegas.append(omega1)
            structure.append(TermStructure(kind="1q", qubit=q, local=local))
    env = SimpleEnvelope(basis=basis, n_basis=n_basis, omegas=tuple(omegas))

    h0_tag = TermStructure(kind="diag", diag=np.zeros(d))
    if dense:
        Hs = [np.diag(linalg.zz_diagonal(n_qubits, i, j)) for (i, j) in bonds]
        for q in range(n_qubits):
            for local in (linalg.X, linalg.Y):
                Hs.append(linalg.op_on_qubits(local, [q], n_qubits))
        ham = ControlledHamiltonian.create(
            np.zeros((d, d)), Hs, dtype=dtype, structure=structure,
            h0_structure=h0_tag, device=dev)
    else:
        ham = ControlledHamiltonian.create_structured(
            d, structure, h0_structure=h0_tag, dtype=dtype)

    # Neel state |0101...>: the symmetry sector of the AFM chain
    neel = sum(1 << (n_qubits - 1 - q) for q in range(1, n_qubits, 2))
    psi0 = cpx.from_complex(linalg.basis_state(neel, d), dtype=dtype,
                            device=dev)
    T = float(np.pi * (1.0 / omega0 + 1.0 / omega1) * n_layers)
    return HeisenbergProblem(n_qubits=n_qubits, J=J, delta=delta, ham=ham,
                             envelope=env, measurement=meas, psi0=psi0, T=T)
