"""Pulse-level QAOA MaxCut problem family — the port of
:mod:`diffquantum_tpu.models.maxcut`.

- drift H0 = 0;
- one ZZ control per edge (strength omega0) and one X control per qubit
  (strength omega1);
- cost observable ``M = -1/2 sum_e (I - Z_i Z_j)`` (diagonal);
- horizon ``T = pi (1/omega0 + 1/omega1) n_layers``;
- uniform-superposition initial state.

``dense=None`` picks dense operators up to 8 qubits and the matrix-free
structured form beyond, as the JAX package does: the reference's own
4-qubit demo instance then evolves on the dense backends. The dense
problem carries the structure tags too, and its measurement is the
dense cost operator with the Pauli term table of sampled measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..dynamics.hamiltonian import ControlledHamiltonian, TermStructure
from ..measure import Measurement
from ..ops import cpx, linalg
from ..ops.cpx import CP
from ..pulses.envelope import SimpleEnvelope
from ..utils.device import resolve_device


def ring_graph(n: int) -> list[tuple[int, int]]:
    return [(i, (i + 1) % n) for i in range(n)]


def random_graph(n: int, p: float = 0.5,
                 seed: int = 0) -> list[tuple[int, int]]:
    rng = np.random.default_rng(seed)
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.uniform() < p]


@dataclasses.dataclass
class MaxCutProblem:
    n_qubits: int
    graph: list
    ham: ControlledHamiltonian
    envelope: SimpleEnvelope
    measurement: Measurement
    psi0: CP
    T: float
    cost_diag: np.ndarray        # diagonal of M (M is diagonal for maxcut)

    def cut_value(self, bitstring: int) -> float:
        """Number of cut edges for a computational-basis state."""
        cut = 0
        for (i, j) in self.graph:
            bi = (bitstring >> (self.n_qubits - 1 - i)) & 1
            bj = (bitstring >> (self.n_qubits - 1 - j)) & 1
            cut += int(bi != bj)
        return float(cut)

    @property
    def max_cut(self) -> float:
        return float(-self.cost_diag.min())

    def readout(self, final_state) -> tuple[int, float]:
        """(most-probable bitstring, its cut value)."""
        state, _ = linalg.find_state(final_state)
        return state, self.cut_value(state)


def build_maxcut(n_qubits: int, graph: Sequence[Sequence[int]],
                 n_basis: int = 6, basis: str = "bspline",
                 omega0: float = np.pi, omega1: float = np.pi,
                 n_layers: int = 1, dtype=torch.float32,
                 sampling: bool = False, noisy: bool = False,
                 dense: bool | None = None, device="cuda") -> MaxCutProblem:
    """The MaxCut problem on ``device``. ``dense=None`` auto-selects:
    dense operators up to 8 qubits, the structured form (host metadata,
    psi0 and the cost diagonal on the device) beyond. ``dense=True``
    builds the dense operators at any size (O(n_edges 4^n) memory)."""
    dev = resolve_device(device)
    graph = [tuple(e) for e in graph]
    d = 2**n_qubits
    if dense is None:
        dense = n_qubits <= 8

    cost_diag = np.zeros(d)
    for (i, j) in graph:
        cost_diag += -0.5 * (1.0 - linalg.zz_diagonal(n_qubits, i, j))

    omegas, structure = [], []
    for (i, j) in graph:
        omegas.append(omega0)
        structure.append(TermStructure(
            kind="diag", diag=linalg.zz_diagonal(n_qubits, i, j)))
    for q in range(n_qubits):
        omegas.append(omega1)
        structure.append(TermStructure(kind="1q", qubit=q, local=linalg.X))

    env = SimpleEnvelope(basis=basis, n_basis=n_basis, omegas=tuple(omegas))
    h0_structure = TermStructure(kind="diag", diag=np.zeros(d))
    if dense:
        Hs = [np.diag(linalg.zz_diagonal(n_qubits, i, j)) for (i, j) in graph]
        Hs += [linalg.op_on_qubits(linalg.X, [q], n_qubits)
               for q in range(n_qubits)]
        ham = ControlledHamiltonian.create(
            np.zeros((d, d)), Hs, dtype=dtype, structure=structure,
            h0_structure=h0_structure, device=dev)
        # Pauli term table of sampled measurement
        terms = [(np.diag(linalg.zz_diagonal(n_qubits, i, j)).astype(
            np.complex128), 0.5) for (i, j) in graph]
        terms.append((np.eye(d, dtype=np.complex128), -0.5 * len(graph)))
        meas = Measurement.create(np.diag(cost_diag).astype(np.complex128),
                                  terms=terms, dtype=dtype, device=dev,
                                  sampling=sampling, noisy=noisy)
    else:
        ham = ControlledHamiltonian.create_structured(
            d, structure, h0_structure=h0_structure, dtype=dtype)
        diag_terms = [(linalg.zz_diagonal(n_qubits, i, j), 0.5)
                      for (i, j) in graph]
        diag_terms.append((np.ones(d), -0.5 * len(graph)))
        meas = Measurement.create_diagonal(cost_diag, diag_terms=diag_terms,
                                           dtype=dtype, device=dev,
                                           sampling=sampling, noisy=noisy)
    T = float(np.pi * (1.0 / omega0 + 1.0 / omega1) * n_layers)
    psi0 = cpx.from_complex(linalg.uniform_superposition(n_qubits),
                            dtype=dtype, device=dev)
    return MaxCutProblem(n_qubits=n_qubits, graph=list(graph), ham=ham,
                         envelope=env, measurement=meas, psi0=psi0, T=T,
                         cost_diag=cost_diag)


def demo_problem(**kw) -> MaxCutProblem:
    """The reference demo instance: 4-qubit ring (`demo_maxcut.py:10-11`)."""
    kw.setdefault("n_basis", 6)
    return build_maxcut(4, [(0, 1), (0, 3), (1, 2), (2, 3)], **kw)
