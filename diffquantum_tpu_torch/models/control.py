"""Quantum optimal-control problems: state transfer and gate synthesis —
the port of :mod:`diffquantum_tpu.models.control`.

- :func:`state_transfer`: drive |source> to |target> under X/Y controls
  with a Z drift (one qubit) or X/Y/ZZ controls (two qubits);
- :func:`bell_state_preparation`: |00> to (|00> + |11>)/sqrt(2);
- :func:`gate_synthesis_pairs`: a target unitary G as the basis-state
  transfer pairs |i> -> G|i> (the batch-of-pairs interface of
  ``train_fidelity``); :func:`hadamard_synthesis` for G = H.

The Hamiltonians are dense (d = 2 or 4) on ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dynamics.hamiltonian import ControlledHamiltonian
from ..ops import cpx, linalg
from ..ops.cpx import CP
from ..pulses.envelope import SimpleEnvelope
from ..utils.device import resolve_device


@dataclasses.dataclass
class ControlProblem:
    ham: ControlledHamiltonian
    envelope: SimpleEnvelope
    initial_states: CP   # [n_pairs, d]
    target_states: CP    # [n_pairs, d]
    T: float


def single_qubit_controls(detuning: float = 0.5, omega: float = np.pi,
                          dtype=torch.float32, device="cuda"):
    """H0 = detuning * Z / 2, controls {X, Y}; returns (ham, omegas)."""
    ham = ControlledHamiltonian.create(0.5 * detuning * linalg.Z,
                                       [linalg.X, linalg.Y], dtype=dtype,
                                       device=device)
    return ham, (omega, omega)


def two_qubit_controls(coupling: float = 0.0, omega: float = np.pi,
                       dtype=torch.float32, device="cuda"):
    """Controls {X0, X1, Y0, Y1, ZZ}, an optional fixed ZZ drift; returns
    (ham, omegas)."""
    hs = [linalg.pauli_string(p) for p in ("XI", "IX", "YI", "IY", "ZZ")]
    ham = ControlledHamiltonian.create(coupling * linalg.pauli_string("ZZ"),
                                       hs, dtype=dtype, device=device)
    return ham, (omega,) * len(hs)


def _states(vectors, dtype, device) -> CP:
    return cpx.from_complex(np.stack(vectors), dtype=dtype,
                            device=resolve_device(device))


def state_transfer(n_qubits: int = 1, T: float = 2.0, n_basis: int = 6,
                   basis: str = "bspline", dtype=torch.float32,
                   source: int = 0, target: int = None,
                   device="cuda") -> ControlProblem:
    """|source> -> |target> (default |0...0> -> |1...1>)."""
    d = 2**n_qubits
    if target is None:
        target = d - 1
    if n_qubits == 1:
        ham, omegas = single_qubit_controls(dtype=dtype, device=device)
    elif n_qubits == 2:
        ham, omegas = two_qubit_controls(dtype=dtype, device=device)
    else:
        raise ValueError("state_transfer supports 1 or 2 qubits; build "
                         "custom ControlProblem for larger systems")
    env = SimpleEnvelope(basis=basis, n_basis=n_basis, omegas=omegas)
    return ControlProblem(
        ham=ham, envelope=env,
        initial_states=_states([linalg.basis_state(source, d)], dtype,
                               device),
        target_states=_states([linalg.basis_state(target, d)], dtype,
                              device), T=float(T))


def bell_state_preparation(T: float = 2.0, n_basis: int = 6,
                           basis: str = "bspline", dtype=torch.float32,
                           device="cuda") -> ControlProblem:
    """|00> -> (|00> + |11>)/sqrt(2)."""
    ham, omegas = two_qubit_controls(dtype=dtype, device=device)
    env = SimpleEnvelope(basis=basis, n_basis=n_basis, omegas=omegas)
    bell = (linalg.basis_state(0, 4) + linalg.basis_state(3, 4)) / np.sqrt(2)
    return ControlProblem(
        ham=ham, envelope=env,
        initial_states=_states([linalg.basis_state(0, 4)], dtype, device),
        target_states=_states([bell], dtype, device), T=float(T))


def gate_synthesis_pairs(gate: np.ndarray, ham: ControlledHamiltonian,
                         envelope: SimpleEnvelope, T: float,
                         dtype=torch.float32,
                         device="cuda") -> ControlProblem:
    """Target-unitary synthesis as basis-state transfer pairs
    (|i> -> G|i> for every computational basis state i)."""
    d = gate.shape[0]
    eye = np.eye(d, dtype=np.complex128)
    dev = resolve_device(device)
    return ControlProblem(
        ham=ham, envelope=envelope,
        initial_states=cpx.from_complex(eye, dtype=dtype, device=dev),
        target_states=cpx.from_complex((np.asarray(gate) @ eye).T,
                                       dtype=dtype, device=dev), T=float(T))


def hadamard_synthesis(T: float = 2.0, n_basis: int = 6,
                       basis: str = "bspline", dtype=torch.float32,
                       device="cuda") -> ControlProblem:
    ham, omegas = single_qubit_controls(detuning=0.0, dtype=dtype,
                                        device=device)
    env = SimpleEnvelope(basis=basis, n_basis=n_basis, omegas=omegas)
    h = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    return gate_synthesis_pairs(h, ham, env, T, dtype=dtype, device=device)
