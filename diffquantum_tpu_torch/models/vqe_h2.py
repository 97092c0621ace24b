"""VQE for the H2 ground state with analog pulses — the port of
:mod:`diffquantum_tpu.models.vqe_h2`.

The molecular Hamiltonian is the 2-qubit reduced H2 operator (STO-3G,
R = 0.7414 Å, after symmetry reduction; O'Malley et al., PRX 6 031007
(2016)): ``H = g0 I + g1 Z0 + g2 Z1 + g3 Z0 Z1 + g4 Y0 Y1 + g5 X0 X1``.
Controls: X on each qubit, XX/YY/ZZ entanglers and Z on each qubit; the
state starts from the Hartree-Fock reference |10>. Train it with
``train_energy`` (any gradient mode); the measurement is dense, with the
Pauli term table for sampled measurement.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dynamics.hamiltonian import ControlledHamiltonian
from ..measure import Measurement
from ..ops import cpx, linalg
from ..ops.cpx import CP
from ..pulses.envelope import SimpleEnvelope
from ..utils.device import resolve_device

# g coefficients (Hartree) for R = 0.7414 Å (O'Malley et al. 2016, Table I)
H2_COEFFS = {
    "II": -0.4804,
    "ZI": +0.3435,
    "IZ": -0.4347,
    "ZZ": +0.5716,
    "YY": +0.0910,
    "XX": +0.0910,
}


def h2_hamiltonian() -> tuple[np.ndarray, list[tuple[np.ndarray, float]]]:
    """(dense 4x4 molecular Hamiltonian, weighted Pauli term list)."""
    terms = [(linalg.pauli_string(p), g) for p, g in H2_COEFFS.items()]
    return sum(g * p for p, g in terms), terms


@dataclasses.dataclass
class VQEProblem:
    ham: ControlledHamiltonian
    envelope: SimpleEnvelope
    measurement: Measurement
    psi0: CP
    T: float
    exact_ground_energy: float


def build_h2(n_basis: int = 6, basis: str = "bspline", T: float = 2.0,
             omega: float = np.pi, dtype=torch.float32,
             sampling: bool = False, noisy: bool = False,
             device="cuda") -> VQEProblem:
    dev = resolve_device(device)
    m, terms = h2_hamiltonian()
    exact = float(np.linalg.eigvalsh(m)[0])
    hs = [linalg.pauli_string(p)
          for p in ("XI", "IX", "XX", "YY", "ZZ", "ZI", "IZ")]
    ham = ControlledHamiltonian.create(np.zeros((4, 4)), hs, dtype=dtype,
                                       device=dev)
    env = SimpleEnvelope(basis=basis, n_basis=n_basis,
                         omegas=(omega,) * len(hs))
    meas = Measurement.create(m, terms=terms, dtype=dtype, device=dev,
                              sampling=sampling, noisy=noisy)
    psi0 = cpx.from_complex(linalg.basis_state(2, 4), dtype=dtype,
                            device=dev)
    return VQEProblem(ham=ham, envelope=env, measurement=meas, psi0=psi0,
                      T=float(T), exact_ground_energy=exact)
