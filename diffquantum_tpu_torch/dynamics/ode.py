"""Adaptive-ODE forward engine, the reference's ``qp.mesolve`` semantics —
the port of :mod:`diffquantum_tpu.dynamics.ode`.

The trotter engines sample the envelope piecewise-constant on a grid;
this engine integrates the exact Schrodinger equation under the
continuous envelope with scipy ``solve_ivp`` (DOP853, complex128), u(t)
evaluated pointwise in float64. It is the accuracy oracle: FD gradients
with forward runs only (where the reference used mesolve), trotter-error
audits and parity studies.

It runs on the host by design, as the JAX package's does: adaptive step
control is data-dependent and serial. Inputs on the card are copied to
the host once, and the result is copied back; the card's engines
(:mod:`.propagator`) stay the production path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import cpx
from ..ops.cpx import CP


def evolve_ode(ham, envelope, coeff, psi0: CP, T0: float, T: float,
               horizon: float, rtol: float = 1e-10, atol: float = 1e-10,
               method: str = "DOP853") -> CP:
    """psi(T) under the continuous envelope, adaptive integration.

    ham must carry dense operators (small d); psi0 may have leading batch
    dims (integrated jointly: the right-hand side is block-diagonal).
    Returns CP with psi0's shape, on psi0's device in psi0's dtype."""
    from scipy.integrate import solve_ivp

    if ham.is_structured_only:
        raise ValueError("evolve_ode needs dense operators (small-d "
                         "high-accuracy engine); build with dense=True")
    H0 = cpx.to_complex(ham.H0)
    Hs = cpx.to_complex(ham.Hs)          # [n_controls, d, d]
    d = ham.dim
    c64 = torch.as_tensor(coeff).detach().to(dtype=torch.float64,
                                             device="cpu")

    def amp(t: float) -> np.ndarray:
        ts = torch.tensor([t], dtype=torch.float64)
        return envelope.amplitudes(c64, ts, float(horizon))[..., 0].numpy()

    lead = tuple(psi0.shape[:-1])
    y0 = cpx.to_complex(psi0).reshape(-1, d)

    def rhs(t, y):
        H = H0 + np.tensordot(amp(t), Hs, axes=1)
        return (-1j * (y.reshape(-1, d) @ H.T)).reshape(-1)

    with torch.no_grad():
        sol = solve_ivp(rhs, (float(T0), float(T)), y0.reshape(-1),
                        rtol=rtol, atol=atol, method=method)
    if not sol.success:
        raise RuntimeError(f"solve_ivp failed: {sol.message}")
    yT = sol.y[:, -1].reshape(lead + (d,))
    like = dict(dtype=psi0.dtype, device=psi0.device)
    return CP(torch.as_tensor(yT.real, **like),
              torch.as_tensor(yT.imag, **like))


def fd_energy_grad_ode(ham, envelope, measurement, coeff, psi0: CP,
                       T: float, delta: float = 1e-3,
                       rtol: float = 1e-10) -> np.ndarray:
    """Central-difference gradient with adaptive-ODE forward runs, the
    reference's FD recipe (`sim_plain.py:308-353`: 2 n_Hs n_basis mesolve
    runs a step), for gradient-accuracy baselines. Host-side and serial;
    :mod:`..gradients.fd` is the production FD."""
    c0 = torch.as_tensor(coeff).detach().to(dtype=torch.float64,
                                            device="cpu").numpy()
    grad = np.zeros_like(c0)

    def energy(c):
        psi = evolve_ode(ham, envelope, torch.as_tensor(c), psi0, 0.0, T,
                         horizon=T, rtol=rtol, atol=rtol)
        return float(measurement.expectation(psi))

    for idx in np.ndindex(c0.shape):
        cp_, cm_ = c0.copy(), c0.copy()
        cp_[idx] += delta
        cm_[idx] -= delta
        grad[idx] = (energy(cp_) - energy(cm_)) / (2.0 * delta)
    return grad
