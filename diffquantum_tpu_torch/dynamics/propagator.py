"""Time-ordered propagator psi(T) = Prod_k exp(-i dt H(t_k)) psi(T0) — the
port of :mod:`diffquantum_tpu.dynamics.propagator` for structured
Hamiltonians.

Envelopes are sampled at the left endpoint ``t_k = T0 + k dt`` (or the
midpoint), ``n_steps = int(per_step * (|T - T0| + 1))``. The dense
per-step exponential backends ('expm', 'apply') wait for slice 3
(ROADMAP.md, Queue 1 item 12).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.cpx import CP
from .hamiltonian import ControlledHamiltonian

_UNPORTED = {
    "expm": "the dense 'expm' backend is not ported yet "
            "(ROADMAP.md, Queue 1 item 12)",
    "apply": "the dense 'apply' backend is not ported yet "
             "(ROADMAP.md, Queue 1 item 12)",
}


def reference_n_steps(per_step: int, T0: float, T: float) -> int:
    """Step-count rule ``int(per_step * (|T - T0| + 1))``."""
    return int(per_step * (abs(T - T0) + 1))


def time_grid(T0, dt, n_steps: int, t_sample: str = "left",
              device=None) -> torch.Tensor:
    """Envelope sample times (float64): 'left' = segment starts (the
    reference semantics, O(dt) vs the true dynamics), 'mid' = segment
    midpoints (O(dt^2) at the same cost). ``T0``/``dt`` may be tensors,
    0-dim (the MC split time, drawn on the device) or one per member
    [G], giving grids [G, n_steps]."""
    if t_sample not in ("left", "mid"):
        raise ValueError(f"t_sample must be 'left' or 'mid', "
                         f"got {t_sample!r}")
    if isinstance(T0, torch.Tensor):
        T0 = T0.to(torch.float64)[..., None]
    if isinstance(dt, torch.Tensor):
        dt = dt.to(torch.float64)[..., None]
    ts = T0 + dt * torch.arange(n_steps, dtype=torch.float64, device=device)
    if t_sample == "mid":
        return ts + 0.5 * dt
    return ts


def evolve(
    ham: ControlledHamiltonian,
    envelope,
    coeff: torch.Tensor,
    psi0: CP,
    T0,
    T,
    horizon: float,
    n_steps: int,
    backend: str = "auto",
    tol: float = 1e-7,
    dt_bound: Optional[float] = None,
    precision: str = "full",
    t_sample: str = "left",
) -> CP:
    """Evolve ``psi0`` from ``T0`` to ``T`` under H(t) = H0 + sum u_k(t) H_k.

    backend: 'auto' | 'product' | 'product_fused'. 'auto' takes the fused
    engine (:func:`..product.select_engine`: K1 or K2 at 10-17 qubits, K3
    at 18, K5 at 19-24, K6 for hop drive sets at 19-24) for a float32
    CUDA state that :func:`..product.fused_eligible` accepts, else the
    eager 'product' engine (always, on the CPU). Unported backends raise
    NotImplementedError; none falls back. The engine names 'packed',
    'mega' and 'mega_hop' are no backends here, as in the JAX package.
    ``T0``/``T`` may be tensors on the state's device, 0-dim or one per
    member (see :mod:`..product`), so a split time drawn on the card is
    never copied to the host. ``tol`` and ``dt_bound`` belong to the dense
    backends and are unused.
    """
    from .product import evolve_product, evolve_product_fused, fused_eligible
    if backend in _UNPORTED:
        raise NotImplementedError(_UNPORTED[backend])
    if backend == "auto":
        backend = "product_fused" if (psi0.re.is_cuda
                                      and ham.dtype == torch.float32
                                      and fused_eligible(ham)) else "product"
    if backend == "product_fused":
        return evolve_product_fused(ham, envelope, coeff, psi0, T0, T,
                                    horizon=horizon, n_steps=n_steps,
                                    precision=precision, t_sample=t_sample)
    if backend == "product":
        return evolve_product(ham, envelope, coeff, psi0, T0, T,
                              horizon=horizon, n_steps=n_steps,
                              t_sample=t_sample)
    raise ValueError(f"unknown backend {backend!r}")
