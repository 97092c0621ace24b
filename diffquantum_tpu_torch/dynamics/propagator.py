"""Time-ordered propagator psi(T) = Prod_k exp(-i dt H(t_k)) psi(T0) — the
port of :mod:`diffquantum_tpu.dynamics.propagator`.

Envelopes are sampled at the left endpoint ``t_k = T0 + k dt`` (or the
midpoint), ``n_steps = int(per_step * (|T - T0| + 1))``. Structured
Hamiltonians run the product-formula engines (:mod:`.product`). Dense
ones run one of two backends, each a piecewise-constant exponential per
step:

- 'expm': the step's exponential exp(-i dt H_t) by Taylor
  scaling-and-squaring (:func:`..ops.expm.cexpm_taylor`), then one
  matrix-vector product, plain ``torch.matmul``. The exponentials of all
  steps are formed in one batched call (H_t does not depend on the
  state), then applied in order;
- 'apply': exp(-i dt H_t) psi without forming the exponential, one
  call per step on the route :func:`..ops.taylor_apply.apply_route`
  names: K7 for float32 on the card with d <= 1024, the truncated-Taylor
  recurrence in plain products otherwise (float64, larger d, the CPU),
  as the JAX package's 'apply' runs at every size and dtype.

H_t for the whole grid is one product of the amplitude table with the
[n_controls, d*d] stack (:meth:`.hamiltonian.ControlledHamiltonian.at`),
so Hs is read once per evolution, and autograd carries the coefficient
gradient back through it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import cpx
from ..ops.cpx import CP
from ..ops.expm import cexpm_taylor, taylor_params
from ..ops.taylor_apply import (apply_route, substep_z,
                                taylor_apply_recurrence, taylor_apply_zs)
from .hamiltonian import ControlledHamiltonian

# The dense 'auto' rule of the JAX package: 'apply' at d >= 512 or for a
# batch of states, else 'expm'.
APPLY_MIN_DIM = 512


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


def _amplitude_bound(envelope) -> tuple[float, ...]:
    """Static per-control max |u_k|: a SimpleEnvelope is bounded by its
    omegas, the channel model by the sum of |omega_c| over a control's
    channels."""
    if hasattr(envelope, "omegas"):
        return tuple(abs(w) for w in envelope.omegas)
    bounds = [0.0] * envelope.n_controls
    for c in envelope.channels:
        bounds[c.control] += abs(c.omega)
    return tuple(bounds)


def dense_backend(ham: ControlledHamiltonian, batched: bool,
                  backend: str = "auto") -> str:
    """The dense backend 'auto' picks: 'apply' for d >= 512 or a batch of
    states, else 'expm' (the JAX package's rule)."""
    if backend != "auto":
        return backend
    return "apply" if (ham.dim >= APPLY_MIN_DIM or batched) else "expm"


def _dense_steps(H: CP, psi: CP, dt, a_bound: float, tol: float,
                 backend: str, trajectory: bool = False):
    """Run the chain for G groups: H CP [G, T, d, d], psi CP [G, m, d],
    dt a 0-dim tensor or one per group [G] (in the states' dtype).
    Returns psi(T) [G, m, d], or with ``trajectory`` the states after
    every step, [T, G, m, d]."""
    # Steps are taken from the [G, T, ...] stacks with unbind: its
    # backward stacks the steps' gradients once, where indexing would
    # materialize a zero-filled gradient of the whole stack per step.
    n_groups, n_steps, d = H.re.shape[:3]
    seen = []
    if backend == "expm":
        col = dt.reshape(-1, 1, 1, 1) if dt.ndim else dt
        e = cexpm_taylor(cpx.mulmi(cpx.rscale(H, col)), a_bound, tol)
        e_steps = list(zip(e.re.unbind(1), e.im.unbind(1)))
        for t in range(n_steps):
            psi = cpx.matvec(CP(*e_steps[t]), psi)
            if trajectory:
                seen.append(psi)
    elif backend == "apply":
        order, s = taylor_params(a_bound, tol)
        # exp(z H) psi with z = -i dt, per group
        zs = [substep_z(0.0, -(dt[g] if dt.ndim else dt), 2**s, psi.re)
              for g in range(n_groups)]
        step = taylor_apply_zs if apply_route(
            psi.re.device, psi.re.dtype, d) == "k7" \
            else taylor_apply_recurrence
        h_steps = list(zip(H.re.reshape(-1, d, d).unbind(0),
                           H.im.reshape(-1, d, d).unbind(0)))
        ps = [CP(*p) for p in zip(psi.re.unbind(0), psi.im.unbind(0))]
        for t in range(n_steps):
            ps = [step(CP(*h_steps[g * n_steps + t]), ps[g], zs[g],
                       order, 2**s)
                  for g in range(n_groups)]
            if trajectory:
                seen.append(CP(torch.stack([p.re for p in ps]),
                               torch.stack([p.im for p in ps])))
        psi = CP(torch.stack([p.re for p in ps]),
                 torch.stack([p.im for p in ps]))
    else:
        raise ValueError(f"unknown backend {backend!r}")
    if trajectory:
        return CP(torch.stack([p.re for p in seen]),
                  torch.stack([p.im for p in seen]))
    return psi


def _evolve_dense(ham: ControlledHamiltonian, envelope, coeff, psi0: CP,
                  T0, T, horizon: float, n_steps: int, backend: str,
                  tol: float, dt_bound: Optional[float],
                  t_sample: str) -> CP:
    """The dense backends. Per-member coefficients [G, n_c, n_b] or time
    grids ([G] tensors) evolve a batch [B, d] as G groups of B/G members
    each (the product engine's contract); a group of one state counts as
    unbatched for 'auto', as a vmapped member does in the JAX package."""
    from .product import _amplitudes
    dt, u = _amplitudes(envelope, coeff, T0, T, horizon, n_steps, t_sample)
    if dt_bound is None:
        dt_bound = float(horizon) / n_steps
    a_bound = dt_bound * ham.norm_bound(_amplitude_bound(envelope))
    d, rdt = ham.dim, ham.dtype
    psi = psi0.astype(rdt)
    if u.ndim == 3:  # per-member pulses: groups of consecutive members
        if psi.ndim != 2:
            raise ValueError("per-member coefficients or times need a "
                             "batch of states [B, d]")
        n_groups, b = u.shape[0], psi.shape[0]
        if b % n_groups:
            raise ValueError(f"{n_groups} coefficient sets or time grids "
                             f"do not divide a batch of {b} states")
        batched = b // n_groups > 1
    else:
        n_groups, batched = 1, psi.ndim > 1
        u = u[None]
    backend = dense_backend(ham, batched, backend)
    dt_c = torch.as_tensor(dt, dtype=rdt, device=psi.device)
    H = ham.at(u.transpose(-1, -2))                       # [G, T, d, d]
    out = _dense_steps(H, psi.reshape(n_groups, -1, d), dt_c, a_bound, tol,
                       backend)
    return out.reshape(*psi0.shape)


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

    backend: 'auto' | 'product' | 'product_fused' | 'expm' | 'apply'.
    'auto' on a structure-only Hamiltonian takes the fused engine
    (:func:`..product.select_engine`: K1 or K2 at 10-17 qubits, K3 at 18,
    K5 at 19-24, K6 for hop drive sets at 19-24) for a float32 CUDA state
    that :func:`..product.fused_eligible` accepts, else the eager
    'product' engine (always, on the CPU). On a dense Hamiltonian, with
    or without structure tags, 'auto' takes 'apply' for d >= 512 or a
    batch of states, else 'expm' (:func:`dense_backend`). 'apply' on the
    card is K7 for float32 and d <= 1024, and the plain recurrence for
    other dtypes and sizes (:func:`..ops.taylor_apply.apply_route`,
    chosen before any launch); nothing falls back. The engine names
    'packed', 'mega' and 'mega_hop' are no backends, as in the JAX
    package. ``T0``/``T`` may be tensors
    on the state's device, 0-dim or one per member (see
    :mod:`..product`), so a split time drawn on the card is never copied
    to the host. ``tol`` (Taylor truncation) and ``dt_bound`` (a static
    bound on |dt|, default horizon / n_steps) belong to the dense
    backends; ``precision`` to the fused engine.
    """
    from .product import evolve_product, evolve_product_fused, fused_eligible
    if backend == "auto" and ham.is_structured_only:
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
    if backend not in ("auto", "expm", "apply"):
        raise ValueError(f"unknown backend {backend!r}")
    if ham.is_structured_only:
        raise ValueError(
            f"backend {backend!r} needs dense operators, but this "
            "ControlledHamiltonian is structure-only (create_structured); "
            "use backend='product'/'product_fused' or build with dense=True")
    return _evolve_dense(ham, envelope, coeff, psi0, T0, T, horizon,
                         n_steps, backend, tol, dt_bound, t_sample)


def evolve_trajectory(ham: ControlledHamiltonian, envelope,
                      coeff: torch.Tensor, psi0: CP, T0, T, horizon: float,
                      n_steps: int, backend: str = "auto",
                      tol: float = 1e-7) -> CP:
    """Like :func:`evolve` (dense, left-endpoint grid) but returns the
    state at every grid point, CP [n_steps + 1, ..., d] including
    psi(T0)."""
    if ham.is_structured_only:
        raise ValueError("evolve_trajectory needs dense operators; use "
                         "evolve per segment for a structured H")
    from .product import _amplitudes
    dt, u = _amplitudes(envelope, coeff, T0, T, horizon, n_steps, "left")
    a_bound = float(horizon) / n_steps \
        * ham.norm_bound(_amplitude_bound(envelope))
    psi = psi0.astype(ham.dtype)
    backend = dense_backend(ham, psi.ndim > 1, backend)
    dt_c = torch.as_tensor(dt, dtype=ham.dtype, device=psi.device)
    h = ham.at(u.transpose(-1, -2))                       # [T, d, d]
    traj = _dense_steps(CP(h.re[None], h.im[None]),
                        psi.reshape(1, -1, ham.dim), dt_c, a_bound, tol,
                        backend, trajectory=True)
    shape = (n_steps,) + tuple(psi0.shape)
    return CP(torch.cat([psi.re[None], traj.re.reshape(shape)]),
              torch.cat([psi.im[None], traj.im.reshape(shape)]))


def step_doubling_error(ham, envelope, coeff, psi0: CP, T: float,
                        n_steps: int, backend: str = "auto",
                        t_sample: str = "left", **kw) -> float:
    """A-posteriori error estimate of the grid, ``||psi(n_steps) -
    psi(2 n_steps)||`` (max over a batch): within 2x of the true error
    for a method of global order p >= 1, with no oracle."""
    a = evolve(ham, envelope, coeff, psi0, 0.0, T, horizon=float(T),
               n_steps=n_steps, backend=backend, t_sample=t_sample, **kw)
    b = evolve(ham, envelope, coeff, psi0, 0.0, T, horizon=float(T),
               n_steps=2 * n_steps, backend=backend, t_sample=t_sample, **kw)
    d2 = cpx.norm2(cpx.sub(a, b)).detach().cpu().numpy()
    return float(np.sqrt(np.max(d2)))


def calibrate_n_steps(ham, envelope, coeff, psi0: CP, T: float,
                      tol: float = 1e-4, n_start: int = 10,
                      n_max: int = 100_000, backend: str = "auto",
                      t_sample: str = "left", **kw) -> int:
    """Smallest power-of-two refinement of ``n_start`` whose step-doubling
    error estimate is below ``tol``."""
    n = n_start
    while n <= n_max:
        if step_doubling_error(ham, envelope, coeff, psi0, T, n,
                               backend=backend, t_sample=t_sample,
                               **kw) < tol:
            return n
        n *= 2
    raise ValueError(f"tol={tol} not reached by n_steps={n_max}; "
                     "consider t_sample='mid' (second order) or a looser "
                     "tolerance")


def trotter(ham: ControlledHamiltonian, envelope, coeff, psi0: CP, T0: float,
            T: float, horizon: Optional[float] = None, per_step: int = 10,
            **kw) -> CP:
    """Reference-signature wrapper: ``n_steps`` from
    :func:`reference_n_steps`; ``horizon`` defaults to T."""
    n_steps = reference_n_steps(per_step, T0, T)
    return evolve(ham, envelope, coeff, psi0, T0, T,
                  horizon=float(T if horizon is None else horizon),
                  n_steps=n_steps, **kw)
