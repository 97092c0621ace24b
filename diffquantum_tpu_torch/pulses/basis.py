"""Spectral function bases for pulse parameterization — the port of
:mod:`diffquantum_tpu.pulses.basis`.

The basis is evaluated on the whole time grid at once, giving
``Phi[n_t, n_basis]``, so an envelope is one matmul ``coeff @ Phi.T``.

- ``poly``     : ``phi_j(t) = (t - 0.5)**j``
- ``legendre`` : ``phi_j(t) = P_j(2 t / T - 1)`` (Bonnet recurrence)
- ``fourier``  : ``n_basis//2`` cosines ``cos(2 pi j t)``, then as many
                 sines (t is not rescaled by T); an odd trailing column is 0
- ``bspline``  : quadratic bump on ``t/T`` with ``tau = 1/(n_basis-2)``,
                 centre ``tau*(b-1.5)``, support ``±1.5 tau``, peak 1
"""
from __future__ import annotations

import math

import torch

BASIS_KINDS = ("poly", "legendre", "fourier", "bspline")


def canonical_kind(kind: str) -> str:
    k = kind.lower()
    if k not in BASIS_KINDS:
        raise ValueError(f"unknown basis kind {kind!r}; "
                         f"expected one of {BASIS_KINDS}")
    return k


def legendre_matrix(x: torch.Tensor, n_basis: int) -> torch.Tensor:
    """``P_j(x)`` for j < n_basis: x [...] → [..., n_basis]."""
    cols = [torch.ones_like(x)]
    if n_basis > 1:
        cols.append(x)
    for j in range(2, n_basis):
        cols.append(((2 * j - 1) * x * cols[-1] - (j - 1) * cols[-2]) / j)
    return torch.stack(cols[:n_basis], dim=-1)


def bspline_matrix(tn: torch.Tensor, n_basis: int) -> torch.Tensor:
    """Quadratic bump basis on normalized time ``tn = t/T``; 0 at and
    outside the open support."""
    if n_basis <= 2:
        raise ValueError("bspline basis needs n_basis >= 3")
    tn = tn[..., None]
    tau = 1.0 / (n_basis - 2.0)
    b = torch.arange(n_basis, dtype=tn.dtype, device=tn.device)
    center = tau * (b - 1.5)
    left = center - 1.5 * tau
    right = center + 1.5 * tau
    norm = -((1.5 * tau) ** 2)
    val = (tn - left) * (tn - right) / norm
    inside = (tn > left) & (tn < right)
    return torch.where(inside, val, torch.zeros_like(val))


def poly_matrix(t: torch.Tensor, n_basis: int) -> torch.Tensor:
    """``(t - 0.5)**j`` columns, by repeated products."""
    x = t - 0.5
    cols = [torch.ones_like(x)]
    for _ in range(1, n_basis):
        cols.append(cols[-1] * x)
    return torch.stack(cols, dim=-1)


def fourier_matrix(t: torch.Tensor, n_basis: int) -> torch.Tensor:
    """[cos(2 pi j t) for j < n | sin(2 pi j t) for j < n], n = n_basis//2,
    zero-padded to n_basis columns."""
    t = t[..., None]
    n = n_basis // 2
    j = torch.arange(n, dtype=t.dtype, device=t.device)
    ang = 2.0 * math.pi * j * t
    cols = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    if cols.shape[-1] < n_basis:
        pad = torch.zeros(t.shape[:-1] + (n_basis - cols.shape[-1],),
                          dtype=cols.dtype, device=cols.device)
        cols = torch.cat([cols, pad], dim=-1)
    return cols


def basis_matrix(kind: str, n_basis: int, t: torch.Tensor, T) -> torch.Tensor:
    """Evaluate the basis on times ``t`` (a tensor) with horizon ``T``.
    Returns ``Phi`` with shape ``t.shape + (n_basis,)``."""
    k = canonical_kind(kind)
    if k == "poly":
        return poly_matrix(t, n_basis)
    if k == "legendre":
        return legendre_matrix(2.0 * t / T - 1.0, n_basis)
    if k == "fourier":
        return fourier_matrix(t, n_basis)
    return bspline_matrix(t / T, n_basis)
