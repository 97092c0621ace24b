"""Matrix exponentials on the real-pair (CP) representation — the port of
:mod:`diffquantum_tpu.ops.expm`. Plain tensor code (``torch.matmul``):

- :func:`cexpm_taylor`: scaling-and-squaring with a truncated Taylor
  series, solve-free, with the squaring count and order fixed from a
  norm bound (:func:`taylor_params`);
- :func:`cexpm_pade13`: Padé(13) scaling-and-squaring, the solve on the
  real 2d x 2d embedding (``torch.linalg.solve``);
- :func:`cexpm_apply_taylor`: ``exp(z H) psi`` without forming the
  exponential, ``2^s`` substeps of ``order`` Taylor terms
  (:func:`taylor_recurrence`). The recurrence is K7's function
  (:mod:`.taylor_apply`), and the dense 'apply' backend's route for what
  K7 does not take (:func:`.taylor_apply.apply_route`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import cpx
from .cpx import CP

_FACTORIALS = [math.factorial(k) for k in range(35)]


def taylor_params(norm_bound: float, tol: float = 1e-7,
                  max_order: int = 24) -> tuple[int, int]:
    """Static (order, n_squarings) so the truncated-Taylor error of
    ``exp(A)`` with ``||A|| <= norm_bound`` stays below ``tol``: the
    smallest squaring count s with scaled norm theta <= 1, then the
    smallest order m with theta^(m+1)/(m+1)! <= tol."""
    norm_bound = float(max(norm_bound, 1e-30))
    s = max(0, int(math.ceil(math.log2(norm_bound))))
    theta = norm_bound / (2.0**s)
    for m in range(4, max_order + 1):
        if theta ** (m + 1) / _FACTORIALS[m + 1] <= tol:
            return m, s
    return max_order, s


def cexpm_taylor(a: CP, norm_bound: float, tol: float = 1e-7) -> CP:
    """Batched ``exp(a)`` for a: CP [..., d, d] whose every matrix has
    spectral norm at most ``norm_bound``; Horner form
    I + a(I + a/2(I + a/3(...))), then s squarings."""
    order, s = taylor_params(norm_bound, tol)
    a = cpx.rscale(a, 1.0 / (2.0**s))
    d = a.shape[-1]
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    acc = CP(eye + a.re / order, a.im / order)
    for k in range(order - 1, 0, -1):
        prod = cpx.matmul(a, acc)
        acc = CP(eye + prod.re / k, prod.im / k)
    for _ in range(s):
        acc = cpx.matmul(acc, acc)
    return acc


# Padé(13) coefficients (Higham 2005).
_PADE13_B = np.array([
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
    1187353796428800.0, 129060195264000.0, 10559470521600.0,
    670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
    960960.0, 16380.0, 182.0, 1.0,
])
_PADE13_THETA = 5.371920351148152


def _real_embed(a: CP) -> torch.Tensor:
    """[[re, -im], [im, re]], the regular representation."""
    return torch.cat([torch.cat([a.re, -a.im], dim=-1),
                      torch.cat([a.im, a.re], dim=-1)], dim=-2)


def cexpm_pade13(a: CP, norm_bound: float) -> CP:
    """Padé(13) scaling-and-squaring with a static scaling count and the
    solve on the real embedding."""
    s = max(0, int(math.ceil(math.log2(max(norm_bound, 1e-30)
                                       / _PADE13_THETA))))
    a = cpx.rscale(a, 1.0 / (2.0**s))
    d = a.shape[-1]
    b = _PADE13_B
    eye = torch.eye(d, dtype=a.dtype, device=a.device).expand(a.re.shape)
    ident = CP(eye, torch.zeros_like(eye))
    a2 = cpx.matmul(a, a)
    a4 = cpx.matmul(a2, a2)
    a6 = cpx.matmul(a2, a4)

    def lin(c6, c4, c2, c0):
        return CP(c6 * a6.re + c4 * a4.re + c2 * a2.re + c0 * ident.re,
                  c6 * a6.im + c4 * a4.im + c2 * a2.im + c0 * ident.im)

    inner = CP(b[13] * a6.re + b[11] * a4.re + b[9] * a2.re,
               b[13] * a6.im + b[11] * a4.im + b[9] * a2.im)
    u = cpx.matmul(a, cpx.add(cpx.matmul(a6, inner),
                              lin(b[7], b[5], b[3], b[1])))
    v = cpx.add(cpx.matmul(a6, CP(b[12] * a6.re + b[10] * a4.re
                                  + b[8] * a2.re,
                                  b[12] * a6.im + b[10] * a4.im
                                  + b[8] * a2.im)),
                lin(b[6], b[4], b[2], b[0]))
    sol = torch.linalg.solve(_real_embed(cpx.sub(v, u)),
                             _real_embed(cpx.add(v, u)))
    r = CP(sol[..., :d, :d], sol[..., d:, :d])
    for _ in range(s):
        r = cpx.matmul(r, r)
    return r


def taylor_recurrence(h: CP, psi: CP, w_re, w_im, order: int,
                      substeps: int) -> CP:
    """``substeps`` substeps of ``order`` Taylor terms of ``exp(w h)``
    applied to psi [..., d], w = (w_re, w_im) the substep's exponent:
    per substep t_k = (w/k) h t_{k-1}, summed. Plain products that
    autograd differentiates."""
    out = psi
    for _ in range(substeps):
        term = acc = out
        for k in range(1, order + 1):
            term = cpx.cscale(cpx.matvec(h, term), w_re / k, w_im / k)
            acc = cpx.add(acc, term)
        out = acc
    return out


def cexpm_apply_taylor(h: CP, psi: CP, z_re, z_im, norm_bound: float,
                       tol: float = 1e-7, max_order: int = 24) -> CP:
    """``exp((z_re + i z_im) h) psi`` by truncated-Taylor products.

    h: CP [d, d]; psi: CP [..., d]; z_re, z_im: numbers or 0-dim tensors
    with ``|z| ||h|| <= norm_bound``, which fixes the substeps and order
    (:func:`taylor_params`). Per substep, ``order`` products
    (:func:`taylor_recurrence`)."""
    order, s = taylor_params(norm_bound, tol, max_order)
    r = 2**s
    return taylor_recurrence(h, psi, z_re / r, z_im / r, order, r)
