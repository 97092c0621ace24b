"""Complex tensors as real pairs — the port of :mod:`diffquantum_tpu.ops.cpx`.

The JAX package keeps every complex quantity as a (re, im) pair of real
arrays because the TPU and Pallas are real-valued. The port keeps the same
representation: the CUDA kernels take f32 re/im planes, and the public
functions keep the JAX package's layouts so the tests compare like with
like.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CP(NamedTuple):
    """A complex tensor as (real, imag) tensors of one shape and dtype."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def dtype(self):
        return self.re.dtype

    @property
    def device(self):
        return self.re.device

    def astype(self, dtype) -> "CP":
        return CP(self.re.to(dtype), self.im.to(dtype))

    def reshape(self, *shape) -> "CP":
        return CP(self.re.reshape(*shape), self.im.reshape(*shape))

    def __getitem__(self, idx) -> "CP":
        """Index both planes alike (unpacking ``re, im = a`` still
        iterates the fields)."""
        return CP(self.re[idx], self.im[idx])


def from_complex(a, dtype=torch.float32, device="cuda") -> CP:
    """Host numpy complex → CP on ``device``."""
    a = np.asarray(a)
    return CP(torch.as_tensor(np.ascontiguousarray(a.real), dtype=dtype,
                              device=device),
              torch.as_tensor(np.ascontiguousarray(a.imag), dtype=dtype,
                              device=device))


def to_complex(a: CP) -> np.ndarray:
    """CP → numpy complex128 on the host."""
    re = a.re.detach().cpu().numpy().astype(np.float64)
    im = a.im.detach().cpu().numpy().astype(np.float64)
    return re + 1j * im


def mul(a: CP, b: CP) -> CP:
    """Elementwise complex product."""
    return CP(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def abs2(a: CP) -> torch.Tensor:
    return a.re * a.re + a.im * a.im


# ---------------------------------------------------------------------------
# the dense slice's algebra (ops on [..., d] kets and [..., d, d] matrices)
# ---------------------------------------------------------------------------

def zeros(shape, dtype=torch.float32, device="cpu") -> CP:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return CP(z, torch.zeros_like(z))


def eye(d: int, dtype=torch.float32, device="cpu") -> CP:
    return CP(torch.eye(d, dtype=dtype, device=device),
              torch.zeros((d, d), dtype=dtype, device=device))


def add(a: CP, b: CP) -> CP:
    return CP(a.re + b.re, a.im + b.im)


def sub(a: CP, b: CP) -> CP:
    return CP(a.re - b.re, a.im - b.im)


def neg(a: CP) -> CP:
    return CP(-a.re, -a.im)


def conj(a: CP) -> CP:
    return CP(a.re, -a.im)


def rscale(a: CP, s) -> CP:
    """Scale by a real scalar or tensor (broadcasting)."""
    return CP(a.re * s, a.im * s)


def cscale(a: CP, s_re, s_im) -> CP:
    """Scale by a complex scalar given as (re, im) reals (numbers or
    tensors)."""
    return CP(a.re * s_re - a.im * s_im, a.re * s_im + a.im * s_re)


def muli(a: CP) -> CP:
    """Multiply by +i."""
    return CP(-a.im, a.re)


def mulmi(a: CP) -> CP:
    """Multiply by -i."""
    return CP(a.im, -a.re)


def dag(m: CP) -> CP:
    """Conjugate transpose of a matrix stack."""
    return CP(m.re.transpose(-1, -2), -m.im.transpose(-1, -2))


def matmul(a: CP, b: CP) -> CP:
    """Complex matrix product, four real products (``torch.matmul``; on
    the card IEEE fp32 unless the caller enables TF32). The JAX package's
    3-product Gauss form saved MXU passes; here it would only cost
    accuracy."""
    return CP(torch.matmul(a.re, b.re) - torch.matmul(a.im, b.im),
              torch.matmul(a.re, b.im) + torch.matmul(a.im, b.re))


def matvec(m: CP, psi: CP) -> CP:
    """Apply matrices [..., d, d] to row-stacked kets [..., d]: each ket
    psi_b becomes M psi_b (``psi @ M^T``)."""
    mt = CP(m.re.transpose(-1, -2), m.im.transpose(-1, -2))
    return matmul(psi, mt)


def vdot(a: CP, b: CP) -> CP:
    """<a|b> = sum conj(a) b over the last axis."""
    return CP(torch.sum(a.re * b.re + a.im * b.im, dim=-1),
              torch.sum(a.re * b.im - a.im * b.re, dim=-1))


def norm2(a: CP) -> torch.Tensor:
    """||a||^2 along the last axis."""
    return torch.sum(abs2(a), dim=-1)


def tensordot_weights(w: torch.Tensor, m: CP) -> CP:
    """sum_k w[..., k] m[k] for real weights w [..., k] and a matrix stack
    m [k, d, d]: one product of [..., k] by [k, d*d] per plane."""
    k, d1, d2 = m.re.shape
    out = (w.shape[:-1]) + (d1, d2)
    return CP(torch.matmul(w, m.re.reshape(k, d1 * d2)).reshape(out),
              torch.matmul(w, m.im.reshape(k, d1 * d2)).reshape(out))
