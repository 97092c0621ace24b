"""Complex tensors as real pairs — the port of :mod:`diffquantum_tpu.ops.cpx`.

The JAX package keeps every complex quantity as a (re, im) pair of real
arrays because the TPU and Pallas are real-valued. The port keeps the same
representation: the CUDA kernels take f32 re/im planes, and the public
functions keep the JAX package's layouts so the tests compare like with
like. Only what the slice's path uses is here.
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
