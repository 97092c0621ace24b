"""Control-envelope model — the port of
:class:`diffquantum_tpu.pulses.envelope.SimpleEnvelope`:
``u_k(t) = (2 sigmoid(sum_j c_kj phi_j(t)) - 1) * omega_k``, a bounded
drive in ``[-omega_k, +omega_k]``, for the whole time grid at once.
``ChannelEnvelope`` (the carrier-modulated channel model) is not ported
yet (ROADMAP.md, Queue 1: ChannelEnvelope)."""
from __future__ import annotations

import dataclasses

import torch

from ..utils.device import resolve_device
from .basis import basis_matrix, canonical_kind

_EXPIT_CUTOFF = 32.0  # the sigmoid saturates to exactly 0/1 beyond ±32


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Sigmoid with hard saturation beyond |x| = 32."""
    s = torch.sigmoid(x)
    s = torch.where(x > _EXPIT_CUTOFF, torch.ones_like(s), s)
    return torch.where(x < -_EXPIT_CUTOFF, torch.zeros_like(s), s)


@dataclasses.dataclass(frozen=True)
class SimpleEnvelope:
    """Per-control squashed spectral envelope.

    Attributes:
        basis: basis kind ('poly' | 'legendre' | 'fourier' | 'bspline').
        n_basis: number of basis functions (coefficient columns).
        omegas: [n_controls] max drive amplitude per control.
    """

    basis: str
    n_basis: int
    omegas: tuple[float, ...]
    _memo: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "basis", canonical_kind(self.basis))
        object.__setattr__(self, "omegas",
                           tuple(float(w) for w in self.omegas))

    @property
    def n_controls(self) -> int:
        return len(self.omegas)

    @property
    def coeff_shape(self) -> tuple[int, int]:
        return (self.n_controls, self.n_basis)

    def init_coeff(self, generator: torch.Generator, scale: float = 1e-3,
                   dtype=torch.float32, device="cuda") -> torch.Tensor:
        """N(0, scale) init drawn from ``generator`` (on the generator's
        own device), returned on ``device``."""
        dev = resolve_device(device)
        c = torch.randn(self.coeff_shape, generator=generator, dtype=dtype,
                        device=generator.device)
        return (scale * c).to(dev)

    def raw(self, coeff: torch.Tensor, ts: torch.Tensor, T) -> torch.Tensor:
        """Pre-squash expansion A_k(t) = sum_j c_kj phi_j(t):
        coeff [n_controls, n_basis], ts [n_t] → [n_controls, n_t]. The
        basis is evaluated in the grid's dtype and cast to coeff's.
        Per-member coefficients [G, n_controls, n_basis] and/or grids
        [G, n_t] give [G, n_controls, n_t]."""
        phi = basis_matrix(self.basis, self.n_basis, ts, T)
        return torch.matmul(coeff, phi.to(dtype=coeff.dtype,
                                          device=coeff.device
                                          ).transpose(-1, -2))

    def omega_vector(self, dtype, device) -> torch.Tensor:
        """omegas as a [n_controls] tensor on ``device``, memoized: one
        host-to-card copy, not one (and a stream sync) per call."""
        key = ("omegas", dtype, str(device))
        if key not in self._memo:
            self._memo[key] = torch.tensor(self.omegas, dtype=dtype,
                                           device=device)
        return self._memo[key]

    def amplitudes(self, coeff: torch.Tensor, ts: torch.Tensor,
                   T) -> torch.Tensor:
        """u[..., n_controls, n_t] drive amplitude table."""
        a = self.raw(coeff, ts, T)
        omg = self.omega_vector(a.dtype, a.device)
        return (2.0 * clamped_sigmoid(a) - 1.0) * omg[:, None]
