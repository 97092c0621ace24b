"""Control-envelope models — the port of
:mod:`diffquantum_tpu.pulses.envelope`, for the whole time grid at once:

- :class:`SimpleEnvelope`: ``u_k(t) = (2 sigmoid(sum_j c_kj phi_j(t)) -
  1) * omega_k``, a bounded drive in ``[-omega_k, +omega_k]``;
- :class:`ChannelEnvelope`: the carrier-modulated two-quadrature
  channel model (`diffqc.cc:95-135`), channels summed per control.

Both broadcast over per-member coefficients and time grids, so seed
populations, FD's perturbed sets and the MC estimator's samples evaluate
in one call.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

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


@dataclasses.dataclass(frozen=True)
class Channel:
    """One drive channel of the carrier model (`diffqc.cc:108-111`):
    ``control`` is the index of the Hamiltonian term H_h it drives,
    ``w`` the carrier's angular frequency, ``idx`` its coefficient row
    in vv[quadrature, idx, basis]."""

    control: int
    omega: float
    w: float
    idx: int


@dataclasses.dataclass(frozen=True)
class ChannelEnvelope:
    """Carrier-modulated two-quadrature pulse model (`diffqc.cc:95-135`).

    Coefficients ``vv`` have shape [2, n_idx, n_basis] (quadrature, row,
    basis), the reference's ``vv`` layout. ``func_type`` 0 selects
    Legendre on 2t/T - 1, 1 the B-spline bump on t/T. Channel c gives
    ``omega_c (2 sigmoid(N) - 1) / N (cos(w_c t) A + sin(w_c t) B)`` with
    A, B its two quadratures' expansions and N = sqrt(A^2 + B^2), and 0
    where N < 1e-6 (`diffqc.cc:128`); a control's amplitude is the sum
    over its channels.
    """

    channels: tuple
    n_controls: int
    n_basis: int
    n_idx: int
    func_type: int = 0  # 0: legendre, 1: bspline (diffqc.cc:25)
    _memo: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @classmethod
    def from_rows(cls, rows_per_control: Sequence[Sequence[Sequence[float]]],
                  n_basis: int, func_type: int = 0) -> "ChannelEnvelope":
        """From the reference's nested channel table
        (``channels[h][i_c] = [_, omega, w, idx]``, `diffqc.cc:103-111`)."""
        chans = []
        n_idx = 0
        for h, rows in enumerate(rows_per_control):
            for row in rows:
                idx = int(round(row[3]))
                chans.append(Channel(control=h, omega=float(row[1]),
                                     w=float(row[2]), idx=idx))
                n_idx = max(n_idx, idx + 1)
        return cls(channels=tuple(chans), n_controls=len(rows_per_control),
                   n_basis=n_basis, n_idx=n_idx, func_type=int(func_type))

    @property
    def coeff_shape(self) -> tuple[int, int, int]:
        return (2, self.n_idx, self.n_basis)

    def init_coeff(self, generator: torch.Generator, scale: float = 1e-3,
                   dtype=torch.float32, device="cuda") -> torch.Tensor:
        """N(0, scale) init drawn from ``generator`` (on the generator's
        own device), returned on ``device``."""
        dev = resolve_device(device)
        c = torch.randn(self.coeff_shape, generator=generator, dtype=dtype,
                        device=generator.device)
        return (scale * c).to(dev)

    def _tables(self, dtype, device):
        """(row index [n_chan], omega [n_chan], w [n_chan] in float64,
        the 0/1 control-by-channel matrix [n_controls, n_chan]) on
        ``device``, memoized: one host-to-card copy per dtype."""
        key = (dtype, str(device))
        if key not in self._memo:
            ch = self.channels
            seg = torch.zeros((self.n_controls, len(ch)), dtype=dtype)
            for i, c in enumerate(ch):
                seg[c.control, i] = 1.0
            self._memo[key] = (
                torch.tensor([c.idx for c in ch], dtype=torch.long,
                             device=device),
                torch.tensor([c.omega for c in ch], dtype=dtype,
                             device=device),
                torch.tensor([c.w for c in ch], dtype=torch.float64,
                             device=device),
                seg.to(device))
        return self._memo[key]

    def amplitudes(self, vv: torch.Tensor, ts: torch.Tensor,
                   T) -> torch.Tensor:
        """u[n_controls, n_t]; per-member coefficients [G, 2, n_idx,
        n_basis] and/or grids [G, n_t] give [G, n_controls, n_t]. The
        basis and the carriers are evaluated in the grid's dtype and cast
        to vv's. Inside the N < 1e-6 mask the value is 0 and so is its
        gradient: the mask is applied before the square root (which is
        taken of 1 there) and after it."""
        kind = "legendre" if self.func_type == 0 else "bspline"
        phi = basis_matrix(kind, self.n_basis, ts, T).to(
            dtype=vv.dtype, device=vv.device)             # [..., n_t, n_b]
        idx, omega, w, seg = self._tables(vv.dtype, vv.device)
        ab = torch.matmul(torch.index_select(vv, -2, idx),
                          phi.transpose(-1, -2).unsqueeze(-3))
        a, b = ab.unbind(-3)                              # [..., n_chan, n_t]
        n2 = a * a + b * b
        small = torch.sqrt(n2.detach()) < 1e-6
        n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
        wt = w[:, None] * ts.to(w.device)[..., None, :]
        carrier = torch.cos(wt).to(vv.dtype) * a \
            + torch.sin(wt).to(vv.dtype) * b
        contrib = omega[:, None] * (2.0 * clamped_sigmoid(n) - 1.0) / n \
            * carrier
        contrib = torch.where(small, torch.zeros_like(contrib), contrib)
        return torch.matmul(seg, contrib)
