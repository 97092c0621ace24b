"""Drop-in replacement for the reference's ``diffqc`` pybind11 module, on
the port's engine — the port of :mod:`diffquantum_tpu.compat.diffqc`.

The reference exposes ``set_H / trotter / print_test / complex_test /
test_eigen / __version__`` with module-global system state
(`diffqc.cc:210-228, 21-25`). This module keeps that surface so scripts
written against ``import diffqc`` run unchanged:

    from diffquantum_tpu_torch.compat import diffqc
    diffqc.set_H(H0, Hs, channels, duration, func_type)   # device="cuda"
    psi_T = diffqc.trotter(psi0, T0, T, per_step, vv)

Argument conventions match the reference:
- ``H0``: nested list / array [d][d] complex; ``Hs``: [k][d][d];
- ``channels``: per-control list of channel rows ``[_, omega, w, idx]``
  (`diffqc.cc:108-111`; row position 0 is unused there too);
- ``vv``: [2][n_idx][n_basis] spectral coefficients; ``n_basis`` is read
  from ``vv`` at each ``trotter`` call;
- the basis is normalised by the ``duration`` given to ``set_H``, not by
  ``trotter``'s T;
- ``trotter`` returns a plain list of complex amplitudes.

The evolution runs on ``set_H``'s ``device`` (default ``"cuda"``; without
a card it raises unless ``device="cpu"``) by the port's dense engine in
float64: :class:`..pulses.envelope.ChannelEnvelope` amplitudes,
``ControlledHamiltonian`` operators and
:func:`..dynamics.propagator.trotter`, which takes 'expm' below d = 512
and the plain Taylor recurrence from 512 up (K7 takes float32 only, so no
kernel runs here). The Taylor truncation is held to ``TAYLOR_TOL`` a step,
below float64 rounding, as the reference's complex128 ``expm`` is exact.
There is no numpy fallback and no call into the native engine.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dynamics.hamiltonian import ControlledHamiltonian
from ..dynamics.propagator import reference_n_steps
from ..dynamics.propagator import trotter as _trotter
from ..ops import cpx
from ..pulses.envelope import ChannelEnvelope
from ..utils.device import resolve_device

__version__ = "dev"  # matches diffqc.cc:227

TAYLOR_TOL = 1e-15
_state = {"sys": None}


def set_H(H0, Hs, channels, duration, func_type, device="cuda") -> None:
    """Register the controlled system (reference `diffqc.cc:43-73`) on
    ``device``."""
    dev = resolve_device(device)
    H0 = np.asarray(H0, dtype=np.complex128)
    Hs = [np.asarray(h, dtype=np.complex128) for h in Hs]
    if len(channels) != len(Hs):
        raise ValueError(f"{len(channels)} channel lists for {len(Hs)} "
                         "controls")
    ham = ControlledHamiltonian.create(H0, Hs, dtype=torch.float64,
                                       device=dev)
    rows = [[tuple(float(x) for x in row) for row in chans]
            for chans in channels]
    _state["sys"] = (ham, rows, float(duration), int(func_type), dev)


def trotter(psi0, T0, T, per_step, vv):
    """Evolve psi0 over [T0, T] (reference `diffqc.cc:173-205`).

    Returns a list of complex amplitudes (matching the pybind11 return of
    std::vector<std::complex<double>>)."""
    if _state["sys"] is None:
        raise RuntimeError("call set_H first")
    ham, rows, duration, func_type, dev = _state["sys"]
    vv = np.asarray(vv, dtype=np.float64)
    if vv.ndim != 3 or vv.shape[0] != 2:
        raise ValueError(f"vv must be [2, n_idx, n_basis], got {vv.shape}")
    env = ChannelEnvelope.from_rows(rows, n_basis=vv.shape[2],
                                    func_type=func_type)
    if env.n_idx > vv.shape[1]:
        raise ValueError(f"a channel reads coefficient row {env.n_idx - 1}, "
                         f"vv has {vv.shape[1]}")
    psi = cpx.from_complex(np.asarray(psi0, dtype=np.complex128).reshape(-1),
                           dtype=torch.float64, device=dev)
    T0, T, per_step = float(T0), float(T), int(per_step)
    # |dt| bounds the Taylor order; it exceeds duration / n_steps when the
    # interval is longer than the basis' horizon
    dt_bound = abs(T - T0) / reference_n_steps(per_step, T0, T)
    out = _trotter(ham, env, torch.as_tensor(vv, device=dev), psi, T0, T,
                   horizon=duration, per_step=per_step, tol=TAYLOR_TOL,
                   dt_bound=dt_bound)
    return [complex(z) for z in cpx.to_complex(out)]


def print_test() -> None:  # diffqc.cc:27-29
    print("hello")


def complex_test(psi0):  # diffqc.cc:31-34
    return list(np.asarray(psi0, dtype=np.complex128).reshape(-1))


def test_eigen(v):  # diffqc.cc:36-38
    return [list(map(float, row)) for row in v]
