"""diffquantum_tpu_torch — the PyTorch/CUDA port of :mod:`diffquantum_tpu`.

The same pulse-level simulator and trainer, ``H(t) = H0 + sum_k u_k(t; c)
H_k`` with spectral pulse envelopes and exact adjoint gradients, written
for PyTorch on an NVIDIA Hopper card. Module paths and names mirror the
JAX package so every function has a findable counterpart; the JAX package
stays the reference the tests hold this one against.

Complex state is a real pair (:class:`diffquantum_tpu_torch.ops.cpx.CP`),
as in the JAX package. Hot loops run in hand-written CUDA kernels under
``csrc/`` (built with ``nvcc`` at first use, see :mod:`.ops._build`); every
kernel keeps a plain PyTorch version beside it, which is what runs for CPU
tensors.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when no card is present unless the caller asks for ``device="cpu"``.
"""
from .version import __version__
from .ops import cpx, linalg
from .ops.cpx import CP
from .ops.expm import (cexpm_apply_taylor, cexpm_pade13, cexpm_taylor,
                       taylor_params)
from .pulses.basis import basis_matrix
from .pulses.envelope import Channel, ChannelEnvelope, SimpleEnvelope
from .dynamics.hamiltonian import (ControlledHamiltonian, TermStructure,
                                   classify_operator, detect_structure)
from .dynamics.propagator import (calibrate_n_steps, evolve,
                                  evolve_trajectory, reference_n_steps,
                                  step_doubling_error, trotter)
from .dynamics.product import evolve_product, evolve_product_fused
from .measure import DiagonalTermSet, Measurement, PauliTermSet
from . import models, parallel, train, utils  # noqa: F401 (convenience)

__all__ = [
    "__version__",
    "cpx", "CP", "linalg",
    "cexpm_taylor", "cexpm_pade13", "cexpm_apply_taylor", "taylor_params",
    "basis_matrix",
    "SimpleEnvelope", "Channel", "ChannelEnvelope",
    "ControlledHamiltonian", "TermStructure",
    "classify_operator", "detect_structure",
    "evolve", "trotter", "reference_n_steps",
    "step_doubling_error", "calibrate_n_steps",
    "Measurement", "PauliTermSet",
]
