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
__version__ = "0.1.0"
