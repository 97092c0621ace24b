"""Training configuration — the port of
:class:`diffquantum_tpu.train.config.TrainConfig`, same fields and
defaults. ``epoch_block`` and ``precision='fast'`` are accepted and change
nothing (PyTorch runs eagerly; the fused kernels have no matmul precision
to pick). ``mc_t_jacobian`` is read by no trainer, as in the JAX
package."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_basis: int = 5
    basis: str = "bspline"
    n_epoch: int = 200
    lr: float = 2e-2
    is_noisy: bool = False
    sampling_measure: bool = False
    per_step: int = 10
    n_step: int = 100          # segment grid length of the MC/FD estimators

    grad_mode: str = "adjoint"   # 'adjoint' | 'mc' | 'fd'
    backend: str = "auto"        # propagator backend
    t_sample: str = "left"       # 'left' | 'mid'
    precision: str = "full"      # 'full' | 'fast'
    mc_samples: int = 1
    mc_chain: str = "exact"      # 'exact' | 'reference'
    mc_strategy: str = "iid"     # 'iid' | 'antithetic' | 'stratified'
    mc_t_jacobian: bool = False
    fd_delta: float = 1e-3
    w_l2: float = 0.0            # j^2-weighted L2 on the coefficients
    per_pauli: int = 100
    seed: int = 0
    dtype: str = "float32"       # real dtype: 'float32' | 'float64'
    optimizer: str = "adam"      # 'adam' | 'sgd'
    lr_schedule: str = "constant"  # 'constant' | 'cosine' | 'warmup_cosine'
    log_every: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    epoch_block: Optional[int] = None

    @property
    def rdtype(self):
        return torch.float64 if self.dtype in ("float64", "complex128") \
            else torch.float32

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
