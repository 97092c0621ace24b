"""Energy-minimization training — the port of
:func:`diffquantum_tpu.train.energy.train_energy` in its adjoint mode.

Semantics kept from the JAX package:
- coefficient init ``N(0, 1e-3)`` (drawn from a ``torch.Generator``
  seeded with ``config.seed``; JAX's draws differ, so parity runs pass
  ``init_coeff``);
- Adam (``torch.optim.Adam`` with optax's defaults: betas (0.9, 0.999),
  eps 1e-8) or SGD at a constant learning rate;
- per epoch: the loss at the current coefficients, then one update; the
  reported gap is ``loss - lambda_min(M)``;
- ``w_l2 > 0`` adds the j^2-weighted L2 gradient to the estimator's.

There is no analog of the JAX epoch-block ``lax.scan``: PyTorch runs
eagerly. The loss of an epoch is the value ``energy_and_grad`` returns,
which equals the JAX package's separate measured forward when the
measurement is exact (the only kind ported). Not ported yet, and raising:
``grad_mode`` 'mc' (ROADMAP.md, Queue 1 item 10) and 'fd' (item 11), LR
schedules and checkpoint/resume (item 20).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..dynamics.propagator import evolve, reference_n_steps
from ..gradients.adjoint import energy_and_grad
from ..measure import Measurement
from ..utils.logger import Logger, NullLogger
from .config import TrainConfig

_UNPORTED_MODES = {
    "mc": "grad_mode='mc' is not ported yet (ROADMAP.md, Queue 1 item 10)",
    "fd": "grad_mode='fd' is not ported yet (ROADMAP.md, Queue 1 item 11)",
}


@dataclasses.dataclass
class TrainResult:
    coeff: torch.Tensor
    losses_energy: list          # per-epoch optimality gaps
    losses_raw: list             # per-epoch loss values
    final_state: object          # CP at the returned coefficients
    wall_s: float
    grad_mode: str


def make_optimizer(config: TrainConfig, params) -> torch.optim.Optimizer:
    """The optimizer over ``params`` at a constant learning rate."""
    if config.lr_schedule != "constant":
        if config.lr_schedule in ("cosine", "warmup_cosine"):
            raise NotImplementedError(
                f"lr_schedule={config.lr_schedule!r} is not ported yet "
                "(ROADMAP.md, Queue 1 item 20)")
        raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}")
    if config.optimizer == "adam":
        return torch.optim.Adam(params, lr=config.lr, betas=(0.9, 0.999),
                                eps=1e-8)
    if config.optimizer == "sgd":
        return torch.optim.SGD(params, lr=config.lr)
    raise ValueError(f"unknown optimizer {config.optimizer!r}")


def l2_grad(coeff: torch.Tensor, w_l2: float) -> torch.Tensor:
    """Gradient of ``mean_j(mean_k c_kj^2 * j^2) * w_l2`` (basis index on
    the last axis)."""
    if w_l2 == 0.0:
        return torch.zeros_like(coeff)
    j2 = torch.arange(coeff.shape[-1], dtype=coeff.dtype,
                      device=coeff.device) ** 2
    return 2.0 * w_l2 * coeff * j2 / coeff.numel()


def train_energy(
    ham,
    envelope,
    measurement: Measurement,
    psi0,
    T: float,
    config: TrainConfig,
    logger: Optional[Logger] = None,
    init_coeff: Optional[torch.Tensor] = None,
    callback: Optional[Callable] = None,
    lam_min: Optional[float] = None,
) -> TrainResult:
    """Optimize spectral coefficients to minimize <psi(T)|M|psi(T)>, on
    psi0's device."""
    mode = config.grad_mode
    if mode in _UNPORTED_MODES:
        raise NotImplementedError(_UNPORTED_MODES[mode])
    if mode != "adjoint":
        raise ValueError(f"unknown grad_mode {mode!r}")
    if config.checkpoint_dir:
        raise NotImplementedError(
            "checkpoint/resume is not ported yet (ROADMAP.md, Queue 1 "
            "item 20)")
    if config.sampling_measure or config.is_noisy:
        raise NotImplementedError(
            "shot-sampled and noisy measurement are not ported yet "
            "(ROADMAP.md, Queue 1 item 10)")
    log = logger or NullLogger()
    log.write_text("!!!! train_energy ========")
    log.log_config({f.name: getattr(config, f.name)
                    for f in dataclasses.fields(config)})

    dev, rdt = psi0.re.device, config.rdtype
    if init_coeff is None:
        gen = torch.Generator().manual_seed(config.seed)
        coeff = envelope.init_coeff(gen, scale=1e-3, dtype=rdt, device=dev)
    else:
        coeff = torch.as_tensor(init_coeff, dtype=rdt,
                                device=dev).detach().clone()
    coeff.requires_grad_(True)
    opt = make_optimizer(config, [coeff])

    T = float(T)
    n_steps = reference_n_steps(config.per_step, 0.0, T)
    if lam_min is None:
        lam_min = float(measurement.diag.min())
    lam_min = float(lam_min)
    evolve_kw = dict(backend=config.backend, precision=config.precision,
                     t_sample=config.t_sample)

    losses_gap, losses_raw = [], []
    t0 = time.time()
    for epoch in range(1, config.n_epoch + 1):
        loss, grad = energy_and_grad(ham, envelope, measurement,
                                     coeff.detach(), psi0, T, n_steps,
                                     **evolve_kw)
        with torch.no_grad():
            coeff.grad = grad.to(rdt) + l2_grad(coeff, config.w_l2)
        opt.step()
        loss = float(loss)
        gap = loss - lam_min
        losses_raw.append(loss)
        losses_gap.append(gap)
        if epoch % config.log_every == 0:
            log.write_text(
                f"epoch: {epoch:04d}, loss: {loss}, loss_energy: {gap}")
            log.log_metrics(epoch=epoch, loss=loss, gap=gap, mode=mode)
        if callback is not None:
            callback(epoch=epoch, coeff=coeff.detach(), loss=loss, gap=gap)
    coeff = coeff.detach()
    final_state = None
    if config.n_epoch >= 1:
        with torch.no_grad():  # state of the RETURNED coefficients
            final_state = evolve(ham, envelope, coeff, psi0, 0.0, T,
                                 horizon=T, n_steps=n_steps, **evolve_kw)
    return TrainResult(coeff=coeff, losses_energy=losses_gap,
                       losses_raw=losses_raw, final_state=final_state,
                       wall_s=time.time() - t0, grad_mode=mode)
