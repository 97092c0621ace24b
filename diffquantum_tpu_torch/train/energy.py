"""Energy-minimization training — the port of
:func:`diffquantum_tpu.train.energy.train_energy` and ``train_energy_fd``,
with the three gradient modes:

- ``adjoint``: the exact reverse-mode gradient (K1 forward and adjoint on
  the card);
- ``mc``: the paper's Monte-Carlo estimator, one sample per epoch, or the
  mean of ``config.mc_samples`` iid samples run as one batch
  (:mod:`..gradients.mc`);
- ``fd``: central finite differences, one batched evolution
  (:mod:`..gradients.fd`).

Semantics kept from the JAX package:
- coefficient init ``N(0, 1e-3)`` (drawn from a ``torch.Generator``
  seeded with ``config.seed``; JAX's draws differ, so parity runs pass
  ``init_coeff``);
- Adam (``torch.optim.Adam`` with optax's defaults: betas (0.9, 0.999),
  eps 1e-8) or SGD at a constant learning rate;
- per epoch: the measured loss at the current coefficients, then one
  update; the reported gap is ``loss - lambda_min(M)``. The measured loss
  is a separate forward evolution measured with ``sampling_measure`` /
  ``is_noisy``; in adjoint mode with exact measurement it is the value
  ``energy_and_grad`` returns, which is the same number;
- the MC and FD estimators take ``config.n_step`` steps, the loss and the
  adjoint ``per_step`` rule's;
- ``w_l2 > 0`` adds the j^2-weighted L2 gradient to the estimator's.

There is no analog of the JAX epoch-block ``lax.scan``: PyTorch runs
eagerly. Random draws (split times, shots, noise) come from a
``torch.Generator`` on the state's device seeded with ``config.seed + 1``,
not from the JAX key schedule. Not ported yet, and raising: LR schedules
and checkpoint/resume (ROADMAP.md, Queue 1: LR schedules and
checkpoint/resume).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..dynamics.propagator import evolve, reference_n_steps
from ..gradients.adjoint import energy_and_grad
from ..gradients.fd import fd_energy_grad
from ..gradients.mc import mc_energy_grad, mc_energy_grad_batch
from ..measure import Measurement, measure
from ..ops import cpx
from ..utils.logger import Logger, NullLogger
from .config import TrainConfig

GRAD_MODES = ("adjoint", "mc", "fd")


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
                "(ROADMAP.md, Queue 1: LR schedules and "
                "checkpoint/resume)")
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


def _lambda_min(measurement: Measurement) -> float:
    """The smallest eigenvalue of M, once on the host: the diagonal's
    minimum, a dense operator's lowest eigenvalue, else 0 (a target or
    a Pauli-string sum, whose lowest eigenvalue the caller passes as
    ``lam_min`` when it knows it: the gap is then the raw loss)."""
    if measurement.diag is not None:
        return float(measurement.diag.min())
    if measurement.matrix is not None:
        return float(np.linalg.eigvalsh(cpx.to_complex(
            measurement.matrix))[0])
    return 0.0


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
    if mode not in GRAD_MODES:
        raise ValueError(f"unknown grad_mode {mode!r}")
    if config.checkpoint_dir:
        raise NotImplementedError(
            "checkpoint/resume is not ported yet (ROADMAP.md, Queue 1: LR "
            "schedules and checkpoint/resume)")
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
    draws = torch.Generator(device=dev).manual_seed(config.seed + 1)

    T = float(T)
    n_steps = reference_n_steps(config.per_step, 0.0, T)
    if lam_min is None:
        lam_min = _lambda_min(measurement)
    lam_min = float(lam_min)
    evolve_kw = dict(backend=config.backend, precision=config.precision,
                     t_sample=config.t_sample)
    meas_flags = dict(sampling=config.sampling_measure,
                      noisy=config.is_noisy, per_pauli=config.per_pauli)
    exact_loss = mode == "adjoint" and not (config.sampling_measure
                                            or config.is_noisy)

    def measured_loss(c):
        with torch.no_grad():
            psi = evolve(ham, envelope, c, psi0, 0.0, T, horizon=T,
                         n_steps=n_steps, **evolve_kw)
            return measure(measurement, psi, draws, **meas_flags)

    def value_and_grad(c):
        if mode == "adjoint":
            return energy_and_grad(ham, envelope, measurement, c, psi0, T,
                                   n_steps, **evolve_kw)
        if mode == "mc" and config.mc_samples == 1:
            g = mc_energy_grad(ham, envelope, measurement, c, psi0, T,
                               draws, config.n_step, chain=config.mc_chain,
                               **evolve_kw, **meas_flags)
        elif mode == "mc":
            # the mean of iid single samples, as the JAX trainer takes it
            # (config.mc_strategy is the seed trainer's), as one batch
            g = mc_energy_grad_batch(
                ham, envelope, measurement, c, psi0, T, draws,
                config.n_step, config.mc_samples, strategy="iid",
                chain=config.mc_chain, **evolve_kw, **meas_flags)
        else:
            g = fd_energy_grad(ham, envelope, measurement, c, psi0, T,
                               draws, config.n_step, delta=config.fd_delta,
                               **evolve_kw, **meas_flags)
        return None, g

    losses_gap, losses_raw = [], []
    t0 = time.time()
    for epoch in range(1, config.n_epoch + 1):
        c = coeff.detach()
        # the measured loss first, as the JAX trainer draws it; with exact
        # measurement the adjoint's own value is that number
        loss = None if exact_loss else measured_loss(c)
        value, grad = value_and_grad(c)
        if loss is None:
            loss = value
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


def train_energy_fd(ham, envelope, measurement, psi0, T,
                    config: TrainConfig, **kw) -> TrainResult:
    """The reference's FD baseline trainer (`sim_plain.py:355-412`)."""
    return train_energy(ham, envelope, measurement, psi0, T,
                        config.replace(grad_mode="fd"), **kw)
