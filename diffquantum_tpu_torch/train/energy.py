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
not from the JAX key schedule. The LR schedules are optax's
(:func:`lr_schedule`), and ``checkpoint_dir`` / ``checkpoint_every``
save and resume the run as the JAX trainer does
(:mod:`..utils.checkpointing`; the generator's state takes the PRNG
key's place).
"""
from __future__ import annotations

import dataclasses
import math
import os
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
from ..utils.checkpointing import load_checkpoint, save_checkpoint
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


def _cosine_decay(init_value: float, decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule (exponent 1) as a function of the
    update count."""
    if not decay_steps > 0:
        raise ValueError("the cosine schedule needs positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(count: int) -> float:
        count = min(float(count), float(decay_steps))
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay + alpha)
    return schedule


def lr_schedule(config: TrainConfig) -> Callable[[int], float]:
    """The learning rate of update k (optax's count: 0 at the first
    update) under ``config.lr_schedule``, with optax's formulas
    (`diffquantum_tpu/train/energy.py:60-75`): 'constant'; 'cosine',
    ``cosine_decay_schedule(lr, n_epoch, alpha=0.05)``; 'warmup_cosine',
    a linear warmup from 0 over ``warm = max(1, n_epoch // 20)`` updates,
    then a cosine down to 0.05 lr at update n_epoch
    (``warmup_cosine_decay_schedule(0, lr, warm, n_epoch, end_value=0.05
    lr)``)."""
    lr, n = config.lr, config.n_epoch
    if config.lr_schedule == "constant":
        return lambda count: lr
    if config.lr_schedule == "cosine":
        return _cosine_decay(lr, n, 0.05)
    if config.lr_schedule == "warmup_cosine":
        warm = max(1, n // 20)
        decay = _cosine_decay(lr, n - warm, 0.05)

        def schedule(count: int) -> float:
            if count >= warm:
                return decay(count - warm)
            return lr * count / warm
        return schedule
    raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}")


def make_optimizer(config: TrainConfig, params) -> torch.optim.Optimizer:
    """The optimizer over ``params`` with the learning rate of
    :func:`lr_schedule`. Each param group counts its updates in
    ``group["update_count"]``, part of the optimizer's ``state_dict``: a
    step-pre hook sets the group's lr for the coming update from that
    count, so a run resumed from a saved state continues the schedule."""
    schedule = lr_schedule(config)
    if config.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999),
                               eps=1e-8)
    elif config.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=schedule(0))
    else:
        raise ValueError(f"unknown optimizer {config.optimizer!r}")
    for group in opt.param_groups:
        group["update_count"] = 0

    def set_lr(optimizer, args, kwargs):
        for group in optimizer.param_groups:
            group["lr"] = schedule(group["update_count"])
            group["update_count"] += 1
    opt.register_step_pre_hook(set_lr)
    return opt


def serialization_to_optstate(restored: dict,
                              template: torch.optim.Optimizer):
    """Load an optimizer ``state_dict`` restored from a checkpoint into
    ``template``, a freshly made optimizer over the run's parameters (the
    JAX package rebuilds an optax state from its msgpack containers with
    the fresh state as the template). Returns the template."""
    template.load_state_dict(restored)
    return template


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
    start_epoch = 1

    # checkpoint/resume (absent in the reference — SURVEY.md §5)
    if config.checkpoint_dir and os.path.exists(
            os.path.join(config.checkpoint_dir, "ckpt.pt")):
        state = load_checkpoint(config.checkpoint_dir)
        with torch.no_grad():
            coeff.copy_(state["coeff"])
        serialization_to_optstate(state["opt_state"], opt)
        draws.set_state(state["rng"])
        start_epoch = int(state["epoch"]) + 1
        log.write_text(f"resumed from epoch {start_epoch - 1}")
    ckpt_every = config.checkpoint_every if config.checkpoint_dir else 0

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
    for epoch in range(start_epoch, config.n_epoch + 1):
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
        if ckpt_every and epoch % ckpt_every == 0:
            save_checkpoint(config.checkpoint_dir, dict(
                coeff=coeff, opt_state=opt.state_dict(),
                rng=draws.get_state(), epoch=epoch))
    coeff = coeff.detach()
    final_state = None
    if config.n_epoch >= start_epoch:
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
