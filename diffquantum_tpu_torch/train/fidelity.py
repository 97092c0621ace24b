"""State-transfer fidelity training — the port of
:mod:`diffquantum_tpu.train.fidelity` (``SimulatorPlain.train_fidelity``,
`sim_plain.py:414-475`).

A batch of (initial, target) state pairs; per pair the objective is
``1 - |<target|psi(T)>|^2``, the rank-1 projector measured matrix-free.
Gradients: 'adjoint' (exact, :func:`..gradients.adjoint.
fidelity_and_grad`) or 'mc' (the paper's estimator with
``coeff_sign = -1``, `sim_plain.py:461`, one sample per pair per step).

- ``per_pair=True`` (the reference): one optimizer step per pair per
  epoch;
- ``per_pair=False``: the mean loss and gradient over all pairs, one
  step per epoch. The adjoint evolves the pairs as one batch (the dense
  'apply' backend; the JAX package vmaps pairs, each on 'expm' below
  d = 512: the two agree to the Taylor tolerance).

``sampling_measure`` measures the loss as Bernoulli trials on
|<t|psi>|^2, ``is_noisy`` adds the reference's Gaussian noise to the
overlap (`sim_plain.py:452-454`); both draw from a ``torch.Generator``
seeded with ``config.seed + 1``. Coefficients start at N(0, 1)
(`sim_plain.py:425`), drawn from a generator seeded with
``config.seed``. The loop is the plain per-epoch loop (no compiled epoch
blocks: ``epoch_block`` changes nothing).
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ..dynamics.propagator import evolve, reference_n_steps
from ..gradients.adjoint import fidelity_and_grad
from ..gradients.mc import mc_energy_grad
from ..measure import (Measurement, measurement_noise, sampled_target_prob,
                       target_overlap_prob)
from ..ops.cpx import CP
from ..utils.logger import Logger, NullLogger
from .config import TrainConfig
from .energy import TrainResult, l2_grad, make_optimizer


def train_fidelity(ham, envelope, initial_states: CP, target_states: CP,
                   T: float, config: TrainConfig,
                   logger: Optional[Logger] = None, per_pair: bool = True,
                   init_coeff: Optional[torch.Tensor] = None) -> TrainResult:
    """Maximize the transfer fidelity of every (initial, target) pair
    (CP [n_pairs, d] each, on the device the training runs on)."""
    mode = config.grad_mode
    if mode not in ("adjoint", "mc"):
        raise ValueError(f"grad_mode {mode!r} not supported for fidelity")
    log = logger or NullLogger()
    log.write_text("!!!! train_fidelity ========")
    dev, rdt = initial_states.re.device, config.rdtype
    if init_coeff is None:
        gen = torch.Generator().manual_seed(config.seed)
        coeff = envelope.init_coeff(gen, scale=1.0, dtype=rdt, device=dev)
    else:
        coeff = torch.as_tensor(init_coeff, dtype=rdt,
                                device=dev).detach().clone()
    coeff.requires_grad_(True)
    opt = make_optimizer(config, [coeff])
    draws = torch.Generator(device=dev).manual_seed(config.seed + 1)
    T = float(T)
    n_steps = reference_n_steps(config.per_step, 0.0, T)
    kw = dict(backend=config.backend, precision=config.precision,
              t_sample=config.t_sample)
    inits, targets = initial_states.astype(rdt), target_states.astype(rdt)
    n_pairs = inits.shape[0]
    pairs = [(CP(inits.re[i], inits.im[i]), CP(targets.re[i],
                                                targets.im[i]))
             for i in range(n_pairs)]

    def measured_loss(c, psi0: CP, target: CP) -> torch.Tensor:
        """1 - the measured overlap, per pair (psi0 and target [d] or
        [n_pairs, d])."""
        with torch.no_grad():
            psi = evolve(ham, envelope, c, psi0, 0.0, T, horizon=T,
                         n_steps=n_steps, **kw)
            if config.sampling_measure:
                ov = sampled_target_prob(target, psi, draws,
                                         config.per_pauli)
            else:
                ov = target_overlap_prob(target, psi)
            if config.is_noisy:
                ov = measurement_noise(ov, draws)
            return 1.0 - ov

    def pair_grad(c, psi0: CP, target: CP) -> torch.Tensor:
        if mode == "adjoint":
            return fidelity_and_grad(ham, envelope, target, c, psi0, T,
                                     n_steps, **kw)[1]
        return mc_energy_grad(
            ham, envelope, Measurement(target=target), c, psi0, T, draws,
            config.n_step, coeff_sign=-1.0, chain=config.mc_chain,
            sampling=config.sampling_measure, noisy=config.is_noisy,
            per_pauli=config.per_pauli, **kw)

    def step(grad):
        with torch.no_grad():
            coeff.grad = grad.to(rdt) + l2_grad(coeff, config.w_l2)
        opt.step()

    losses = []
    t0 = time.time()
    for epoch in range(1, config.n_epoch + 1):
        if per_pair:
            batch = []
            for psi0, target in pairs:
                c = coeff.detach()
                batch.append(float(measured_loss(c, psi0, target)))
                step(pair_grad(c, psi0, target))
            mean_loss = sum(batch) / n_pairs
        else:
            c = coeff.detach()
            mean_loss = float(measured_loss(c, inits, targets).mean())
            if mode == "adjoint":
                cg = c.clone().requires_grad_(True)
                with torch.enable_grad():
                    psi = evolve(ham, envelope, cg, inits, 0.0, T,
                                 horizon=T, n_steps=n_steps, **kw)
                    loss = torch.mean(1.0 - target_overlap_prob(targets,
                                                                psi))
                    (grad,) = torch.autograd.grad(loss, cg)
            else:
                grad = torch.stack([pair_grad(c, p, t)
                                    for p, t in pairs]).mean(dim=0)
            step(grad)
        losses.append(mean_loss)
        if epoch % config.log_every == 0:
            log.write_text(f"epoch: {epoch:04d}, loss: {mean_loss:.4f}, "
                           f"loss_fidelity: {mean_loss:.4f}")
            log.log_metrics(epoch=epoch, loss=mean_loss, mode=mode)
    coeff = coeff.detach()
    with torch.no_grad():
        finals = evolve(ham, envelope, coeff, inits, 0.0, T, horizon=T,
                        n_steps=n_steps, **kw)
    return TrainResult(coeff=coeff, losses_energy=losses, losses_raw=losses,
                       final_state=finals, wall_s=time.time() - t0,
                       grad_mode=mode)
