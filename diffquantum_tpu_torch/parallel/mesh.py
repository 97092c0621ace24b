"""Seed-batched training on one card — the port of the single-device part
of :mod:`diffquantum_tpu.parallel.mesh` (``SeedsResult``,
``train_energy_seeds``).

The reference trains one pulse initialisation at a time; the natural
scale-out axis is many independent initialisations trained at once as one
batched program (64 seeds of the 12-qubit ring MaxCut in the JAX bench).
Here the seeds are the batch axis of the fused engine:

- adjoint mode: per epoch one batched forward and one batched adjoint
  over the B seeds' own coefficients (on the card, one K2 launch each);
- MC mode: the exact energies (one batched forward), then the MC
  estimator with every seed's samples flattened onto the batch axis
  (:func:`..gradients.mc.mc_grads_per_sample`): seeds × samples states
  to their split times, then seeds × samples × 2·n_Hs branches (one K2
  launch each on the card), ``mc_strategy`` setting the split times when
  ``mc_samples > 1``.

Adam over the stacked [B, ...] coefficients equals B independent
optimisers (its update is elementwise). Losses stay on the device during
training and reach the host once, at the end. The JAX package shards the
seed axis over a device mesh; ``mesh=`` and :func:`make_mesh` raise until
the multi-device port (ROADMAP.md, Queue 1 item 18).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..dynamics.propagator import evolve, reference_n_steps
from ..gradients.mc import (check_sampled_size, draw_split_times,
                            mc_grads_per_sample)
from ..measure import Measurement, diag_expectation
from ..ops.cpx import CP
from ..train.config import TrainConfig
from ..train.energy import make_optimizer

_MESH_MSG = ("device meshes (multi-card seed sharding) are not ported yet "
             "(ROADMAP.md, Queue 1 item 18)")


def make_mesh(axes: dict, devices=None):
    """Raises: the multi-device part of the port is not written yet."""
    raise NotImplementedError(_MESH_MSG)


@dataclasses.dataclass
class SeedsResult:
    coeffs: torch.Tensor       # [n_seeds, ...] final coefficients
    losses: np.ndarray         # [n_epochs, n_seeds] loss history
    best_seed: int
    best_loss: float


def train_energy_seeds(
    ham,
    envelope,
    measurement: Measurement,
    psi0: CP,
    T: float,
    config: TrainConfig,
    n_seeds: int,
    mesh=None,
    data_axis: str = "data",
    init_scale: float = 1e-3,
    init_coeffs: Optional[torch.Tensor] = None,
) -> SeedsResult:
    """Train ``n_seeds`` independent pulse initialisations as one batch on
    psi0's device (adjoint gradients by default, ``grad_mode='mc'`` for
    the hardware-realistic estimator). ``init_scale``: stddev of the
    coefficient init, drawn from a ``torch.Generator`` seeded with
    ``config.seed``; ``init_coeffs`` [n_seeds, n_controls, n_basis]
    replaces the draw (the JAX package draws from ``jax.random``, so
    parity runs hand both the same start). ``losses[e, b]`` is seed b's
    exact energy before epoch e's update."""
    if mesh is not None:
        raise NotImplementedError(_MESH_MSG)
    if not ham.is_structured_only or measurement.diag is None:
        raise NotImplementedError(
            "train_energy_seeds on dense Hamiltonians and non-diagonal "
            "objectives is not ported yet (ROADMAP.md, Queue 1 item 13)")
    del data_axis
    if config.grad_mode not in ("adjoint", "mc"):
        raise ValueError(f"train_energy_seeds takes grad_mode 'adjoint' or "
                         f"'mc', got {config.grad_mode!r}")
    if config.grad_mode == "mc":
        check_sampled_size(ham, "train_energy_seeds(grad_mode='mc')")
    T = float(T)
    n_steps = reference_n_steps(config.per_step, 0.0, T)
    dev, rdt = psi0.re.device, config.rdtype
    shape = (n_seeds,) + tuple(envelope.coeff_shape)
    if init_coeffs is None:
        gen = torch.Generator().manual_seed(config.seed)
        cs = (init_scale * torch.randn(shape, generator=gen,
                                       dtype=rdt)).to(dev)
    else:
        cs = torch.as_tensor(init_coeffs, dtype=rdt,
                             device=dev).detach().clone()
        if tuple(cs.shape) != shape:
            raise ValueError(f"init_coeffs must be {shape}, got "
                             f"{tuple(cs.shape)}")
    cs.requires_grad_(True)
    opt = make_optimizer(config, [cs])
    draws = torch.Generator(device=dev).manual_seed(config.seed + 1)
    psi_b = CP(psi0.re.expand(n_seeds, -1), psi0.im.expand(n_seeds, -1))
    evolve_kw = dict(backend=config.backend, precision=config.precision,
                     t_sample=config.t_sample)
    mc_kw = dict(chain=config.mc_chain, sampling=config.sampling_measure,
                 noisy=config.is_noisy, per_pauli=config.per_pauli,
                 **evolve_kw)

    def energies(c):
        psi = evolve(ham, envelope, c, psi_b, 0.0, T, horizon=T,
                     n_steps=n_steps, **evolve_kw)
        return diag_expectation(measurement.diag, psi)

    def mc_grads(c):
        n = config.mc_samples
        # one sample is mc_energy_grad's uniform draw; more take the
        # strategy, as mc_energy_grad_batch per seed in the JAX package
        s = draw_split_times(config.mc_strategy if n > 1 else "iid", n, T,
                             draws, lead=(n_seeds,))
        g = mc_grads_per_sample(ham, envelope, measurement,
                                c.repeat_interleave(n, dim=0), psi0, T,
                                s.reshape(-1), config.n_step, draws,
                                **mc_kw)
        return g.reshape((n_seeds, n) + tuple(g.shape[1:])).mean(dim=1)

    losses = []
    for _ in range(config.n_epoch):
        c = cs.detach()
        if config.grad_mode == "mc":
            with torch.no_grad():
                e = energies(c)
                g = mc_grads(c)
        else:
            c = c.requires_grad_(True)
            with torch.enable_grad():
                e = energies(c)
                (g,) = torch.autograd.grad(e.sum(), c)
            e = e.detach()
        cs.grad = g.to(rdt)
        opt.step()
        losses.append(e)

    losses_np = torch.stack(losses).cpu().numpy() if losses \
        else np.zeros((0, n_seeds))
    final = losses_np[-1] if len(losses_np) else np.full(n_seeds, np.nan)
    best = int(np.argmin(final)) if len(losses_np) else 0
    return SeedsResult(coeffs=cs.detach(), losses=losses_np, best_seed=best,
                       best_loss=float(final[best]))
