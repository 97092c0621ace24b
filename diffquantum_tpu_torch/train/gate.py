"""Coherent target-unitary (gate) synthesis — the port of
:mod:`diffquantum_tpu.train.gate`.

The loss is the coherent gate infidelity

    1 - |Tr(G^dag U(T))|^2 / d^2,

which is 0 iff U(T) = e^{i phi} G. U(T) is never formed: the d basis
states evolve as one batch (the dense 'apply' backend: K7 on the card,
d members per launch) and the trace is the coherent sum of the columns'
overlaps, ``Tr(G^dag U) = sum_i <G e_i | U e_i>``. Gradients are
adjoint only (the trace is no per-state observable, so the MC estimator
does not apply). The loop is the plain per-epoch loop: PyTorch runs
eagerly, so there are no compiled epoch blocks (``epoch_block`` is
accepted and changes nothing).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..dynamics.propagator import evolve, reference_n_steps
from ..ops import cpx
from ..ops.cpx import CP
from ..utils.device import resolve_device
from ..utils.logger import Logger, NullLogger
from .config import TrainConfig
from .energy import TrainResult, l2_grad, make_optimizer


def _device_of(ham, device=None) -> torch.device:
    """Where a trainer without a given state works: ``device`` if named,
    else the dense Hamiltonian's device (a structured one needs
    ``device``)."""
    if device is not None:
        return resolve_device(device)
    if ham.is_structured_only:
        raise ValueError("a structured Hamiltonian holds no device; pass "
                         "device=")
    return ham.H0.re.device


def gate_infidelity(ham, envelope, coeff, gate_dag: CP, psi0_cols: CP,
                    T: float, n_steps: int, backend: str = "auto",
                    precision: str = "full",
                    t_sample: str = "left") -> torch.Tensor:
    """1 - |Tr(G^dag U(T))|^2 / d^2 with U(T) applied column by column as
    one batched evolution. ``gate_dag`` row i is <G e_i|; ``psi0_cols``
    row i is |i>."""
    d = psi0_cols.shape[-1]
    psi = evolve(ham, envelope, coeff, psi0_cols, 0.0, T, horizon=T,
                 n_steps=n_steps, backend=backend, precision=precision,
                 t_sample=t_sample)
    o_re = torch.sum(gate_dag.re * psi.re - gate_dag.im * psi.im, dim=-1)
    o_im = torch.sum(gate_dag.re * psi.im + gate_dag.im * psi.re, dim=-1)
    tr_re, tr_im = torch.sum(o_re), torch.sum(o_im)
    return 1.0 - (tr_re * tr_re + tr_im * tr_im) / (d * d)


def train_gate(ham, envelope, gate: np.ndarray, T: float,
               config: TrainConfig, logger: Optional[Logger] = None,
               init_coeff: Optional[torch.Tensor] = None,
               device=None) -> TrainResult:
    """Optimize the coefficients so the evolution implements ``gate`` (a
    [d, d] unitary) up to a global phase. ``losses_raw`` is the
    per-epoch coherent infidelity; ``final_state`` holds the realized
    evolution as row-stacked kets (CP [d, d], row i = U|i>, i.e. U^T).
    The coefficient init is N(0, 1) from a ``torch.Generator`` seeded
    with ``config.seed`` (the JAX package draws from ``jax.random``, so
    parity runs pass ``init_coeff``)."""
    if config.grad_mode != "adjoint":
        raise ValueError("train_gate is adjoint-only (the coherent trace is "
                         "not a per-state observable); use train_fidelity "
                         "for the measurable pair-based surrogate")
    log = logger or NullLogger()
    log.write_text("!!!! train_gate ========")
    dev, rdt = _device_of(ham, device), config.rdtype
    if init_coeff is None:
        gen = torch.Generator().manual_seed(config.seed)
        coeff = envelope.init_coeff(gen, scale=1.0, dtype=rdt, device=dev)
    else:
        coeff = torch.as_tensor(init_coeff, dtype=rdt,
                                device=dev).detach().clone()
    g = np.asarray(gate, dtype=np.complex128)
    d = g.shape[0]
    if g.shape != (d, d) or not np.allclose(g @ g.conj().T, np.eye(d),
                                            atol=1e-8):
        raise ValueError("gate must be a square unitary matrix")
    gate_dag = cpx.from_complex(g.conj().T, dtype=rdt, device=dev)
    psi0_cols = cpx.eye(d, dtype=rdt, device=dev)
    coeff.requires_grad_(True)
    opt = make_optimizer(config, [coeff])
    T = float(T)
    n_steps = reference_n_steps(config.per_step, 0.0, T)
    kw = dict(backend=config.backend, precision=config.precision,
              t_sample=config.t_sample)

    losses = []
    t0 = time.time()
    for epoch in range(1, config.n_epoch + 1):
        c = coeff.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = gate_infidelity(ham, envelope, c, gate_dag, psi0_cols, T,
                                   n_steps, **kw)
            (grad,) = torch.autograd.grad(loss, c)
        with torch.no_grad():
            coeff.grad = grad + l2_grad(coeff, config.w_l2)
        opt.step()
        loss = float(loss.detach())
        losses.append(loss)
        if epoch % config.log_every == 0:
            log.write_text(f"epoch: {epoch:04d}, loss_gate: {loss:.6f}")
            log.log_metrics(epoch=epoch, loss=loss, mode="adjoint")
    coeff = coeff.detach()
    with torch.no_grad():
        finals = evolve(ham, envelope, coeff, psi0_cols, 0.0, T, horizon=T,
                        n_steps=n_steps, **kw)
    return TrainResult(coeff=coeff, losses_energy=losses, losses_raw=losses,
                       final_state=finals, wall_s=time.time() - t0,
                       grad_mode="adjoint")
