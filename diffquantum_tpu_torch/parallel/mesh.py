"""Device meshes over ``torch.distributed`` and seed-batched training —
the port of :mod:`diffquantum_tpu.parallel.mesh` (``make_mesh``,
``SeedsResult``, ``train_energy_seeds``).

A :class:`Mesh` names axes over the ranks of the default process group,
laid out row-major as the JAX package reshapes its device list: on the
card one rank per card (NCCL), on the CPU gloo ranks (``device="cpu"``,
as the tests run them). :func:`make_mesh` joins the group that exists,
starts one from the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``),
or else starts a world of one rank on a ``FileStore`` in a temporary
directory, which needs no network.

The reference trains one pulse initialisation at a time; the natural
scale-out axis is many independent initialisations trained at once as one
batched program (64 seeds of the 12-qubit ring MaxCut in the JAX bench).
Here the seeds are the batch axis of the engines:

- adjoint mode: per epoch one batched forward and one batched adjoint
  over the B seeds' own coefficients (on the card one K2, K5 or K6
  launch each for a structured problem; a dense one evolves each seed as
  a group of one member, the JAX package's vmapped rule: 'expm' below
  d = 512, 'apply' at and past it);
- MC mode: the exact energies (one batched forward), then the MC
  estimator with every seed's samples flattened onto the batch axis
  (:func:`..gradients.mc.mc_grads_per_sample`): seeds × samples states
  to their split times, then seeds × samples × 2·n_Hs branches,
  ``mc_strategy`` setting the split times when ``mc_samples > 1``;
  from 18 qubits up the (seed, sample) pairs run one after another, each
  one K3/K5 chain to its split time and one batched launch over its
  branches.

With ``mesh=`` the seeds are split over its data axis: each rank trains
its share as above, and the losses and coefficients are gathered at the
end, so every rank returns the same :class:`SeedsResult`. Adam over the
stacked [B, ...] coefficients equals B independent optimisers (its
update is elementwise). Losses stay on the device during training and
reach the host once, at the end.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..dynamics.propagator import evolve, reference_n_steps
from ..gradients.adjoint import _objective
from ..gradients.mc import draw_split_times, mc_grads_per_sample
from ..measure import Measurement
from ..ops.cpx import CP
from ..train.config import TrainConfig
from ..train.energy import make_optimizer
from ..utils.device import resolve_device
from .comm import Axis, all_gather


@dataclasses.dataclass(eq=False)
class Mesh:
    """Named axes over the world's ranks, as this rank sees them:
    ``shape`` maps each axis name to its size (as ``jax.sharding.Mesh``
    does), ``axes`` to its :class:`.comm.Axis`; ``device`` is this rank's
    device."""

    axis_names: tuple
    shape: dict
    axes: dict
    device: torch.device


def _world_rank():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return (int(os.environ.get("WORLD_SIZE", "1")),
            int(os.environ.get("RANK", "0")))


def _init_world(backend: str):
    """Start the default group: from the torchrun environment when it is
    set, else a world of one rank on a FileStore in a temp directory."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ \
            and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    path = os.path.join(tempfile.mkdtemp(prefix="dq_mesh_"), "store")
    dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0,
                            world_size=1)


def make_mesh(axes: dict, devices=None, device="cuda") -> Mesh:
    """A mesh of named axes over the world, e.g. ``make_mesh({"data": 2,
    "state": 2})``; the sizes must multiply to the world size. ``device``
    'cuda' runs NCCL with rank r on card ``LOCAL_RANK`` (default r modulo
    the cards) or ``devices[r]`` when given; 'cpu' runs gloo."""
    names = tuple(axes)
    sizes = tuple(int(v) for v in axes.values())
    n = int(np.prod(sizes)) if sizes else 1
    world, rank = _world_rank()
    if n != world:
        raise ValueError(f"mesh {dict(axes)} needs {n} ranks, the world "
                         f"has {world}")
    dev = resolve_device(device)
    if not dist.is_initialized():
        _init_world("nccl" if dev.type == "cuda" else "gloo")
        world, rank = _world_rank()
    if devices is not None:
        dev = torch.device(devices[rank])
    elif dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    grid = np.arange(n).reshape(sizes)
    coords = np.unravel_index(rank, sizes)
    mesh_axes = {}
    for i, name in enumerate(names):
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        mine = None
        for line in lines:  # every rank creates every group, in order
            ranks = tuple(int(r) for r in line)
            group = dist.new_group(list(ranks)) if sizes[i] > 1 else None
            if rank in ranks:
                mine = (ranks, group)
        mesh_axes[name] = Axis(name, sizes[i], int(coords[i]), *mine)
    return Mesh(names, dict(zip(names, sizes)), mesh_axes, dev)


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
    mesh: Optional[Mesh] = None,
    data_axis: str = "data",
    init_scale: float = 1e-3,
    init_coeffs: Optional[torch.Tensor] = None,
) -> SeedsResult:
    """Train ``n_seeds`` independent pulse initialisations as one batch on
    psi0's device (adjoint gradients by default, ``grad_mode='mc'`` for
    the hardware-realistic estimator), on a structured or a dense
    Hamiltonian, with the exact objective of ``measurement`` (its
    diagonal, target, Pauli strings or matrix). ``init_scale``: stddev of the
    coefficient init, drawn from a ``torch.Generator`` seeded with
    ``config.seed``; ``init_coeffs`` [n_seeds, n_controls, n_basis]
    replaces the draw (the JAX package draws from ``jax.random``, so
    parity runs hand both the same start). ``losses[e, b]`` is seed b's
    exact energy before epoch e's update. With ``mesh``, rank i of its
    ``data_axis`` (of size D, dividing n_seeds) trains seeds
    i n_seeds/D .. (i+1) n_seeds/D - 1 and every rank returns the whole
    result; the split times of MC mode are drawn for all seeds on every
    rank, so they are those of ``mesh=None``."""
    if config.grad_mode not in ("adjoint", "mc"):
        raise ValueError(f"train_energy_seeds takes grad_mode 'adjoint' or "
                         f"'mc', got {config.grad_mode!r}")
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
    lo, n_local, data = 0, n_seeds, None
    if mesh is not None:
        data = mesh.axes[data_axis]
        if n_seeds % data.size:
            raise ValueError(f"{n_seeds} seeds do not split over the "
                             f"{data.size} ranks of axis {data_axis!r}")
        n_local = n_seeds // data.size
        lo = data.index * n_local
        cs = cs[lo:lo + n_local].clone()
    cs.requires_grad_(True)
    opt = make_optimizer(config, [cs])
    draws = torch.Generator(device=dev).manual_seed(config.seed + 1)
    psi_b = CP(psi0.re.expand(n_local, -1), psi0.im.expand(n_local, -1))
    evolve_kw = dict(backend=config.backend, precision=config.precision,
                     t_sample=config.t_sample)
    mc_kw = dict(chain=config.mc_chain, sampling=config.sampling_measure,
                 noisy=config.is_noisy, per_pauli=config.per_pauli,
                 **evolve_kw)

    def energies(c):
        psi = evolve(ham, envelope, c, psi_b, 0.0, T, horizon=T,
                     n_steps=n_steps, **evolve_kw)
        return _objective(measurement, psi)

    def mc_grads(c):
        n = config.mc_samples
        # one sample is mc_energy_grad's uniform draw; more take the
        # strategy, as mc_energy_grad_batch per seed in the JAX package
        s = draw_split_times(config.mc_strategy if n > 1 else "iid", n, T,
                             draws, lead=(n_seeds,))[lo:lo + n_local]
        g = mc_grads_per_sample(ham, envelope, measurement,
                                c.repeat_interleave(n, dim=0), psi0, T,
                                s.reshape(-1), config.n_step, draws,
                                **mc_kw)
        return g.reshape((n_local, n) + tuple(g.shape[1:])).mean(dim=1)

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

    coeffs = cs.detach()
    if losses:
        loss_t = torch.stack(losses)
    else:
        loss_t = torch.zeros((0, n_local), dtype=rdt, device=dev)
    if data is not None:
        loss_t = all_gather(loss_t, data, dim=1)
        coeffs = all_gather(coeffs, data, dim=0)
    losses_np = loss_t.cpu().numpy()
    final = losses_np[-1] if len(losses_np) else np.full(n_seeds, np.nan)
    best = int(np.argmin(final)) if len(losses_np) else 0
    return SeedsResult(coeffs=coeffs, losses=losses_np, best_seed=best,
                       best_loss=float(final[best]))
