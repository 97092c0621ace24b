"""The collectives of the state-sharded engine and the meshed seed
population, over ``torch.distributed`` process groups: what the JAX
package takes from ``shard_map`` (``lax.axis_index``, ``lax.ppermute``
with an XOR permutation, ``lax.psum`` and the transpose rule of inputs
replicated over an axis).

An :class:`Axis` is one named axis of a :class:`.mesh.Mesh` as seen from
this rank: its size, this rank's coordinate on it, the global ranks along
it through this rank, and their process group (None at size 1). Every
function here makes no call into ``torch.distributed`` on an axis of size
1, so a world of one rank runs the engines without communication.

Gradients. Every rank back-propagates the same replicated loss (the
output of :func:`psum`), and two rules keep the gradients those of the
unsharded program:

- :func:`psum`'s backward passes the cotangent through unchanged. The
  cotangent of the psum's output is already the same on every rank;
  summing it again, as ``torch.distributed.nn.functional.all_reduce``
  does, would multiply the gradients by the axis size;
- :func:`replicated` marks an input every rank of an axis holds whole
  (the coefficients, ``P()`` in JAX's ``in_specs``): identity forward,
  and its backward sums the ranks' shares of the gradient over the axis,
  where each rank would otherwise see only its own shard's share.

:func:`exchange`'s backward is the same exchange of the cotangent: the
XOR permutation is its own inverse.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it."""

    name: str
    size: int
    index: int                 # this rank's coordinate on the axis
    ranks: tuple               # global ranks along the axis, by coordinate
    group: Optional[object]    # their ProcessGroup; None at size 1


def axis_index(mesh, axis_name: str) -> int:
    """This rank's coordinate on ``axis_name`` (``lax.axis_index``)."""
    return mesh.axes[axis_name].index


def _swap(tensors: Sequence[torch.Tensor], axis: Axis, mask: int):
    """Send ``tensors`` to the partner ``index ^ mask`` on ``axis`` and
    receive its, in one batch of point-to-point operations."""
    peer = axis.ranks[axis.index ^ mask]
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer, axis.group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, peer, axis.group) for o in outs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, mask, *tensors):
        ctx.axis, ctx.mask = axis, mask
        return tuple(_swap(tensors, axis, mask))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(_swap(grads, ctx.axis, ctx.mask))


def exchange(tensors: Sequence[torch.Tensor], mask: int,
             axis: Axis) -> tuple:
    """The blocks of the partner ``index ^ mask`` on ``axis`` (the JAX
    package's ``ppermute`` with the permutation ``i -> i ^ mask``), one
    per tensor, differentiable. ``mask`` 0 returns the tensors."""
    if not 0 <= mask < axis.size:
        raise ValueError(f"mask {mask} is outside axis {axis.name!r} of "
                         f"size {axis.size}")
    if mask == 0:
        return tuple(tensors)
    return _Exchange.apply(axis, mask, *tensors)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, the same on every rank; its
    backward passes the (replicated) cotangent through unchanged."""
    if axis.size == 1:
        return x
    return _PSum.apply(x, axis.group)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


def replicated(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """``x``, held whole by every rank of ``axes``: identity forward; the
    backward sums the gradient over those axes (JAX's transpose of a
    ``P()`` input of ``shard_map``)."""
    groups = tuple(a.group for a in axes if a.size > 1)
    if not groups or not x.requires_grad:
        return x
    return _Replicated.apply(x, groups)


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``axis``, concatenated on ``dim``
    in axis order, on every rank (not differentiable)."""
    if axis.size == 1:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=dim)
