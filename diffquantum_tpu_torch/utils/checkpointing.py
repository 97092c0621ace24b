"""Checkpoint / resume for training state — the port of
:mod:`diffquantum_tpu.utils.checkpointing`.

The reference has none (SURVEY.md §5: "Training state lives only in
self.spectral_coeff in memory"). The port's format is ``torch.save`` of a
dict of tensors and plain containers (coefficients, the optimizer's
``state_dict``, the ``torch.Generator`` state, the epoch), every tensor
moved to the host first, written to a temporary file and moved into place
with ``os.replace``, so an interrupted write never corrupts the latest
checkpoint. It loads with ``torch.load(weights_only=True)``.
"""
from __future__ import annotations

import os
from typing import Any

import torch


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(directory: str, state: dict, name: str = "ckpt") -> str:
    """Serialize ``state`` (a dict of tensors and plain containers) to
    ``<directory>/<name>.pt`` atomically. Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.pt")
    tmp = path + ".tmp"
    torch.save(_to_host(state), tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(directory: str, name: str = "ckpt") -> dict:
    """The state :func:`save_checkpoint` wrote, its tensors on the host."""
    path = os.path.join(directory, f"{name}.pt")
    return torch.load(path, map_location="cpu", weights_only=True)
