"""Device selection for the port's entry points.

Entry points take an explicit ``device`` whose default is ``"cuda"``.
Without a card they raise instead of quietly running on the CPU: a CPU
run is asked for by name (``device="cpu"``), as the tests do."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA
    and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
