"""Parameters from the JAX package into the port.

:func:`params_from_numpy` turns the JAX package's trainable state — the
spectral coefficients ``[n_controls, n_basis]`` and, optionally, optax
Adam's moments and step count, all as numpy arrays — into a leaf tensor
and the ``torch.optim.Adam`` per-parameter state that continues the same
run. optax's ``mu``/``nu``/``count`` are torch's ``exp_avg``/
``exp_avg_sq``/``step``, and both apply the same bias-corrected update.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils.device import resolve_device


def params_from_numpy(coeff, adam_mu=None, adam_nu=None, step=None,
                      device="cuda"):
    """Returns ``(coeff_tensor, adam_state)``: a leaf tensor of the
    array's dtype that requires grad, on ``device``, and ``None`` or the
    dict to install with ``optimizer.state[coeff_tensor] = adam_state``."""
    dev = resolve_device(device)
    c = torch.tensor(np.asarray(coeff), device=dev, requires_grad=True)
    if adam_mu is None and adam_nu is None and step is None:
        return c, None
    if adam_mu is None or adam_nu is None or step is None:
        raise ValueError("Adam state needs adam_mu, adam_nu and step")
    state = {
        "step": torch.tensor(float(step)),
        "exp_avg": torch.tensor(np.asarray(adam_mu), dtype=c.dtype,
                                device=dev),
        "exp_avg_sq": torch.tensor(np.asarray(adam_nu), dtype=c.dtype,
                                   device=dev),
    }
    return c, state
