"""Control-waveform plotting — the port of
:mod:`diffquantum_tpu.utils.plotting`.

The reference's ``save_plot`` is dead code, disabled by an early
``return``. This is the working version: sample every control envelope
u_k(t) on a grid and save a labeled matplotlib figure. matplotlib is imported lazily and failure to
import degrades to a no-op.
"""
from __future__ import annotations

import numpy as np
import torch


def save_pulse_plot(envelope, coeff, T: float, path: str,
                    n_points: int = 200) -> bool:
    """Render u_k(t) for all controls of ``envelope`` (a simple or a
    channel envelope) to ``path``. Returns True on success."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    c = torch.as_tensor(coeff).detach()
    ts = np.linspace(0.0, T, n_points, endpoint=False)
    with torch.no_grad():
        u = envelope.amplitudes(c, torch.tensor(ts, dtype=c.dtype,
                                                device=c.device), T)
    u = u.cpu().numpy()
    fig, ax = plt.subplots(figsize=(8, 4))
    for k in range(u.shape[0]):
        ax.plot(ts, u[k], label=f"u_{k}")
    ax.set_xlabel("t")
    ax.set_ylabel("drive amplitude")
    ax.legend(loc="upper right", ncol=2, fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True
