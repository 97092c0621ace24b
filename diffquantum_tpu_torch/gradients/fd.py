"""Central finite-difference gradients — the port of
:mod:`diffquantum_tpu.gradients.fd`, the reference's comparison baseline
(``compute_energy_grad_FD``, `sim_plain.py:308-353`): for every
coefficient (k, j), two forward simulations at ``c ± delta e_kj`` and
``(E_p - E_m) / (2 delta)``.

All ``2 * n_params`` perturbed simulations run as ONE batched
evolution with per-member coefficients (on the card, one K2 forward of
288 members for the 12-qubit ring MaxCut), not a loop. From 18 qubits
up the members may not fit at once (the 24-qubit ring's 576 members are
74 GB of states), so they run in chunks sized from the card's free
memory (:func:`fd_chunk_size`), one batched K3/K5 forward each, with
the same result member for member. Like the JAX package, it integrates
over the true horizon [0, T] (the reference's FD path fixes its grid to
[0, 1], `sim_plain.py:320`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dynamics import product
from ..dynamics.propagator import evolve
from ..measure import Measurement, measure
from ..ops.cpx import CP

# A member's working set in f32 state pairs (its state in and out, the
# measurement's temporaries), and the share of free card memory the
# chunks may take.
FD_MEMBER_STATES = 6
FD_MEMORY_SHARE = 0.5


def fd_chunk_size(ham, n_members: int, device) -> int:
    """Members per batched evolution: all of them below 18 qubits or off
    the card, else as many as ``FD_MEMORY_SHARE`` of the card's free
    memory holds at ``FD_MEMBER_STATES`` state pairs a member."""
    device = torch.device(device)
    if device.type != "cuda" or ham.n_qubits < product._PACKED_MIN_QUBITS:
        return n_members
    free, _ = torch.cuda.mem_get_info(device)
    per_member = FD_MEMBER_STATES * 8 * ham.dim
    return max(1, min(n_members, int(FD_MEMORY_SHARE * free) // per_member))


def fd_energies(ham, envelope, measurement: Measurement,
                all_coeffs: torch.Tensor, psi0: CP, T: float,
                generator: Optional[torch.Generator], n_steps: int,
                chunk: int, sampling: bool = False, noisy: bool = False,
                per_pauli: int = 100, **evolve_kw) -> torch.Tensor:
    """The measured energy of each coefficient set of ``all_coeffs``
    [M, ...] from psi0, evolved ``chunk`` members at a time (one batched
    evolution each); [M]."""
    out = []
    for lo in range(0, all_coeffs.shape[0], chunk):
        cs = all_coeffs[lo:lo + chunk]
        batch = CP(psi0.re.expand(cs.shape[0], -1),
                   psi0.im.expand(cs.shape[0], -1))
        psi = evolve(ham, envelope, cs, batch, 0.0, T, horizon=T,
                     n_steps=n_steps, **evolve_kw)
        out.append(measure(measurement, psi, generator, sampling, noisy,
                           per_pauli))
        del psi
    return torch.cat(out)


def fd_energy_grad(ham, envelope, measurement: Measurement,
                   coeff: torch.Tensor, psi0: CP, T: float,
                   generator: Optional[torch.Generator], n_steps: int,
                   backend: str = "auto", delta: float = 1e-3,
                   sampling: bool = False, noisy: bool = False,
                   per_pauli: int = 100, precision: str = "full",
                   t_sample: str = "left") -> torch.Tensor:
    """Central-difference gradient over all coefficients, one batched
    evolution (or chunks of :func:`fd_chunk_size` members); shaped like
    ``coeff``. ``generator`` draws the shots and noise of a sampled or
    noisy measurement (None when exact)."""
    shape = coeff.shape
    n_params = coeff.numel()
    flat = coeff.reshape(-1)
    eye = torch.eye(n_params, dtype=coeff.dtype, device=coeff.device) * delta
    all_coeffs = torch.cat([flat[None, :] + eye, flat[None, :] - eye],
                           dim=0).reshape((2 * n_params,) + tuple(shape))
    chunk = fd_chunk_size(ham, 2 * n_params, psi0.re.device)
    e = fd_energies(ham, envelope, measurement, all_coeffs, psi0, T,
                    generator, n_steps, chunk, sampling=sampling,
                    noisy=noisy, per_pauli=per_pauli, backend=backend,
                    precision=precision, t_sample=t_sample)
    return ((e[:n_params] - e[n_params:]) / (2.0 * delta)).reshape(
        shape).to(coeff.dtype)
