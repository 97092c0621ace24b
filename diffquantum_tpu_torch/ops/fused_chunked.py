"""K5: the packed-phase Strang chain at 19-24 qubits, for one state or a
seed population, and its exact adjoint; K4: the same chain in the
per-call form that the state-sharded engine runs one Strang step at a
time.

Port of :mod:`diffquantum_tpu.ops.fused_chunked`. The mega form:
``chunked_evolve_mega`` and ``chunked_evolve_mega_batched`` with their
custom VJPs, whose Pallas kernels are ``_make_mega_fwd`` /
``_make_mega_bwd``. They compute K3's function
(:func:`..fused_product.fused_product_evolve_packed`) on X and Y ops; the
TPU splits the two only because an 18-qubit state fits VMEM and a 19+
one does not. On the card neither fits one SM's shared memory, so both
run on one kernel pair, ``csrc/packed_phase.cu``, whose passes keep the
state in global memory (the TPU layout, ``[C, F, 128]`` slabs streamed
by DMA with ``txa``/``txb`` rows, has no counterpart here).

Contracts, as in the JAX package: :func:`chunked_evolve_mega` takes psi0
CP [d], ud [T, n_diag+1], theta_x [T, n_x];
:func:`chunked_evolve_mega_batched` psi0 [B, d], ud [T, B, n_diag+1],
theta_x [T, B, n_x] (one launch for the whole population); both take
h0th [d] (zero cotangent) and signs [P, d] int32 (none). Gradients are
``_bwd_mega``'s: the merged rows' cotangents summed back onto the T
steps, and d theta_x per step.

The per-call form, :func:`chunked_evolve` (K4; Pallas kernels
``_make_passA_fwd`` / ``_make_passB_fwd`` and their inverses
``_make_passA_bwd`` / ``_make_passB_bwd``), has the single form's
contract and computes K5's function: the JAX package keeps two forms
only because the mega form compiles ~20x faster under Mosaic. Here both
run on the same pass pair. At T = 1, the sharded engine's call, the
chain is the leading half-phase with the step's rotations, then the
trailing half-phase alone (nothing merges across calls).
``K4_FWD_LAUNCHES`` / ``K4_BWD_LAUNCHES`` count its chains.

Dispatch: CPU tensors take the plain version, CUDA tensors launch the
kernel pair. ``K5_FWD_LAUNCHES`` / ``K5_BWD_LAUNCHES`` count the chains
of both mega forms; ``K5_BATCHED_FWD_LAUNCHES`` /
``K5_BATCHED_BWD_LAUNCHES`` the batched form's among them.
"""
from __future__ import annotations

import torch

from .cpx import CP
from .fused_product import (_adjoint_packed_plain, _packed_plan,
                            fused_product_evolve_packed_plain,
                            run_packed_chain)

# The JAX engine's chunk plan. It has no role in the card's kernels, but
# it decides K6's integrator: K6's pass A holds the ops on positions >= c
# (ops/fused_mega_hop.py), so c must be the JAX package's.
_LANE_QUBITS = 7
_F_BITS = 10  # free row bits per pass-A slab on the TPU

K4_FWD_LAUNCHES = 0
K4_BWD_LAUNCHES = 0
K5_FWD_LAUNCHES = 0
K5_BWD_LAUNCHES = 0
K5_BATCHED_FWD_LAUNCHES = 0
K5_BATCHED_BWD_LAUNCHES = 0


def _plan(n_qubits: int):
    """(c, f): the JAX engine's chunk row bits (top) and free row bits
    (``diffquantum_tpu/ops/fused_chunked.py::_plan``)."""
    row_bits = n_qubits - _LANE_QUBITS
    f = min(row_bits, _F_BITS)
    c = row_bits - f
    if c > _F_BITS - 3:  # pass-B block [2^c, Bf, 128] needs Bf >= 8
        raise ValueError(f"chunked engine supports up to "
                         f"{_LANE_QUBITS + _F_BITS + _F_BITS - 3} qubits, "
                         f"got {n_qubits}")
    return c, f


def check_size(n_qubits: int):
    """The JAX engine's size check (:func:`_plan`): 24 qubits at most."""
    _plan(n_qubits)


def _check_kinds(x_qubits, kinds):
    kinds = tuple(kinds) if kinds else ("x",) * len(x_qubits)
    if any(k not in ("x", "y") for k in kinds):
        raise ValueError("the chunked engine takes X and Y ops only (hop "
                         "drive sets at 19-24 qubits run on K6, "
                         "ops/fused_mega_hop.py)")
    return kinds


def _count_k4(backward: bool):
    global K4_FWD_LAUNCHES, K4_BWD_LAUNCHES
    if backward:
        K4_BWD_LAUNCHES += 1
    else:
        K4_FWD_LAUNCHES += 1


def _count_single(backward: bool):
    global K5_FWD_LAUNCHES, K5_BWD_LAUNCHES
    if backward:
        K5_BWD_LAUNCHES += 1
    else:
        K5_FWD_LAUNCHES += 1


def _count_batched(backward: bool):
    global K5_BATCHED_FWD_LAUNCHES, K5_BATCHED_BWD_LAUNCHES
    _count_single(backward)
    if backward:
        K5_BATCHED_BWD_LAUNCHES += 1
    else:
        K5_BATCHED_FWD_LAUNCHES += 1


def _one(psi0: CP, ud, theta_x, what="chunked_evolve_mega") -> tuple:
    """The single form's tensors as a population of one."""
    if psi0.re.ndim != 1 or ud.ndim != 2 or theta_x.ndim != 2:
        raise ValueError(f"{what} takes psi0 [d], ud [T, S], "
                         f"theta_x [T, n_x]; got {tuple(psi0.re.shape)}, "
                         f"{tuple(ud.shape)}, {tuple(theta_x.shape)}")
    return (CP(psi0.re[None], psi0.im[None]), ud[:, None], theta_x[:, None])


def _single_chain(psi0: CP, ud, theta_x, h0th, signs, x_qubits: tuple,
                  n_qubits: int, kinds, count, what: str) -> CP:
    """One state's packed chain through :func:`run_packed_chain`, as a
    population of one, counted by ``count``."""
    check_size(n_qubits)
    kinds = _check_kinds(x_qubits, kinds)
    p, u, t = _one(psi0, ud, theta_x, what)
    out = run_packed_chain(p, u, t, h0th, signs,
                           _packed_plan(x_qubits, kinds, n_qubits),
                           len(x_qubits), n_qubits, count, what)
    return CP(out.re[0], out.im[0])


def chunked_evolve(psi0: CP, ud: torch.Tensor, theta_x: torch.Tensor,
                   h0th: torch.Tensor, signs: torch.Tensor, x_qubits: tuple,
                   n_qubits: int, kinds: tuple = None,
                   fast_math: bool = False) -> CP:
    """K4: psi(T) of one state through the packed chain, differentiable in
    psi0, ud and theta_x; the JAX package's per-call form.

    psi0: CP [2^n] f32; ud: [T, n_diag+1] scaled diagonal controls (slot
    k = dt/2 u_k w_k, the last slot the offset); theta_x: [T, n_x]; h0th:
    [2^n] drift half-angles (zero cotangent); signs: [P, 2^n] int32 sign
    bit-planes (no cotangent); kinds 'x' or 'y'. Tables are contiguous (a
    slice of ``signs`` along the amplitudes is not until copied).
    ``fast_math`` changes nothing. One chain of pass launches on the card
    (and one for the adjoint), counted in ``K4_FWD_LAUNCHES`` /
    ``K4_BWD_LAUNCHES``."""
    del fast_math
    return _single_chain(psi0, ud, theta_x, h0th, signs, x_qubits,
                         n_qubits, kinds, _count_k4, "K4")


def chunked_evolve_mega(psi0: CP, ud: torch.Tensor, theta_x: torch.Tensor,
                        h0th: torch.Tensor, signs: torch.Tensor,
                        x_qubits: tuple, n_qubits: int, kinds: tuple = None,
                        fast_math: bool = False) -> CP:
    """The whole packed chain of one state [2^n] as one chain of pass
    launches (and one for the adjoint), differentiable in psi0, ud and
    theta_x. ``fast_math`` changes nothing (no matmul to truncate)."""
    del fast_math
    return _single_chain(psi0, ud, theta_x, h0th, signs, x_qubits,
                         n_qubits, kinds, _count_single, "K5")


def chunked_evolve_mega_batched(psi0: CP, ud: torch.Tensor,
                                theta_x: torch.Tensor, h0th: torch.Tensor,
                                signs: torch.Tensor, x_qubits: tuple,
                                n_qubits: int, kinds: tuple = None,
                                fast_math: bool = False) -> CP:
    """Seed-batched :func:`chunked_evolve_mega`: psi0 CP [B, 2^n], ud
    [T, B, n_diag+1], theta_x [T, B, n_x], per-seed pulses, one chain of
    launches for the whole population (grid: blocks x B)."""
    del fast_math
    check_size(n_qubits)
    kinds = _check_kinds(x_qubits, kinds)
    return run_packed_chain(psi0, ud, theta_x, h0th, signs,
                            _packed_plan(x_qubits, kinds, n_qubits),
                            len(x_qubits), n_qubits, _count_batched,
                            "K5 batched")


def chunked_evolve_mega_plain(psi0: CP, ud, theta_x, h0th, signs,
                              x_qubits: tuple, n_qubits: int,
                              kinds: tuple = None) -> CP:
    """K5's forward (single form) in plain PyTorch, any device."""
    check_size(n_qubits)
    kinds = _check_kinds(x_qubits, kinds)
    out = fused_product_evolve_packed_plain(*_one(psi0, ud, theta_x), h0th,
                                            signs, x_qubits, n_qubits, kinds)
    return CP(out.re[0], out.im[0])


def chunked_evolve_mega_batched_plain(psi0: CP, ud, theta_x, h0th, signs,
                                      x_qubits: tuple, n_qubits: int,
                                      kinds: tuple = None) -> CP:
    """K5's forward (batched form) in plain PyTorch, any device."""
    check_size(n_qubits)
    return fused_product_evolve_packed_plain(
        psi0, ud, theta_x, h0th, signs, x_qubits, n_qubits,
        _check_kinds(x_qubits, kinds))


def _adjoint_mega_plain(psi_T: CP, lam: CP, ud, theta_x, h0th, signs,
                        x_qubits: tuple, n_qubits: int, kinds: tuple = None):
    """K5's backward in plain PyTorch, either form (by psi_T's rank):
    (dpsi0 CP, d ud, d theta_x) in the shapes of the inputs."""
    check_size(n_qubits)
    kinds = _check_kinds(x_qubits, kinds)
    if psi_T.re.ndim == 2:
        return _adjoint_packed_plain(psi_T, lam, ud, theta_x, h0th, signs,
                                     x_qubits, n_qubits, kinds)
    p, u, t = _one(psi_T, ud, theta_x)
    gp, gud, gtx = _adjoint_packed_plain(p, CP(lam.re[None], lam.im[None]),
                                         u, t, h0th, signs, x_qubits,
                                         n_qubits, kinds)
    return CP(gp.re[0], gp.im[0]), gud[:, 0], gtx[:, 0]


# K4 computes K5's function: its plain versions are the single form's.
chunked_evolve_plain = chunked_evolve_mega_plain
_adjoint_chunked_plain = _adjoint_mega_plain
