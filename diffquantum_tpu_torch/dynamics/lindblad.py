"""Open-system (Lindblad) dynamics: the master equation and quantum-jump
trajectories — the port of :mod:`diffquantum_tpu.dynamics.lindblad`.

    drho/dt = -i [H(t), rho] + sum_k ( c_k rho c_k^dag
                                       - 1/2 {c_k^dag c_k, rho} )

Engines, sharing the pulse and Hamiltonian stack:

- :func:`evolve_lindblad`: rho(T) by per-step ``exp(dt L)`` with a
  truncated Taylor series of the matrix-free Lindbladian (batched [m, d, d]
  products, ``torch.matmul`` on complex tensors, one product where the
  real pairs take four; the superoperator is never built), dense
  operators;
- :func:`evolve_lindblad_structured`: the Strang split of the Lindbladian
  into exact per-qubit channel maps and the structured unitary step, for
  structure-only Hamiltonians: no dense operator anywhere, O(d^2) state;
- :func:`evolve_dephasing_trajectories`: pure dephasing as unitary
  trajectories with Gaussian Z kicks (pathwise gradients);
- :func:`evolve_mcwf_structured`: quantum-jump trajectories on the
  product engine, with ``return_logp`` for :func:`score_surrogate`'s
  unbiased gradient; ``backend='fused'`` runs the trajectories in
  lockstep through one K2 launch a step (:func:`..ops.fused_product.
  fused_rot_block`), 10-17 qubits;
- :func:`evolve_mcwf`: quantum-jump trajectories with dense operators;
  the no-jump branch ``exp(dt (-i H - K/2)) psi`` is one
  :func:`..ops.taylor_apply.taylor_apply` step over all trajectories, K7
  on the card where :func:`..ops.taylor_apply.apply_route` names it.

Every step of the differentiable engines is checkpointed
(``torch.utils.checkpoint``), as the JAX package's scans are. In the
structured master equation the unitary part of a step is one autograd
function whose backward rebuilds each intermediate rho from the step's
output by the inverse rotation (exact: the ops are unitary), so a step's
recomputation holds a few rho-sized buffers, not one per rotation.

Random draws: the samplers take a ``torch.Generator`` where the JAX
functions take a key, and an optional ``draws`` holding their random
inputs in natural form (:class:`McwfDraws`, or the dephasing kicks
``xi``), so that a caller can replay a given set of draws: the jump
channel is ``argmax(log(w + eps) + gumbel)``, which is what
``jax.random.categorical`` computes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops import cpx
from ..ops.cpx import CP
from ..ops.expm import taylor_params
from ..utils.device import resolve_device
from .hamiltonian import ControlledHamiltonian, spectral_norm_bound
from .propagator import _amplitude_bound

def _taped(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def _run_step(step, taped: bool, *args):
    if taped:
        return checkpoint(step, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return step(*args)


@dataclasses.dataclass(frozen=True, eq=False)
class CollapseSet:
    """Stacked collapse operators c_k (CP [m, d, d]) with their static
    norms and the precomputed Hermitian ``K = sum_k c_k^dag c_k``."""

    ops: CP             # [m, d, d]
    k_op: CP            # [d, d]
    norms: tuple        # per-op spectral norms

    @classmethod
    def create(cls, c_ops: Sequence, dtype=torch.float32,
               device="cuda") -> "CollapseSet":
        """From host (complex) numpy operators, on ``device``."""
        dev = resolve_device(device)
        mats = [np.asarray(c, dtype=np.complex128) for c in c_ops]
        if not mats:
            raise ValueError("CollapseSet needs at least one operator; use "
                             "the unitary engines for closed systems")
        k = sum(c.conj().T @ c for c in mats)
        return cls(ops=cpx.from_complex(np.stack(mats), dtype=dtype,
                                        device=dev),
                   k_op=cpx.from_complex(k, dtype=dtype, device=dev),
                   norms=tuple(spectral_norm_bound(c) for c in mats))

    @property
    def k_norm(self) -> float:
        return float(sum(n * n for n in self.norms))


# ---------------------------------------------------------------------------
# standard single-qubit noise channels (embedded at site `qubit` of n)
def amplitude_damping(gamma: float, qubit: int, n: int) -> np.ndarray:
    """sqrt(gamma) |0><1| at `qubit` (T1 relaxation toward |0>)."""
    from ..ops.linalg import op_on_qubits
    sm = np.array([[0.0, 1.0], [0.0, 0.0]])
    return np.sqrt(gamma) * op_on_qubits(sm, [qubit], n)


def dephasing(gamma: float, qubit: int, n: int) -> np.ndarray:
    """sqrt(gamma/2) Z at `qubit` (pure dephasing, T2)."""
    from ..ops.linalg import op_on_qubits
    z = np.diag([1.0, -1.0])
    return np.sqrt(gamma / 2.0) * op_on_qubits(z, [qubit], n)


# ---------------------------------------------------------------------------
# the dense master equation
# ---------------------------------------------------------------------------

def _lindblad_apply(lefts, rights, rho):
    """L[rho] = -i[H, rho] + sum_k c rho c^dag - 1/2 {K, rho}, matrix-free,
    on complex tensors: ``sum_j l_j rho r_j`` over the pairs (l, r) =
    (A, I), (I, A^dag), (c_k, c_k^dag) with ``A = -i H - K/2``: the l_j
    stacked as rows [(m + 2) d, d] (one product), the r_j as [m + 2, d,
    d] (one batched product), and a sum."""
    d = rho.shape[-1]
    return torch.bmm((lefts @ rho).view(-1, d, d), rights).sum(0)


def lindblad_norm_bound(ham: ControlledHamiltonian, envelope,
                        c: CollapseSet) -> float:
    """Static bound on the superoperator norm: 2||H|| + 2 sum ||c_k||^2."""
    return 2.0 * ham.norm_bound(_amplitude_bound(envelope)) + 2.0 * c.k_norm


def _dense_only(ham: ControlledHamiltonian, what: str, why: str = ""):
    if ham.is_structured_only:
        raise ValueError(f"{what} needs dense operators{why}; build the "
                         "problem with dense matrices (dense=True), or use "
                         "the structured engines")


def evolve_lindblad(ham: ControlledHamiltonian, envelope,
                    coeff: torch.Tensor, rho0: CP, c_ops: CollapseSet, T0, T,
                    horizon: float, n_steps: int, tol: float = 1e-7,
                    t_sample: str = "left") -> CP:
    """rho(T) by per-step ``exp(dt L)``: ``2^s`` substeps of ``order``
    Taylor terms of the matrix-free Lindbladian, both fixed from
    :func:`lindblad_norm_bound` (:func:`..ops.expm.taylor_params`), in
    ``ham.dtype`` on rho0's device. Differentiable in ``coeff``; each
    step is checkpointed. Same left-endpoint grid as
    :func:`.propagator.evolve`."""
    from .product import _amplitudes
    _dense_only(ham, "evolve_lindblad", " (the dissipator is a dense "
                "superoperator contraction)")
    dt, u = _amplitudes(envelope, coeff, T0, T, horizon, n_steps, t_sample)
    a_bound = (float(horizon) / n_steps) * lindblad_norm_bound(
        ham, envelope, c_ops)
    order, s = taylor_params(a_bound, tol)
    r = 2**s
    rdt = ham.dtype
    h = ham.at(u.transpose(-1, -2).to(rdt))              # [T, d, d]
    zr = dt / r
    c = torch.complex(c_ops.ops.re, c_ops.ops.im)
    c_h = c.conj().transpose(-1, -2).resolve_conj().contiguous()
    d = c.shape[-1]
    eye = torch.eye(d, dtype=c.dtype, device=c.device)[None]
    k_half = 0.5 * torch.complex(c_ops.k_op.re, c_ops.k_op.im)

    def step(re, im, h_re, h_im):
        a = (torch.complex(h_im, -h_re) - k_half)[None]    # -i H - K/2
        lefts = torch.cat([a, eye, c]).view(-1, d)
        rights = torch.cat([eye, a.conj().transpose(-1, -2), c_h])
        rho = torch.complex(re, im)
        for _ in range(r):
            term = acc = rho
            for k in range(1, order + 1):
                term = _lindblad_apply(lefts, rights, term) * (zr / k)
                acc = acc + term
            rho = acc
        return rho.real, rho.imag

    rho = rho0.astype(rdt)
    re, im = rho.re, rho.im
    taped = _taped(re, im, h.re, h.im)
    for h_re, h_im in zip(h.re.unbind(0), h.im.unbind(0)):
        re, im = _run_step(step, taped, re, im, h_re, h_im)
    return CP(re, im)


# ---------------------------------------------------------------------------
# readouts
# ---------------------------------------------------------------------------

def expectation_rho(m, rho: CP) -> torch.Tensor:
    """tr(M rho): a real diagonal vector m, a CP dense m, or a Measurement
    (diagonal, dense, Pauli-string and target forms)."""
    if isinstance(m, CP):
        prod = cpx.matmul(m, rho)
        return torch.diagonal(prod.re, dim1=-2, dim2=-1).sum(-1)
    if hasattr(m, "diag") and hasattr(m, "matrix"):   # Measurement
        if m.diag is not None:
            return _diag_expectation(m.diag, rho)
        if getattr(m, "strings", None) is not None:
            return strings_expectation_rho(m.strings, rho)
        if getattr(m, "target", None) is not None:
            # tr(|t><t| rho) = <t| rho |t>
            t = m.target.astype(rho.dtype)
            return cpx.vdot(t, cpx.matvec(rho, t)).re
        if m.matrix is None:
            raise ValueError("Measurement has no operator form usable on a "
                             "density matrix")
        return expectation_rho(m.matrix, rho)
    return _diag_expectation(m, rho)


def _diag_expectation(diag, rho: CP) -> torch.Tensor:
    w = torch.as_tensor(diag, dtype=rho.dtype, device=rho.device)
    return torch.sum(w * torch.diagonal(rho.re, dim1=-2, dim2=-1), dim=-1)


def strings_expectation_rho(strings, rho: CP) -> torch.Tensor:
    """sum_t w_t tr(P_t rho), matrix-free: with each string's signed
    permutation form P|l> = f(l)|l xor m> (:class:`..measure.
    PauliStringSet`), tr(P rho) = sum_k f(k xor m) rho[k xor m, k], one
    gather a term."""
    from ..measure import _bit_parity
    d = 2**strings.n_qubits
    j = torch.arange(d, dtype=torch.int64, device=rho.device)
    w = strings.weights.to(dtype=rho.dtype, device=rho.device)
    total = torch.zeros((), dtype=rho.dtype, device=rho.device)
    for t in range(len(strings.flips)):
        jp = j ^ strings.flips[t]
        s = (1.0 - 2.0 * _bit_parity(jp & strings.yz_masks[t])).to(rho.dtype)
        g_re = torch.sum(s * rho.re[jp, j])
        g_im = torch.sum(s * rho.im[jp, j])
        e = (g_re, -g_im, -g_re, g_im)[strings.n_ys[t] % 4]
        total = total + w[t] * e
    return total


def density_from_trajectories(psis: CP) -> CP:
    """Mean |psi><psi| over a trajectory batch CP [n_traj, d]."""
    n = psis.re.shape[0]
    re = (psis.re.T @ psis.re + psis.im.T @ psis.im) / n
    im = (psis.im.T @ psis.re - psis.re.T @ psis.im) / n
    return CP(re, im)


def score_surrogate(values: torch.Tensor, logps: torch.Tensor) -> torch.Tensor:
    """Surrogate scalar for trajectory-ensemble objectives whose VALUE is
    exactly ``mean(values)`` and whose GRADIENT is the unbiased hybrid
    pathwise + score-function estimator

        d/dth E[L] = E[ dL/dth |_outcomes  +  (L - b) d log P(outcomes)/dth ]

    with a leave-one-out baseline ``b_i = mean_{j != i} L_j`` (unbiased,
    where a batch-mean baseline would correlate with its own sample).

    values: [n_traj] per-trajectory losses, differentiable in the pulse
    parameters (the pathwise part); logps: [n_traj] from
    ``evolve_mcwf_structured(..., return_logp=True)``. Differentiate the
    result like an ordinary loss."""
    n = values.shape[0]
    v_sg = values.detach()
    if n > 1:
        baseline = (torch.sum(v_sg) - v_sg) / (n - 1)
    else:
        baseline = torch.zeros_like(v_sg)
    # (logps - logps.detach()) is 0 in value, d(logps)/dth in gradient
    score = (v_sg - baseline) * (logps - logps.detach())
    return torch.mean(values + score)


# ---------------------------------------------------------------------------
# structured noise and the structured master equation
# ---------------------------------------------------------------------------

class StructuredNoise:
    """Per-qubit noise channels for structured (matrix-free) engines:
    amplitude damping (T1, ``c_q = sqrt(g1) |0><1|_q``) and pure dephasing
    (``c_q = sqrt(gphi/2) Z_q``). For these channels ``K = sum c^dag c`` is
    diagonal, ``sum_q g1_q n_q + sum_q gphi_q/2``, so the non-Hermitian
    part of H_eff folds into the Strang phase block as a real decay, and
    every jump is a masked gather or a sign flip."""

    def __init__(self, n_qubits: int, t1=(), dephasing=()):
        """t1 / dephasing: sequences of (qubit, gamma)."""
        self.n_qubits = int(n_qubits)
        self.t1 = tuple((int(q), float(g)) for q, g in t1)
        self.dephasing = tuple((int(q), float(g)) for q, g in dephasing)
        if not self.t1 and not self.dephasing:
            raise ValueError("StructuredNoise needs at least one channel")

    def k_diag(self) -> np.ndarray:
        """Diagonal of K = sum_k c_k^dag c_k (length 2^n, host numpy)."""
        d = 2**self.n_qubits
        j = np.arange(d)
        out = np.zeros(d)
        for q, g in self.t1:
            bit = 1 << (self.n_qubits - 1 - q)
            out += g * ((j & bit) > 0)
        for _, g in self.dephasing:
            out += 0.5 * g
        return out

    @property
    def k_norm(self) -> float:
        return float(np.max(self.k_diag()))

    def dense_collapse_ops(self):
        """Dense c_k list (for small-n oracle cross-checks)."""
        return ([amplitude_damping(g, q, self.n_qubits)
                 for q, g in self.t1]
                + [dephasing(g, q, self.n_qubits)
                   for q, g in self.dephasing])


def _qubit_view(x: torch.Tensor, qubit: int, n: int) -> torch.Tensor:
    """rho [d, d] as [left, 2, right, left, 2, right] over ``qubit``'s row
    and column bits."""
    left, right = 2**qubit, 2 ** (n - qubit - 1)
    return x.reshape(left, 2, right, left, 2, right)


def _rho_phase(rho: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """rho <- diag(e^{-i th}) rho diag(e^{+i th}) on complex rho [d, d]:
    rho_ij e^{-i th_i} e^{+i th_j}."""
    p = torch.polar(torch.ones_like(theta), -theta)
    return rho * p[:, None] * p.conj()[None, :]


def _apply_axis(rho: torch.Tensor, m: torch.Tensor, qubit: int, n: int,
                axis: int) -> torch.Tensor:
    """Contract a complex 2x2 matrix with the ``qubit`` tensor slot of the
    row (axis=0) or column (axis=1) index of complex rho [d, d]:
    axis=0: y[i,:] = sum_b M[a_i, b] rho[b,:]; axis=1: y[:,j] = sum_b
    rho[:,b] M[b, a_j]. Elementwise on the two halves of the [left, 2,
    right d] (rows) or [d left, 2, right] (columns) view: a batched
    product with an inner dimension of 2 runs far below the card's
    memory rate."""
    d = rho.shape[0]
    left, right = 2**qubit, 2 ** (n - qubit - 1)
    if axis == 0:
        x = rho.reshape(left, 2, right * d)
    else:
        x, m = rho.reshape(d * left, 2, right), m.transpose(0, 1)
    x0, x1 = x[:, 0], x[:, 1]
    return torch.stack([m[0, 0] * x0 + m[0, 1] * x1,
                        m[1, 0] * x0 + m[1, 1] * x1], dim=1).reshape(d, d)


def _rho_1q_rot(rho: torch.Tensor, theta, qubit: int, n: int,
                g: torch.Tensor) -> torch.Tensor:
    """rho <- U rho U^dag, U = exp(-i th G) = cos th I - i sin th G for an
    involutory G (complex 2x2) on ``qubit``."""
    eye = torch.eye(2, dtype=g.dtype, device=g.device)
    u = torch.cos(theta) * eye - 1j * torch.sin(theta) * g
    rho = _apply_axis(rho, u, qubit, n, axis=0)
    return _apply_axis(rho, u.conj().transpose(0, 1), qubit, n, axis=1)


class _UnitaryBlock(torch.autograd.Function):
    """The unitary part of a structured master-equation step on complex
    rho, rho <- P R_k .. R_1 P rho (.)^dag with P = diag(e^{-i theta_half})
    and R_i = exp(-i alpha_i G_i) on qubit q_i. Saves only its output: the
    backward walks the ops in reverse, rebuilding each op's output from
    the next by the inverse conjugation, with

        d/d theta_k = sum_j Im(conj(g) rho)_kj - sum_i Im(conj(g) rho)_ik,
        d/d alpha_i = sum Im(conj(g) (G rho - rho G)),

    rho the op's output and g its cotangent (dL/d re + i dL/d im); the
    cotangent moves back by the adjoint map, the inverse conjugation (the
    ops are unitary)."""

    @staticmethod
    def forward(ctx, rho, theta, alphas, ops, n):
        out = _rho_phase(rho, theta)
        for i, (q, g) in enumerate(ops):
            out = _rho_1q_rot(out, alphas[i], q, n, g)
        out = _rho_phase(out, theta)
        ctx.save_for_backward(out, theta, alphas)
        ctx.static = (ops, n)
        return out

    @staticmethod
    def backward(ctx, g):
        rho, theta, alphas = ctx.saved_tensors
        ops, n = ctx.static
        g_alpha = torch.zeros_like(alphas)

        def phase_grad(rho, g):
            # row sums minus column sums of Im(conj(g) rho)
            return (torch.linalg.vecdot(g, rho, dim=1)
                    - torch.linalg.vecdot(g, rho, dim=0)).imag

        def im_vdot(a, b):
            return torch.vdot(a.reshape(-1), b.reshape(-1)).imag

        g_theta = phase_grad(rho, g)
        rho, g = _rho_phase(rho, -theta), _rho_phase(g, -theta)
        for i in range(len(ops) - 1, -1, -1):
            q, gen = ops[i]
            # one product at a time, so that a single rho-sized
            # temporary is alive beside rho and g
            g_alpha[i] = im_vdot(g, _apply_axis(rho, gen, q, n, axis=0)) \
                - im_vdot(g, _apply_axis(rho, gen, q, n, axis=1))
            rho = _rho_1q_rot(rho, -alphas[i], q, n, gen)
            g = _rho_1q_rot(g, -alphas[i], q, n, gen)
        g_theta = g_theta + phase_grad(rho, g)
        return _rho_phase(g, -theta), g_theta, g_alpha, None, None


def _channel_half(rho: torch.Tensor, noise: StructuredNoise,
                  tau) -> torch.Tensor:
    """Exact per-qubit noise channels applied to complex rho for time
    ``tau``:

    - pure dephasing (c = sqrt(g/2) Z): coherences whose row and column
      differ in the qubit's bit decay by e^{-g tau};
    - amplitude damping (c = sqrt(g) |0><1|): the exact Kraus map, a
      scale of eta^{(row bit)+(col bit)} (eta = e^{-g tau / 2}) and the
      population transfer rho[i0, j0] += (1 - eta^2) rho[i1, j1].

    Each is a [2, 2] factor on the qubit's (row bit, column bit) block of
    the [left, 2, right, left, 2, right] view, so autograd keeps no
    [d, d] mask. Channels on distinct qubits commute."""
    n = noise.n_qubits
    tau = torch.as_tensor(tau, dtype=rho.real.dtype, device=rho.device)
    for q, g in noise.dephasing:
        e = torch.exp(-g * tau)
        one = torch.ones_like(e)
        f = torch.stack([torch.stack([one, e]), torch.stack([e, one])])
        rho = (_qubit_view(rho, q, n) * f.reshape(1, 2, 1, 1, 2, 1)
               ).reshape(rho.shape)
    for q, g in noise.t1:
        eta = torch.exp(-0.5 * g * tau)
        v = _qubit_view(rho, q, n)
        b00 = v[:, 0, :, :, 0, :] + (1.0 - eta * eta) * v[:, 1, :, :, 1, :]
        b01 = eta * v[:, 0, :, :, 1, :]
        b10 = eta * v[:, 1, :, :, 0, :]
        b11 = (eta * eta) * v[:, 1, :, :, 1, :]
        rho = torch.stack([torch.stack([b00, b01], dim=3),
                           torch.stack([b10, b11], dim=3)], dim=1
                          ).reshape(rho.shape)
    return rho


def _structured_inputs(ham, envelope, coeff, T0, T, horizon, n_steps,
                       t_sample, noise, hop_msg):
    """(dt, (u_diag, u_oneq) [k, T] in ham.dtype, diag_table, h0_vec,
    oneq_qubits, oneq_locals) of the structured engines, on coeff's
    device."""
    from .product import _amplitudes, _control_rows, _tables, split_structure
    (_, _, _, _, oneq_qubits, oneq_locals) = split_structure(
        ham, hop_msg=hop_msg)
    if noise.n_qubits != ham.n_qubits:
        raise ValueError("noise qubit count mismatch")
    dt, u = _amplitudes(envelope, coeff, T0, T, horizon, n_steps, t_sample)
    u_diag, u_oneq, _ = _control_rows(ham, u, ham.dtype)
    diag_table, h0_vec = _tables(ham, ham.dtype, u.device)
    return dt, u_diag, u_oneq, diag_table, h0_vec, oneq_qubits, oneq_locals


def _rotation_order(oneq_qubits, dt):
    """(op order, angle factor): palindromic half angles when two drives
    share a qubit, as in the product engine."""
    m = len(oneq_qubits)
    if len(set(oneq_qubits)) < m:
        return list(range(m)) + list(reversed(range(m))), 0.5 * dt
    return list(range(m)), dt


def _generators(oneq_locals, dtype, device):
    """The 1q generators as complex 2x2 tensors of the real ``dtype``'s
    complex twin."""
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    return [torch.as_tensor(np.asarray(g), dtype=cdt, device=device)
            for g in oneq_locals]


def evolve_lindblad_structured(ham, envelope, coeff: torch.Tensor, rho0: CP,
                               noise: StructuredNoise, T0, T, horizon: float,
                               n_steps: int, t_sample: str = "left") -> CP:
    """Differentiable master-equation evolution for structured problems:
    the Strang split of the Lindbladian into (exact per-qubit channel
    maps, half time) x (structured unitary step, two-sided) x (channel
    maps, half time), O(dt^3) local error like the closed-system product
    engine, O(d^2) state and O(n d^2) elementwise work a step, no dense
    operator. rho is complex inside (one tensor, where the real pairs take
    two). Each step is checkpointed; its unitary part rebuilds its
    intermediates in the backward (:class:`_UnitaryBlock`), so autograd
    keeps about one rho a step (14 qubits: rho is 2 GiB in float32)."""
    rdt = ham.dtype
    dt, u_diag, u_oneq, diag_table, h0_vec, oneq_qubits, oneq_locals = \
        _structured_inputs(ham, envelope, coeff, T0, T, horizon, n_steps,
                           t_sample, noise, "evolve_lindblad_structured "
                           "does not support 'hop' (XX+YY) terms yet")
    n = ham.n_qubits
    dev = u_diag.device
    order, frac = _rotation_order(oneq_qubits, dt)
    gens = _generators(oneq_locals, rdt, dev)
    ops = tuple((oneq_qubits[i], gens[i]) for i in order)
    order_idx = torch.tensor(order, dtype=torch.long, device=dev)
    half = 0.5 * dt

    def step(rho, ud, uq):
        rho = _channel_half(rho, noise, half)
        theta_half = half * (h0_vec + torch.matmul(ud, diag_table))
        alphas = frac * uq.index_select(0, order_idx)
        rho = _UnitaryBlock.apply(rho, theta_half, alphas, ops, n)
        return _channel_half(rho, noise, half)

    rho0 = rho0.astype(rdt)
    rho = torch.complex(rho0.re.to(dev), rho0.im.to(dev))
    taped = _taped(rho, u_diag, u_oneq)
    for ud, uq in zip(u_diag.unbind(-1), u_oneq.unbind(-1)):
        rho = _run_step(step, taped, rho, ud, uq)
    return CP(rho.real, rho.imag)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

class McwfDraws(NamedTuple):
    """The per-step random inputs of the MCWF samplers: ``uniform``
    [n_steps, n_traj] for the jump decision (jump when below the step's
    jump probability) and ``gumbel`` [n_steps, n_traj, n_ch] for the
    channel (``argmax(log(w + eps) + gumbel)``)."""

    uniform: torch.Tensor
    gumbel: torch.Tensor


def draw_mcwf(generator: torch.Generator, n_steps: int, n_traj: int,
              n_ch: int, dtype=torch.float32) -> McwfDraws:
    """Fresh :class:`McwfDraws` from ``generator``, on its device."""
    kw = dict(generator=generator, dtype=dtype, device=generator.device)
    uni = torch.rand((n_steps, n_traj), **kw)
    tiny = torch.finfo(dtype).tiny
    g = torch.rand((n_steps, n_traj, n_ch), **kw).clamp_(min=tiny)
    return McwfDraws(uni, -torch.log(-torch.log(g)))


def _mcwf_draws(draws, generator, n_steps, n_traj, n_ch, dtype, device):
    if draws is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the draws")
        draws = draw_mcwf(generator, n_steps, n_traj, n_ch, dtype)
    uni, gum = draws
    if tuple(uni.shape) != (n_steps, n_traj) \
            or tuple(gum.shape) != (n_steps, n_traj, n_ch):
        raise ValueError(
            f"draws must be uniform [{n_steps}, {n_traj}] and gumbel "
            f"[{n_steps}, {n_traj}, {n_ch}], got {tuple(uni.shape)} and "
            f"{tuple(gum.shape)}")
    return (uni.to(dtype=dtype, device=device),
            gum.to(dtype=dtype, device=device))


def evolve_dephasing_trajectories(ham, envelope, coeff: torch.Tensor,
                                  psi0: CP, noise: StructuredNoise, T0, T,
                                  horizon: float, n_steps: int,
                                  generator: Optional[torch.Generator] = None,
                                  n_traj: int = 1, t_sample: str = "left",
                                  xi: Optional[torch.Tensor] = None) -> CP:
    """Pure-dephasing open dynamics as an ensemble of unitary trajectories
    with random Z phases, exact in distribution and differentiable.

    A dephasing channel (c = sqrt(g/2) Z_q) equals Gaussian phase noise:
    exp(-i a Z_q) with a ~ N(0, g dt / 2) each step decays coherences by
    exactly e^{-g dt} in expectation. The noise does not depend on the
    pulse, so the gradient of the trajectory-mean loss is an unbiased
    estimate of the Lindblad-loss gradient. T1 channels cannot be
    unravelled this way.

    ``xi`` [n_traj, n_steps, n_ch] are the standard normal kicks; without
    them ``generator`` draws them on its device. The trajectories run on
    the batch axis, each step checkpointed. Returns CP [n_traj, d]."""
    from .product import apply_1q_pauli_rot
    if noise.t1:
        raise ValueError(
            "random-phase unraveling covers pure dephasing only; T1 "
            "channels need evolve_lindblad_structured (differentiable) or "
            "evolve_mcwf_structured (sampling)")
    rdt = ham.dtype
    dt, u_diag, u_oneq, diag_table, h0_vec, oneq_qubits, oneq_locals = \
        _structured_inputs(ham, envelope, coeff, T0, T, horizon, n_steps,
                           t_sample, noise, "the dephasing-trajectory engine "
                           "does not support 'hop' (XX+YY) terms yet")
    n, d, dev = ham.n_qubits, ham.dim, u_diag.device
    j_idx = np.arange(d)
    z_rows = [1.0 - 2.0 * ((j_idx & (1 << (n - 1 - q))) > 0)
              for q, _ in noise.dephasing]
    z_table = torch.as_tensor(np.stack(z_rows), dtype=rdt, device=dev)
    gammas = torch.tensor([g for _, g in noise.dephasing], dtype=rdt,
                          device=dev)
    dt_c = torch.as_tensor(dt, dtype=rdt, device=dev)
    sig = torch.sqrt(gammas * torch.abs(dt_c) / 2.0)   # a ~ N(0, g dt / 2)
    shape = (n_traj, n_steps, len(gammas))
    if xi is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the kicks xi")
        xi = torch.randn(shape, generator=generator, dtype=rdt,
                         device=generator.device)
    if tuple(xi.shape) != shape:
        raise ValueError(f"xi must be {list(shape)}, got {tuple(xi.shape)}")
    alphas = xi.to(dtype=rdt, device=dev) * sig
    order, frac = _rotation_order(oneq_qubits, dt)

    def step(re, im, ud, uq, al):
        theta_half = (0.5 * dt) * (h0_vec + torch.matmul(ud, diag_table)) \
            + 0.5 * torch.matmul(al, z_table)               # [B, d]
        ph = CP(torch.cos(theta_half), -torch.sin(theta_half))
        psi = cpx.mul(ph, CP(re, im))
        for i in order:
            psi = apply_1q_pauli_rot(psi, frac * uq[i], oneq_qubits[i], n,
                                     oneq_locals[i])
        psi = cpx.mul(ph, psi)
        return psi.re, psi.im

    psi = psi0.astype(rdt)
    re = psi.re.to(dev).expand(n_traj, d)
    im = psi.im.to(dev).expand(n_traj, d)
    taped = _taped(re, im, u_diag, u_oneq)
    for ud, uq, al in zip(u_diag.unbind(-1), u_oneq.unbind(-1),
                          alphas.unbind(1)):
        re, im = _run_step(step, taped, re, im, ud, uq, al)
    return CP(re, im)


def _jump_step(det: CP, cands: list, w: torch.Tensor, uni: torch.Tensor,
               gum: torch.Tensor, eps):
    """The first-order jump decision over a batch [B, d]: channel k ~ w_k
    [B, m] by the Gumbel argmax among the m candidate states, a jump when
    uni < dp = sum_k w_k; returns (the new states, the chosen log w_k,
    taken [B], dp [B])."""
    dp = torch.sum(w, dim=-1)
    take = uni < dp
    idx = torch.argmax(torch.log(w + eps) + gum, dim=-1)         # [B]
    cre = torch.stack([c.re for c in cands], dim=1)              # [B, m, d]
    cim = torch.stack([c.im for c in cands], dim=1)
    sel = idx[:, None, None].expand(-1, 1, cre.shape[-1])
    chosen_logw = torch.log(torch.gather(w, 1, idx[:, None])[:, 0] + eps)
    tk = take[:, None]
    return (CP(torch.where(tk, torch.gather(cre, 1, sel)[:, 0], det.re),
               torch.where(tk, torch.gather(cim, 1, sel)[:, 0], det.im)),
            chosen_logw, take, dp)


def _fused_band(ham):
    """The 'fused' backend's limits, checked before any table is built."""
    from ..ops.fused_product import MAX_QUBITS, MIN_QUBITS
    n = ham.n_qubits
    if not MIN_QUBITS <= n <= MAX_QUBITS:
        raise ValueError(
            f"backend='fused' runs on K2's band, {MIN_QUBITS}-{MAX_QUBITS} "
            f"qubits, got {n}; use backend='xla'")
    if ham.dtype != torch.float32:
        raise ValueError("backend='fused' runs K2, which takes float32; "
                         f"this Hamiltonian is {ham.dtype}")


def _fused_rotations(oneq_qubits, oneq_locals, dt, u_oneq):
    """(op qubits, kinds, theta table [T, n_ops] f32) of K2 for the
    'fused' backend: Pauli X/Y drives, palindromic when two share a
    qubit."""
    from .product import _pauli_kind, _symmetrize_rots
    kinds = tuple(_pauli_kind(g) for g in oneq_locals)
    if any(k is None for k in kinds):
        raise ValueError("backend='fused' needs Pauli X/Y 1q drives; use "
                         "backend='xla' for general involutory generators")
    return _symmetrize_rots(list(oneq_qubits), kinds,
                            (dt * u_oneq.T).to(torch.float32), dim=1)


def evolve_mcwf_structured(ham, envelope, coeff: torch.Tensor, psi0: CP,
                           noise: StructuredNoise, T0, T, horizon: float,
                           n_steps: int,
                           generator: Optional[torch.Generator] = None,
                           n_traj: int = 1, t_sample: str = "left",
                           return_logp: bool = False, backend: str = "xla",
                           draws: Optional[McwfDraws] = None):
    """Quantum-jump trajectories on the product-formula engine, the
    scalable open-system path: CP [n_traj, d] (and logp [n_traj] with
    ``return_logp``).

    Per step: the Strang split of ``exp(dt(-i H(t) - K/2))``, the diagonal
    decay K/2 inside the exact diagonal phase block, 1q rotations between
    the half phases; then the first-order jump decision from the state
    before the step. Jumps: amplitude damping is a masked XOR gather,
    dephasing a parity sign flip.

    ``return_logp`` also returns each trajectory's differentiable
    log-likelihood (``log w_k`` for a jump on channel k, ``log(1 - dp)``
    for none, summed over steps), for :func:`score_surrogate`.

    ``backend='xla'`` (the JAX name) applies the rotations op by op in
    plain PyTorch; ``'fused'`` runs all trajectories in lockstep through
    one K2 launch a step (:func:`..ops.fused_product.fused_rot_block`, one
    shared angle row) and its adjoint launch: Pauli X/Y drives, float32,
    10-17 qubits, raising outside them. The two take the same jumps draw
    for draw. Draws: :class:`McwfDraws`, or fresh from ``generator``."""
    from .product import apply_1q_pauli_rot
    if backend not in ("xla", "fused"):
        raise ValueError(f"backend must be 'xla' or 'fused', "
                         f"got {backend!r}")
    if backend == "fused":
        _fused_band(ham)
    rdt = ham.dtype
    dt, u_diag, u_oneq, diag_table, h0_vec, oneq_qubits, oneq_locals = \
        _structured_inputs(ham, envelope, coeff, T0, T, horizon, n_steps,
                           t_sample, noise, "the structured MCWF/trajectory "
                           "engine does not support 'hop' (XX+YY) terms yet")
    n, d, dev = ham.n_qubits, ham.dim, u_diag.device
    if backend == "fused":
        from ..ops.fused_product import fused_rot_block
        qubits_t, kinds_t, theta_tbl = _fused_rotations(
            oneq_qubits, oneq_locals, dt, u_oneq)
    dt_c = torch.as_tensor(dt, dtype=rdt, device=dev)
    kd = torch.as_tensor(noise.k_diag(), dtype=rdt, device=dev)
    decay_half = torch.exp(-0.25 * dt_c * kd)   # exp(-dt K / 2) in two
    j_idx = torch.arange(d, dtype=torch.int64, device=dev)
    t1_bits = [1 << (n - 1 - q) for q, _ in noise.t1]
    deph_bits = [1 << (n - 1 - q) for q, _ in noise.dephasing]
    t1_masks = [(j_idx & b) > 0 for b in t1_bits]
    deph_signs = [torch.where((j_idx & b) > 0, -1.0, 1.0).to(rdt)
                  for b in deph_bits]
    rates = [dt_c * g for _, g in noise.t1] \
        + [dt_c * 0.5 * g for _, g in noise.dephasing]
    n_ch = len(rates)
    eps = torch.tensor(1e-30, dtype=rdt, device=dev)
    # jump-candidate norm floor: keeps rsqrt and its derivative finite in
    # the working dtype (a candidate this small is never drawn)
    cand_floor = 1e-24 if rdt == torch.float32 else 1e-30
    order, frac = _rotation_order(oneq_qubits, dt)
    uni, gum = _mcwf_draws(draws, generator, n_steps, n_traj, n_ch, rdt, dev)

    def det_step(psi: CP, ud, uq, th_row) -> CP:
        theta_half = (0.5 * dt_c) * (h0_vec + torch.matmul(ud, diag_table))
        ph = CP(torch.cos(theta_half) * decay_half,
                -torch.sin(theta_half) * decay_half)
        psi = cpx.mul(ph, psi)
        if backend == "fused":
            if theta_tbl.shape[1]:
                psi = fused_rot_block(psi, th_row[None], qubits_t, n,
                                      kinds_t)
        else:
            for i in order:
                psi = apply_1q_pauli_rot(psi, frac * uq[i], oneq_qubits[i],
                                         n, oneq_locals[i])
        return cpx.mul(ph, psi)

    psi = psi0.astype(rdt)
    psi = CP(psi.re.to(dev).expand(n_traj, d).contiguous(),
             psi.im.to(dev).expand(n_traj, d).contiguous())
    logp = torch.zeros((n_traj,), dtype=rdt, device=dev)
    th_rows = theta_tbl.unbind(0) if backend == "fused" \
        else (None,) * n_steps
    for t, (ud, uq, th) in enumerate(zip(u_diag.unbind(-1),
                                         u_oneq.unbind(-1), th_rows)):
        p2 = cpx.abs2(psi)
        norm = torch.sum(p2, dim=-1)
        occ = [torch.sum(torch.where(m, p2, 0.0), dim=-1) for m in t1_masks]
        w = torch.stack([r * o for r, o in zip(
            rates, occ + [norm] * len(deph_bits))], dim=-1)      # [B, n_ch]
        det = det_step(psi, ud, uq, th)
        det = cpx.rscale(det, torch.rsqrt(cpx.norm2(det) + eps)[:, None])
        cands = []
        for bit in t1_bits:
            src = j_idx | bit
            keep = (j_idx & bit) == 0
            jr = torch.where(keep, psi.re.index_select(-1, src), 0.0)
            ji = torch.where(keep, psi.im.index_select(-1, src), 0.0)
            # maximum, not + eps: a zero-weight candidate gets a constant
            # norm, so the derivative of rsqrt stays finite
            s2 = torch.clamp(torch.sum(jr * jr + ji * ji, dim=-1),
                             min=cand_floor)
            nrm = torch.rsqrt(s2)[:, None]
            cands.append(CP(jr * nrm, ji * nrm))
        for sgn in deph_signs:
            cands.append(CP(psi.re * sgn, psi.im * sgn))
        psi, chosen_logw, take, dp = _jump_step(det, cands, w, uni[t],
                                                gum[t], eps)
        # the untaken branch stays finite: dp is clipped before log1p
        logp = logp + torch.where(
            take, chosen_logw, torch.log1p(-torch.clamp(dp, 0.0, 1.0 - 1e-7)))
    return (psi, logp) if return_logp else psi


def evolve_mcwf(ham: ControlledHamiltonian, envelope, coeff: torch.Tensor,
                psi0: CP, c_ops: CollapseSet, T0, T, horizon: float,
                n_steps: int, generator: Optional[torch.Generator] = None,
                n_traj: int = 1, tol: float = 1e-7, t_sample: str = "left",
                draws: Optional[McwfDraws] = None) -> CP:
    """CP [n_traj, d] of quantum-jump trajectory endpoints with dense
    operators. The trajectory mean of <psi|M|psi> estimates tr(M rho(T))
    to O(1/sqrt(n_traj)) + O(dt) unravelling bias.

    Per step, for all trajectories at once: the candidate jumps c_k psi
    (one product), the no-jump branch ``exp(dt M_eff) psi`` with
    ``M_eff = -i H(t) - K/2`` as one :func:`..ops.taylor_apply.
    taylor_apply` step (order and substeps from ``taylor_params`` of the
    H_eff bound; K7 on the card for float32 and d <= 1024, the
    recurrence otherwise, :func:`..ops.taylor_apply.apply_route`), both
    renormalized, then the jump decision. Draws: :class:`McwfDraws`, or
    fresh from ``generator``."""
    from ..ops.taylor_apply import (apply_route, substep_z,
                                    taylor_apply_recurrence,
                                    taylor_apply_zs)
    from .product import _amplitudes
    _dense_only(ham, "evolve_mcwf")
    dt, u = _amplitudes(envelope, coeff, T0, T, horizon, n_steps, t_sample)
    heff_bound = (float(horizon) / n_steps) * (
        ham.norm_bound(_amplitude_bound(envelope)) + 0.5 * c_ops.k_norm)
    order, s = taylor_params(heff_bound, tol)
    rdt, d = ham.dtype, ham.dim
    psi = psi0.astype(rdt)
    dev = psi.device
    m = c_ops.ops.re.shape[0]
    h = ham.at(u.transpose(-1, -2).to(rdt))              # [T, d, d]
    k_half = cpx.rscale(c_ops.k_op, -0.5)
    zs = substep_z(dt, 0.0, 2**s, psi.re)
    apply = taylor_apply_zs if apply_route(dev, rdt, d) == "k7" \
        else taylor_apply_recurrence
    eps = torch.tensor(1e-30, dtype=rdt, device=dev)
    c_re = c_ops.ops.re.reshape(m * d, d)
    c_im = c_ops.ops.im.reshape(m * d, d)
    uni, gum = _mcwf_draws(draws, generator, n_steps, n_traj, m, rdt, dev)

    psi = CP(psi.re.expand(n_traj, d).contiguous(),
             psi.im.expand(n_traj, d).contiguous())
    for t, (h_re, h_im) in enumerate(zip(h.re.unbind(0), h.im.unbind(0))):
        # candidate jumps c_k psi_b: [m d, d] x [d, B] -> [B, m, d]
        cre = (c_re @ psi.re.T - c_im @ psi.im.T).T.reshape(n_traj, m, d)
        cim = (c_re @ psi.im.T + c_im @ psi.re.T).T.reshape(n_traj, m, d)
        w = dt * torch.sum(cre * cre + cim * cim, dim=-1)     # [B, m]
        m_eff = cpx.add(cpx.mulmi(CP(h_re, h_im)), k_half)
        det = apply(m_eff, psi, zs, order, 2**s)
        det = cpx.rscale(det, torch.rsqrt(cpx.norm2(det) + eps)[:, None])
        cands = [CP(cre[:, k], cim[:, k]) for k in range(m)]
        cands = [cpx.rscale(c, torch.rsqrt(cpx.norm2(c) + eps)[:, None])
                 for c in cands]
        psi = _jump_step(det, cands, w, uni[t], gum[t], eps)[0]
    return psi
