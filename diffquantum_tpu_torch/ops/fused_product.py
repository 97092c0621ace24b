"""K1: the whole streamed Strang chain for one state, and its exact adjoint.

Port of :mod:`diffquantum_tpu.ops.fused_product` (``fused_product_evolve``
and its custom VJP, whose Pallas kernels are ``_make_forward_kernel`` and
``_make_backward_kernel``). The CUDA kernels live in
``csrc/fused_product.cu``; this module holds their wrapper, the op plan,
the table helpers, and the plain PyTorch version of both kernels.

Math (real-pair convention, L real):
  phase    y = e^{-i th} x:  dL/dth = lam_re*y_im - lam_im*y_re (elementwise)
           lam_x = e^{+i th} lam_y;  x = e^{+i th} y
  X-rot    y = c x - i s Gx (G = the flip i -> i ^ mask, G^2 = I)
  Y-rot    y = c x + s Kx   (K: out[bit 0] = -x[bit 1], out[bit 1] = +x[bit 0],
           K^2 = -I)
  hop      X-type rotation by the pre-doubled angle on the {01, 10}
           subspace of the pair's two bits, identity on {00, 11}
Qubit 0 is the most significant bit of an amplitude index. The forward
runs T+1 merged phase stages, P(a_0) R_0 P(a_1) R_1 ... R_{T-1} P(a_T)
(:func:`merge_phase_rows`), with the ops of each R_t applied in the order
of ``x_qubits``. The backward rebuilds the state by inverting each step
(O(1) memory in T) and returns dpsi0, d theta_half [T, d] and
d theta_x [T, n_x].

On the card an X/Y/hop generator is a gather at index ``i ^ mask``: the
TPU's row/lane split and XOR-permutation matmuls have no counterpart, so
``precision='fast'`` (which on the TPU selects single-pass bf16 matmuls)
computes exactly what 'full' computes here.

Dispatch: CPU tensors take the plain version, CUDA tensors launch the
kernel (``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` count the launches); there is
no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from . import _build
from .cpx import CP

KIND_X, KIND_Y, KIND_HOP = 0, 1, 2
_KIND_CODES = {"x": KIND_X, "y": KIND_Y, "hop": KIND_HOP}
MAX_OPS = 128          # op-table rows the kernel holds in shared memory
MIN_QUBITS, MAX_QUBITS = 10, 17   # the router's 'streamed' band
_BWD_SMEM_MAX_QUBITS = 13  # above this the backward keeps y in scratch

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


# ---------------------------------------------------------------------------
# op plan and tables
# ---------------------------------------------------------------------------

def _plan_ops(x_qubits: Sequence, kinds: Sequence[str],
              n_qubits: int) -> np.ndarray:
    """Ordered op plan as an int32 table [n_ops, 4], one row per op:
    (angle slot j, kind code, mask_a, mask_b). For 'x'/'y' on qubit q,
    mask_a = 1 << (n-1-q) is the flip mask and mask_b = 0. For a 'hop' on
    (qi, qj), qi < qj, mask_a and mask_b are the two sites' bits: the op
    pairs index ``i`` (qi bit 0, qj bit 1) with ``i ^ (mask_a | mask_b)``.
    Row order is the order of ``x_qubits``: hops do not commute with 1q
    rotations on their sites, so ops are never regrouped."""
    rows = []
    for j, (ent, kind) in enumerate(zip(x_qubits, kinds)):
        if kind not in _KIND_CODES:
            raise ValueError(f"op {j}: unknown kind {kind!r}")
        if kind == "hop":
            qi, qj = min(ent), max(ent)
            if not (0 <= qi < qj < n_qubits):
                raise ValueError(f"op {j}: bad hop pair {ent!r}")
            rows.append((j, KIND_HOP, 1 << (n_qubits - 1 - qi),
                         1 << (n_qubits - 1 - qj)))
        else:
            if isinstance(ent, tuple) or not 0 <= ent < n_qubits:
                raise ValueError(f"op {j}: bad qubit {ent!r} for {kind!r}")
            rows.append((j, _KIND_CODES[kind], 1 << (n_qubits - 1 - ent), 0))
    return np.asarray(rows, dtype=np.int32).reshape(len(rows), 4)


@functools.lru_cache(maxsize=64)
def _plan_tensor(plan_key: tuple, device: torch.device) -> torch.Tensor:
    """The op table on ``device`` (cached: one host copy per plan)."""
    return torch.tensor(plan_key, dtype=torch.int32,
                        device=device).reshape(len(plan_key), 4)


def merge_phase_rows(theta_half: torch.Tensor) -> torch.Tensor:
    """[T, ...] half-step phase rows -> [T+1, ...] merged rows
    P(th_0) R_0 P(th_0+th_1) R_1 ... R_{T-1} P(th_{T-1}): the trailing
    half phase of step t and the leading one of step t+1 commute and fuse.
    Exact. The gradient transpose is :func:`unmerge_phase_grads`."""
    return torch.cat([theta_half[:1], theta_half[:-1] + theta_half[1:],
                      theta_half[-1:]], dim=0)


def unmerge_phase_grads(ga: torch.Tensor) -> torch.Tensor:
    """Transpose of :func:`merge_phase_rows`: [T+1, ...] -> [T, ...]."""
    return ga[:-1] + ga[1:]


def parity_sign_masks(diag_rows, cap_terms: bool = True):
    """Express each two-valued diagonal row as
    ``row_k(j) = c_k + w_k * (-1)^parity(j & m_k)`` (every Pauli-Z-string
    cost). Returns ``(masks, consts, scales)``, or None when a row is not
    of that form (or, with ``cap_terms``, past 120 rows). Host numpy."""
    rows = [np.asarray(r, dtype=np.float64) for r in diag_rows]
    if cap_terms and len(rows) > 120:
        return None
    if not rows:
        return ((), np.zeros(0), np.zeros(0))
    d = rows[0].shape[0]
    nbits = int(round(np.log2(d)))
    j = np.arange(d, dtype=np.int64)
    masks, consts, scales = [], [], []
    for row in rows:
        lo, hi = float(row.min()), float(row.max())
        c, w = 0.5 * (hi + lo), 0.5 * (hi - lo)
        if w == 0.0:
            masks.append(0)
            consts.append(c)
            scales.append(0.0)
            continue
        s = (row - c) / w
        if np.max(np.abs(np.abs(s) - 1.0)) > 1e-9:
            return None  # more than two distinct values
        neg = s < 0
        if neg[0]:  # parity(0 & m) = 0: absorb a global flip into w
            w = -w
            neg = ~neg
        m = 0
        for b in range(nbits):
            if neg[1 << b]:
                m |= 1 << b
        x = j & m
        for sh in (32, 16, 8, 4, 2, 1):
            x ^= x >> sh
        if not np.array_equal((x & 1).astype(bool), neg):
            return None  # two-valued but not a parity function
        masks.append(m)
        consts.append(c)
        scales.append(w)
    return tuple(masks), np.asarray(consts), np.asarray(scales)


def parity_bit_device(j: torch.Tensor, mask: int) -> torch.Tensor:
    """parity(j & mask) of an int tensor, from shifts and xors."""
    x = torch.bitwise_and(j, mask)
    for sh in (16, 8, 4, 2, 1):
        x = torch.bitwise_xor(x, torch.bitwise_right_shift(x, sh))
    return torch.bitwise_and(x, 1)


def diag_rows_device(diag_rows, d: int, dtype, device) -> torch.Tensor:
    """[n_rows, d] diagonal-control table built on ``device`` from parity
    masks when every row is parity-form (no host table to copy); the
    dense host rows otherwise."""
    if not diag_rows:
        return torch.zeros((0, d), dtype=dtype, device=device)
    par = parity_sign_masks(diag_rows, cap_terms=False)
    if par is None:
        return torch.as_tensor(np.stack(diag_rows), dtype=dtype,
                               device=device)
    masks, consts, scales = par
    j = torch.arange(d, dtype=torch.int32, device=device)
    rows = [torch.full((d,), c, dtype=dtype, device=device) if w == 0.0
            else c + w * (1.0 - 2.0 * parity_bit_device(j, m).to(dtype))
            for m, c, w in zip(masks, consts, scales)]
    return torch.stack(rows).to(dtype)


def diag_vec_device(row, dtype, device) -> torch.Tensor:
    """One diagonal (an H0) as a device vector, see
    :func:`diag_rows_device`."""
    row = np.asarray(row)
    return diag_rows_device([row], row.shape[0], dtype, device)[0]


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------

def _flip(v: torch.Tensor, mask: int) -> torch.Tensor:
    """v[i ^ mask] for a single-bit mask."""
    b = mask.bit_length() - 1
    return v.reshape(-1, 2, 1 << b).flip(1).reshape(v.shape)


def _kflip(v: torch.Tensor, mask: int) -> torch.Tensor:
    """The Y operator K: out[bit 0] = -v[bit 1], out[bit 1] = +v[bit 0]."""
    b = mask.bit_length() - 1
    w = v.reshape(-1, 2, 1 << b)
    return torch.stack([-w[:, 1], w[:, 0]], dim=1).reshape(v.shape)


def _hop_mask(d: int, ma: int, mb: int, like: torch.Tensor) -> torch.Tensor:
    """{01, 10} subspace indicator of the bits ma, mb as a float vector."""
    j = torch.arange(d, device=like.device)
    m = torch.bitwise_xor(torch.bitwise_and(j, ma) != 0,
                          torch.bitwise_and(j, mb) != 0)
    return m.to(like.dtype)


def _check_inputs(psi_re, psi_im, theta_half, theta_x, n_qubits, n_ops):
    ts = (psi_re, psi_im, theta_half, theta_x)
    if len({t.device for t in ts}) != 1:
        raise ValueError("fused_product_evolve: inputs on different devices")
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"fused_product_evolve takes float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused_product_evolve takes contiguous tensors")
    if not MIN_QUBITS <= n_qubits <= MAX_QUBITS:
        raise ValueError(f"fused_product_evolve runs {MIN_QUBITS}.."
                         f"{MAX_QUBITS} qubits, got {n_qubits}")
    d = 1 << n_qubits
    if psi_re.shape != (d,) or psi_im.shape != (d,):
        raise ValueError(f"psi0 must be [{d}], got {tuple(psi_re.shape)}")
    if theta_half.ndim != 2 or theta_half.shape[1] != d \
            or theta_half.shape[0] < 1:
        raise ValueError(f"theta_half must be [T>=1, {d}], got "
                         f"{tuple(theta_half.shape)}")
    if theta_x.shape != (theta_half.shape[0], n_ops):
        raise ValueError(f"theta_x must be [{theta_half.shape[0]}, {n_ops}],"
                         f" got {tuple(theta_x.shape)}")
    if n_ops > MAX_OPS:
        raise ValueError(f"op plan has {n_ops} ops; the kernel holds "
                         f"{MAX_OPS}")


def _rot_plain(re, im, op, c, s, d):
    _, kind, ma, mb = (int(v) for v in op)
    if kind == KIND_X:
        g_re, g_im = _flip(re, ma), _flip(im, ma)
        return c * re + s * g_im, c * im - s * g_re
    if kind == KIND_Y:
        return c * re + s * _kflip(re, ma), c * im + s * _kflip(im, ma)
    m = _hop_mask(d, ma, mb, re)
    ct = 1.0 + m * (c - 1.0)
    g_re, g_im = _flip(_flip(re, ma), mb), _flip(_flip(im, ma), mb)
    return ct * re + s * (m * g_im), ct * im - s * (m * g_re)


def fused_product_evolve_plain(psi0: CP, theta_half: torch.Tensor,
                               theta_x: torch.Tensor, x_qubits: tuple,
                               n_qubits: int, kinds: tuple = None) -> CP:
    """The kernel's forward in plain PyTorch: same stage loop, same op
    plan, any device."""
    kinds = tuple(kinds) if kinds else ("x",) * len(x_qubits)
    plan = _plan_ops(x_qubits, kinds, n_qubits)
    _check_inputs(psi0.re, psi0.im, theta_half, theta_x, n_qubits,
                  len(plan))
    d = 1 << n_qubits
    a = merge_phase_rows(theta_half)
    n_steps = theta_half.shape[0]
    re, im = psi0.re, psi0.im
    for k in range(n_steps + 1):
        c, s = torch.cos(a[k]), torch.sin(a[k])
        re, im = c * re + s * im, c * im - s * re
        if k == n_steps:
            break
        for op in plan:
            th = theta_x[k, int(op[0])]
            re, im = _rot_plain(re, im, op, torch.cos(th), torch.sin(th), d)
    return CP(re, im)


def _undo_rot_plain(y_re, y_im, l_re, l_im, op, c, s, d):
    """Invert one rotation: returns (x_re, x_im, lam_x_re, lam_x_im,
    dL/dtheta), deriving G(x) from G(y) (G^2 = I, K^2 = -I)."""
    _, kind, ma, mb = (int(v) for v in op)
    if kind == KIND_X:
        gy_re, gy_im = _flip(y_re, ma), _flip(y_im, ma)
        gl_re, gl_im = _flip(l_re, ma), _flip(l_im, ma)
        x_re = c * y_re - s * gy_im
        x_im = c * y_im + s * gy_re
        gx_re = c * gy_re - s * y_im
        gx_im = c * gy_im + s * y_re
        g = torch.sum(l_re * (-s * x_re + c * gx_im)
                      + l_im * (-s * x_im - c * gx_re))
        return x_re, x_im, c * l_re - s * gl_im, c * l_im + s * gl_re, g
    if kind == KIND_Y:
        ky_re, ky_im = _kflip(y_re, ma), _kflip(y_im, ma)
        kl_re, kl_im = _kflip(l_re, ma), _kflip(l_im, ma)
        x_re = c * y_re - s * ky_re
        x_im = c * y_im - s * ky_im
        gx_re = c * ky_re + s * y_re
        gx_im = c * ky_im + s * y_im
        g = torch.sum(l_re * (-s * x_re + c * gx_re)
                      + l_im * (-s * x_im + c * gx_im))
        return x_re, x_im, c * l_re - s * kl_re, c * l_im - s * kl_im, g
    m = _hop_mask(d, ma, mb, y_re)
    ct = 1.0 + m * (c - 1.0)
    flip2 = lambda v: _flip(_flip(v, ma), mb)  # noqa: E731
    gy_re, gy_im = m * flip2(y_re), m * flip2(y_im)
    tl_re, tl_im = flip2(l_re), flip2(l_im)
    x_re = ct * y_re - s * gy_im
    x_im = ct * y_im + s * gy_re
    gx_re = c * gy_re - s * (m * y_im)
    gx_im = c * gy_im + s * (m * y_re)
    g = torch.sum(l_re * (-s * (m * x_re) + c * gx_im)
                  + l_im * (-s * (m * x_im) - c * gx_re))
    return (x_re, x_im, ct * l_re - s * (m * tl_im),
            ct * l_im + s * (m * tl_re), g)


def _adjoint_plain(psi_T: CP, lam: CP, theta_half: torch.Tensor,
                   theta_x: torch.Tensor, x_qubits: tuple, n_qubits: int,
                   kinds: tuple = None):
    """The kernel's backward in plain PyTorch: from the final state and
    its cotangent, rebuild the chain in reverse and return
    (dpsi0 CP, d theta_half [T, d], d theta_x [T, n_x])."""
    kinds = tuple(kinds) if kinds else ("x",) * len(x_qubits)
    plan = _plan_ops(x_qubits, kinds, n_qubits)
    _check_inputs(psi_T.re, psi_T.im, theta_half, theta_x, n_qubits,
                  len(plan))
    d = 1 << n_qubits
    n_steps = theta_half.shape[0]
    a = merge_phase_rows(theta_half)
    y_re, y_im, l_re, l_im = psi_T.re, psi_T.im, lam.re, lam.im
    ga = torch.empty((n_steps + 1, d), dtype=theta_half.dtype,
                     device=theta_half.device)
    gtx = torch.zeros_like(theta_x)
    for k in range(n_steps, -1, -1):
        if k < n_steps:
            for op in plan[::-1]:
                th = theta_x[k, int(op[0])]
                y_re, y_im, l_re, l_im, g = _undo_rot_plain(
                    y_re, y_im, l_re, l_im, op, torch.cos(th),
                    torch.sin(th), d)
                gtx[k, int(op[0])] = g
        c, s = torch.cos(a[k]), torch.sin(a[k])
        ga[k] = l_re * y_im - l_im * y_re
        y_re, y_im = c * y_re - s * y_im, s * y_re + c * y_im
        l_re, l_im = c * l_re - s * l_im, s * l_re + c * l_im
    return CP(l_re, l_im), unmerge_phase_grads(ga), gtx


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_product")
    if not getattr(lib, "_dq_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dq_k1_forward.argtypes = [p] * 7 + [i] * 3 + [p]
        lib.dq_k1_forward.restype = i
        lib.dq_k1_backward.argtypes = [p] * 13 + [i] * 3 + [p]
        lib.dq_k1_backward.restype = i
        lib.dq_error_string.argtypes = [i]
        lib.dq_error_string.restype = ctypes.c_char_p
        lib._dq_typed = True
    return lib


def _raise_on(lib, code: int, what: str):
    if code != 0:
        raise RuntimeError(f"K1 {what} launch failed: "
                           f"{lib.dq_error_string(code).decode()} ({code})")


def _ptr(t):
    return t.data_ptr() if t is not None and t.numel() else None


def _forward_cuda(psi_re, psi_im, theta_half, theta_x, plan, n_qubits):
    global FWD_LAUNCHES
    dev = psi_re.device
    ops = _plan_tensor(tuple(map(tuple, plan.tolist())), dev)
    out_re, out_im = torch.empty_like(psi_re), torch.empty_like(psi_im)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dq_k1_forward(
            _ptr(theta_half), _ptr(theta_x), _ptr(psi_re), _ptr(psi_im),
            _ptr(ops), _ptr(out_re), _ptr(out_im), n_qubits,
            theta_half.shape[0], len(plan), stream)
    _raise_on(lib, code, "forward")
    FWD_LAUNCHES += 1
    return out_re, out_im


def _backward_cuda(out_re, out_im, lam_re, lam_im, theta_half, theta_x,
                   plan, n_qubits):
    global BWD_LAUNCHES
    dev = out_re.device
    ops = _plan_tensor(tuple(map(tuple, plan.tolist())), dev)
    gth = torch.empty_like(theta_half)
    gtx = torch.empty_like(theta_x)
    gp_re, gp_im = torch.empty_like(out_re), torch.empty_like(out_im)
    scratch = (torch.empty_like(out_re), torch.empty_like(out_im)) \
        if n_qubits > _BWD_SMEM_MAX_QUBITS else (None, None)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dq_k1_backward(
            _ptr(theta_half), _ptr(theta_x), _ptr(out_re), _ptr(out_im),
            _ptr(lam_re), _ptr(lam_im), _ptr(ops), _ptr(gth), _ptr(gtx),
            _ptr(gp_re), _ptr(gp_im), _ptr(scratch[0]), _ptr(scratch[1]),
            n_qubits, theta_half.shape[0], len(plan), stream)
    _raise_on(lib, code, "backward")
    BWD_LAUNCHES += 1
    return gp_re, gp_im, gth, gtx


class _FusedProductEvolve(torch.autograd.Function):
    """psi(T) and its exact adjoint: the kernel pair on the card, the
    plain pair (:func:`fused_product_evolve_plain`, :func:`_adjoint_plain`)
    on the CPU."""

    @staticmethod
    def forward(ctx, psi_re, psi_im, theta_half, theta_x, x_qubits,
                n_qubits, kinds):
        plan = _plan_ops(x_qubits, kinds, n_qubits)
        _check_inputs(psi_re, psi_im, theta_half, theta_x, n_qubits,
                      len(plan))
        if psi_re.is_cuda:
            out_re, out_im = _forward_cuda(psi_re, psi_im, theta_half,
                                           theta_x, plan, n_qubits)
        elif psi_re.device.type == "cpu":
            out = fused_product_evolve_plain(CP(psi_re, psi_im), theta_half,
                                             theta_x, x_qubits, n_qubits,
                                             kinds)
            out_re, out_im = out.re, out.im
        else:
            raise ValueError(f"fused_product_evolve: no path for device "
                             f"{psi_re.device}")
        ctx.save_for_backward(out_re, out_im, theta_half, theta_x)
        ctx.static = (x_qubits, n_qubits, kinds, plan)
        return out_re, out_im

    @staticmethod
    def backward(ctx, lam_re, lam_im):
        out_re, out_im, theta_half, theta_x = ctx.saved_tensors
        x_qubits, n_qubits, kinds, plan = ctx.static
        lam_re, lam_im = lam_re.contiguous(), lam_im.contiguous()
        if out_re.is_cuda:
            gp_re, gp_im, gth, gtx = _backward_cuda(
                out_re, out_im, lam_re, lam_im, theta_half, theta_x, plan,
                n_qubits)
        else:
            gp, gth, gtx = _adjoint_plain(CP(out_re, out_im),
                                          CP(lam_re, lam_im), theta_half,
                                          theta_x, x_qubits, n_qubits, kinds)
            gp_re, gp_im = gp.re, gp.im
        return gp_re, gp_im, gth, gtx, None, None, None


def fused_product_evolve(psi0: CP, theta_half: torch.Tensor,
                         theta_x: torch.Tensor, x_qubits: tuple,
                         n_qubits: int, kinds: tuple = None,
                         fast_math: bool = False) -> CP:
    """psi(T) = P(a_T) prod_t [R_t P(a_t)] psi0, differentiable in psi0,
    theta_half and theta_x.

    psi0: CP [2^n] f32; theta_half: [T, 2^n] half-step phase angles;
    theta_x: [T, n_x] rotation angles, column j for ``x_qubits[j]``;
    kinds: per-op 'x' | 'y' | 'hop' (default all 'x'); a hop entry is a
    qubit pair and its angle is already doubled. ``fast_math`` is
    accepted for API parity and changes nothing (see the module note)."""
    del fast_math
    kinds = tuple(kinds) if kinds else ("x",) * len(x_qubits)
    re, im = _FusedProductEvolve.apply(psi0.re, psi0.im, theta_half,
                                       theta_x, tuple(x_qubits), n_qubits,
                                       kinds)
    return CP(re, im)

