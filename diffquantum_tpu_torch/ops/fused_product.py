"""K1 and K2: the whole streamed Strang chain for one state (K1) or a
batch of states with per-member angles (K2), and their exact adjoints;
K3: the packed-phase chain, whose phases the kernel computes from sign
bit-planes.

Port of :mod:`diffquantum_tpu.ops.fused_product`: ``fused_product_evolve``
and ``fused_product_evolve_batched`` with their custom VJPs, whose Pallas
kernels are ``_make_forward_kernel``/``_make_backward_kernel`` (K1) and
``_make_forward_kernel_b``/``_make_backward_kernel_b`` (K2), and
``fused_product_evolve_packed`` (K3, ``_make_forward_kernel_pk`` /
``_make_backward_kernel_pk``). The CUDA kernels of K1 and K2 live in
``csrc/fused_product.cu`` (K1 is K2 at one member; launch geometry from
:func:`fp_plan`);
K3's in ``csrc/packed_phase.cu``, which also backs K5
(:mod:`.fused_chunked`) and K6 (:mod:`.fused_mega_hop`). This module
holds their wrappers, the op plan, the table helpers, and the plain
PyTorch versions of these kernels.

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

Packed phases (K3, and K5 and K6 in :mod:`.fused_chunked` and
:mod:`.fused_mega_hop`): stage k's angle at amplitude j is
``m h0th[j] + off + sum_i a_i (1 - 2 bit_i(j))`` from the merged row
``[a_0 .. a_{n_diag-1}, off, m]`` (:func:`merge_ud_rows`) and the sign
bit-planes (bit i%30 of plane i//30, :func:`pack_diag_signs`): no [T, d]
table exists, and the backward reduces the phase cotangents to
``n_diag + 1`` scalars per stage. The packed chains run op rows
(:func:`_packed_plan`) that carry a scale beside their angle slot: a row
applies its rotation by scale x theta_x[slot], and a slot may have
several rows (K6's half-angle sweeps), whose scaled gradients add.

Dispatch: CPU tensors take the plain version, CUDA tensors launch the
kernel (the counters ``k1_forward`` / ``k1_backward`` of
:func:`..utils.profiling.count` count K1's launches, ``k2_*`` K2's,
``k3_*`` K3's, one per chain; each launch, or plain version, is a
``chain.fwd`` / ``chain.bwd`` span); there is no fallback from one to
the other. The pass kernels of K3-K6 take their geometry from
:func:`pk_plan` and their pass and op tables from :func:`_pass_layout`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from ..utils import profiling
from . import _build
from .cpx import CP

KIND_X, KIND_Y, KIND_HOP = 0, 1, 2
_KIND_CODES = {"x": KIND_X, "y": KIND_Y, "hop": KIND_HOP}
MAX_OPS = 128          # op-table rows the kernel holds in shared memory
MIN_QUBITS, MAX_QUBITS = 10, 17   # the router's 'streamed' band

PLANE_BITS = 30        # sign bits per int32 plane
MAX_PACKED_TERMS = 120  # 4 planes
SCALE_ONE = 2          # a packed op row's scale column counts halves


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


def _packed_plan(x_qubits: Sequence, kinds: Sequence[str],
                 n_qubits: int) -> np.ndarray:
    """The packed chains' op rows [n_ops, 5]: :func:`_plan_ops`'s rows
    with a scale column, here 1 for every row (``SCALE_ONE`` halves)."""
    return _with_scale(_plan_ops(x_qubits, kinds, n_qubits), SCALE_ONE)


def _with_scale(rows: np.ndarray, halves: int) -> np.ndarray:
    """Op rows [n, 4] with a scale column of ``halves`` halves added."""
    return np.concatenate(
        [rows, np.full((len(rows), 1), halves, np.int32)], axis=1)


def _row_scale(op) -> float:
    """The scale of a packed op row."""
    return 0.5 * int(op[4])


@functools.lru_cache(maxsize=64)
def _plan_tensor(plan_key: tuple, device: torch.device) -> torch.Tensor:
    """An int32 table of rows on ``device`` (cached: one host copy per
    plan)."""
    width = len(plan_key[0]) if plan_key else 4
    return torch.tensor(plan_key, dtype=torch.int32,
                        device=device).reshape(len(plan_key), width)


@functools.lru_cache(maxsize=64)
def _int_tensor(values: tuple, device: torch.device) -> torch.Tensor:
    """A flat int32 table on ``device`` (cached)."""
    return torch.tensor(values, dtype=torch.int32, device=device)


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
    if cap_terms and len(rows) > MAX_PACKED_TERMS:
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


def signs_planes_device(masks, d: int, device) -> torch.Tensor:
    """[P, d] int32 sign bit-planes (bit k%30 of plane k//30 set where row
    k's sign is -1) built on ``device`` from parity masks: bit for bit
    the planes of :func:`pack_diag_signs` for parity-form rows, with no
    host table to copy."""
    if not masks:
        return torch.zeros((1, d), dtype=torch.int32, device=device)
    j = torch.arange(d, dtype=torch.int32, device=device)
    planes = []
    for p0 in range(0, len(masks), PLANE_BITS):
        plane = torch.zeros(d, dtype=torch.int32, device=device)
        for k, m in enumerate(masks[p0:p0 + PLANE_BITS]):
            plane |= parity_bit_device(j, m) << k
        planes.append(plane)
    return torch.stack(planes)


def pack_diag_signs(diag_rows):
    """Decompose two-valued diagonal rows as ``row_k = c_k + w_k s_k``,
    s_k in {-1, +1}, and pack the signs into int32 bit-planes (plane
    k//30, bit k%30 set where s_k < 0). Returns (signs [P, d] int32,
    consts [n], scales [n]) with P = ceil(n/30) >= 1, or None when a row
    has more than two values or n > 120. Host numpy."""
    rows = [np.asarray(r, dtype=np.float64) for r in diag_rows]
    if len(rows) > MAX_PACKED_TERMS:
        return None
    if not rows:
        return (np.zeros((1, 0), np.int32), np.zeros(0), np.zeros(0))
    d = rows[0].shape[0]
    signs = np.zeros((max(1, -(-len(rows) // PLANE_BITS)), d), np.int32)
    consts, scales = [], []
    for k, row in enumerate(rows):
        lo, hi = float(row.min()), float(row.max())
        c, w = 0.5 * (hi + lo), 0.5 * (hi - lo)
        if w == 0.0:
            s_neg = np.zeros(d, bool)
        else:
            s = (row - c) / w
            if np.max(np.abs(np.abs(s) - 1.0)) > 1e-9:
                return None  # more than two distinct values
            s_neg = s < 0
        consts.append(c)
        scales.append(w)
        signs[k // PLANE_BITS] |= (s_neg.astype(np.int32)
                                   << (k % PLANE_BITS))
    return signs, np.asarray(consts), np.asarray(scales)


def merge_ud_rows(ud: torch.Tensor) -> torch.Tensor:
    """[T, B, S] per-step packed rows (slot S-1 the offset) -> the
    [T+1, B, S+1] merged stage rows: slot S is the h0 multiplier, 1 at
    the two boundary half-phases and 2 where step t-1's trailing half and
    step t's leading half fuse (their slots add: the angle is linear in
    the row). T = 1 keeps its two halves apart. The gradient transpose is
    :func:`unmerge_phase_grads` over the first S slots."""
    ud = ud.to(torch.float32)
    one = torch.ones(ud.shape[1:-1] + (1,), dtype=torch.float32,
                     device=ud.device)
    first = torch.cat([ud[0], one], -1)[None]
    last = torch.cat([ud[-1], one], -1)[None]
    if ud.shape[0] == 1:
        return torch.cat([first, last], 0)
    mid = torch.cat([ud[:-1] + ud[1:],
                     (2.0 * one).expand((ud.shape[0] - 1,) + one.shape)], -1)
    return torch.cat([first, mid, last], 0)


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
    kind, ma, mb = int(op[1]), int(op[2]), int(op[3])
    if kind == KIND_X:
        g_re, g_im = _flip(re, ma), _flip(im, ma)
        return c * re + s * g_im, c * im - s * g_re
    if kind == KIND_Y:
        return c * re + s * _kflip(re, ma), c * im + s * _kflip(im, ma)
    m = _hop_mask(d, ma, mb, re)
    ct = 1.0 + m * (c - 1.0)
    g_re, g_im = _flip(_flip(re, ma), mb), _flip(_flip(im, ma), mb)
    return ct * re + s * (m * g_im), ct * im - s * (m * g_re)


def _evolve_core(re, im, a, tx, plan, d):
    """The forward stage loop on states [..., d]: merged phase rows
    a [T+1, ..., d], angles tx [T, ..., n_x] (leading dims per member)."""
    n_steps = tx.shape[0]
    for k in range(n_steps + 1):
        c, s = torch.cos(a[k]), torch.sin(a[k])
        re, im = c * re + s * im, c * im - s * re
        if k == n_steps:
            break
        for op in plan:
            th = tx[k, ..., int(op[0])][..., None]
            re, im = _rot_plain(re, im, op, torch.cos(th), torch.sin(th), d)
    return re, im


def fused_product_evolve_plain(psi0: CP, theta_half: torch.Tensor,
                               theta_x: torch.Tensor, x_qubits: tuple,
                               n_qubits: int, kinds: tuple = None) -> CP:
    """The kernel's forward in plain PyTorch: same stage loop, same op
    plan, any device."""
    kinds = tuple(kinds) if kinds else ("x",) * len(x_qubits)
    plan = _plan_ops(x_qubits, kinds, n_qubits)
    _check_inputs(psi0.re, psi0.im, theta_half, theta_x, n_qubits,
                  len(plan))
    re, im = _evolve_core(psi0.re, psi0.im, merge_phase_rows(theta_half),
                          theta_x, plan, 1 << n_qubits)
    return CP(re, im)


def _undo_rot_plain(y_re, y_im, l_re, l_im, op, c, s, d):
    """Invert one rotation on states [..., d]: returns (x_re, x_im,
    lam_x_re, lam_x_im, dL/dtheta [...]), deriving G(x) from G(y)
    (G^2 = I, K^2 = -I)."""
    kind, ma, mb = int(op[1]), int(op[2]), int(op[3])
    if kind == KIND_X:
        gy_re, gy_im = _flip(y_re, ma), _flip(y_im, ma)
        gl_re, gl_im = _flip(l_re, ma), _flip(l_im, ma)
        x_re = c * y_re - s * gy_im
        x_im = c * y_im + s * gy_re
        gx_re = c * gy_re - s * y_im
        gx_im = c * gy_im + s * y_re
        g = torch.sum(l_re * (-s * x_re + c * gx_im)
                      + l_im * (-s * x_im - c * gx_re), dim=-1)
        return x_re, x_im, c * l_re - s * gl_im, c * l_im + s * gl_re, g
    if kind == KIND_Y:
        ky_re, ky_im = _kflip(y_re, ma), _kflip(y_im, ma)
        kl_re, kl_im = _kflip(l_re, ma), _kflip(l_im, ma)
        x_re = c * y_re - s * ky_re
        x_im = c * y_im - s * ky_im
        gx_re = c * ky_re + s * y_re
        gx_im = c * ky_im + s * y_im
        g = torch.sum(l_re * (-s * x_re + c * gx_re)
                      + l_im * (-s * x_im + c * gx_im), dim=-1)
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
                  + l_im * (-s * (m * x_im) - c * gx_re), dim=-1)
    return (x_re, x_im, ct * l_re - s * (m * tl_im),
            ct * l_im + s * (m * tl_re), g)


def _adjoint_core(y_re, y_im, l_re, l_im, a, tx, plan, d):
    """The backward stage loop on states [..., d] (see
    :func:`_evolve_core`): returns (dpsi0 re, im, d theta_half [T, ..., d],
    d theta_x shaped like tx)."""
    n_steps = tx.shape[0]
    ga = torch.empty((n_steps + 1,) + tuple(y_re.shape), dtype=a.dtype,
                     device=a.device)
    gtx = torch.zeros(tx.shape, dtype=tx.dtype, device=tx.device)
    for k in range(n_steps, -1, -1):
        if k < n_steps:
            for op in plan[::-1]:
                j = int(op[0])
                th = tx[k, ..., j][..., None]
                y_re, y_im, l_re, l_im, g = _undo_rot_plain(
                    y_re, y_im, l_re, l_im, op, torch.cos(th),
                    torch.sin(th), d)
                gtx[k, ..., j] = g
        c, s = torch.cos(a[k]), torch.sin(a[k])
        ga[k] = l_re * y_im - l_im * y_re
        y_re, y_im = c * y_re - s * y_im, s * y_re + c * y_im
        l_re, l_im = c * l_re - s * l_im, s * l_re + c * l_im
    return l_re, l_im, unmerge_phase_grads(ga), gtx


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
    g_re, g_im, gth, gtx = _adjoint_core(
        psi_T.re, psi_T.im, lam.re, lam.im, merge_phase_rows(theta_half),
        theta_x, plan, 1 << n_qubits)
    return CP(g_re, g_im), gth, gtx


# ---------------------------------------------------------------------------
# K2: the batched chain, plain version
# ---------------------------------------------------------------------------

def _check_inputs_b(psi_re, psi_im, theta_half, theta_x, n_qubits, n_ops):
    """K2's contract: psi [B, d], theta_half [T, G, d], theta_x
    [T, Gx, n_ops], with G and Gx dividing B (G = B: a row per member)."""
    ts = (psi_re, psi_im, theta_half, theta_x)
    if len({t.device for t in ts}) != 1:
        raise ValueError("fused_product_evolve_batched: inputs on different "
                         "devices")
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"fused_product_evolve_batched takes float32, "
                            f"got {t.dtype}")
    if not (theta_half.is_contiguous() and theta_x.is_contiguous()):
        raise ValueError("fused_product_evolve_batched takes contiguous "
                         "tables (shared rows as [T, G, ...] group rows)")
    if not MIN_QUBITS <= n_qubits <= MAX_QUBITS:
        raise ValueError(f"fused_product_evolve_batched runs {MIN_QUBITS}.."
                         f"{MAX_QUBITS} qubits, got {n_qubits}")
    d = 1 << n_qubits
    if psi_re.ndim != 2 or psi_re.shape[1] != d \
            or psi_im.shape != psi_re.shape or psi_re.shape[0] < 1:
        raise ValueError(f"psi0 must be [B, {d}], got "
                         f"{tuple(psi_re.shape)}")
    b = psi_re.shape[0]
    if theta_half.ndim != 3 or theta_half.shape[2] != d \
            or theta_half.shape[0] < 1 or b % theta_half.shape[1]:
        raise ValueError(f"theta_half must be [T>=1, G, {d}] with G "
                         f"dividing B={b}, got {tuple(theta_half.shape)}")
    if theta_x.ndim != 3 or theta_x.shape[0] != theta_half.shape[0] \
            or theta_x.shape[2] != n_ops or b % theta_x.shape[1]:
        raise ValueError(f"theta_x must be [{theta_half.shape[0]}, Gx, "
                         f"{n_ops}] with Gx dividing B={b}, got "
                         f"{tuple(theta_x.shape)}")
    if n_ops > MAX_OPS:
        raise ValueError(f"op plan has {n_ops} ops; the kernel holds "
                         f"{MAX_OPS}")


def _per_member(t: torch.Tensor, b: int) -> torch.Tensor:
    """[T, G, ...] group rows -> [T, B, ...] member rows."""
    g = t.shape[1]
    return t if g == b else t.repeat_interleave(b // g, dim=1)


def _to_groups(g: torch.Tensor, groups: int) -> torch.Tensor:
    """[T, B, ...] member cotangents -> [T, G, ...]: the transpose of
    :func:`_per_member` (the sum over each group's members)."""
    n_steps, b = g.shape[:2]
    if groups == b:
        return g
    return g.reshape((n_steps, groups, b // groups) + tuple(g.shape[2:])
                     ).sum(dim=2)


def fused_product_evolve_batched_plain(psi0: CP, theta_half: torch.Tensor,
                                       theta_x: torch.Tensor,
                                       x_qubits: tuple, n_qubits: int,
                                       kinds: tuple = None) -> CP:
    """K2's forward in plain PyTorch: K1's stage loop over B members,
    each reading its group's rows."""
    kinds = tuple(kinds) if kinds else ("x",) * len(x_qubits)
    plan = _plan_ops(x_qubits, kinds, n_qubits)
    _check_inputs_b(psi0.re, psi0.im, theta_half, theta_x, n_qubits,
                    len(plan))
    b = psi0.re.shape[0]
    re, im = _evolve_core(psi0.re, psi0.im,
                          merge_phase_rows(_per_member(theta_half, b)),
                          _per_member(theta_x, b), plan, 1 << n_qubits)
    return CP(re, im)


def _adjoint_batched_plain(psi_T: CP, lam: CP, theta_half: torch.Tensor,
                           theta_x: torch.Tensor, x_qubits: tuple,
                           n_qubits: int, kinds: tuple = None):
    """K2's backward in plain PyTorch: (dpsi0 CP [B, d], d theta_half and
    d theta_x in the shapes of theta_half and theta_x)."""
    kinds = tuple(kinds) if kinds else ("x",) * len(x_qubits)
    plan = _plan_ops(x_qubits, kinds, n_qubits)
    _check_inputs_b(psi_T.re, psi_T.im, theta_half, theta_x, n_qubits,
                    len(plan))
    b = psi_T.re.shape[0]
    g_re, g_im, gth, gtx = _adjoint_core(
        psi_T.re, psi_T.im, lam.re, lam.im,
        merge_phase_rows(_per_member(theta_half, b)),
        _per_member(theta_x, b), plan, 1 << n_qubits)
    return (CP(g_re, g_im), _to_groups(gth, theta_half.shape[1]),
            _to_groups(gtx, theta_x.shape[1]))


# ---------------------------------------------------------------------------
# K1 and K2 on the card: the launch plan (csrc/fused_product.cu checks it)
# ---------------------------------------------------------------------------

FP_RBITS = (4, 3)       # 2^r amplitudes of each plane a thread (fp_plan)
FP_LANE_BITS = 5        # index bits 0..4 are a warp's lanes
FP_LOC_LANE = 8         # an op's location: register rank 0..r-1 or 8 + lane
# registers a thread and the largest block, by (backward, r): the kernels'
# launch bounds (csrc/fused_product.cu: bound_threads, max_threads)
FP_REGS = {(False, 3): 64, (False, 4): 80, (True, 3): 128, (True, 4): 128}
FP_MAX_THREADS = {(False, 3): 1024, (False, 4): 512, (True, 3): 512,
                  (True, 4): 512}
FP_GRID_THREADS = 256   # mode 'grid', at FP_GRID_REGS registers a thread
FP_GRID_REGS = 128
FP_GRID_RBITS = 3
FP_MAX_ROUNDS = 128
FP_STATIC_BYTES = 6144  # the kernels' static tables (kStaticBytes)
_FP_MODES = {"block": 0, "grid": 1}
_SM_BLOCKS = 32         # resident blocks an SM (sm_90)


@dataclasses.dataclass(frozen=True)
class FpRound:
    """One round of a step: op rows [begin, begin + count) whose bits all
    sit in the lanes (index bits 0-4) and the ``reg`` bits (held in
    registers); ``blk`` the bits that index a member's blocks."""
    begin: int
    count: int
    reg: int
    blk: int


@dataclasses.dataclass(frozen=True)
class FpPlan:
    """K1/K2's launch geometry for n qubits: a member's state over
    ``blocks`` blocks of ``threads`` threads, 2^``rbits`` amplitudes of
    each plane (2 forward, 4 backward) a thread; ``mode`` 'block' (one
    block a member, exchanges through its shared memory in ``bufs``
    buffers) or 'grid' (a cooperative grid, exchanges through global
    memory, ``chunk`` members a launch so that every block is resident),
    an exchange moving ``xplanes`` planes a pass (the backward's four in
    one pass or two); ``smem`` dynamic shared memory a block; ``per_sm``
    blocks resident an SM; ``rounds`` a step's rounds in plan order (the
    last one's layout is the phase stages'); ``ops`` the op rows (slot,
    kind, location a, location b): a register rank, ``FP_LOC_LANE`` + a
    lane bit, or -1."""
    n: int
    backward: bool
    members: int
    groups: int
    mode: str
    rbits: int
    warp_bits: int
    block_bits: int
    threads: int
    bufs: int
    xplanes: int
    smem: int
    per_sm: int
    chunk: int
    rounds: tuple
    ops: tuple

    @property
    def planes(self) -> int:
        return 4 if self.backward else 2

    @property
    def blocks(self) -> int:
        """Blocks a member."""
        return 1 << self.block_bits

    @property
    def grid(self) -> int:
        """Blocks a launch (the last launch's may be fewer)."""
        return self.chunk * self.blocks

    @property
    def launches(self) -> int:
        return -(-self.members // self.chunk)

    @property
    def warps(self) -> int:
        """Warps a member (the d theta_x partials' width)."""
        return self.blocks * self.threads // 32

    @property
    def exchanges(self) -> int:
        """Layout changes a step (the first round's from the phase
        layout, which is the last round's)."""
        lay = [(r.reg, r.blk) for r in self.rounds]
        return sum(lay[i] != lay[i - 1] for i in range(len(lay)))


def _bits(mask: int) -> list:
    return [1 << b for b in range(mask.bit_length()) if mask >> b & 1]


def _popcount(mask: int) -> int:
    return bin(mask).count("1")


def _fp_runs(plan_ops, n: int, rbits: int) -> list:
    """A step's ops in plan order cut into runs whose bits above the lanes
    fit ``rbits`` register bits: [(begin, count, needed bits)]."""
    high = ((1 << n) - 1) & ~((1 << FP_LANE_BITS) - 1)
    runs, begin, cur = [], 0, 0
    for o, row in enumerate(plan_ops):
        need = (int(row[2]) | int(row[3])) & high
        if _popcount(cur | need) > rbits:
            runs.append((begin, o - begin, cur))
            begin, cur = o, 0
        cur |= need
    runs.append((begin, len(plan_ops) - begin, cur))
    return runs


def _fp_fill(mask: int, high: int, rbits: int) -> int:
    """``mask`` topped up to ``rbits`` bits of ``high``, the highest free
    ones first."""
    for b in _bits(high)[::-1]:
        if _popcount(mask) >= rbits:
            break
        mask |= b
    return mask


def _fp_top(mask: int, c: int) -> int:
    out = 0
    for b in _bits(mask)[::-1][:c]:
        out |= b
    return out


def _fp_blocks(regs: list, high: int, c: int) -> list:
    """Each round's c block bits, outside its register bits: constant
    where c bits are free of every round's, else over the fewest cyclic
    arcs of rounds."""
    m = len(regs)
    if c == 0:
        return [0] * m
    free = high
    for r in regs:
        free &= ~r
    if _popcount(free) >= c:
        return [_fp_top(free, c)] * m
    best = None
    for start in range(m):
        arcs, i = [], 0
        while i < m:
            j, used = i, 0
            while j < m and _popcount(
                    high & ~(used | regs[(start + j) % m])) >= c:
                used |= regs[(start + j) % m]
                j += 1
            arcs.append((i, j, _fp_top(high & ~used, c)))
            i = j
        if best is None or len(arcs) < len(best[1]):
            best = (start, arcs)
    start, arcs = best
    out = [0] * m
    for i, j, blk in arcs:
        for t in range(i, j):
            out[(start + t) % m] = blk
    return out


def _fp_loc(bit: int, reg: int) -> int:
    if bit < 1 << FP_LANE_BITS:
        return FP_LOC_LANE + bit.bit_length() - 1
    if not reg & bit:
        raise ValueError("an op's bit is not local in its round")
    return _popcount(reg & (bit - 1))


@functools.lru_cache(maxsize=256)
def fp_plan(n_qubits: int, plan_ops: tuple, members: int = 1,
            groups: int = 1, sm_count: int = None,
            backward: bool = False) -> FpPlan:
    """K1/K2's launch plan (plain Python; csrc/fused_product.cu checks it
    and chooses none) for the op rows ``plan_ops`` (:func:`_plan_ops`, as
    a tuple) over ``members`` states reading ``groups`` angle rows, on a
    card of ``sm_count`` SMs.

    - A thread holds 2^r amplitudes of each plane in registers: r = 3
      while the members leave SMs free (more warps hide a chain's
      latency), r = 4 once they fill the card (fewer instructions an
      amplitude). A member takes 2^(n-r) threads.
    - One block a member ('block') while its launch bounds
      (``FP_MAX_THREADS``, at ``FP_REGS`` registers) hold them and its
      buffers fit shared memory: up to 13 qubits forward and 12 backward.
      Past that (at r = 3) a cooperative grid of 256-thread blocks
      ('grid'), over as few launches of equal member chunks as keep every
      block of a launch resident.
    - Rounds: the step's ops in plan order, cut where their bits above the
      lanes pass r; each round's register bits are its ops' bits topped up
      from the highest free ones; the last round (the phase layout) takes
      the first round's bits where both fit, so that a step opens without
      an exchange. Block bits avoid a round's register bits and change
      across the fewest cyclic arcs of rounds.
    - Exchange buffers: two (one barrier an exchange) where they fit,
      else one; the backward's four planes in one pass or, where they do
      not fit, two. Past ``sm_count`` members, the choice that keeps the
      most blocks resident an SM."""
    n = n_qubits
    if not MIN_QUBITS <= n <= MAX_QUBITS:
        raise ValueError(f"fp_plan runs {MIN_QUBITS}..{MAX_QUBITS} qubits, "
                         f"got {n}")
    if members < 1 or groups < 1 or members % groups:
        raise ValueError(f"fp_plan: {groups} groups do not divide "
                         f"{members} members")
    if len(plan_ops) > MAX_OPS:
        raise ValueError(f"op plan has {len(plan_ops)} ops; the kernel "
                         f"holds {MAX_OPS}")
    sms = sm_count or H100_SMS
    # one block at 2^3 amplitudes a thread (more warps) while the members
    # leave SMs free; 2^4 (fewer instructions an amplitude) first once
    # they fill the card
    for rb in FP_RBITS[1:] if members <= sms else FP_RBITS:
        try:
            return _fp_geometry(n, plan_ops, members, groups, sms, backward,
                                "block", rb)
        except ValueError:
            pass
    return _fp_geometry(n, plan_ops, members, groups, sms, backward, "grid",
                        FP_GRID_RBITS)


def _fp_geometry(n, plan_ops, members, groups, sms, backward, mode, rb):
    """:func:`fp_plan` in ``mode`` at r = ``rb``; raises ValueError where
    it does not fit."""
    n_ops = len(plan_ops)
    planes = 4 if backward else 2
    need = 1 << (n - rb)            # threads a member
    runs = _fp_runs(plan_ops, n, rb)
    if len(runs) > FP_MAX_ROUNDS:
        raise ValueError(f"{len(runs)} rounds a step; the kernels hold "
                         f"{FP_MAX_ROUNDS}")

    def smem_of(threads, bufs, xp=planes):
        """The exchange buffer (``xp`` planes); a warp's (cos, sin) table,
        staged angles and base index in each round; a thread's ring of
        two phase rows and (backward) its held cotangents."""
        exch = 0 if mode == "grid" else 4 * xp * (threads << rb) * bufs
        return exch + threads // 32 * (n_ops * 12 + len(runs) * 4) \
            + ((12 if backward else 8) * threads << rb)

    def fits(threads, bufs, xp):
        return smem_of(threads, bufs, xp) + FP_STATIC_BYTES <= SMEM_BLOCK

    def per_sm(threads, bufs, xp):
        regs = FP_GRID_REGS if mode == "grid" else FP_REGS[backward, rb]
        return min(_SM_THREADS // threads, _SM_BLOCKS,
                   _SM_REGS // (threads * regs),
                   SMEM_SM // (smem_of(threads, bufs, xp)
                               + FP_STATIC_BYTES + SMEM_RESERVED))

    if mode == "block":
        threads = need
        if threads > FP_MAX_THREADS[backward, rb]:
            raise ValueError(f"{n} qubits need {threads} threads a block")
        # exchange buffers and planes a pass, fewest barriers an exchange
        # first; past sm_count members, the most blocks resident an SM
        shapes = [s_ for s_ in ((2, planes), (1, planes), (2, 2), (1, 2))
                  if fits(threads, *s_)]
        if not shapes:
            raise ValueError(f"{n} qubits do not fit a block of {threads}")
        if members > sms:
            shapes.sort(key=lambda s_: -per_sm(threads, *s_))
    elif mode == "grid" and rb == FP_GRID_RBITS:
        threads, shapes = FP_GRID_THREADS, [(1, planes)]
    else:
        raise ValueError(f"fp_plan: no mode {mode!r} at r = {rb}")
    bufs, xplanes = shapes[0]
    resident = per_sm(threads, bufs, xplanes)
    blocks = need // threads
    fit = resident * sms // blocks   # members whose blocks are resident
    if resident < 1 or fit < 1:
        raise ValueError(f"{n} qubits do not fit the card in mode {mode!r}")
    chunk = members if mode == "block" else \
        -(-members // -(-members // fit))
    c = blocks.bit_length() - 1

    high = ((1 << n) - 1) & ~((1 << FP_LANE_BITS) - 1)
    reg = [_fp_fill(need_, high, rb) for _, _, need_ in runs]
    first, last = runs[0][2], runs[-1][2]
    if len(runs) > 1 and _popcount(first | last) <= rb:
        reg[0] = reg[-1] = _fp_fill(first | last, high, rb)
    blk = _fp_blocks(reg, high, c)
    rounds = tuple(FpRound(b, k, r, bk)
                   for (b, k, _), r, bk in zip(runs, reg, blk))
    ops = []
    for rd in rounds:
        for row in plan_ops[rd.begin:rd.begin + rd.count]:
            slot, kind, ma, mb = (int(v) for v in row[:4])
            ops.append((slot, kind, _fp_loc(ma, rd.reg),
                        _fp_loc(mb, rd.reg) if kind == KIND_HOP else -1))
    return FpPlan(n, backward, members, groups, mode, rb,
                  n - FP_LANE_BITS - rb - c, c, threads, bufs, xplanes,
                  smem_of(threads, bufs, xplanes), resident, chunk, rounds,
                  tuple(ops))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_product")
    if not getattr(lib, "_dq_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dq_forward.argtypes = [p] * 10
        lib.dq_forward.restype = i
        lib.dq_backward.argtypes = [p] * 15
        lib.dq_backward.restype = i
        lib.dq_error_string.argtypes = [i]
        lib.dq_error_string.restype = ctypes.c_char_p
        lib._dq_typed = True
    return lib


def _raise_on(lib, code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.dq_error_string(code).decode()} ({code})")


def _ptr(t):
    return t.data_ptr() if t is not None and t.numel() else None


def _kernel_rows(t: torch.Tensor) -> torch.Tensor:
    """The [T, G, ...] rows the kernels read: a single chain's [T, ...]
    table is its one row (G = 1)."""
    return t[:, None] if t.ndim == 2 else t


def _members(psi_re: torch.Tensor) -> int:
    return psi_re.shape[0] if psi_re.ndim == 2 else 1


def _count(batched: bool, backward: bool):
    profiling.count(("k2_" if batched else "k1_")
                    + ("backward" if backward else "forward"))


_FP_RECORDS: dict = {}


def _fp_launch(plan, n_qubits, th, tx, members, backward, device):
    """A call's launch record, cached by its plan, shapes and device: (the
    plan, its op rows on the device, the host table and its address). The
    host table is what ``dq_forward`` / ``dq_backward`` check and launch
    from: the header (qubits, steps, ops, rounds, members, angle groups,
    op-angle groups, r, mode, threads, blocks a member, buffers, planes a
    pass, shared memory, members a launch), then the op rows and the
    rounds, four ints each."""
    key = (plan.tobytes(), n_qubits, th.shape[0], th.shape[1], tx.shape[1],
           members, backward, device)
    rec = _FP_RECORDS.get(key)
    if rec is None:
        geo = fp_plan(n_qubits, tuple(map(tuple, plan.tolist())), members,
                      th.shape[1], _sm_count(device), backward)
        head = (n_qubits, th.shape[0], len(geo.ops), len(geo.rounds),
                members, th.shape[1], tx.shape[1], geo.rbits,
                _FP_MODES[geo.mode], geo.threads, geo.blocks, geo.bufs,
                geo.xplanes, geo.smem, geo.chunk)
        host = np.asarray(head + sum(geo.ops, ()) + sum(
            ((r.begin, r.count, r.reg, r.blk) for r in geo.rounds), ()),
            dtype=np.int32)
        rec = _FP_RECORDS[key] = (geo, _plan_tensor(geo.ops, device), host,
                                   host.ctypes.data)
    return rec


def _forward_cuda(psi_re, psi_im, theta_half, theta_x, plan, n_qubits):
    """The forward launch: K1 for a state [d], K2 for a batch [B, d]."""
    batched = psi_re.ndim == 2
    b = _members(psi_re)
    th, tx = _kernel_rows(theta_half), _kernel_rows(theta_x)
    dev = psi_re.device
    geo, ops, _, host = _fp_launch(plan, n_qubits, th, tx, b, False, dev)
    psi_re, psi_im = psi_re.contiguous(), psi_im.contiguous()
    out_re, out_im = torch.empty_like(psi_re), torch.empty_like(psi_im)
    xbuf = torch.empty((geo.chunk, 2, 2, 1 << n_qubits), dtype=torch.float32,
                       device=dev) if geo.mode == "grid" else None
    lib = _lib()
    with profiling.span("chain.fwd"), torch.cuda.device(dev):
        code = lib.dq_forward(
            _ptr(th), _ptr(tx), _ptr(psi_re), _ptr(psi_im), _ptr(ops), host,
            _ptr(out_re), _ptr(out_im), _ptr(xbuf),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, code, "K2 forward" if batched else "K1 forward")
    _count(batched, backward=False)
    return out_re, out_im


def _backward_cuda(out_re, out_im, lam_re, lam_im, theta_half, theta_x,
                   plan, n_qubits):
    """The adjoint launch (K1 or K2, as :func:`_forward_cuda`); returns
    (dpsi0 re, im, d theta_half, d theta_x) in the shapes of the inputs
    (group rows summed over their members)."""
    batched = out_re.ndim == 2
    b = _members(out_re)
    th, tx = _kernel_rows(theta_half), _kernel_rows(theta_x)
    n_steps, d = th.shape[0], out_re.shape[-1]
    dev = out_re.device
    geo, ops, _, host = _fp_launch(plan, n_qubits, th, tx, b, True, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    gth = torch.empty((n_steps, b, d), **f32)
    gtx = torch.empty((n_steps, b, tx.shape[2]), **f32)
    gp_re, gp_im = torch.empty_like(out_re), torch.empty_like(out_im)
    part = torch.empty((b * n_steps * len(plan) * geo.warps,), **f32)
    xbuf = torch.empty((geo.chunk, 2, 4, d), **f32) \
        if geo.mode == "grid" else None
    lib = _lib()
    with profiling.span("chain.bwd"), torch.cuda.device(dev):
        code = lib.dq_backward(
            _ptr(th), _ptr(tx), _ptr(out_re), _ptr(out_im), _ptr(lam_re),
            _ptr(lam_im), _ptr(ops), host, _ptr(gth), _ptr(gtx),
            _ptr(gp_re), _ptr(gp_im), _ptr(part), _ptr(xbuf),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, code, "K2 backward" if batched else "K1 backward")
    _count(batched, backward=True)
    if not batched:
        return gp_re, gp_im, gth[:, 0], gtx[:, 0]
    return (gp_re, gp_im, _to_groups(gth, theta_half.shape[1]),
            _to_groups(gtx, theta_x.shape[1]))


class _FusedProductEvolve(torch.autograd.Function):
    """psi(T) and its exact adjoint, for one state (K1) or a batch (K2):
    the kernel pair on the card, the plain pair
    (:func:`fused_product_evolve_plain` / :func:`_adjoint_plain`, or
    their batched forms) on the CPU."""

    @staticmethod
    def forward(ctx, psi_re, psi_im, theta_half, theta_x, x_qubits,
                n_qubits, kinds, batched):
        plan = _plan_ops(x_qubits, kinds, n_qubits)
        check = _check_inputs_b if batched else _check_inputs
        check(psi_re, psi_im, theta_half, theta_x, n_qubits, len(plan))
        if psi_re.is_cuda:
            out_re, out_im = _forward_cuda(psi_re, psi_im, theta_half,
                                           theta_x, plan, n_qubits)
        elif psi_re.device.type == "cpu":
            plain = fused_product_evolve_batched_plain if batched \
                else fused_product_evolve_plain
            with profiling.span("chain.fwd"):
                out = plain(CP(psi_re, psi_im), theta_half, theta_x,
                            x_qubits, n_qubits, kinds)
            out_re, out_im = out.re, out.im
        else:
            raise ValueError(f"fused_product_evolve: no path for device "
                             f"{psi_re.device}")
        ctx.save_for_backward(out_re, out_im, theta_half, theta_x)
        ctx.static = (x_qubits, n_qubits, kinds, plan, batched)
        return out_re, out_im

    @staticmethod
    def backward(ctx, lam_re, lam_im):
        out_re, out_im, theta_half, theta_x = ctx.saved_tensors
        x_qubits, n_qubits, kinds, plan, batched = ctx.static
        lam_re, lam_im = lam_re.contiguous(), lam_im.contiguous()
        if out_re.is_cuda:
            gp_re, gp_im, gth, gtx = _backward_cuda(
                out_re, out_im, lam_re, lam_im, theta_half, theta_x, plan,
                n_qubits)
        else:
            plain = _adjoint_batched_plain if batched else _adjoint_plain
            with profiling.span("chain.bwd"):
                gp, gth, gtx = plain(CP(out_re, out_im), CP(lam_re, lam_im),
                                     theta_half, theta_x, x_qubits, n_qubits,
                                     kinds)
            gp_re, gp_im = gp.re, gp.im
        return gp_re, gp_im, gth, gtx, None, None, None, None


def fused_product_evolve(psi0: CP, theta_half: torch.Tensor,
                         theta_x: torch.Tensor, x_qubits: tuple,
                         n_qubits: int, kinds: tuple = None,
                         fast_math: bool = False) -> CP:
    """psi(T) = P(a_T) prod_t [R_t P(a_t)] psi0 (K1), differentiable in
    psi0, theta_half and theta_x.

    psi0: CP [2^n] f32; theta_half: [T, 2^n] half-step phase angles;
    theta_x: [T, n_x] rotation angles, column j for ``x_qubits[j]``;
    kinds: per-op 'x' | 'y' | 'hop' (default all 'x'); a hop entry is a
    qubit pair and its angle is already doubled. ``fast_math`` is
    accepted for API parity and changes nothing (see the module note)."""
    del fast_math
    kinds = tuple(kinds) if kinds else ("x",) * len(x_qubits)
    re, im = _FusedProductEvolve.apply(psi0.re, psi0.im, theta_half,
                                       theta_x, tuple(x_qubits), n_qubits,
                                       kinds, False)
    return CP(re, im)


def fused_product_evolve_batched(psi0: CP, theta_half: torch.Tensor,
                                 theta_x: torch.Tensor, x_qubits: tuple,
                                 n_qubits: int, kinds: tuple = None,
                                 fast_math: bool = False) -> CP:
    """Batched fused evolution (K2), differentiable in all three inputs:
    psi0 CP [B, 2^n] f32, theta_half [T, B, 2^n], theta_x [T, B, n_x]:
    per-member pulses, as in the JAX package.

    A table may also carry G rows for B members, G dividing B
    (theta_half [T, G, 2^n], theta_x [T, G, n_x]): row g then serves
    members g*B/G .. (g+1)*B/G - 1, and its gradient is the sum over
    them: no [T, B, 2^n] table is built for members that share their
    pulses (the MC estimator's branches). Tables are contiguous; an
    ``expand``ed [T, B, ...] table is refused on every device, since
    [T, 1, ...] group rows say the same without strides. ``fast_math``
    changes nothing, as for :func:`fused_product_evolve`. T = 1 runs the
    merged stage loop, which equals the JAX package's unmerged T = 1
    stage."""
    del fast_math
    kinds = tuple(kinds) if kinds else ("x",) * len(x_qubits)
    re, im = _FusedProductEvolve.apply(psi0.re, psi0.im, theta_half,
                                       theta_x, tuple(x_qubits), n_qubits,
                                       kinds, True)
    return CP(re, im)


def fused_rot_block(psi: CP, theta_x: torch.Tensor, x_qubits: tuple,
                    n_qubits: int, kinds: tuple = None,
                    fast_math: bool = False) -> CP:
    """One Strang rotation block with no phase, the sharded engine's
    'fused' local step: K1 for a state [2^n] with theta_x [n_x], K2 for a
    batch [B, 2^n] with theta_x [B, n_x] (or [1, n_x], one row for every
    member), each at T = 1 with a zero phase row (a T = 1 chain applies
    exactly its step's rotations, so the adjoint is the kernels' own).
    Launches count as K1's or K2's."""
    d = 1 << n_qubits
    zero = dict(dtype=torch.float32, device=psi.re.device)
    tx = theta_x.to(torch.float32)[None].contiguous()
    if psi.ndim == 1:
        return fused_product_evolve(psi, torch.zeros((1, d), **zero), tx,
                                    tuple(x_qubits), n_qubits, kinds,
                                    fast_math)
    # one shared zero row serves every member (G = 1 group rows)
    return fused_product_evolve_batched(psi, torch.zeros((1, 1, d), **zero),
                                        tx, tuple(x_qubits), n_qubits,
                                        kinds, fast_math)


# ---------------------------------------------------------------------------
# K3: the packed-phase chain, plain version
# ---------------------------------------------------------------------------

def _check_inputs_pk(psi_re, psi_im, ud, theta_x, h0th, signs, n_qubits,
                     n_x, what="fused_product_evolve_packed"):
    """The packed contract: psi [B, d], ud [T, B, n_diag+1], theta_x
    [T, B, n_x] (n_x angle slots, whatever the number of op rows that
    read them), h0th [d] f32, signs [P, d] int32 with 30 P >= n_diag."""
    ts = (psi_re, psi_im, ud, theta_x, h0th, signs)
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{what}: inputs on different devices")
    for t in ts[:5]:
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32, got {t.dtype}")
    if signs.dtype != torch.int32:
        raise TypeError(f"{what}: signs must be int32, got {signs.dtype}")
    if not all(t.is_contiguous() for t in ts[2:]):
        raise ValueError(f"{what} takes contiguous tables")
    if not 2 <= n_qubits <= 24:
        raise ValueError(f"{what} runs 2..24 qubits, got {n_qubits}")
    d = 1 << n_qubits
    if psi_re.ndim != 2 or psi_re.shape[1] != d \
            or psi_im.shape != psi_re.shape or psi_re.shape[0] < 1:
        raise ValueError(f"psi0 must be [B, {d}], got {tuple(psi_re.shape)}")
    b = psi_re.shape[0]
    if ud.ndim != 3 or ud.shape[0] < 1 or ud.shape[1] != b \
            or not 1 <= ud.shape[2] <= MAX_PACKED_TERMS + 1:
        raise ValueError(f"ud must be [T>=1, {b}, n_diag+1] with n_diag <= "
                         f"{MAX_PACKED_TERMS}, got {tuple(ud.shape)}")
    if theta_x.shape != (ud.shape[0], b, n_x):
        raise ValueError(f"theta_x must be [{ud.shape[0]}, {b}, {n_x}], "
                         f"got {tuple(theta_x.shape)}")
    n_diag = ud.shape[2] - 1
    if h0th.shape != (d,) or signs.ndim != 2 or signs.shape[1] != d \
            or not 1 <= signs.shape[0] <= 4 \
            or PLANE_BITS * signs.shape[0] < n_diag:
        raise ValueError(f"h0th must be [{d}] and signs [P, {d}] with "
                         f"30 P >= {n_diag}, got {tuple(h0th.shape)}, "
                         f"{tuple(signs.shape)}")
    if n_x > MAX_OPS:
        raise ValueError(f"op plan has {n_x} angle slots; the kernels "
                         f"hold {MAX_OPS}")


def _sign_bit(signs: torch.Tensor, k: int) -> torch.Tensor:
    """bit_k(j) of every amplitude as a float [d]."""
    return torch.bitwise_and(torch.bitwise_right_shift(
        signs[k // PLANE_BITS], k % PLANE_BITS), 1).to(torch.float32)


def _packed_angle(row: torch.Tensor, h0th, signs, n_diag: int):
    """A stage's angle [B, d] from its merged rows [B, n_diag+2]: the
    JAX kernel's formula, one sign row at a time (no [n_diag, d] table)."""
    th = row[:, n_diag + 1:n_diag + 2] * h0th + row[:, n_diag:n_diag + 1]
    for k in range(n_diag):
        a = row[:, k:k + 1]
        th = th + a - (2.0 * a) * _sign_bit(signs, k)
    return th


def _packed_core(re, im, udm, tx, h0th, signs, plan, d):
    """The forward stage loop on states [B, d] with packed phases; each
    op row rotates by its scale times its slot's angle."""
    n_steps, n_diag = tx.shape[0], udm.shape[2] - 2
    for k in range(n_steps + 1):
        th = _packed_angle(udm[k], h0th, signs, n_diag)
        c, s = torch.cos(th), torch.sin(th)
        re, im = c * re + s * im, c * im - s * re
        if k == n_steps:
            break
        for op in plan:
            a = _row_scale(op) * tx[k, :, int(op[0])][:, None]
            re, im = _rot_plain(re, im, op, torch.cos(a), torch.sin(a), d)
    return re, im


def _packed_adjoint_core(y_re, y_im, l_re, l_im, udm, tx, h0th, signs,
                         plan, d):
    """The backward stage loop of :func:`_packed_core`: (dpsi0 re, im,
    merged-row cotangents [T+1, B, n_diag+1], d theta_x [T, B, n_x]).
    Slot k of a merged row gets S0 - 2 S_k and the offset slot S0, with
    S0 = sum_j g_j, S_k = sum_j g_j bit_k(j), g = dL/d angle. A slot's
    d theta_x is the sum of its rows' gradients, each times its scale."""
    n_steps, n_diag = tx.shape[0], udm.shape[2] - 2
    b = y_re.shape[0]
    gud = torch.empty((n_steps + 1, b, n_diag + 1), dtype=torch.float32,
                      device=y_re.device)
    gtx = torch.zeros(tx.shape, dtype=torch.float32, device=tx.device)
    for k in range(n_steps, -1, -1):
        if k < n_steps:
            for op in plan[::-1]:
                j, scale = int(op[0]), _row_scale(op)
                a = scale * tx[k, :, j][:, None]
                y_re, y_im, l_re, l_im, g = _undo_rot_plain(
                    y_re, y_im, l_re, l_im, op, torch.cos(a), torch.sin(a),
                    d)
                gtx[k, :, j] += scale * g
        g = l_re * y_im - l_im * y_re
        s0 = g.sum(-1)
        for i in range(n_diag):
            gud[k, :, i] = s0 - 2.0 * (g * _sign_bit(signs, i)).sum(-1)
        gud[k, :, n_diag] = s0
        th = _packed_angle(udm[k], h0th, signs, n_diag)
        c, s = torch.cos(th), torch.sin(th)
        y_re, y_im = c * y_re - s * y_im, s * y_re + c * y_im
        l_re, l_im = c * l_re - s * l_im, s * l_re + c * l_im
    return l_re, l_im, gud, gtx


def fused_product_evolve_packed_plain(psi0: CP, ud: torch.Tensor,
                                      theta_x: torch.Tensor,
                                      h0th: torch.Tensor,
                                      signs: torch.Tensor, x_qubits: tuple,
                                      n_qubits: int,
                                      kinds: tuple = None) -> CP:
    """K3's forward in plain PyTorch: the packed contract of
    :func:`fused_product_evolve_packed`, any device."""
    kinds = tuple(kinds) if kinds else ("x",) * len(x_qubits)
    return packed_chain_plain(psi0, ud, theta_x, h0th, signs,
                              _packed_plan(x_qubits, kinds, n_qubits),
                              len(x_qubits), n_qubits)


def packed_chain_plain(psi0: CP, ud, theta_x, h0th, signs, plan, n_x: int,
                       n_qubits: int, what: str = "packed chain") -> CP:
    """The packed chain of op rows ``plan`` over [B, d] in plain PyTorch,
    any device: the forward of K3, K5 and K6."""
    _check_inputs_pk(psi0.re, psi0.im, ud, theta_x, h0th, signs, n_qubits,
                     n_x, what)
    re, im = _packed_core(psi0.re, psi0.im, merge_ud_rows(ud), theta_x,
                          h0th, signs, plan, 1 << n_qubits)
    return CP(re, im)


def _adjoint_packed_plain(psi_T: CP, lam: CP, ud, theta_x, h0th, signs,
                          x_qubits: tuple, n_qubits: int,
                          kinds: tuple = None):
    """K3's backward in plain PyTorch: (dpsi0 CP [B, d], d ud
    [T, B, n_diag+1], d theta_x [T, B, n_x])."""
    kinds = tuple(kinds) if kinds else ("x",) * len(x_qubits)
    return packed_adjoint_plain(psi_T, lam, ud, theta_x, h0th, signs,
                                _packed_plan(x_qubits, kinds, n_qubits),
                                len(x_qubits), n_qubits)


def packed_adjoint_plain(psi_T: CP, lam: CP, ud, theta_x, h0th, signs,
                         plan, n_x: int, n_qubits: int,
                         what: str = "packed chain"):
    """The backward of :func:`packed_chain_plain`: (dpsi0 CP [B, d], d ud
    [T, B, n_diag+1], d theta_x [T, B, n_x])."""
    _check_inputs_pk(psi_T.re, psi_T.im, ud, theta_x, h0th, signs,
                     n_qubits, n_x, what)
    g_re, g_im, gud, gtx = _packed_adjoint_core(
        psi_T.re, psi_T.im, lam.re, lam.im, merge_ud_rows(ud), theta_x,
        h0th, signs, plan, 1 << n_qubits)
    return CP(g_re, g_im), unmerge_phase_grads(gud), gtx


# ---------------------------------------------------------------------------
# K3-K6 on the card: passes over the state in global memory
# ---------------------------------------------------------------------------

PASS_TILE, PASS_STRIDED, PASS_CROSS, PASS_MID = 0, 1, 2, 3
_CROSS_THREADS = 256
# The H100 (sm_90): shared memory one block may use, an SM's, and what the
# system reserves per block; SMs, threads and registers per SM.
SMEM_BLOCK = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024
H100_SMS = 132
_SM_THREADS, _SM_REGS = 2048, 65536
# The pass kernels' static shared memory (op table, stage row; the
# backward's per-warp sums) by state planes: bounds that
# csrc/packed_phase.cu static_asserts (kFwdStatic, kBwdStatic). A tile
# pass also holds four 256-entry unit-phase tables (float2) per staged
# sign plane.
PK_STATIC_BYTES = {2: 5 * 1024, 4: 21 * 1024}
PK_LUT_BYTES = 4 * 256 * 8
# 2^r amplitudes a thread holds in a round, by state planes: r in
# [PK_MIN_RBITS, PK_MAX_RBITS] aiming at PK_THREADS threads a block (the
# backward's 2^4 amplitudes of y and lambda spill at 128 registers)
PK_MIN_RBITS = {2: 3, 4: 3}
PK_MAX_RBITS = {2: 5, 4: 4}
PK_THREADS = {2: 256, 4: 512}
PK_MAX_STAGES = 3
PK_SEG_COLS = 8               # strided rows of 32 bytes where they fit
PK_MAX_COLS = 6               # up to 256-byte rows
PK_PASSES = (2, 3)            # passes a step: tile, [middle,] strided


def _pk_regs(planes: int, rbits: int) -> int:
    """Registers a thread of a pass kernel may take (its launch bounds:
    the forward at r <= 4 two 512-thread blocks an SM, else one)."""
    return 64 if planes == 2 and rbits <= 4 else 128


@dataclasses.dataclass(frozen=True)
class PassGeom:
    """One pass kind's launch geometry. A tile holds 2^lb amplitudes
    (``words`` f32 words each: the state planes and, in a tile pass, the
    staged sign planes); in each round, ``threads`` threads hold 2^rbits
    of them in registers (2^(lb - rbits) groups); ``blocks`` blocks per
    member walk the member's ``tiles`` tiles through a ring of ``stages``
    buffers filled by cp.async; ``per_sm`` blocks fit an SM. A pass whose
    ops take one round runs direct instead (:func:`_pass_layout`: stages
    0, no ring), with ``direct_blocks`` blocks per member: as many as the
    SMs' threads and registers hold."""
    lb: int
    words: int
    rbits: int
    threads: int
    stages: int
    tiles: int
    blocks: int
    per_sm: int
    static_bytes: int
    lut_bytes: int
    direct_blocks: int

    @property
    def stage_bytes(self) -> int:
        return 4 * self.words << self.lb

    @property
    def block_bytes(self) -> int:
        """Shared memory of one block: its ring, its phase tables and its
        static tables."""
        return self.stages * self.stage_bytes + self.lut_bytes \
            + self.static_bytes

    @property
    def resident(self) -> int:
        """Tiles an SM holds at once (blocks x ring stages)."""
        return self.per_sm * self.stages


@dataclasses.dataclass(frozen=True)
class PkPlan:
    """The pass kernels' geometry for n qubits, ``planes`` f32 state
    planes (2 forward, 4 backward) and ``members`` states. A step's ops
    split by bits: the tile pass ``tile`` takes the low k bits, the
    middle pass ``mid`` the bits k..k2-1 and the strided pass
    ``strided`` the bits k2..n-1, both in rows of 2^lc low-bit columns
    (``mid`` is None when k2 = k: two passes a step; ``strided`` None
    when k2 = n). Cross passes take ``_cross_blocks``."""
    n: int
    planes: int
    members: int
    k: int
    k2: int
    lc: int
    tile: PassGeom
    mid: PassGeom | None
    strided: PassGeom | None

    @property
    def seg_bytes(self) -> int:
        """Bytes of one row segment of a middle or strided tile (0 when
        the tile pass holds every bit)."""
        return 4 << self.lc if self.k < self.n else 0

    @property
    def passes(self) -> tuple:
        return tuple(g for g in (self.tile, self.mid, self.strided)
                     if g is not None)

    def geom(self, kind: int) -> PassGeom:
        return {PASS_TILE: self.tile, PASS_MID: self.mid,
                PASS_STRIDED: self.strided}[kind]


def _pass_geom(lb: int, words: int, planes: int, tiles: int, members: int,
               sms: int, lut_bytes: int = 0) -> PassGeom | None:
    """The geometry of a pass whose tiles hold 2^lb amplitudes of
    ``words`` words (and ``lut_bytes`` of phase tables a block), or None
    if no tile fits a block: of the ring depths that fit, one that keeps
    two tiles resident per SM (blocks x stages: one loads while one
    computes) with the most blocks an SM (more warps to hide latency),
    then the most tiles resident."""
    aim = lb - PK_THREADS[planes].bit_length() + 1
    rbits = min(lb, max(PK_MIN_RBITS[planes], aim, lb - 9))  # <= 512 groups
    if lb < 2 or rbits > PK_MAX_RBITS[planes]:
        return None
    threads = max(32, 1 << (lb - rbits))
    static = PK_STATIC_BYTES[planes] + lut_bytes
    stage = 4 * words << lb
    by_regs = _SM_REGS // (threads * _pk_regs(planes, rbits))
    direct = min(tiles, max(1, min(
        _SM_THREADS // threads, by_regs,
        SMEM_SM // (static + SMEM_RESERVED)) * sms // members))
    best = None
    for stages in range(1, PK_MAX_STAGES + 1):
        if stages * stage + static > SMEM_BLOCK:
            break
        per_sm = max(1, min(
            SMEM_SM // (stages * stage + static + SMEM_RESERVED),
            _SM_THREADS // threads, by_regs))
        blocks = min(tiles, max(1, per_sm * sms // members))
        used = min(stages, -(-tiles // blocks))  # no stage beyond its tiles
        shares = min(per_sm * used, -(-tiles * members // sms))
        key = (min(shares, 2), per_sm, shares)
        if best is None or key > best[0]:
            best = (key, PassGeom(lb, words, rbits, threads, used, tiles,
                                  blocks, per_sm, PK_STATIC_BYTES[planes],
                                  lut_bytes, direct))
    return None if best is None else best[1]


@functools.lru_cache(maxsize=256)
def pk_plan(n_qubits: int, planes: int, n_diag: int, members: int = 1,
            sms: int = H100_SMS) -> PkPlan:
    """The pass kernels' geometry (plain Python; csrc/packed_phase.cu
    checks it and chooses none). Over the splits k <= k2 <= n and the
    columns lc whose tiles fit one block's shared memory (a tile pass
    stages ceil(n_diag / 30) sign planes and holds their phase tables),
    with the passes a step may take in ``PK_PASSES``, it prefers in
    order: 32-byte rows (else the widest that fit); two tiles resident
    per SM in every pass (one loads while one computes); fewer passes a
    step (each moves the whole state); blocks enough to fill the card
    twice over; tiles of up to 2^12 amplitudes in the smallest pass; more
    tiles resident in the pass with fewer (then in the tile pass, which
    also computes the phases); more tiles; and the smaller k and lc."""
    n = n_qubits
    signs = -(-n_diag // PLANE_BITS)
    best = None
    for k in range(1, n + 1):
        for k2 in range(k, n + 1):
            n_pass = 1 + (k2 > k) + (k2 < n)
            if n_pass not in PK_PASSES and k < n:
                continue
            cols = range(min(k, PK_MAX_COLS) + 1) if k < n else (0,)
            for lc in cols:
                tile = _pass_geom(k, planes + signs, planes, 1 << (n - k),
                                  members, sms, signs * PK_LUT_BYTES)
                mid = None if k2 == k else _pass_geom(
                    k2 - k + lc, planes, planes, 1 << (n - k2 + k - lc),
                    members, sms)
                strided = None if k2 == n else _pass_geom(
                    n - k2 + lc, planes, planes, 1 << (k2 - lc), members,
                    sms)
                if tile is None or (k2 > k and mid is None) \
                        or (k2 < n and strided is None):
                    continue
                geoms = [g for g in (tile, mid, strided) if g is not None]
                tiles = min(g.tiles for g in geoms)
                key = (k == n or (1 << lc) >= PK_SEG_COLS, min(lc, 3),
                       min(min(g.resident, 2) for g in geoms), -n_pass,
                       min(tiles * members, 2 * sms),
                       min(min(g.lb for g in geoms), 12),
                       min(g.resident for g in geoms), tile.resident, tiles,
                       -k, -lc)
                if best is None or key > best[0]:
                    best = (key, PkPlan(n, planes, members, k, k2, lc, tile,
                                        mid, strided))
    if best is None:
        raise ValueError(f"{n_qubits} qubits do not fit the pass kernels")
    return best[1]


def _op_bits(op) -> int:
    return int(op[2]) | int(op[3])


def _pass_plan(plan: np.ndarray, n_qubits: int, k: int, lc: int,
               k2: int = None):
    """Group one Strang step's ordered ops into passes: the first a tile
    pass (the stage's phase, then ops on the low k bits), then middle
    passes (ops on the bits k..k2-1), strided passes (ops on the bits
    from k2; k2 = k by default: two pass kinds) and cross passes (one op
    with bits on two sides, e.g. a hop across the tile boundary). An op
    joins the latest pass of its kind only when it commutes with every op
    after that pass (disjoint bits) and that pass holds fewer than
    ``MAX_OPS`` ops, so the product is the plan's own. With k = n every
    op is a tile op. Returns (passes [(kind, [plan rows])], table [n_ops,
    width] int32: each row with its masks in its pass's local index space
    (a middle or strided row's bits above the lc columns), its other
    columns as they are)."""
    k2 = k if k2 is None else k2
    ranges = ((PASS_TILE, 0, k), (PASS_MID, k, k2),
              (PASS_STRIDED, k2, n_qubits))
    passes = [(PASS_TILE, [])]
    for op in plan:
        bits = _op_bits(op)
        kind = PASS_CROSS
        for kd, lo, hi in ranges:
            if lo < hi and not bits & ~(((1 << hi) - 1) ^ ((1 << lo) - 1)):
                kind = kd
        target = None
        if kind != PASS_CROSS:
            for pk, ops in reversed(passes):
                if pk == kind:
                    target = ops
                    break
                if any(_op_bits(o) & bits for o in ops):
                    break
        if target is None or len(target) >= MAX_OPS:
            passes.append((kind, [op]))
        else:
            target.append(op)
    rows = []
    for pk, ops in passes:
        first = {PASS_MID: k, PASS_STRIDED: k2}.get(pk)
        for op in ops:
            row = [int(v) for v in op]
            if first is not None:
                row[2] = (row[2] >> first) << lc
                row[3] = (row[3] >> first) << lc
            rows.append(row)
    return passes, np.asarray(rows, dtype=np.int32).reshape(
        len(rows), plan.shape[1])


def _pass_rounds(masks, lb: int, rbits: int) -> list[int]:
    """Round masks of a pass's ordered ops (their local bit masks): the
    ops split into runs whose bits fit ``rbits`` bits, each run's mask
    those bits, topped up to ``rbits`` bits from the highest free ones
    (so that the threads of a round spread over the low bits)."""
    def close(cur):
        free = [b for b in range(lb - 1, -1, -1) if not cur >> b & 1]
        for b in free[:rbits - bin(cur).count("1")]:
            cur |= 1 << b
        return cur
    out, run, cur = [], 0, 0
    for m in masks:
        if bin(cur | m).count("1") > rbits:
            out += [close(cur)] * run
            run, cur = 0, 0
        run, cur = run + 1, cur | m
    return out + [close(cur)] * run


def _pass_shape(kind: int, n_qubits: int, k: int, lc: int, k2: int = None):
    """(local bits, columns, the rows' first bit, row bits) of a tile,
    middle or strided pass: the kernels' index map (amp_index)."""
    k2 = k if k2 is None else k2
    if kind == PASS_TILE:
        return k, k, k, 0
    if kind == PASS_MID:
        return k2 - k + lc, lc, k, k2 - k
    return n_qubits - k2 + lc, lc, k2, n_qubits - k2


def _pass_tiles(kind: int, n_qubits: int, k: int, lc: int,
                k2: int = None) -> int:
    """Tiles of a tile, middle or strided pass per member."""
    return 1 << (n_qubits - _pass_shape(kind, n_qubits, k, lc, k2)[0])


def _cross_blocks(n_qubits: int) -> int:
    return max(1, min(1024, (1 << n_qubits) // 4 // _CROSS_THREADS))


@functools.lru_cache(maxsize=64)
def _pass_layout(plan_key: tuple, n_qubits: int, planes: int,
                 n_diag: int, n_x: int = None, members: int = 1,
                 sms: int = H100_SMS):
    """For a plan (packed op rows as a tuple) and ``planes`` (2 forward,
    4 backward) over ``members`` states: (k, lc, passes int32 [n_pass, 9]
    = (kind, first op row, op count, blocks per member, partial offset,
    partial width, register bits, threads, ring stages: 0 for a pass of
    one round, which runs direct), op table [n_ops, 6] (the rows with
    local masks and, last, their round's mask), slot table, partial
    floats per stage and member), the geometry from :func:`pk_plan`
    (whose k2 the middle passes use). Backward blocks write their partial
    sums at (offset + block * width + column): a tile pass's columns are
    its ops, then S_0..S_{n_diag-1} and S0. The slot table (int32, flat)
    lists every (pass, column) where each of the ``n_x`` angle slots
    (default: the largest slot + 1) has a row: ``n_x + 1`` offsets, then
    per location (partial offset, blocks, width, column), each slot's
    locations in plan order."""
    plan = np.asarray(plan_key, dtype=np.int32).reshape(len(plan_key), 5)
    if n_x is None:
        n_x = int(plan[:, 0].max()) + 1 if len(plan) else 0
    geo = pk_plan(n_qubits, planes, n_diag, members, sms)
    k, lc = geo.k, geo.lc
    passes, table = _pass_plan(plan, n_qubits, k, lc, geo.k2)
    rounds = np.zeros((len(table), 1), np.int32)
    desc, locs = [], [[] for _ in range(n_x)]
    first, off = 0, 0
    for i, (kind, ops) in enumerate(passes):
        if kind == PASS_CROSS:
            blocks, shape = _cross_blocks(n_qubits), (0, 0, 0)
        else:
            g = geo.geom(kind)
            local = table[first:first + len(ops)]
            masks = _pass_rounds([int(r[2]) | int(r[3]) for r in local],
                                 g.lb, g.rbits)
            rounds[first:first + len(ops), 0] = masks
            one = len(set(masks)) <= 1
            blocks = g.direct_blocks if one else g.blocks
            shape = (g.rbits, g.threads, 0 if one else g.stages)
        width = len(ops) + (n_diag + 1 if i == 0 else 0)
        desc.append((kind, first, len(ops), blocks, off, width) + shape)
        for col, op in enumerate(ops):
            locs[int(op[0])].append((off, blocks, width, col))
        first += len(ops)
        off += blocks * width
    starts = np.cumsum([0] + [len(v) for v in locs])
    slots = np.concatenate([starts, np.asarray(
        [x for v in locs for loc in v for x in loc], np.int64)]
    ).astype(np.int32)
    return (k, lc, np.asarray(desc, np.int32).reshape(-1, 9),
            np.concatenate([table, rounds], axis=1), slots, off)


_ZERO_DRIFT: dict = {}


def zero_drift(d: int, device) -> torch.Tensor:
    """A zero h0th [d] on ``device`` that the pass kernels know to be zero
    (they then read no drift): one cached tensor per (d, device), for
    :func:`..dynamics.product.packed_chain_inputs` to hand out when a
    Hamiltonian has no drift."""
    key = (d, str(torch.device(device)))
    if key not in _ZERO_DRIFT:
        _ZERO_DRIFT[key] = torch.zeros(d, dtype=torch.float32, device=device)
    return _ZERO_DRIFT[key]


def _drift_flag(h0th: torch.Tensor) -> int:
    """0 for a :func:`zero_drift` tensor never written since, else 1."""
    z = _ZERO_DRIFT.get((h0th.shape[0], str(h0th.device)))
    return 0 if h0th is z and h0th._version == 0 else 1


@functools.lru_cache(maxsize=16)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _packed_lib() -> ctypes.CDLL:
    lib = _build.load("packed_phase")
    if not getattr(lib, "_dq_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dq_pk_forward.argtypes = [p] * 8 + [i] * 11 + [p]
        lib.dq_pk_forward.restype = i
        lib.dq_pk_backward.argtypes = [p] * 14 + [i] * 12 + [p]
        lib.dq_pk_backward.restype = i
        lib.dq_pk_error_string.argtypes = [i]
        lib.dq_pk_error_string.restype = ctypes.c_char_p
        lib._dq_typed = True
    return lib


def _host_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _device_layout(plan, n_qubits, planes, n_diag, n_x, members, device):
    """(k, k2, lc, passes, device op table, slots, stride) of
    :func:`_pass_layout` and :func:`pk_plan` for a plan on ``device``."""
    sms = _sm_count(device)
    k, lc, desc, table, slots, stride = _pass_layout(
        tuple(map(tuple, plan.tolist())), n_qubits, planes, n_diag, n_x,
        members, sms)
    k2 = pk_plan(n_qubits, planes, n_diag, members, sms).k2
    ops = _plan_tensor(tuple(map(tuple, table.tolist())), device)
    return k, k2, lc, desc, ops, slots, stride


def _packed_forward_cuda(psi_re, psi_im, udm, tx, h0th, signs, plan,
                         n_qubits, what):
    """One forward chain on the card (K3-K6): the state [B, d] is copied
    once and updated in place by the pass launches (~2T+1 for K3/K5's
    plans) that ``dq_pk_forward`` enqueues."""
    b, n_diag = psi_re.shape[0], udm.shape[2] - 2
    k, k2, lc, desc, ops, _, _ = _device_layout(
        plan, n_qubits, 2, n_diag, tx.shape[2], b, psi_re.device)
    out_re = psi_re.clone(memory_format=torch.contiguous_format)
    out_im = psi_im.clone(memory_format=torch.contiguous_format)
    lib = _packed_lib()
    with profiling.span("chain.fwd"), torch.cuda.device(psi_re.device):
        stream = torch.cuda.current_stream(psi_re.device).cuda_stream
        code = lib.dq_pk_forward(
            _ptr(out_re), _ptr(out_im), _ptr(udm), _ptr(tx), _ptr(h0th),
            _ptr(signs), _ptr(ops), _host_ptr(desc), len(desc), n_qubits,
            k, k2, lc, tx.shape[0], b, n_diag,
            signs.shape[0], tx.shape[2], _drift_flag(h0th), stream)
    if code != 0:
        raise RuntimeError(f"{what} forward launch failed: "
                           f"{lib.dq_pk_error_string(code).decode()} "
                           f"({code})")
    return out_re, out_im


def _packed_backward_cuda(out_re, out_im, lam_re, lam_im, udm, tx, h0th,
                          signs, plan, n_qubits, what):
    """One adjoint chain on the card: (dpsi0 re, im, merged-row cotangents
    [T+1, B, n_diag+1], d theta_x [T, B, n_x]). The pass blocks write
    partial sums; one reduction launch sums them in a fixed order."""
    b, n_diag = out_re.shape[0], udm.shape[2] - 2
    n_steps, n_x = tx.shape[0], tx.shape[2]
    dev = out_re.device
    k, k2, lc, desc, ops, slots, stride = _device_layout(
        plan, n_qubits, 4, n_diag, n_x, b, dev)
    slot_tab = _int_tensor(tuple(slots.tolist()), dev)
    y_re = out_re.clone(memory_format=torch.contiguous_format)
    y_im = out_im.clone(memory_format=torch.contiguous_format)
    l_re = lam_re.clone(memory_format=torch.contiguous_format)
    l_im = lam_im.clone(memory_format=torch.contiguous_format)
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty(((n_steps + 1) * b * stride,), **f32)
    gud = torch.empty((n_steps + 1, b, n_diag + 1), **f32)
    gtx = torch.empty((n_steps, b, n_x), **f32)
    lib = _packed_lib()
    with profiling.span("chain.bwd"), torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dq_pk_backward(
            _ptr(y_re), _ptr(y_im), _ptr(l_re), _ptr(l_im), _ptr(udm),
            _ptr(tx), _ptr(h0th), _ptr(signs), _ptr(ops), _host_ptr(desc),
            _ptr(part), _ptr(slot_tab), _ptr(gud),
            _ptr(gtx), len(desc), stride, n_qubits, k, k2, lc, n_steps, b,
            n_diag, signs.shape[0], n_x, _drift_flag(h0th), stream)
    if code != 0:
        raise RuntimeError(f"{what} backward launch failed: "
                           f"{lib.dq_pk_error_string(code).decode()} "
                           f"({code})")
    return l_re, l_im, gud, gtx


def _count_k3(backward: bool):
    profiling.count("k3_backward" if backward else "k3_forward")


class _PackedEvolve(torch.autograd.Function):
    """psi(T) and its exact adjoint with packed phases, over [B, d], for
    the op rows ``plan`` on ``n_x`` angle slots: the pass kernels on the
    card (K3, or K5 and K6 through :mod:`.fused_chunked` and
    :mod:`.fused_mega_hop`), the plain pair on the CPU.
    ``count(backward)`` is the calling entry point's launch counter."""

    @staticmethod
    def forward(ctx, psi_re, psi_im, ud, theta_x, h0th, signs, plan, n_x,
                n_qubits, count, what):
        _check_inputs_pk(psi_re, psi_im, ud, theta_x, h0th, signs, n_qubits,
                         n_x, what)
        udm = merge_ud_rows(ud)
        if psi_re.is_cuda:
            out_re, out_im = _packed_forward_cuda(
                psi_re, psi_im, udm, theta_x, h0th, signs, plan, n_qubits,
                what)
            count(False)
        elif psi_re.device.type == "cpu":
            with profiling.span("chain.fwd"):
                out_re, out_im = _packed_core(psi_re, psi_im, udm, theta_x,
                                              h0th, signs, plan,
                                              1 << n_qubits)
        else:
            raise ValueError(f"{what}: no path for device {psi_re.device}")
        ctx.save_for_backward(out_re, out_im, udm, theta_x, h0th, signs)
        ctx.static = (n_qubits, plan, count, what)
        return out_re, out_im

    @staticmethod
    def backward(ctx, lam_re, lam_im):
        out_re, out_im, udm, theta_x, h0th, signs = ctx.saved_tensors
        n_qubits, plan, count, what = ctx.static
        lam_re, lam_im = lam_re.contiguous(), lam_im.contiguous()
        if out_re.is_cuda:
            gp_re, gp_im, gud, gtx = _packed_backward_cuda(
                out_re, out_im, lam_re, lam_im, udm, theta_x, h0th, signs,
                plan, n_qubits, what)
            count(True)
        else:
            with profiling.span("chain.bwd"):
                gp_re, gp_im, gud, gtx = _packed_adjoint_core(
                    out_re, out_im, lam_re, lam_im, udm, theta_x, h0th,
                    signs, plan, 1 << n_qubits)
        return (gp_re, gp_im, unmerge_phase_grads(gud), gtx, None, None,
                None, None, None, None, None)


def run_packed_chain(psi0: CP, ud, theta_x, h0th, signs, plan, n_x: int,
                     n_qubits: int, count, what: str) -> CP:
    """The packed chain of op rows ``plan`` (:func:`_packed_plan`, or
    K6's half-angle rows) over [B, d] through :class:`_PackedEvolve`, the
    body of K3's, K5's and K6's entry points."""
    re, im = _PackedEvolve.apply(psi0.re, psi0.im, ud, theta_x, h0th, signs,
                                 plan, n_x, n_qubits, count, what)
    return CP(re, im)


def fused_product_evolve_packed(psi0: CP, ud: torch.Tensor,
                                theta_x: torch.Tensor, h0th: torch.Tensor,
                                signs: torch.Tensor, x_qubits: tuple,
                                n_qubits: int, kinds: tuple = None,
                                fast_math: bool = False) -> CP:
    """Fused evolution with the diagonal phases computed in the kernel
    (K3), differentiable in psi0, ud and theta_x.

    psi0: CP [B, 2^n] f32; ud: [T, B, n_diag+1] per-step scaled diagonal
    controls (slot k = dt/2 u_k w_k, the last slot the offset
    dt/2 sum_k u_k c_k); theta_x: [T, B, n_x] rotation angles (X, Y and
    hop ops, as :func:`fused_product_evolve`); h0th: [2^n] drift
    half-angles dt/2 h0 (zero cotangent); signs: [P, 2^n] int32 sign
    bit-planes (:func:`pack_diag_signs`, no cotangent). ``fast_math``
    changes nothing, as for :func:`fused_product_evolve`."""
    del fast_math
    kinds = tuple(kinds) if kinds else ("x",) * len(x_qubits)
    return run_packed_chain(psi0, ud, theta_x, h0th, signs,
                            _packed_plan(x_qubits, kinds, n_qubits),
                            len(x_qubits), n_qubits, _count_k3, "K3")
