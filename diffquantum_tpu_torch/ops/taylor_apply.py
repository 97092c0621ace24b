"""K7: the fused truncated-Taylor apply ``exp(z H) psi`` — the port of
:mod:`diffquantum_tpu.ops.pallas_kernels` (``taylor_apply_fused``).

The dense 'apply' backend of the propagator takes one step as ``2^s``
substeps of ``order`` Taylor terms, ``t_k = (w/k) H t_{k-1}`` with
``w = z / substeps``, summed per substep (:func:`..ops.expm.
cexpm_apply_taylor` in the JAX package, in XLA). On the card each step
is one launch of the hand-written kernel in ``csrc/taylor_apply.cu``;
its backward is a second kernel that returns the cotangents of psi and
of H (the coefficient gradient flows on through ``H(t) = H0 + sum u_k
H_k``, a plain product outside any kernel). Both are IEEE fp32 for
d <= 1024, as the TPU kernel served. On the CPU the wrapper runs the
plain versions beside them (:func:`taylor_apply_plain`,
:func:`taylor_apply_backward_plain`); a CUDA tensor always launches the
kernel or raises. :func:`k7_plan` chooses the launch's configuration
(block-resident for small d, row-split for the rest) in plain Python and
passes its geometry to the kernels as ints.

The 'apply' backend chooses its route per chain before any launch
(:func:`apply_route`): K7 for float32 on the card with d <= 1024, and
otherwise the truncated-Taylor recurrence in plain products
(:func:`taylor_apply_recurrence`, ``ops/expm.py::taylor_recurrence``),
which is what the JAX package's 'apply' runs at every size and dtype.
The recurrence is the route for the shapes K7 does not take, not a
fallback: no failed build or launch reaches it.

Real-plane cotangents: a loss L of the output planes gives
``g = dL/dout_re + i dL/dout_im``; the returned ``(gH_re, gH_im)`` and
``(gpsi_re, gpsi_im)`` are the gradients of the input planes, so that
``dL = Re sum conj(G) dX`` for X in (H, psi). For the polynomial p(A) of
one substep, A = w H: gpsi = p(A)^dagger g, and gH sums
``conj(w/k) gbar_k t_{k-1}^dagger`` over the terms, gbar_k the
cotangent of term k.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..utils import profiling
from . import _build, cpx
from .cpx import CP
from .expm import taylor_recurrence

MAX_D = 1024  # the largest dimension K7 takes (the TPU kernel's _MAX_D)


def apply_route(device, dtype, d: int) -> str:
    """The dense 'apply' step's route from (device, dtype, d): 'k7' for
    float32 planes on a CUDA card with d <= ``MAX_D``, else
    'recurrence'."""
    if torch.device(device).type == "cuda" and dtype == torch.float32 \
            and d <= MAX_D:
        return "k7"
    return "recurrence"


def _check(h: CP, psi: CP, zs: torch.Tensor):
    if psi.ndim != 2 or h.ndim != 2:
        raise ValueError(f"taylor_apply takes H [d, d] and psi [B, d], got "
                         f"{tuple(h.shape)} and {tuple(psi.shape)}")
    d = psi.shape[1]
    if tuple(h.shape) != (d, d):
        raise ValueError(f"H must be [{d}, {d}], got {tuple(h.shape)}")
    if zs.shape != (2,):
        raise ValueError("zs must be the per-substep (w_re, w_im), [2]")
    devs = {t.device for t in (h.re, h.im, psi.re, psi.im, zs)}
    if len(devs) != 1:
        raise ValueError(f"taylor_apply inputs lie on several devices: "
                         f"{sorted(map(str, devs))}")
    if psi.re.is_cuda:
        dts = {t.dtype for t in (h.re, h.im, psi.re, psi.im, zs)}
        if dts != {torch.float32}:
            raise ValueError(
                f"K7 takes float32 planes on the card, got "
                f"{sorted(map(str, dts))}; the dense 'apply' backend "
                "routes other dtypes to the recurrence (apply_route)")
        if d > MAX_D:
            raise ValueError(
                f"K7 takes d <= {MAX_D}, got {d}; the dense 'apply' "
                "backend routes larger d to the recurrence (apply_route)")


# ---------------------------------------------------------------------------
# the plain versions (what the CPU runs; chip_smoke holds the kernels
# against them on the card)
# ---------------------------------------------------------------------------

def taylor_apply_plain(h: CP, psi: CP, zs: torch.Tensor, order: int,
                       substeps: int) -> CP:
    """K7's forward in plain PyTorch: psi [B, d], zs the per-substep
    (w_re, w_im)."""
    return taylor_recurrence(h, psi, zs[0], zs[1], order, substeps)


def _outer(g: CP, t: CP) -> CP:
    """sum_b g[b, i] conj(t[b, j])."""
    gt = CP(g.re.transpose(0, 1), g.im.transpose(0, 1))
    return CP(gt.re @ t.re + gt.im @ t.im, gt.im @ t.re - gt.re @ t.im)


def taylor_apply_backward_plain(h: CP, psi: CP, g: CP, zs: torch.Tensor,
                                order: int, substeps: int):
    """K7's backward in plain PyTorch, the kernel's algorithm: the
    forward's terms, then the reverse recurrence. Returns (gH, gpsi)."""
    w_re, w_im = zs[0], zs[1]
    terms, x = [], psi
    for _ in range(substeps):
        ts, term, acc = [x], x, x
        for k in range(1, order + 1):
            term = cpx.cscale(cpx.matvec(h, term), w_re / k, w_im / k)
            acc = cpx.add(acc, term)
            if k < order:
                ts.append(term)
        terms.append(ts)
        x = acc
    hd = cpx.dag(h)
    gh = cpx.zeros(h.shape, dtype=h.dtype, device=h.re.device)
    lam = g
    for ts in reversed(terms):
        gbar = lam
        for k in range(order, 0, -1):
            c_re, c_im = w_re / k, -w_im / k        # conj(w / k)
            gh = cpx.add(gh, cpx.cscale(_outer(gbar, ts[k - 1]), c_re, c_im))
            gbar = cpx.add(lam, cpx.cscale(cpx.matvec(hd, gbar), c_re, c_im))
        lam = gbar
    return gh, lam


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232_448   # shared memory a block may use on the H100 (bytes)
SMS = 132              # streaming multiprocessors of the H100 SXM
BLOCK_MAX_D = 64       # the largest d of the block-resident configuration
ROWS = 8               # rows of H per block of the row-split configuration
MAX_WARPS = 16         # warps per block of the row-split configuration
_H_PAD = 16            # floats of padding per shared row of H (row-split)


@dataclasses.dataclass(frozen=True)
class K7Plan:
    """One K7 launch's geometry. ``config`` 'block' (block-resident: a
    block holds all ``rows`` = d rows of H and ``states`` states, ordinary
    launch, ``grid`` blocks split the states) or 'rows' (row-split: a
    cooperative grid of ceil(d / 8) blocks of ``rows`` = 8 rows each,
    ``states`` states per pass of the register-tiled product, ``chunks``
    chunks per pass of ``steps`` x ``threads`` columns (a lane takes 4
    columns of each ``threads``), one block per SM).
    ``smem``: dynamic shared-memory bytes; ``stride``: the row stride of
    the term scratch (d, or d rounded up to 4 for the 16-byte copies of
    'rows'); ``terms_in_smem``: the block-resident backward keeps its
    recomputed terms in shared memory."""
    config: str
    rows: int
    threads: int
    states: int
    grid: int
    smem: int
    chunks: int
    steps: int
    stride: int
    terms_in_smem: bool

    @property
    def config_id(self) -> int:
        return 0 if self.config == "block" else 1


def block_states(d: int) -> int:
    """States one block-resident block takes: 1024 // d (16 at d = 64, 64
    at d = 16), so the control paths (B <= 16) run on one block and need
    no second pass for gH."""
    return max(1, 1024 // d)


def k7_plan(d: int, b: int, backward: bool, terms: int = 64) -> K7Plan:
    """The launch plan of one K7 call on [b, d] states (``terms`` = order
    x substeps, which decides whether the block-resident backward keeps
    its terms in shared memory).

    - d <= ``BLOCK_MAX_D`` (64): block-resident. H takes d^2 x 8 bytes
      (32 KB at d = 64; H^dagger is H read the other way), so one block
      holds H, the terms and (backward) gH with no grid barrier. The
      threshold, from both configurations forced at the same shapes
      (``scripts/k7_variants.py``, NVIDIA H100 80GB HBM3, 700.00 W power
      limit, ms forward / backward): block-resident is faster at d = 16
      and 32 (d = 16, B = 16: 0.047 / 0.078 against 0.117 / 0.324) and
      at d = 48, B = 5; from d = 48, B = 16 and d = 64, B = 5 it is
      faster forward and slower backward (d = 64, B = 5: 0.161 / 0.497
      against 0.170 / 0.435); the row-split launch wins at d = 64,
      B = 16 (0.231 / 0.640 against 0.324 / 1.041) and at every d >= 65.
      No path runs 48 < d <= 64; the control paths (d = 2, 4, 16) are
      well inside.
    - 64 < d <= 1024: row-split, ceil(d / 8) blocks (128 at d = 1024,
      one per SM) of min(16, ceil(d / 32)) warps (at least 8 x states
      threads: one per output of a pass); 2 states per pass at B <= 2 (a
      whole term as one chunk), else 8 (a lane's register tile is 4 rows
      x 4 states x 4 columns; passes of 4 states measured slower at
      d = 1024, B = 40 and 64).
    """
    if d < 1 or b < 1:
        raise ValueError(f"k7_plan needs d, B >= 1, got d={d}, B={b}")
    if d <= BLOCK_MAX_D:
        states = min(b, block_states(d))
        plane = states * d
        work = max(plane, d * d) if backward else plane
        threads = min(1024, max(32, -(-work // 32) * 32))
        hs = d | 1
        in_smem = False
        floats = 2 * d * hs + 6 * plane
        if backward:
            base = 2 * d * hs + 2 * d * d + 8 * plane
            in_smem = 4 * (base + 2 * plane * terms) <= SMEM_LIMIT
            floats = base + (2 * plane * terms if in_smem else 4 * plane)
        return K7Plan("block", d, threads, states, -(-b // states),
                      4 * floats, 1, 1, d, in_smem)
    states = 2 if b <= 2 else 8
    # 32 columns a warp; at least 8 x states threads (one per output of a
    # pass)
    warps = min(MAX_WARPS, max(-(-d // 32), states // 4))
    # a pass of 2 states stages all its columns at once (one chunk, up to
    # two column steps a lane: one staged item per term); 8 states a chunk
    # of one step
    steps = min(2, -(-d // (32 * warps))) if states == 2 else 1
    chunk = 32 * warps * steps
    chunks = -(-d // chunk)
    hs = chunks * chunk + _H_PAD
    h_floats = (2 if backward else 1) * 2 * ROWS * hs
    stage = 2 * states * (chunk + (ROWS if backward else 0))
    floats = h_floats + 2 * stage + 16 * states * warps
    return K7Plan("rows", ROWS, 32 * warps, states, -(-d // ROWS),
                  4 * floats, chunks, steps, -(-d // 4) * 4, False)


def _plan_ints(plan: K7Plan):
    return (plan.config_id, plan.threads, plan.states, plan.grid, plan.smem,
            plan.chunks, plan.steps, plan.stride)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("taylor_apply")
    if not getattr(lib, "_dq_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dq_k7_forward.argtypes = [p] * 8 + [i] * 12 + [p]
        lib.dq_k7_forward.restype = i
        lib.dq_k7_backward.argtypes = [p] * 13 + [i] * 13 + [p]
        lib.dq_k7_backward.restype = i
        lib.dq_k7_error_string.argtypes = [i]
        lib.dq_k7_error_string.restype = ctypes.c_char_p
        lib._dq_typed = True
    return lib


def _raise_on(lib, code: int, what: str, plan: K7Plan):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.dq_k7_error_string(code).decode()} "
                           f"({code}); {plan}")


def _contig(*ts):
    return [t.contiguous() for t in ts]


def _forward_cuda(h_re, h_im, p_re, p_im, zs, order: int, substeps: int):
    """One K7 forward launch (counter ``k7_forward``); returns (out_re,
    out_im)."""
    h_re, h_im, p_re, p_im, zs = _contig(h_re, h_im, p_re, p_im, zs)
    b, d = p_re.shape
    plan = k7_plan(d, b, False, order * substeps)
    out_re, out_im = torch.empty_like(p_re), torch.empty_like(p_im)
    buf = out_re
    if plan.config == "rows":
        buf = torch.empty(4 * b * plan.stride, dtype=torch.float32,
                          device=p_re.device)
    lib = _lib()
    with profiling.span("chain.fwd"), torch.cuda.device(p_re.device):
        stream = torch.cuda.current_stream(p_re.device).cuda_stream
        code = lib.dq_k7_forward(
            h_re.data_ptr(), h_im.data_ptr(), p_re.data_ptr(),
            p_im.data_ptr(), zs.data_ptr(), out_re.data_ptr(),
            out_im.data_ptr(), buf.data_ptr(), d, b, order, substeps,
            *_plan_ints(plan), stream)
    _raise_on(lib, code, "K7 forward", plan)
    profiling.count("k7_forward")
    return out_re, out_im


def _backward_cuda(h_re, h_im, p_re, p_im, g_re, g_im, zs, order: int,
                   substeps: int):
    """One K7 backward launch (counter ``k7_backward``); returns (gh_re,
    gh_im, gp_re, gp_im)."""
    h_re, h_im, p_re, p_im, g_re, g_im, zs = _contig(
        h_re, h_im, p_re, p_im, g_re, g_im, zs)
    b, d = p_re.shape
    plan = k7_plan(d, b, True, order * substeps)
    f32 = dict(dtype=torch.float32, device=p_re.device)
    gh_re, gh_im = torch.empty((d, d), **f32), torch.empty((d, d), **f32)
    gp_re, gp_im = torch.empty_like(p_re), torch.empty_like(p_im)
    terms = gbuf = gp_re
    if plan.config == "rows":
        terms = torch.empty(substeps * order * 2 * b * plan.stride, **f32)
        gbuf = torch.empty(6 * b * plan.stride, **f32)
    else:
        if not plan.terms_in_smem:
            terms = torch.empty(substeps * order * 2 * b * d, **f32)
        if plan.grid > 1:
            gbuf = torch.empty(plan.grid * 2 * d * d, **f32)
    lib = _lib()
    with profiling.span("chain.bwd"), torch.cuda.device(p_re.device):
        stream = torch.cuda.current_stream(p_re.device).cuda_stream
        code = lib.dq_k7_backward(
            h_re.data_ptr(), h_im.data_ptr(), p_re.data_ptr(),
            p_im.data_ptr(), g_re.data_ptr(), g_im.data_ptr(),
            zs.data_ptr(), gh_re.data_ptr(), gh_im.data_ptr(),
            gp_re.data_ptr(), gp_im.data_ptr(), terms.data_ptr(),
            gbuf.data_ptr(), d, b, order, substeps, *_plan_ints(plan),
            int(plan.terms_in_smem), stream)
    _raise_on(lib, code, "K7 backward", plan)
    profiling.count("k7_backward")
    return gh_re, gh_im, gp_re, gp_im


class _TaylorApply(torch.autograd.Function):
    """exp(z H) psi for one step and its cotangents in H and psi: the
    kernel pair on the card, the plain pair on the CPU. No gradient flows
    to z (the MC split time is sampled, not differentiated)."""

    @staticmethod
    def forward(ctx, h_re, h_im, p_re, p_im, zs, order, substeps):
        if p_re.is_cuda:
            out_re, out_im = _forward_cuda(h_re, h_im, p_re, p_im, zs,
                                           order, substeps)
        elif p_re.device.type == "cpu":
            with profiling.span("chain.fwd"):
                out = taylor_apply_plain(CP(h_re, h_im), CP(p_re, p_im), zs,
                                         order, substeps)
            out_re, out_im = out.re, out.im
        else:
            raise ValueError(f"taylor_apply: no path for device "
                             f"{p_re.device}")
        ctx.save_for_backward(h_re, h_im, p_re, p_im, zs)
        ctx.static = (order, substeps)
        return out_re, out_im

    @staticmethod
    def backward(ctx, g_re, g_im):
        h_re, h_im, p_re, p_im, zs = ctx.saved_tensors
        order, substeps = ctx.static
        if p_re.is_cuda:
            gh_re, gh_im, gp_re, gp_im = _backward_cuda(
                h_re, h_im, p_re, p_im, g_re, g_im, zs, order, substeps)
        else:
            with profiling.span("chain.bwd"):
                gh, gp = taylor_apply_backward_plain(
                    CP(h_re, h_im), CP(p_re, p_im), CP(g_re, g_im), zs,
                    order, substeps)
            gh_re, gh_im, gp_re, gp_im = gh.re, gh.im, gp.re, gp.im
        return gh_re, gh_im, gp_re, gp_im, None, None, None


def substep_z(z_re, z_im, substeps: int, like: torch.Tensor) -> torch.Tensor:
    """(z_re, z_im) / substeps as a [2] tensor on ``like``'s device and
    dtype; numbers or 0-dim tensors (a split time drawn on the card stays
    there, and a number is filled in place: no host copy)."""
    parts = [z.to(dtype=like.dtype, device=like.device)
             if isinstance(z, torch.Tensor)
             else torch.full((), z, dtype=like.dtype, device=like.device)
             for z in (z_re, z_im)]
    return torch.stack(parts) / substeps


def taylor_apply(h: CP, psi: CP, z_re, z_im, order: int,
                 substeps: int) -> CP:
    """``exp((z_re + i z_im) H) psi`` for psi [B, d] (or [d]) and H
    [d, d], as ``substeps`` substeps of ``order`` Taylor terms (choose
    them with :func:`..ops.expm.taylor_params`; substeps = 2^s), one K7
    launch on the card; differentiable in H and psi."""
    return taylor_apply_zs(h, psi, substep_z(z_re, z_im, substeps, psi.re),
                           order, substeps)


def taylor_apply_recurrence(h: CP, psi: CP, zs: torch.Tensor, order: int,
                            substeps: int) -> CP:
    """The 'recurrence' route of :func:`apply_route`: :func:`taylor_apply`'s
    function (zs as :func:`taylor_apply_zs`) in plain products on any
    device and dtype, differentiated by autograd; counted in the counter
    ``apply_recurrence``."""
    profiling.count("apply_recurrence")
    return taylor_recurrence(h, psi, zs[0], zs[1], order, substeps)


def taylor_apply_zs(h: CP, psi: CP, zs: torch.Tensor, order: int,
                    substeps: int) -> CP:
    """:func:`taylor_apply` with the per-substep ``zs = z / substeps``
    already made by :func:`substep_z` (a chain of steps of one dt makes it
    once)."""
    one = psi.ndim == 1
    if one:
        psi = CP(psi.re[None], psi.im[None])
    _check(h, psi, zs)
    re, im = _TaylorApply.apply(h.re, h.im, psi.re, psi.im, zs, int(order),
                                int(substeps))
    return CP(re[0], im[0]) if one else CP(re, im)
