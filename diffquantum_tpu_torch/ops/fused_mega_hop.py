"""K6: the hop-capable packed chain at 19-24 qubits (the palindromic A/B
schedule), for one state or a seed population, and its exact adjoint.

Port of :mod:`diffquantum_tpu.ops.fused_mega_hop`:
``chunked_evolve_mega_hop`` and ``chunked_evolve_mega_hop_batched`` with
their custom VJPs, whose Pallas kernels are ``_make_mega_hop_fwd`` /
``_make_mega_hop_bwd``, and the layout helpers around them
(:func:`plan_chunked_hop_layout`, :func:`_assign_passes`,
:func:`permute_amplitude_bits`, :func:`invert_perm`).

K6 is another second-order integrator than the eager Strang engine and
K5. Per step, with P the diagonal phases and the ops split by the JAX
engine's chunk plan (:func:`.fused_chunked._plan`, c chunk bits) into
pass A (every position >= c) and pass B (the rest):

    S(dt) = P(dt/2) · A(½θ, forward) · B_pal(θ) · A(½θ, reversed) · P(dt/2)

``B_pal`` is the B ops at half angle forward, then reversed, or one
sweep at full angle when the B ops sit on distinct positions
(``b_commute``). The partition decides the numbers: another c, or
another relabelling, changes psi(T) at O(dt^2).

On the TPU, K6 exists apart from K5 because a Mosaic pass block cannot
see a hop that crosses the partition, so the qubits are relabelled to
keep every hop inside one pass. On the card the pass kernels of
``csrc/packed_phase.cu`` already run such a hop as a cross pass; what K6
adds is its schedule, which those kernels run as op rows carrying a scale
(:func:`_hop_plan`: A rows ½, B rows ½ or 1) with several rows per angle
slot, whose gradients the adjoint's reduction sums. The relabelling is
kept all the same: it fixes the integrator. The TPU layout ([C, F, 128]
slabs, SMEM op tables, lane permutation matmuls, DMA) has no counterpart.

Contracts, as in the JAX package, in the relabelled position space:
:func:`chunked_evolve_mega_hop` takes psi0 CP [d], ud [T, n_diag+1],
theta_x [T, n_x]; :func:`chunked_evolve_mega_hop_batched` psi0 [B, d], ud
[T, B, n_diag+1], theta_x [T, B, n_x]; both take h0th [d] (zero
cotangent), signs [P, d] int32 (none), ``x_entries`` (ints for 1q ops,
(i, j) position pairs for hops) and ``kinds``. theta_x holds the plain
angles (a hop's already doubled, 2 dt u), neither halved nor made
palindromic: the schedule does that.

Dispatch: CPU tensors take the plain version, CUDA tensors launch the
kernel pair. ``K6_FWD_LAUNCHES`` / ``K6_BWD_LAUNCHES`` count the chains of
both forms; ``K6_BATCHED_FWD_LAUNCHES`` / ``K6_BATCHED_BWD_LAUNCHES`` the
batched form's among them.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .cpx import CP
from .fused_chunked import _one, _plan, check_size
from .fused_product import (SCALE_ONE, _plan_ops, _with_scale,
                            packed_adjoint_plain, packed_chain_plain,
                            run_packed_chain)

K6_FWD_LAUNCHES = 0
K6_BWD_LAUNCHES = 0
K6_BATCHED_FWD_LAUNCHES = 0
K6_BATCHED_BWD_LAUNCHES = 0

_HALF = SCALE_ONE // 2  # scale column value of a half-angle row


# ---------------------------------------------------------------------------
# layout planning: qubit -> position relabelling + op -> pass assignment
# ---------------------------------------------------------------------------

def plan_chunked_hop_layout(entries, kinds, n_qubits):
    """Choose a qubit→position permutation for the hop engine, as the
    JAX package does.

    Positions: [0, c) chunk, [c, c+f) free, [c+f, n) lanes; pass B sees
    chunk + positions >= 2c (low free) + lanes, pass A sees positions
    >= c. Candidate chunk sets, tried in order: the first / last c
    qubits by label, then BFS-connected c-blocks grown from each of the
    four lowest-degree vertices. The chunk's hop-neighbours are kept out
    of the c high-free positions [c, 2c). Returns ``perm`` with ``perm[p]
    = original qubit at position p`` (the identity tuple when c = 0), or
    None with a warning (the router then names 'xla') when no candidate
    clears the boundary (a hop graph denser than the free band can
    absorb)."""
    try:
        c, f = _plan(n_qubits)
    except ValueError:
        return None
    if c == 0:
        return tuple(range(n_qubits))
    adj = {q: set() for q in range(n_qubits)}
    for ent, kd in zip(entries, kinds):
        if kd == "hop":
            i, j = ent
            adj[i].add(j)
            adj[j].add(i)

    def bfs_block(start):
        seen, order = {start}, [start]
        qi = 0
        while len(order) < c:
            if qi < len(order):
                frontier = sorted(adj[order[qi]] - seen)
                qi += 1
            else:  # disconnected: pull in the next unvisited label
                frontier = [q for q in range(n_qubits) if q not in seen][:1]
            for q in frontier:
                if len(order) >= c:
                    break
                seen.add(q)
                order.append(q)
        return tuple(sorted(order))

    by_degree = sorted(range(n_qubits), key=lambda q: (len(adj[q]), q))
    candidates = [tuple(range(c)), tuple(range(n_qubits - c, n_qubits))]
    candidates += [bfs_block(s) for s in by_degree[:4]]
    tried = set()
    for chunk in candidates:
        if chunk in tried:
            continue
        tried.add(chunk)
        nbrs = set()
        for q in chunk:
            nbrs |= adj[q]
        nbrs -= set(chunk)
        rest = [q for q in range(n_qubits) if q not in chunk]
        hf = [q for q in rest if q not in nbrs][:c]
        if len(hf) < c:
            continue
        others = [q for q in rest if q not in hf]
        return tuple(list(chunk) + hf + others)
    warnings.warn(
        f"no feasible chunk layout for this {n_qubits}-qubit hop graph "
        f"({sum(len(v) for v in adj.values()) // 2} hop edges): the router "
        "names 'xla', the eager product engine", stacklevel=2)
    return None


def _assign_passes(entries_pos, kinds, c, n_qubits):
    """Split ops (position space) into (a_idx, b_idx) index lists. Pass A
    holds every op whose positions are all >= c; the rest must fit pass B
    (no position in the high-free band [c, 2c))."""
    a_idx, b_idx = [], []
    for j, (ent, kd) in enumerate(zip(entries_pos, kinds)):
        ps = ent if isinstance(ent, tuple) else (ent,)
        if all(p >= c for p in ps):
            a_idx.append(j)
        elif all(p < c or p >= 2 * c for p in ps):
            b_idx.append(j)
        else:
            raise ValueError(
                f"op {j} spans the chunk / high-free boundary "
                f"(positions {ps}): plan_chunked_hop_layout should have "
                "prevented this")
    return a_idx, b_idx


def _b_commute(entries_pos, b_idx) -> bool:
    """Whether the pass-B ops sit on pairwise distinct positions (then
    they commute and ``B_pal`` is one full-angle sweep)."""
    used = [p for j in b_idx
            for p in (entries_pos[j] if isinstance(entries_pos[j], tuple)
                      else (entries_pos[j],))]
    return len(set(used)) == len(used)


def _hop_plan(entries_pos, kinds, n_qubits: int) -> np.ndarray:
    """K6's op rows for one step [n_rows, 5] (slot, kind, mask a, mask b,
    scale in halves; :func:`.fused_product._packed_plan`'s layout), in
    the order A forward (½), B forward (½, or 1 when ``b_commute``), B
    reversed (½; only when not ``b_commute``), A reversed (½): the JAX
    kernels' ``txh`` / ``txbh`` rows. Stage t of the chain applies its
    phase and then these rows, so the trailing A(½) of step t, the merged
    phase and the leading A(½) of step t+1 run as the JAX kernel's one
    merged pass-A sweep does."""
    kinds = tuple(kinds) if kinds else ("x",) * len(entries_pos)
    c, _ = _plan(n_qubits)
    a_idx, b_idx = _assign_passes(entries_pos, kinds, c, n_qubits)
    b_commute = _b_commute(entries_pos, b_idx)
    ops = _plan_ops(entries_pos, kinds, n_qubits)
    a, b = np.asarray(a_idx, np.int64), np.asarray(b_idx, np.int64)
    parts = [_with_scale(ops[a], _HALF),
             _with_scale(ops[b], SCALE_ONE if b_commute else _HALF)]
    if not b_commute:
        parts.append(_with_scale(ops[b[::-1]], _HALF))
    parts.append(_with_scale(ops[a[::-1]], _HALF))
    return np.concatenate(parts)


def permute_amplitude_bits(x: torch.Tensor, perm) -> torch.Tensor:
    """Relabel the qubits of the last axis (length 2^n): output position p
    carries input qubit ``perm[p]``; differentiable. Identity
    permutations return x unchanged. The bits are grouped into maximal
    consecutive source runs, so the transpose has few axes and a large
    minor one (the planner's permutations are a handful of runs)."""
    n = len(perm)
    if tuple(perm) == tuple(range(n)):
        return x
    runs = []  # (source_start, length), in output order
    s, ln = perm[0], 1
    for p in perm[1:]:
        if p == s + ln:
            ln += 1
        else:
            runs.append((s, ln))
            s, ln = p, 1
    runs.append((s, ln))
    order = sorted(range(len(runs)), key=lambda i: runs[i][0])
    sizes = tuple(2 ** runs[i][1] for i in order)  # source-ordered dims
    src_axis_of_run = {run_id: ax for ax, run_id in enumerate(order)}
    lead = tuple(x.shape[:-1])
    k = len(lead)
    y = x.reshape(lead + sizes).permute(tuple(range(k)) + tuple(
        k + src_axis_of_run[j] for j in range(len(runs))))
    return y.reshape(lead + (2**n,))


def invert_perm(perm):
    inv = [0] * len(perm)
    for p, q in enumerate(perm):
        inv[q] = p
    return tuple(inv)


def relabel_mask(mask: int, perm, n_qubits: int) -> int:
    """A bit mask over qubits (qubit q is bit n-1-q) in the positions of
    ``perm``: the parity row of ``mask`` evaluated on the relabelled
    state, so sign planes are built in position space directly."""
    out = 0
    for p, q in enumerate(perm):
        if (mask >> (n_qubits - 1 - q)) & 1:
            out |= 1 << (n_qubits - 1 - p)
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _count_single(backward: bool):
    global K6_FWD_LAUNCHES, K6_BWD_LAUNCHES
    if backward:
        K6_BWD_LAUNCHES += 1
    else:
        K6_FWD_LAUNCHES += 1


def _count_batched(backward: bool):
    global K6_BATCHED_FWD_LAUNCHES, K6_BATCHED_BWD_LAUNCHES
    _count_single(backward)
    if backward:
        K6_BATCHED_BWD_LAUNCHES += 1
    else:
        K6_BATCHED_FWD_LAUNCHES += 1


def chunked_evolve_mega_hop(psi0: CP, ud: torch.Tensor,
                            theta_x: torch.Tensor, h0th: torch.Tensor,
                            signs: torch.Tensor, x_entries: tuple,
                            n_qubits: int, kinds: tuple = None,
                            fast_math: bool = False) -> CP:
    """K6 for one state [2^n] in position space: one chain of pass
    launches and one for the adjoint, differentiable in psi0, ud and
    theta_x. ``fast_math`` changes nothing (no matmul to truncate)."""
    del fast_math
    check_size(n_qubits)
    plan = _hop_plan(x_entries, kinds, n_qubits)
    p, u, t = _one(psi0, ud, theta_x, "chunked_evolve_mega_hop")
    out = run_packed_chain(p, u, t, h0th, signs, plan, len(x_entries),
                           n_qubits, _count_single, "K6")
    return CP(out.re[0], out.im[0])


def chunked_evolve_mega_hop_batched(psi0: CP, ud: torch.Tensor,
                                    theta_x: torch.Tensor,
                                    h0th: torch.Tensor, signs: torch.Tensor,
                                    x_entries: tuple, n_qubits: int,
                                    kinds: tuple = None,
                                    fast_math: bool = False) -> CP:
    """Seed-batched :func:`chunked_evolve_mega_hop`: psi0 CP [B, 2^n], ud
    [T, B, n_diag+1], theta_x [T, B, n_x], per-seed pulses, one chain of
    launches for the whole population (grid: blocks x B)."""
    del fast_math
    check_size(n_qubits)
    return run_packed_chain(psi0, ud, theta_x, h0th, signs,
                            _hop_plan(x_entries, kinds, n_qubits),
                            len(x_entries), n_qubits, _count_batched,
                            "K6 batched")


def chunked_evolve_mega_hop_plain(psi0: CP, ud, theta_x, h0th, signs,
                                  x_entries: tuple, n_qubits: int,
                                  kinds: tuple = None) -> CP:
    """K6's forward (single form) in plain PyTorch, any device."""
    check_size(n_qubits)
    out = packed_chain_plain(
        *_one(psi0, ud, theta_x, "chunked_evolve_mega_hop"), h0th, signs,
        _hop_plan(x_entries, kinds, n_qubits), len(x_entries), n_qubits,
        "K6")
    return CP(out.re[0], out.im[0])


def chunked_evolve_mega_hop_batched_plain(psi0: CP, ud, theta_x, h0th,
                                          signs, x_entries: tuple,
                                          n_qubits: int,
                                          kinds: tuple = None) -> CP:
    """K6's forward (batched form) in plain PyTorch, any device."""
    check_size(n_qubits)
    return packed_chain_plain(psi0, ud, theta_x, h0th, signs,
                              _hop_plan(x_entries, kinds, n_qubits),
                              len(x_entries), n_qubits, "K6 batched")


def _adjoint_mega_hop_plain(psi_T: CP, lam: CP, ud, theta_x, h0th, signs,
                            x_entries: tuple, n_qubits: int,
                            kinds: tuple = None):
    """K6's backward in plain PyTorch, either form (by psi_T's rank): the
    exact inverse-step adjoint, (dpsi0 CP, d ud, d theta_x) in the shapes
    of the inputs, each slot's d theta_x the sum of its rows' scaled
    gradients."""
    check_size(n_qubits)
    plan = _hop_plan(x_entries, kinds, n_qubits)
    if psi_T.re.ndim == 2:
        return packed_adjoint_plain(psi_T, lam, ud, theta_x, h0th, signs,
                                    plan, len(x_entries), n_qubits,
                                    "K6 batched")
    p, u, t = _one(psi_T, ud, theta_x, "chunked_evolve_mega_hop")
    gp, gud, gtx = packed_adjoint_plain(
        p, CP(lam.re[None], lam.im[None]), u, t, h0th, signs, plan,
        len(x_entries), n_qubits, "K6")
    return CP(gp.re[0], gp.im[0]), gud[:, 0], gtx[:, 0]
