"""State-vector sharding over a mesh of ranks — the port of
:mod:`diffquantum_tpu.parallel.sharded_state` (``evolve_product_sharded``,
``sharded_diag_expectation``, ``sharded_strings_expectation``), on ``torch.distributed`` where the JAX
package runs ``shard_map``.

Layout: a mesh axis ``state`` of size 2^k shards the 2^n amplitudes
into contiguous blocks; the first k qubits (the most significant bits)
are *distributed*, rank m of the axis holding the amplitudes whose
leading bits equal binary(m). Per Strang step:

- diagonal terms are local elementwise phases (the table's columns of
  the block), with no communication;
- rotations on local qubits (q >= k) act on the block's own axes;
- a rotation on a distributed qubit pairs the block with the rank
  ``m ^ 2^(k-1-q)``: one block exchange (:func:`.comm.exchange`), then a
  local linear combination. X: psi' = cos(th) psi - i sin(th)
  psi_partner; Y: psi' = cos(th) psi + sign(bit) sin(th) psi_partner;
- a diagonal observable is a local partial sum and one :func:`.comm.psum`;
  a Pauli-string sum adds one block exchange per distinct flip of the
  distributed bits.

Arrays over the amplitude axis are passed whole, as the JAX package
passes global arrays, or, when the state axis has more than one rank,
as this rank's block; the engine returns this rank's block (with a
batch axis, the block of this rank's members). Coefficients every rank
holds whole are marked :func:`.comm.replicated`, so that autograd sums
the shards' shares of their gradient once, as JAX's transpose does;
per-seed coefficients are split with their members. Everything is
differentiable: the exchanges and the local kernels carry their adjoints.

``local_backend`` picks how a step's local rotations run: 'xla', plain
PyTorch per rotation (any dtype and device; the JAX name); 'fused', one
:func:`..ops.fused_product.fused_rot_block` per step (K1 for a state,
K2 for a batch); 'chunked', one :func:`..ops.fused_chunked.chunked_evolve`
Strang step per time step (K4); 'auto', 'fused' where it is eligible on a
CUDA state, else 'xla' (the JAX package's "on TPU" rule). On one rank
(k = 0) nothing is exchanged and no collective is called.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..dynamics.hamiltonian import ControlledHamiltonian
from ..dynamics.product import (_amplitudes, _control_rows, _packed_tables,
                                _pauli_kind, _symmetrize_rots, _tables,
                                apply_hop_rot, drift_is_zero,
                                split_structure_ext)
from ..measure import _term_image, _term_value
from ..ops import cpx
from ..ops.cpx import CP
from ..ops.fused_product import MAX_OPS, MAX_QUBITS, zero_drift
from .comm import exchange, psum, replicated
from .mesh import Mesh


def _phase_cp(theta: torch.Tensor) -> CP:
    return CP(torch.cos(theta), -torch.sin(theta))


def _bcast_theta(theta, extra_dims: int):
    """Right-pad theta (a scalar or [batch]) with singleton dims so it
    broadcasts against [batch, ...block dims...]."""
    if not isinstance(theta, torch.Tensor) or theta.ndim == 0:
        return theta
    return theta.reshape(theta.shape + (1,) * extra_dims)


def _local_1q_rot(psi: CP, theta, qubit_local: int, n_local: int,
                  local_re: torch.Tensor, local_im: torch.Tensor) -> CP:
    """exp(-i theta G) on a local tensor axis of the block. psi: CP
    [..., d_local]; ``qubit_local`` counts within the n_local local qubits
    (0 = the most significant); ``theta`` a scalar or one angle per
    leading index."""
    lead = psi.re.shape[:-1]
    shape = lead + (2**qubit_local, 2, 2 ** (n_local - qubit_local - 1))
    pre, pim = psi.re.reshape(shape), psi.im.reshape(shape)
    mm = lambda m, x: torch.einsum("ab,...lbr->...lar", m, x)  # noqa: E731
    gre = mm(local_re, pre) - mm(local_im, pim)
    gim = mm(local_re, pim) + mm(local_im, pre)
    th = _bcast_theta(theta, 3)
    c, s = torch.cos(th), torch.sin(th)
    return CP((c * pre + s * gim).reshape(psi.re.shape),
              (c * pim - s * gre).reshape(psi.im.shape))


def _distributed_1q_rot(psi: CP, theta, kind: str, bit: float, mask: int,
                        axis) -> CP:
    """A rotation on a distributed qubit through one block exchange with
    the partner ``index ^ mask`` of ``axis``. ``kind`` 'x' or 'y' (a
    diagonal drive on a distributed qubit is a phase and never gets
    here); ``bit`` this rank's value of the qubit."""
    pp_re, pp_im = exchange((psi.re, psi.im), mask, axis)
    th = _bcast_theta(theta, psi.re.ndim - (
        theta.ndim if isinstance(theta, torch.Tensor) else 0))
    c, s = torch.cos(th), torch.sin(th)
    if kind == "x":  # psi' = c psi - i s psi_partner
        return CP(c * psi.re + s * pp_im, c * psi.im - s * pp_re)
    if kind == "y":  # (Y psi)_local = i (2 bit - 1) psi_partner: a real mix
        sgn = 2.0 * bit - 1.0
        return CP(c * psi.re + s * sgn * pp_re, c * psi.im + s * sgn * pp_im)
    raise ValueError(f"unsupported distributed generator {kind!r}")


def _flip_local_bit(x: torch.Tensor, qubit_local: int,
                    n_local: int) -> torch.Tensor:
    """Flip one local qubit's bit of the block's last axis."""
    lead = x.shape[:-1]
    y = x.reshape(lead + (2**qubit_local, 2,
                          2 ** (n_local - qubit_local - 1)))
    return torch.flip(y, dims=(len(lead) + 1,)).reshape(x.shape)


def _distributed_hop_rot(psi: CP, theta, qi: int, qj: int, k: int,
                         n_local: int, me: int, axis) -> CP:
    """exp(-i theta (XX + YY)) on a pair with at least one distributed
    qubit: one exchange fetches the partner block (XOR over the pair's
    distributed bits), its local member's bit flips in place, and the
    {01, 10} indicator combines this rank's distributed bits with the
    local index. Rotates that subspace by 2 theta, as
    :func:`..dynamics.product.apply_hop_rot`."""
    mask = 0
    for q in (qi, qj):
        if q < k:
            mask |= 1 << (k - 1 - q)
    pp_re, pp_im = exchange((psi.re, psi.im), mask, axis)
    for q in (qi, qj):
        if q >= k:
            pp_re = _flip_local_bit(pp_re, q - k, n_local)
            pp_im = _flip_local_bit(pp_im, q - k, n_local)
    d_local = psi.re.shape[-1]
    j = torch.arange(d_local, device=psi.re.device)
    bits = [torch.full((d_local,), (me >> (k - 1 - q)) & 1,
                       device=psi.re.device) if q < k
            else (j >> (n_local - 1 - (q - k))) & 1 for q in (qi, qj)]
    m = torch.bitwise_xor(bits[0], bits[1]).to(psi.re.dtype)
    th = _bcast_theta(theta, psi.re.ndim - (
        theta.ndim if isinstance(theta, torch.Tensor) else 0))
    c, s = torch.cos(2.0 * th), torch.sin(2.0 * th)
    ct = 1.0 + m * (c - 1.0)
    return CP(ct * psi.re + s * (m * pp_im), ct * psi.im - s * (m * pp_re))


def _classify_local(g: np.ndarray) -> str:
    return _pauli_kind(g) or "dense"


def _state_axis_bits(mesh: Mesh, state_axis: str) -> int:
    size = mesh.shape[state_axis]
    k = int(round(math.log2(size)))
    if 2**k != size:
        raise ValueError(f"state axis size {size} is not a power of two")
    return k


def _local(x: torch.Tensor, d: int, sax, dim: int = -1) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` when ``x`` spans all d
    amplitudes there; ``x`` as it is when it is the block already."""
    if x.shape[dim] == d and sax.size > 1:
        n = d // sax.size
        return x.narrow(dim, sax.index * n, n)
    if x.shape[dim] != d // sax.size:
        raise ValueError(f"an amplitude axis of {x.shape[dim]} is neither "
                         f"the state ({d}) nor this rank's block "
                         f"({d // sax.size})")
    return x


def _split_members(x: torch.Tensor, bax) -> torch.Tensor:
    n = x.shape[0] // bax.size
    return x[bax.index * n:(bax.index + 1) * n]


def evolve_product_sharded(
    ham: ControlledHamiltonian,
    envelope,
    coeff: torch.Tensor,
    psi0: CP,
    T0,
    T,
    horizon: float,
    n_steps: int,
    mesh: Mesh,
    state_axis: str = "state",
    batch_axis: Optional[str] = None,
    local_backend: str = "xla",
) -> CP:
    """Strang-split evolution with the amplitudes sharded over
    ``state_axis`` of ``mesh`` (and an optional leading batch axis over
    ``batch_axis``): the math and grid of
    :func:`..dynamics.product.evolve_product`. Returns this rank's block.

    ``coeff`` is one set [n_controls, n_basis] or one per member [B, ...]
    (per-seed pulses, which need ``batch_axis``). ``local_backend``:

    - 'xla': plain PyTorch per rotation (any dtype);
    - 'fused': one :func:`..ops.fused_product.fused_rot_block` per step
      (K1, or K2 for a batch): f32, Pauli X/Y local drives, 10-17 local
      qubits. Hops ride the kernel's op plan when both qubits are local
      and the exchanges otherwise; with a hop in the set the distributed
      ops wrap the kernel palindromically at half angles (still second
      order; O(dt^2) from 'xla');
    - 'chunked': one :func:`..ops.fused_chunked.chunked_evolve` Strang
      step per time step (K4): f32, Pauli X/Y drives, no hops, every
      diagonal control two-valued, one unbatched state with shared
      coefficients, 10-24 local qubits. The distributed rotations wrap
      each step at half angles (O(dt^2) from 'xla');
    - 'auto': 'fused' when eligible and psi0 lies on a CUDA card, else
      'xla'.
    """
    n = ham.n_qubits
    (diag_idx, diag_rows, h0_diag, oneq_idx, oneq_qubits, oneq_locals,
     hop_idx, hop_pairs) = split_structure_ext(ham)
    if hop_pairs and local_backend == "chunked":
        raise ValueError(
            "local_backend='chunked' does not support 'hop' terms; use "
            "'fused' (local pairs ride the kernel op plan, distributed "
            "pairs one exchange each) or 'xla'")
    sax = mesh.axes[state_axis]
    k = _state_axis_bits(mesh, state_axis)
    n_local = n - k
    d, d_local = ham.dim, ham.dim >> k
    rdt = ham.dtype
    bax = mesh.axes[batch_axis] if batch_axis else None

    per_seed = coeff.ndim == len(envelope.coeff_shape) + 1
    if per_seed and not batch_axis:
        raise ValueError("per-seed coeff needs a batch_axis")
    whole = psi0.re.shape[-1] == d
    p_re, p_im = (_local(x, d, sax) for x in (psi0.re, psi0.im))
    batched = p_re.ndim > 1
    if whole and bax is not None and batched:
        p_re, p_im = (_split_members(x, bax) for x in (p_re, p_im))
        if per_seed:
            coeff = _split_members(coeff, bax)
    # the coefficients' gradient: the sum over the ranks that hold them
    coeff = replicated(coeff, [sax] if per_seed or bax is None
                       else [sax, bax])
    psi = CP(p_re.to(rdt), p_im.to(rdt))

    if local_backend == "chunked":
        return _evolve_sharded_chunked(
            ham, envelope, coeff, psi, T0, T, horizon, n_steps, sax, k,
            n_local, (diag_idx, diag_rows, h0_diag, oneq_idx, oneq_qubits,
                      oneq_locals))

    dt, u = _amplitudes(envelope, coeff, T0, T, horizon, n_steps, "left")
    if u.ndim == 3 and not batched:
        raise ValueError("per-seed coefficients need a batch of states")
    u_diag, u_oneq, u_hop = _control_rows(ham, u, rdt)  # [(S,) n_k, T]
    diag_table, h0_vec = _tables(ham, rdt, psi.re.device)
    dtab = _local(diag_table, d, sax).contiguous()
    h0v = _local(h0_vec, d, sax)
    kinds = [_classify_local(g) for g in oneq_locals]
    dev = psi.re.device
    locals_re = [torch.as_tensor(np.asarray(g).real, dtype=rdt, device=dev)
                 for g in oneq_locals]
    locals_im = [torch.as_tensor(np.asarray(g).imag, dtype=rdt, device=dev)
                 for g in oneq_locals]
    for i, kind in enumerate(kinds):
        if kind == "dense" and oneq_qubits[i] < k:
            raise ValueError("distributed 1q terms must be Pauli X or Y")

    # same-qubit non-commuting drives: the palindromic sub-step order
    used = list(oneq_qubits) + [q for pr in hop_pairs for q in pr]
    palindromic = len(set(used)) < len(used)
    m_rots = len(oneq_qubits)
    loc_ids = [i for i in range(m_rots) if oneq_qubits[i] >= k]
    dist_ids = [i for i in range(m_rots) if oneq_qubits[i] < k]
    loc_hops = [h for h, (a, b) in enumerate(hop_pairs) if a >= k and b >= k]
    dist_hops = [h for h in range(len(hop_pairs)) if h not in loc_hops]
    fused_ok = (rdt == torch.float32 and 10 <= n_local <= MAX_QUBITS
                and all(kinds[i] in ("x", "y") for i in loc_ids))
    if local_backend == "auto":
        local_backend = "fused" if fused_ok and dev.type == "cuda" \
            else "xla"
    if local_backend not in ("xla", "fused"):
        raise ValueError(f"unknown local_backend {local_backend!r}")
    if local_backend == "fused" and not fused_ok:
        raise ValueError(
            "local_backend='fused' needs f32, Pauli X/Y local terms and "
            f"10..{MAX_QUBITS} local qubits (K1/K2's band)")
    me = sax.index

    def apply_rot(p, i, th):
        q = oneq_qubits[i]
        if q >= k:
            return _local_1q_rot(p, th, q - k, n_local, locals_re[i],
                                 locals_im[i])
        return _distributed_1q_rot(p, th, kinds[i], (me >> (k - 1 - q)) & 1,
                                   1 << (k - 1 - q), sax)

    def apply_hop(p, h, th):
        qi, qj = hop_pairs[h]
        if qi >= k and qj >= k:
            return apply_hop_rot(p, th, qi - k, qj - k, n_local)
        return _distributed_hop_rot(p, th, qi, qj, k, n_local, me, sax)

    def phase(p, ud):
        theta_half = (0.5 * dt) * (h0v + torch.matmul(ud, dtab))
        return cpx.mul(_phase_cp(theta_half), p)

    def apply_ops(p, ops, frac, uq, uh):
        for kind_op, i in ops:
            p = apply_rot(p, i, frac * uq[..., i]) if kind_op == "1q" \
                else apply_hop(p, i, frac * uh[..., i])
        return p

    if local_backend == "xla":
        rot_ops = [("1q", i) for i in range(m_rots)] \
            + [("hop", h) for h in range(len(hop_pairs))]
        order = rot_ops + rot_ops[::-1] if palindromic else rot_ops
        frac = 0.5 * dt if palindromic else dt

        def rotations(p, uq, uh):
            return apply_ops(p, order, frac, uq, uh)
    else:
        local_block = _fused_local_block(
            [oneq_qubits[i] - k for i in loc_ids]
            + [(hop_pairs[h][0] - k, hop_pairs[h][1] - k) for h in loc_hops],
            [kinds[i] for i in loc_ids] + ["hop"] * len(loc_hops),
            loc_ids, loc_hops, n_local, dt, dev)
        dist_ops = [("1q", i) for i in dist_ids] \
            + [("hop", h) for h in dist_hops]
        dist_dup = len({oneq_qubits[i] for i in dist_ids}) < len(dist_ids)

        def rotations(p, uq, uh):
            # a distributed hop's local member can share a qubit with a
            # kernel op: wrap the kernel as D(1/2) L D(1/2, reversed), a
            # symmetric composition of exact factors (second order)
            if hop_pairs or dist_dup:
                if hop_pairs:
                    p = apply_ops(p, dist_ops, 0.5 * dt, uq, uh)
                    p = local_block(p, uq, uh)
                else:
                    p = local_block(p, uq, uh)
                    p = apply_ops(p, dist_ops, 0.5 * dt, uq, uh)
                return apply_ops(p, dist_ops[::-1], 0.5 * dt, uq, uh)
            return apply_ops(local_block(p, uq, uh), dist_ops, dt, uq, uh)

    for ud, uq, uh in zip(*(x.unbind(-1) for x in (u_diag, u_oneq, u_hop))):
        psi = phase(rotations(phase(psi, ud), uq, uh), ud)
    return psi


def _fused_local_block(entries, kinds, loc_ids, loc_hops, n_local, dt,
                       dev):
    """The 'fused' step's local rotations as one
    :func:`..ops.fused_product.fused_rot_block`: 1q drives, then local
    hops (angles doubled), palindromic at half angles when a local qubit
    repeats. Returns ``block(p, uq, uh)``."""
    from ..ops.fused_product import fused_rot_block
    used = []
    for e in entries:
        used.extend(e) if isinstance(e, tuple) else used.append(e)
    dup = len(set(used)) < len(used)
    qubits, kinds = tuple(entries), tuple(kinds)
    if dup:
        qubits, kinds = qubits + qubits[::-1], kinds + kinds[::-1]
    if len(qubits) > MAX_OPS:
        raise ValueError("local fused op plan exceeds the 128 angle slots; "
                         "use local_backend='xla'")
    loc_idx = torch.tensor(loc_ids, dtype=torch.long, device=dev)
    hop_idx = torch.tensor(loc_hops, dtype=torch.long, device=dev)

    def block(p, uq, uh):
        if not qubits:
            return p
        th = dt * torch.index_select(uq, -1, loc_idx)
        if loc_hops:  # kernel hop angle = 2 x (dt x u) on {01, 10}
            th = torch.cat([th, 2.0 * dt * torch.index_select(
                uh, -1, hop_idx)], dim=-1)
        if dup:
            th = 0.5 * torch.cat([th, torch.flip(th, dims=(-1,))], dim=-1)
        if p.ndim > 1 and th.ndim == 1:  # one pulse row for every member
            th = th[None]
        return fused_rot_block(p, th, qubits, n_local, kinds)

    return block


def _evolve_sharded_chunked(ham, envelope, coeff, psi, T0, T, horizon,
                            n_steps, sax, k, n_local, structure) -> CP:
    """The 'chunked' engine: per time step the distributed rotations at
    half angles, one K4 Strang step of the local qubits
    (:func:`..ops.fused_chunked.chunked_evolve` at T = 1), the
    distributed rotations at half angles in reversed order. The bracket
    is K4's symmetric step and the two halves close the palindrome, so
    the step is symmetric (second order); it differs from 'xla'/'fused',
    whose distributed rotations sit inside the half-phases, by O(dt^2)."""
    from ..ops.fused_chunked import check_size, chunked_evolve
    (diag_idx, diag_rows, h0_diag, oneq_idx, oneq_qubits,
     oneq_locals) = structure
    if ham.dtype != torch.float32:
        raise ValueError("local_backend='chunked' needs an f32 Hamiltonian")
    if psi.ndim != 1 or coeff.ndim != len(envelope.coeff_shape):
        raise ValueError("local_backend='chunked' supports a single "
                         "unbatched state and shared coefficients")
    if n_local < 10:
        raise ValueError("local_backend='chunked' needs >= 10 local qubits")
    check_size(n_local)  # past K4's 24 local qubits
    kinds_all = [_pauli_kind(g) for g in oneq_locals]
    if any(kd is None for kd in kinds_all):
        raise ValueError("local_backend='chunked' needs Pauli X/Y 1q terms")
    dev = psi.re.device
    try:
        signs, consts, scales, h0_vec = _packed_tables(ham, dev)
    except ValueError as e:
        raise ValueError(
            "local_backend='chunked' needs the packed-phase form: every "
            "diagonal control row two-valued (Pauli-Z strings), <= 120 "
            "terms") from e
    d = ham.dim
    # the rank's columns, copied: a slice along d is not contiguous
    signs = _local(signs, d, sax).contiguous()
    dt, u = _amplitudes(envelope, coeff, T0, T, horizon, n_steps, "left")
    u_diag, u_oneq, _ = _control_rows(ham, u, torch.float32)  # [n_k, T]
    half = 0.5 * dt
    h0th = zero_drift(d // sax.size, dev) if drift_is_zero(
        ham, h0_vec) else (half * _local(h0_vec, d, sax)).contiguous()
    ud = torch.cat([half * u_diag.T * scales,
                    (half * (u_diag.T @ consts))[:, None]], dim=1)
    m = len(oneq_qubits)
    loc_ids = [i for i in range(m) if oneq_qubits[i] >= k]
    dist_ids = [i for i in range(m) if oneq_qubits[i] < k]
    def cols(ids):
        return torch.index_select(u_oneq.T, 1, torch.tensor(
            ids, dtype=torch.long, device=dev))

    theta_loc = dt * cols(loc_ids)
    loc_qubits, loc_kinds, theta_loc = _symmetrize_rots(
        [oneq_qubits[i] - k for i in loc_ids],
        [kinds_all[i] for i in loc_ids], theta_loc, dim=1)
    theta_dist = half * cols(dist_ids)
    me = sax.index

    def dist_rot(p, i, th):
        q = oneq_qubits[i]
        return _distributed_1q_rot(p, th, kinds_all[i], (me >> (k - 1 - q))
                                   & 1, 1 << (k - 1 - q), sax)

    for ud_row, tl_row, td_row in zip(ud.unbind(0), theta_loc.unbind(0),
                                      theta_dist.unbind(0)):
        for di, i in enumerate(dist_ids):
            psi = dist_rot(psi, i, td_row[di])
        psi = chunked_evolve(psi, ud_row[None], tl_row[None], h0th, signs,
                             loc_qubits, n_local, loc_kinds)
        for di, i in reversed(list(enumerate(dist_ids))):
            psi = dist_rot(psi, i, td_row[di])
    return psi


def sharded_diag_expectation(psi: CP, diag: torch.Tensor, mesh: Mesh,
                             state_axis: str = "state",
                             batch_axis: Optional[str] = None
                             ) -> torch.Tensor:
    """<psi|diag(M)|psi> with the amplitudes sharded: the block's partial
    sum and one psum over the state axis, the same on every rank of it.
    ``psi`` is this rank's block (as :func:`evolve_product_sharded`
    returns it); ``diag`` whole or this rank's block. With a batch axis,
    one value per member of this rank's block."""
    del batch_axis  # the members are the block's leading axis
    sax = mesh.axes[state_axis]
    d_local = psi.re.shape[-1]
    dvec = _local(diag, d_local * sax.size, sax).to(psi.re.dtype)
    local = torch.sum((psi.re * psi.re + psi.im * psi.im) * dvec, dim=-1)
    return psum(local, sax)


def sharded_strings_expectation(psi: CP, strings, mesh: Mesh,
                                state_axis: str = "state",
                                batch_axis: Optional[str] = None
                                ) -> torch.Tensor:
    """<psi|M|psi> for a Pauli-string sum
    (:class:`...measure.PauliStringSet`) with the amplitudes sharded over
    ``state_axis`` (its k ranks hold the top k qubits): each term's XOR
    flip splits into its rank bits, one :func:`.comm.exchange` of the
    whole local shard with the partner rank (once per distinct rank
    flip), and its local bits, a flip inside the shard; the parity sign
    splits into the partner rank's parity and the local one. One psum of
    the total at the end, the same on every rank of the axis. ``psi`` is
    this rank's block [..., d / 2^k]; with a batch axis, one value per
    member of the block."""
    del batch_axis  # the members are the block's leading axis
    sax = mesh.axes[state_axis]
    k = _state_axis_bits(mesh, state_axis)
    n_local = strings.n_qubits - k
    if psi.re.shape[-1] != 2**n_local:
        raise ValueError(f"a block of {psi.re.shape[-1]} amplitudes is not "
                         f"1/{sax.size} of a {strings.n_qubits}-qubit state")
    low = 2**n_local - 1
    me = sax.index
    by_rank_flip = {}
    for t, flip in enumerate(strings.flips):
        by_rank_flip.setdefault(flip >> n_local, []).append(t)
    vals = [None] * strings.n_terms
    for flip_dist, terms in by_rank_flip.items():
        q_re, q_im = exchange((psi.re, psi.im), flip_dist, sax)
        for t in terms:
            yz = strings.yz_masks[t]
            par = bin((me ^ flip_dist) & (yz >> n_local)).count("1") % 2
            img = _term_image(CP(q_re, q_im), strings.flips[t] & low,
                              yz & low, n_local)
            e = _term_value(psi, img, strings.n_ys[t])
            vals[t] = -e if par else e
    w = strings.weights.to(psi.re.dtype)
    return psum(torch.tensordot(w, torch.stack(vals), dims=1), sax)
