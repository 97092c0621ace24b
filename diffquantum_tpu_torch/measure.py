"""Measurement objectives — the port of :mod:`diffquantum_tpu.measure`:
dense operators, diagonal observables, rank-1 targets and Pauli-string
sums.

- a dense Hermitian M (CP [d, d]): ``Re <psi|M|psi>``
  (:func:`exact_expectation`), shot-sampled per weighted term in each
  term's eigenbasis (:class:`PauliTermSet`, :func:`stochastic_measure`);
- a diagonal observable (any cut or Ising cost) needs no operator:
  ``sum_j |psi_j|^2 diag_j``, sampled by computational-basis draws per
  term (:func:`stochastic_measure_diag`);
- a rank-1 target ``|t><t|`` (the fidelity objective): ``|<t|psi>|^2``,
  sampled as Bernoulli trials (:func:`sampled_target_prob`);
- a weighted Pauli-string sum (TFIM, Heisenberg): matrix-free, each
  string a permutation of the state's bit axes and a sign
  (:class:`PauliStringSet`), sampled per qubit-wise-commuting group
  (:func:`stochastic_measure_strings`).

Noisy measurement adds the reference's Gaussian noise of scale |value|/5
(:func:`measurement_noise`). Every draw comes from an explicit
``torch.Generator`` where the JAX package takes a PRNG key, so the two
packages agree in distribution, not draw by draw.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from .ops import cpx
from .ops.cpx import CP
from .utils.device import resolve_device

NOISE_REL_SCALE = 0.2  # reference: np.random.normal(scale=|v|/5)
# torch.multinomial takes at most 2^24 categories: 24 qubits
MAX_SAMPLED_DIM = 2**24
# sign bits multiplied in at once: a factor of at most 2^10 entries
_SIGN_CHUNK_BITS = 10


def exact_expectation(m: CP, psi: CP) -> torch.Tensor:
    """Re <psi|M|psi> for a dense M [d, d] (psi may carry batch dims)."""
    mp = cpx.matvec(m, psi)
    return torch.sum(psi.re * mp.re + psi.im * mp.im, dim=-1)


@dataclasses.dataclass(frozen=True)
class PauliTermSet:
    """A measurement operator as weighted Hermitian terms with their
    eigensystems: weights [n_terms], evals [n_terms, d], estates CP
    [n_terms, d, d] (eigenvectors as columns)."""

    weights: torch.Tensor
    evals: torch.Tensor
    estates: CP

    @classmethod
    def create(cls, terms: Sequence[tuple[np.ndarray, float]],
               dtype=torch.float32, device="cuda") -> "PauliTermSet":
        """From (matrix, weight) pairs; one host eigendecomposition per
        term."""
        dev = resolve_device(device)
        ws, evs, ests = [], [], []
        for m, w in terms:
            ev, es = np.linalg.eigh(np.asarray(m))
            ws.append(float(w))
            evs.append(ev)
            ests.append(es)
        return cls(weights=torch.tensor(ws, dtype=dtype, device=dev),
                   evals=torch.as_tensor(np.stack(evs), dtype=dtype,
                                         device=dev),
                   estates=cpx.from_complex(np.stack(ests), dtype=dtype,
                                            device=dev))

    @property
    def n_terms(self) -> int:
        return self.weights.shape[0]


def stochastic_measure(terms: PauliTermSet, psi: CP,
                       generator: torch.Generator,
                       per_pauli: int = 100) -> torch.Tensor:
    """Finite-shot estimate of sum_t w_t <psi|P_t|psi>: per term, the Born
    distribution over its eigenstates |<e_j|psi>|^2, ``per_pauli`` draws
    (``torch.multinomial`` with replacement, where the JAX package draws
    ``jax.random.categorical``) and ``w_t mean(eval_t[draws])``. psi [d]
    gives a scalar, [..., d] one estimate per state."""
    er = terms.estates.re.transpose(-1, -2)          # [t, j, d]
    ei = terms.estates.im.transpose(-1, -2)
    amp_re = torch.einsum("tjd,...d->...tj", er, psi.re) \
        + torch.einsum("tjd,...d->...tj", ei, psi.im)
    amp_im = torch.einsum("tjd,...d->...tj", er, psi.im) \
        - torch.einsum("tjd,...d->...tj", ei, psi.re)
    probs = amp_re * amp_re + amp_im * amp_im        # [..., t, d]
    lead, (n_terms, d) = probs.shape[:-2], probs.shape[-2:]
    draws = torch.multinomial(probs.reshape(-1, d), per_pauli,
                              replacement=True, generator=generator)
    draws = draws.reshape(-1, n_terms, per_pauli)
    vals = torch.gather(terms.evals.expand(draws.shape[0], n_terms, d), -1,
                        draws)
    est = torch.sum(terms.weights * vals.mean(dim=-1), dim=-1)
    return est.reshape(lead)


def target_overlap_prob(target: CP, psi: CP) -> torch.Tensor:
    """|<t|psi>|^2 (psi may carry batch dims): the rank-1 projector's
    expectation, matrix-free."""
    return cpx.abs2(cpx.vdot(target, psi))


def sampled_target_prob(target: CP, psi: CP, generator: torch.Generator,
                        shots: int = 100) -> torch.Tensor:
    """Finite-shot estimate of |<t|psi>|^2: ``shots`` Bernoulli trials
    with success probability p, the frequency."""
    p = torch.clamp(target_overlap_prob(target, psi), 0.0, 1.0)
    u = torch.rand((shots,) + tuple(p.shape), generator=generator,
                   dtype=p.dtype, device=p.device)
    return torch.mean((u < p).to(p.dtype), dim=0)


def diag_expectation(diag: torch.Tensor, psi: CP) -> torch.Tensor:
    """<psi|diag(w)|psi> = sum |psi|^2 w over the last axis."""
    return torch.sum(cpx.abs2(psi) * diag, dim=-1)


@dataclasses.dataclass(frozen=True)
class DiagonalTermSet:
    """Weighted diagonal terms: weights [n_terms], diags [n_terms, d]."""

    weights: torch.Tensor
    diags: torch.Tensor

    @classmethod
    def create(cls, terms: Sequence[tuple[np.ndarray, float]],
               dtype=torch.float32, device="cuda") -> "DiagonalTermSet":
        """terms: (diag_vector, weight) pairs."""
        dev = resolve_device(device)
        ws = torch.tensor([w for _, w in terms], dtype=dtype, device=dev)
        ds = torch.as_tensor(np.stack([np.asarray(d) for d, _ in terms]),
                             dtype=dtype, device=dev)
        return cls(weights=ws, diags=ds)

    @property
    def n_terms(self) -> int:
        return self.weights.shape[0]


def stochastic_measure_diag(terms: DiagonalTermSet, psi: CP,
                            generator: torch.Generator,
                            per_pauli: int = 100) -> torch.Tensor:
    """Finite-shot estimate for diagonal terms: independent ``per_pauli``
    computational-basis draws from |psi|^2 per term (the reference's
    per-term sampling, `sim_plain.py:104-116`), then
    ``sum_t w_t mean(diag_t[draws])``. psi [d] gives a scalar, [..., d]
    one estimate per state. The draws come from ``generator`` on psi's
    device (``torch.multinomial`` with replacement), where the JAX
    package draws ``jax.random.categorical``."""
    probs = cpx.abs2(psi)
    lead = probs.shape[:-1]
    d = probs.shape[-1]
    n_terms = terms.n_terms
    draws = torch.multinomial(probs.reshape(-1, d), n_terms * per_pauli,
                              replacement=True, generator=generator)
    draws = draws.reshape(-1, n_terms, per_pauli)     # [S, t, shots]
    vals = torch.gather(terms.diags.expand(draws.shape[0], n_terms, d), -1,
                        draws)
    est = torch.sum(terms.weights * vals.mean(dim=-1), dim=-1)
    return est.reshape(lead)


def measurement_noise(value: torch.Tensor, generator: torch.Generator,
                      rel_scale: float = NOISE_REL_SCALE) -> torch.Tensor:
    """value + N(0, |value| * rel_scale) — `sim_plain.py:283-284`."""
    sigma = torch.abs(value) * rel_scale
    return value + sigma * torch.randn(value.shape, generator=generator,
                                       dtype=value.dtype,
                                       device=value.device)


def _bit_parity(v: torch.Tensor) -> torch.Tensor:
    """Parity (0/1) of the set bits of a non-negative integer tensor
    below 2^32, branchless."""
    for sh in (16, 8, 4, 2, 1):
        v = v ^ (v >> sh)
    return v & 1


def _parse_pauli_label(label: str) -> tuple[int, int, int]:
    """(flip_mask, yz_mask, n_y) for a Pauli string label, qubit 0 = MSB
    (the :func:`.ops.linalg.pauli_string` kron convention)."""
    n = len(label)
    flip = yz = n_y = 0
    for q, ch in enumerate(label.upper()):
        bit = 1 << (n - 1 - q)
        if ch == "X":
            flip |= bit
        elif ch == "Y":
            flip |= bit
            yz |= bit
            n_y += 1
        elif ch == "Z":
            yz |= bit
        elif ch != "I":
            raise ValueError(f"bad Pauli label char {ch!r} in {label!r}")
    return flip, yz, n_y


def _mask_axes(mask: int, n: int) -> list:
    """The qubits (tensor axes of the [2] * n view, 0 = MSB) set in
    ``mask``."""
    return [q for q in range(n) if (mask >> (n - 1 - q)) & 1]


@functools.lru_cache(maxsize=None)
def _sign_factors(yz: int, n: int, dtype, device) -> tuple:
    """(-1)^{par(j & yz)} as broadcast factors over the [2] * n view, one
    per run of up to _SIGN_CHUNK_BITS sign bits, made once per mask and
    device (no [d] sign or index vector)."""
    axes = _mask_axes(yz, n)
    out = []
    for lo in range(0, len(axes), _SIGN_CHUNK_BITS):
        f = torch.ones((1,) * n, dtype=dtype, device=device)
        for q in axes[lo:lo + _SIGN_CHUNK_BITS]:
            shape = [1] * n
            shape[q] = 2
            f = f * torch.tensor([1.0, -1.0], dtype=dtype,
                                 device=device).reshape(shape)
        out.append(f)
    return tuple(out)


def _sign_flip(x: torch.Tensor, flip: int, yz: int, n: int) -> torch.Tensor:
    """y[j] = (-1)^{par((j ^ flip) & yz)} x[j ^ flip] on the last axis of
    ``x`` [..., 2^n]: the sign is a product of +-1 along the sign bits'
    axes of the [2] * n view and the XOR flip is ``torch.flip`` over the
    flipped bits' axes, so no index tensor is built (autograd's VJP of a
    flip is the same flip)."""
    lead = x.shape[:-1]
    y = x.reshape(lead + (2,) * n)
    for f in _sign_factors(yz, n, x.dtype, x.device):
        y = y * f
    if flip:
        y = torch.flip(y, dims=[len(lead) + q for q in _mask_axes(flip, n)])
    return y.reshape(x.shape)


def _term_image(psi: CP, flip: int, yz: int, n: int) -> CP:
    """The string's flip and sign applied to psi, before its i^{n_y}."""
    return CP(_sign_flip(psi.re, flip, yz, n),
              _sign_flip(psi.im, flip, yz, n))


def _term_value(psi: CP, q: CP, n_y: int) -> torch.Tensor:
    """Re(i^{n_y} <psi|q>) over the last axis: <psi|P|psi> for the
    string's image q = :func:`_term_image`."""
    if n_y % 2:  # -Im <psi|q> for n_y = 1, +Im for 3 (mod 4)
        g = torch.sum(psi.re * q.im - psi.im * q.re, dim=-1)
        return -g if n_y % 4 == 1 else g
    g = torch.sum(psi.re * q.re + psi.im * q.im, dim=-1)
    return g if n_y % 4 == 0 else -g   # +Re for n_y = 0, -Re for 2


class _StringsExpectation(torch.autograd.Function):
    """<psi|M|psi> per state with its exact VJP: for Hermitian M the
    gradient of the real expectation is (2 Re(M psi), 2 Im(M psi)). The
    forward keeps no per-term image for the backward (at 24 qubits each
    is a 128 MB pair); the backward applies M once."""

    @staticmethod
    def forward(ctx, strings, re, im):
        ctx.strings = strings
        ctx.save_for_backward(re, im)
        return strings._expectation(CP(re, im))

    @staticmethod
    def backward(ctx, g):
        re, im = ctx.saved_tensors
        mp = ctx.strings.apply(CP(re, im))
        g2 = 2.0 * g[..., None]
        return None, g2 * mp.re, g2 * mp.im


@dataclasses.dataclass(frozen=True)
class PauliStringSet:
    """Matrix-free weighted Pauli-sum observable ``M = sum_t w_t P_t``.

    Each string acts on a computational-basis state as an XOR-mask index
    flip and a parity sign, ``P|j> = i^{n_y} (-1)^{par(j & yz)}
    |j ^ flip>``, so ``<psi|M|psi>`` costs a flip and a product per
    term, O(d) memory at any qubit count: what lets energy training scale
    for non-diagonal costs (TFIM, Heisenberg).

    weights: [n_terms] real, on the device; the masks are host ints.
    """

    weights: torch.Tensor
    flips: tuple          # per-term XOR masks
    yz_masks: tuple       # per-term sign masks (Y|Z bits)
    n_ys: tuple           # per-term Y counts
    n_qubits: int = -1

    @classmethod
    def create(cls, terms: Sequence[tuple[str, float]],
               dtype=torch.float32, device="cuda") -> "PauliStringSet":
        """terms: (label, weight) pairs, e.g. [("ZZI", -1.0), ("XII",
        -0.5)]. All labels must have equal length (the qubit count)."""
        labels = [t[0] for t in terms]
        n = len(labels[0])
        if any(len(lb) != n for lb in labels):
            raise ValueError("all Pauli labels must have the same length")
        parsed = [_parse_pauli_label(lb) for lb in labels]
        return cls(
            weights=torch.tensor([float(w) for _, w in terms], dtype=dtype,
                                 device=resolve_device(device)),
            flips=tuple(p[0] for p in parsed),
            yz_masks=tuple(p[1] for p in parsed),
            n_ys=tuple(p[2] for p in parsed),
            n_qubits=n)

    @property
    def n_terms(self) -> int:
        return len(self.flips)

    def _expectation(self, psi: CP) -> torch.Tensor:
        vals = [_term_value(psi, _term_image(psi, flip, yz, self.n_qubits),
                            n_y)
                for flip, yz, n_y in zip(self.flips, self.yz_masks,
                                         self.n_ys)]
        w = self.weights.to(psi.re.dtype)
        return torch.tensordot(w, torch.stack(vals), dims=1)

    def expectation(self, psi: CP) -> torch.Tensor:
        """sum_t w_t <psi|P_t|psi> for psi CP [..., d] (batch dims kept),
        differentiable in psi."""
        return _StringsExpectation.apply(self, psi.re, psi.im)

    def apply(self, psi: CP) -> CP:
        """(M psi), matrix-free."""
        w = self.weights.to(psi.re.dtype)
        out_re = torch.zeros_like(psi.re)
        out_im = torch.zeros_like(psi.im)
        for t, (flip, yz, n_y) in enumerate(zip(self.flips, self.yz_masks,
                                                self.n_ys)):
            q = _term_image(psi, flip, yz, self.n_qubits)
            sign = -1.0 if n_y % 4 >= 2 else 1.0
            if n_y % 2:  # i q = (-q.im, q.re)
                out_re = torch.addcmul(out_re, w[t], q.im, value=-sign)
                out_im = torch.addcmul(out_im, w[t], q.re, value=sign)
            else:
                out_re = torch.addcmul(out_re, w[t], q.re, value=sign)
                out_im = torch.addcmul(out_im, w[t], q.im, value=sign)
        return CP(out_re, out_im)


@functools.lru_cache(maxsize=None)
def qwc_groups(flips: tuple, yz_masks: tuple):
    """Greedy qubit-wise-commuting (QWC) grouping of Pauli strings.

    Two strings are QWC iff on every qubit their Paulis agree or one is
    the identity: then one single-qubit basis rotation diagonalizes the
    whole group and one batch of shots measures every member. Returns a
    tuple of groups ``(x_mask, y_mask, z_mask, term_indices)``, the masks
    the group's union basis assignment. Greedy first-fit in descending
    support order, on the host: the JAX package's order, so the groups
    are identical."""
    order = sorted(range(len(flips)),
                   key=lambda t: -bin(flips[t] | yz_masks[t]).count("1"))
    groups = []  # [x_mask, y_mask, z_mask, [term indices]]
    for t in order:
        flip, yz = flips[t], yz_masks[t]
        xt, yt, zt = flip & ~yz, flip & yz, yz & ~flip
        for g in groups:
            conflict = ((xt & (g[1] | g[2])) | (yt & (g[0] | g[2]))
                        | (zt & (g[0] | g[1])))
            if not conflict:
                g[0] |= xt
                g[1] |= yt
                g[2] |= zt
                g[3].append(t)
                break
        else:
            groups.append([xt, yt, zt, [t]])
    return tuple((g[0], g[1], g[2], tuple(g[3])) for g in groups)


_H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
_HSDAG = _H @ np.diag([1.0, -1j])


def _apply_local(psi: CP, qubit: int, n: int, local) -> CP:
    """A 2x2 complex gate on tensor axis ``qubit`` of CP [..., 2^n]; its
    entries are host numbers, so nothing is copied to the device."""
    g = np.asarray(local, dtype=complex)
    lead = psi.re.shape[:-1]
    shape = lead + (2**qubit, 2, 2 ** (n - qubit - 1))
    pre, pim = psi.re.reshape(shape), psi.im.reshape(shape)
    cols = [(pre[..., c, :], pim[..., c, :]) for c in range(2)]
    rows = []
    for r in range(2):
        re = im = 0.0
        for c, (a_re, a_im) in enumerate(cols):
            gr, gi = float(g[r, c].real), float(g[r, c].imag)
            if gr:
                re, im = re + gr * a_re, im + gr * a_im
            if gi:  # i gi (a_re + i a_im)
                re, im = re - gi * a_im, im + gi * a_re
        rows.append((re, im))
    re = torch.stack([rows[0][0], rows[1][0]], dim=-2)
    im = torch.stack([rows[0][1], rows[1][1]], dim=-2)
    return CP(re.reshape(psi.re.shape), im.reshape(psi.im.shape))


def draw_shots(probs: torch.Tensor, per_pauli: int,
               generator: torch.Generator) -> torch.Tensor:
    """``per_pauli`` computational-basis draws per row of ``probs`` [B,
    d], [B, per_pauli] (``torch.multinomial`` with replacement): the one
    source of :func:`stochastic_measure_strings`' draws."""
    d = probs.shape[-1]
    if d > MAX_SAMPLED_DIM:
        raise ValueError(f"sampled measurement of {d} amplitudes: "
                         f"torch.multinomial takes at most "
                         f"{MAX_SAMPLED_DIM} categories (24 qubits)")
    return torch.multinomial(probs, per_pauli, replacement=True,
                             generator=generator)


def stochastic_measure_strings(strings: PauliStringSet, psi: CP,
                               generator: torch.Generator,
                               per_pauli: int = 100) -> torch.Tensor:
    """Finite-shot estimate of a Pauli-sum expectation, grouped: the
    strings are partitioned into qubit-wise-commuting families
    (:func:`qwc_groups`); each family costs one basis rotation (X -> H,
    Y -> H S^dag per supported qubit) and one batch of ``per_pauli``
    computational-basis shots (:func:`draw_shots`), and every member's
    eigenvalue ``(-1)^{par(j & support)}`` is read off the same draws,
    as shots are spent on hardware. psi [d] gives a scalar, [..., d] one
    estimate per state."""
    n = strings.n_qubits
    d = 2**n
    lead = psi.re.shape[:-1]
    w = strings.weights.to(psi.re.dtype)
    total = 0.0
    for x_mask, y_mask, _, terms_idx in qwc_groups(strings.flips,
                                                   strings.yz_masks):
        rot = psi
        for q in range(n):  # the JAX package's qubit order
            bit = 1 << (n - 1 - q)
            if x_mask & bit:
                rot = _apply_local(rot, q, n, _H)
            elif y_mask & bit:
                rot = _apply_local(rot, q, n, _HSDAG)
        draws = draw_shots(cpx.abs2(rot).reshape(-1, d), per_pauli,
                           generator)
        for t in terms_idx:
            support = strings.flips[t] | strings.yz_masks[t]
            ev = 1.0 - 2.0 * _bit_parity(draws & support).to(psi.re.dtype)
            total = total + w[t] * ev.mean(dim=-1).reshape(lead)
    return total


@dataclasses.dataclass(frozen=True)
class Measurement:
    """A measurement objective — a dense operator (``matrix``), a
    diagonal (``diag``), a rank-1 target (``target``) or a Pauli-string
    sum (``strings``) — with the
    reference's sampling and noise switches (`sim_plain.py:30-31`).
    ``terms`` is the decomposition that sampled measurement reads (a
    :class:`PauliTermSet` for a dense operator, a
    :class:`DiagonalTermSet` for a diagonal; without one a diagonal is
    sampled as one term)."""

    diag: Optional[torch.Tensor] = None
    terms: Optional[object] = None
    sampling: bool = False
    noisy: bool = False
    per_pauli: int = 100
    matrix: Optional[CP] = None
    target: Optional[CP] = None
    strings: Optional[PauliStringSet] = None

    @classmethod
    def create(cls, matrix, terms=None, dtype=torch.float32, device="cuda",
               **kw) -> "Measurement":
        """From a host complex operator [d, d], with an optional
        (matrix, weight) term list for sampled measurement."""
        dev = resolve_device(device)
        term_set = PauliTermSet.create(terms, dtype=dtype, device=dev) \
            if terms else None
        return cls(matrix=cpx.from_complex(np.asarray(matrix), dtype=dtype,
                                           device=dev), terms=term_set, **kw)

    @classmethod
    def create_target(cls, target, dtype=torch.float32, device="cuda",
                      **kw) -> "Measurement":
        """Matrix-free rank-1 projector M = |t><t| from a target state:
        ``target`` a host complex [d] array or a CP pair (kept as it
        is)."""
        t = target if isinstance(target, CP) else cpx.from_complex(
            np.asarray(target), dtype=dtype, device=resolve_device(device))
        return cls(target=t, **kw)

    @classmethod
    def create_strings(cls, terms: Sequence[tuple[str, float]],
                       dtype=torch.float32, device="cuda",
                       **kw) -> "Measurement":
        """Matrix-free Pauli-sum observable from (label, weight) pairs,
        e.g. ``[("ZZI", -1.0), ("IXI", -0.5)]``: the exact and the
        shot-sampled paths need no dense matrix and no
        eigendecomposition."""
        return cls(strings=PauliStringSet.create(terms, dtype=dtype,
                                                 device=device), **kw)

    @classmethod
    def create_diagonal(cls, diag, diag_terms=None, dtype=torch.float32,
                        device="cuda", **kw) -> "Measurement":
        """Matrix-free diagonal observable: ``diag`` is the length-d real
        diagonal; ``diag_terms`` optional (diag_vector, weight) pairs."""
        dev = resolve_device(device)
        term_set = DiagonalTermSet.create(diag_terms, dtype=dtype,
                                          device=dev) if diag_terms else None
        return cls(diag=torch.as_tensor(np.asarray(diag), dtype=dtype,
                                        device=dev),
                   terms=term_set, **kw)

    def expectation(self, psi: CP,
                    generator: Optional[torch.Generator] = None):
        """Measured value of <psi|M|psi> (leading batch dims kept),
        honoring the sampling/noise flags; ``generator`` (on psi's
        device) is required when either is set."""
        return measure(self, psi, generator, self.sampling, self.noisy,
                       self.per_pauli)


def measure(m: Measurement, psi: CP, generator, sampling: bool,
            noisy: bool, per_pauli: int = 100) -> torch.Tensor:
    """<psi|M|psi>, shot-sampled and/or with Gaussian noise as asked (the
    flags of the caller, as the JAX package's estimators pass their
    own)."""
    if (sampling or noisy) and generator is None:
        raise ValueError("sampled or noisy measurement needs a "
                         "torch.Generator")
    if sampling:
        if m.target is not None:
            val = sampled_target_prob(m.target, psi, generator, per_pauli)
        elif m.strings is not None:
            val = stochastic_measure_strings(m.strings, psi, generator,
                                             per_pauli)
        elif isinstance(m.terms, PauliTermSet):
            val = stochastic_measure(m.terms, psi, generator, per_pauli)
        elif m.terms is not None or m.diag is not None:
            terms = m.terms
            if terms is None:  # sample the diagonal as ONE term
                terms = DiagonalTermSet(weights=torch.ones(
                    (1,), dtype=m.diag.dtype, device=m.diag.device),
                    diags=m.diag[None, :])
            val = stochastic_measure_diag(terms, psi, generator, per_pauli)
        else:
            raise ValueError(
                "sampling measurement needs a term decomposition: pass "
                "terms=/diag_terms= at construction (or use "
                "create_strings / create_target)")
    elif m.diag is not None:
        val = diag_expectation(m.diag, psi)
    elif m.target is not None:
        val = target_overlap_prob(m.target, psi)
    elif m.strings is not None:
        val = m.strings.expectation(psi)
    else:
        val = exact_expectation(m.matrix, psi)
    if noisy:
        val = measurement_noise(val, generator)
    return val
