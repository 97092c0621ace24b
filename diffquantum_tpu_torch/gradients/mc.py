"""The paper's unbiased Monte-Carlo gradient estimator — the port of
:mod:`diffquantum_tpu.gradients.mc`.

Re-implements the reference's ``compute_energy_grad_MC``
(`sim_plain.py:156-231`): hardware-compatible gradients from forward
evolutions and measurements only. Per sample:

1. draw ``s ~ U(0, T)``;
2. the envelope sensitivity ``dD_k(s)/dc_kj`` of
   ``D_k = (2 sigmoid(A_k) - 1) omega_k``;
3. evolve ``phi = U(s, 0) psi0``;
4. apply the non-unitary gates ``(I ± r i H_k)/sqrt(1+r^2)``, r = 1/2:
   matrix-free on a structured Hamiltonian
   (:func:`..dynamics.product.apply_structured_terms`), one product of
   the dense stack Hs [n_c, d, d] with phi on a dense one;
5. evolve the 2 n_Hs branches from s to T and measure ``<M>``;
6. ``ps_k = sign * (1+r^2)/(2r) * (ps_m - ps_p)``;
7. chain rule ``grad[k, j] = ps_k * dD_k/dc_kj``.

Divergences from the reference are the JAX package's: static step counts
with a per-sample dt on both legs, ``chain='exact'`` by default
(``chain='reference'`` reproduces the reference's missing sigmoid factor
for poly/Fourier), and no 1/T scaling unless ``t_jacobian``.

Batching. The JAX package vmaps samples, or ``lax.map``s them from 18
qubits up (its ``_mc_sample_mode`` switch). Here, below 18 qubits
(``sample_mode`` 'vmap'), S samples, each with its own split time and,
for seed populations, its own coefficients, are flattened onto the batch
axis of the fused engine: leg 1 (0 -> s) is one evolution of S members
with per-member time grids, leg 2 (s -> T) one evolution of S·2·n_Hs
members whose phase and angle tables have one row per sample
(:func:`..ops.fused_product.fused_product_evolve_batched`'s group rows).
On the card that is one K2 launch per leg; a single sample evolves its
first leg on K1. From 18 qubits up ('map') the samples run one after
another, as the JAX package's 'map' mode does: each sample's leg 1 is
one K3/K5 chain and its 2·n_Hs branches one batched K3/K5 launch that
shares its split time (the packed engines take one time grid per
launch). The split times are drawn on the state's device from a
``torch.Generator`` and never copied to the host. Random streams differ
from ``jax.random``: the tests inject ``s``. On a dense Hamiltonian the
legs run the dense backends: leg 1 of one state on 'expm' below
d = 512, the branches on 'apply' (K7 on the card), per-sample grids as
groups of members (:func:`..dynamics.propagator.evolve`).

Envelope models. The simple model's sensitivity has a closed form
(:func:`envelope_sensitivity`); the channel model
(:class:`..pulses.envelope.ChannelEnvelope`) shares coefficient rows
across channels, so its full Jacobian ``du_k(s)/dcoeff`` is taken by
``torch.func.jacrev`` (vmapped over split times) and the estimator
contracts its control axis with ``ps_k``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dynamics import product
from ..dynamics.product import apply_structured_terms
from ..dynamics.propagator import evolve
from ..measure import Measurement, measure
from ..ops import cpx
from ..ops.cpx import CP
from ..pulses.basis import basis_matrix

STRATEGIES = ("iid", "antithetic", "stratified")
SAMPLE_MODES = ("auto", "vmap", "map")


def envelope_sensitivity(envelope, coeff: torch.Tensor, s, T,
                         chain: str = "exact") -> torch.Tensor:
    """dD_k(s)/dc_kj for the simple envelope model, closed form:
    D_k = (2 sigmoid(A_k) - 1) omega_k, A_k = sum_j c_kj phi_j(s), so
    dD_k/dc_kj = 2 sigmoid'(A_k) omega_k phi_j(s).

    ``s`` is a number or a tensor of split times [...]; ``coeff`` is
    [n_controls, n_basis] or one set per split time [..., n_controls,
    n_basis]. Returns [..., n_controls, n_basis] in coeff's dtype.
    chain='reference' reproduces `sim_plain.py:224-230`: poly/fourier get
    raw phi_j(s) (no sigmoid factor), legendre/bspline the exact chain."""
    s = torch.as_tensor(s, dtype=torch.float64, device=coeff.device)
    phi = basis_matrix(envelope.basis, envelope.n_basis, s,
                       T).to(coeff.dtype)                  # [..., n_basis]
    a = torch.sum(coeff * phi[..., None, :], dim=-1)       # [..., n_c]
    sig = torch.sigmoid(a)
    omg = envelope.omega_vector(a.dtype, a.device)
    factor = 2.0 * sig * (1.0 - sig) * omg
    exact = factor[..., :, None] * phi[..., None, :]
    if chain == "exact":
        return exact
    if chain == "reference":
        if envelope.basis in ("legendre", "bspline"):
            return exact
        return torch.broadcast_to(phi[..., None, :], exact.shape)
    raise ValueError(f"unknown chain mode {chain!r}")


def envelope_jacobian(envelope, coeff: torch.Tensor, s, T) -> torch.Tensor:
    """du_k(s)/dcoeff for any envelope model, by ``torch.func.jacrev``
    (the channel model shares coefficient rows across channels, so the
    closed form above does not apply). ``s`` 0-dim gives
    [n_controls, *coeff_shape]; ``s`` [S] gives [S, n_controls,
    *coeff_shape] through ``torch.func.vmap``, with ``coeff`` shared or
    one set per split time [S, *coeff_shape]."""
    s = torch.as_tensor(s, dtype=torch.float64, device=coeff.device)

    def u_at(c, si):
        return envelope.amplitudes(c, si[None], T)[..., 0]

    jac = torch.func.jacrev(u_at)
    if s.ndim == 0:
        return jac(coeff, s)
    if s.ndim != 1:
        raise ValueError(f"split times must be 0-dim or [S], got "
                         f"{tuple(s.shape)}")
    per_sample = coeff.ndim == len(envelope.coeff_shape) + 1
    return torch.func.vmap(jac, in_dims=(0 if per_sample else None, 0))(
        coeff, s)


def _mc_sample_mode(ham, mode: str) -> str:
    """'vmap' runs all samples on the batch axis of one evolution per
    leg; 'map' runs them one after another. 'auto' picks 'map' from the
    packed engines' size up (18 qubits), where one time grid serves a
    launch, as the JAX package's router does."""
    if mode not in SAMPLE_MODES:
        raise ValueError(f"unknown sample_mode {mode!r}; expected one of "
                         f"{SAMPLE_MODES}")
    if mode != "auto":
        return mode
    return "map" if ham.n_qubits >= product._PACKED_MIN_QUBITS else "vmap"


def split_times(strategy: str, u: torch.Tensor, T) -> torch.Tensor:
    """Split times from uniforms ``u`` [..., m] as
    :func:`mc_energy_grad_batch`'s strategies set them, for N samples:
    'iid' s = u T (m = N); 'antithetic' the pairs (u T, (1 - u) T), first
    all u then all 1 - u (m = N/2); 'stratified' s_i = (i + u_i) T / N
    (m = N)."""
    if strategy == "iid":
        return u * T
    if strategy == "antithetic":
        return torch.cat([u, 1.0 - u], dim=-1) * T
    if strategy == "stratified":
        n = u.shape[-1]
        i = torch.arange(n, dtype=u.dtype, device=u.device)
        return (i + u) * (T / n)
    raise ValueError(f"unknown sampling strategy {strategy!r}")


def draw_split_times(strategy: str, n_samples: int, T,
                     generator: torch.Generator, lead: tuple = ()):
    """[*lead, n_samples] split times drawn by ``strategy`` (float64, on
    the generator's device)."""
    if strategy == "antithetic" and n_samples % 2:
        raise ValueError("antithetic sampling needs even n_samples")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown sampling strategy {strategy!r}")
    m = n_samples // 2 if strategy == "antithetic" else n_samples
    u = torch.rand(tuple(lead) + (m,), generator=generator,
                   dtype=torch.float64, device=generator.device)
    return split_times(strategy, u, T)


def mc_grads_per_sample(ham, envelope, measurement: Measurement, coeff,
                        psi0: CP, T, s, n_steps: int, generator=None,
                        backend: str = "auto", r: float = 0.5,
                        coeff_sign: float = 1.0, chain: str = "exact",
                        sampling: bool = False, noisy: bool = False,
                        per_pauli: int = 100, t_jacobian: bool = False,
                        precision: str = "full", t_sample: str = "left",
                        sample_mode: str = "auto") -> torch.Tensor:
    """One MC sample per split time: ``s`` 0-dim (one sample, psi0 [d],
    coeff of the envelope's ``coeff_shape``) or [S] (S samples; coeff
    shared or one set each, [S, *coeff_shape]; psi0 [d] shared or [S,
    d]). Returns grads shaped like ``s.shape + coeff_shape``. The
    seed-population trainer flattens seeds × samples onto S.
    ``sample_mode`` as :func:`_mc_sample_mode`; arguments after
    ``n_steps`` as for :func:`mc_energy_grad`."""
    s = torch.as_tensor(s, dtype=torch.float64, device=psi0.device)
    one = dict(generator=generator, backend=backend, r=r,
               coeff_sign=coeff_sign, chain=chain, sampling=sampling,
               noisy=noisy, per_pauli=per_pauli, t_jacobian=t_jacobian,
               precision=precision, t_sample=t_sample)
    if s.ndim == 1 and _mc_sample_mode(ham, sample_mode) == "map":
        per_coeff = coeff.ndim == len(envelope.coeff_shape) + 1
        return torch.stack([mc_grads_per_sample(
            ham, envelope, measurement, coeff[i] if per_coeff else coeff,
            psi0[i] if psi0.ndim == 2 else psi0, T, s[i], n_steps, **one)
            for i in range(s.shape[0])])
    T = float(T)
    kw = dict(horizon=T, n_steps=n_steps, backend=backend,
              precision=precision, t_sample=t_sample)
    simple = hasattr(envelope, "omegas")
    dDdc = envelope_sensitivity(envelope, coeff, s, T, chain) if simple \
        else envelope_jacobian(envelope, coeff, s, T)
    batched = s.ndim == 1
    if batched and psi0.ndim == 1:
        n = s.shape[0]
        psi0 = CP(psi0.re.expand(n, -1), psi0.im.expand(n, -1))
    # leg 1, 0 -> s: K1 for one sample, K2 with a grid per member else
    phi = evolve(ham, envelope, coeff, psi0, 0.0, s, **kw)

    # perturbation gates phi ± r i (H_k phi), i (a + ib) = -b + ia
    if ham.is_structured_only:
        h_re, h_im = apply_structured_terms(ham, phi)      # [n_hs, ..., d]
    else:  # one product of the dense stack with phi (plain torch.matmul)
        h_re, h_im = cpx.matvec(ham.Hs, phi)               # [n_hs, ..., d]
    h_re, h_im = h_re.movedim(0, -2), h_im.movedim(0, -2)  # [..., n_hs, d]
    p_re, p_im = phi.re[..., None, :], phi.im[..., None, :]
    scale = 1.0 / (1.0 + r * r) ** 0.5
    br_re = torch.cat([p_re - r * h_im, p_re + r * h_im], dim=-2) * scale
    br_im = torch.cat([p_im + r * h_re, p_im - r * h_re], dim=-2) * scale
    n_hs = h_re.shape[-2]
    d = phi.re.shape[-1]
    # leg 2, s -> T: the branches of sample i share its pulses (rows)
    kets = evolve(ham, envelope, coeff, CP(br_re.reshape(-1, d),
                                           br_im.reshape(-1, d)),
                  s, T, **kw)
    ps = measure(measurement, kets, generator, sampling, noisy, per_pauli)
    ps = ps.reshape(s.shape + (2 * n_hs,))
    factor = coeff_sign * (1.0 + r * r) / (2.0 * r)
    if t_jacobian:
        factor = factor * T
    ps_k = factor * (ps[..., n_hs:] - ps[..., :n_hs])      # [..., n_hs]
    ps_k = ps_k.to(dDdc.dtype)
    if simple:
        return ps_k[..., None] * dDdc
    # the channel model: contract the control axis of the full Jacobian
    lead = dDdc.shape[:-len(envelope.coeff_shape) - 1]
    flat = dDdc.reshape(lead + (n_hs, -1))
    return torch.matmul(ps_k[..., None, :], flat).reshape(
        lead + tuple(envelope.coeff_shape))


def mc_energy_grad(ham, envelope, measurement: Measurement,
                   coeff: torch.Tensor, psi0: CP, T: float,
                   generator: Optional[torch.Generator], n_steps: int,
                   backend: str = "auto", r: float = 0.5,
                   coeff_sign: float = 1.0, chain: str = "exact",
                   sampling: bool = False, noisy: bool = False,
                   per_pauli: int = 100, t_jacobian: bool = False,
                   s=None, precision: str = "full",
                   t_sample: str = "left") -> torch.Tensor:
    """One MC sample of the stochastic gradient (the reference's one
    sample per step, `sim_plain.py:290`), shaped like ``coeff``.

    ``generator`` draws s ~ U(0, T) and the shots and noise of a sampled
    or noisy measurement, on the state's device; it may be None when
    ``s`` is given and the measurement is exact. ``coeff_sign=-1.0`` is
    the fidelity-training mode (`sim_plain.py:461`); ``t_jacobian=True``
    multiplies by the U(0, T) sampling Jacobian T. ``s`` overrides the
    draw (a number or 0-dim tensor in [0, T]). On the card: K1 to s, then
    one K2 launch over the 2 n_Hs branches (from 18 qubits one K3/K5
    chain, then one batched K3/K5 launch)."""
    if s is None:
        if generator is None:
            raise ValueError("mc_energy_grad needs a generator or s")
        s = torch.rand((), generator=generator, dtype=torch.float64,
                       device=generator.device) * T
    return mc_grads_per_sample(
        ham, envelope, measurement, coeff, psi0, T, s, n_steps, generator,
        backend=backend, r=r, coeff_sign=coeff_sign, chain=chain,
        sampling=sampling, noisy=noisy, per_pauli=per_pauli,
        t_jacobian=t_jacobian, precision=precision, t_sample=t_sample)


def mc_energy_grad_batch(ham, envelope, measurement, coeff, psi0, T,
                         generator: torch.Generator, n_steps: int,
                         n_samples: int, strategy: str = "iid",
                         s: Optional[torch.Tensor] = None,
                         **kw) -> torch.Tensor:
    """Average of ``n_samples`` MC gradient samples. The only randomness
    of the noiseless estimator is the split time; its ``strategy`` sets
    the variance at fixed cost: 'iid' (independent uniforms), 'antithetic'
    (pairs s, T - s) or 'stratified' (one uniform per sub-interval
    [i T/N, (i+1) T/N)); all three are unbiased (:func:`split_times`).
    ``s`` [n_samples] overrides the draw. ``kw`` as for
    :func:`mc_energy_grad`, and ``sample_mode`` (:func:`_mc_sample_mode`).
    On the card below 18 qubits: two K2 launches, n_samples members to
    the split times, then n_samples·2·n_Hs branches; from 18 qubits the
    samples one after another."""
    if s is None:
        s = draw_split_times(strategy, n_samples, T, generator)
    s = torch.as_tensor(s, dtype=torch.float64, device=psi0.device)
    if s.shape != (n_samples,):
        raise ValueError(f"s must be [{n_samples}], got {tuple(s.shape)}")
    g = mc_grads_per_sample(ham, envelope, measurement, coeff, psi0, T, s,
                            n_steps, generator, **kw)
    return g.mean(dim=0)
