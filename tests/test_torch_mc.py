"""The Monte-Carlo pulse-gradient estimator and finite differences of the
PyTorch port against the JAX package on the CPU (the measurement and the
'mc'/'fd' trainers are in ``test_torch_mc_train.py``).

Random streams differ between ``jax.random`` and ``torch.Generator``, so
the estimators are compared at injected split times ``s`` (deterministic
given s) and the split-time strategies from the same uniforms.
Tolerances: f64 through the eager engines 1e-9 relative to the
gradient's max-norm (the same arithmetic in another order); f32 through
the port's fused wrapper (K1 and K2 plain paths) against JAX's f32 eager
engine 1e-4 of the max-norm (differences of energies that agree to
~1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.gradients import fd as jfd
from diffquantum_tpu.gradients import mc as jmc
from diffquantum_tpu.pulses import envelope as jenv
from diffquantum_tpu_torch.gradients import fd as tfd
from diffquantum_tpu_torch.gradients import mc as tmc
from diffquantum_tpu_torch.ops import fused_product as tfp
from diffquantum_tpu_torch.pulses import envelope as tenv
from torch_estimators_common import N, _problems, _rel_close


@pytest.mark.parametrize("basis", ["bspline", "legendre", "poly", "fourier"])
@pytest.mark.parametrize("chain", ["exact", "reference"])
def test_envelope_sensitivity_matches_jax(basis, chain):
    rng = np.random.default_rng(2)
    omegas = (np.pi, 0.5, 2.0)
    coeff = rng.standard_normal((3, 5))
    je = jenv.SimpleEnvelope(basis=basis, n_basis=5, omegas=omegas)
    te = tenv.SimpleEnvelope(basis=basis, n_basis=5, omegas=omegas)
    for s in (0.0, 0.37, 1.9):
        want = np.asarray(jmc.envelope_sensitivity(je, jnp.asarray(coeff), s,
                                                   2.0, chain))
        got = tmc.envelope_sensitivity(te, torch.tensor(coeff), s, 2.0,
                                       chain).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # split times [S] with a coefficient set each: JAX vmapped
    ss, cs = np.array([0.2, 1.1]), rng.standard_normal((2, 3, 5))
    want = np.asarray(jax.vmap(lambda c, s: jmc.envelope_sensitivity(
        je, c, s, 2.0, chain))(jnp.asarray(cs), jnp.asarray(ss)))
    got = tmc.envelope_sensitivity(te, torch.tensor(cs), torch.tensor(ss),
                                   2.0, chain).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("coeff_sign,t_jacobian", [(1.0, False),
                                                   (-1.0, False),
                                                   (1.0, True)])
def test_mc_energy_grad_f64_matches_jax(coeff_sign, t_jacobian):
    jp, tp, coeff = _problems(N, np.float64)
    kw = dict(coeff_sign=coeff_sign, t_jacobian=t_jacobian)
    want = np.asarray(jmc.mc_energy_grad(
        jp.ham, jp.envelope, jp.measurement, jnp.asarray(coeff), jp.psi0,
        jp.T, jax.random.PRNGKey(0), 6, backend="product", s=0.7, **kw))
    got = tmc.mc_energy_grad(tp.ham, tp.envelope, tp.measurement,
                             torch.tensor(coeff), tp.psi0, tp.T, None, 6,
                             s=0.7, **kw)
    assert got.shape == coeff.shape
    _rel_close(got.numpy(), want, 1e-9)


@pytest.mark.parametrize("chain", ["exact", "reference"])
def test_mc_energy_grad_f32_fused_wrapper(chain):
    """Leg 1 through K1's plain path, the 2 n_Hs branches through K2's
    (one shared phase row), against JAX's f32 eager engine."""
    jp, tp, coeff = _problems(N, np.float32)
    want = np.asarray(jmc.mc_energy_grad(
        jp.ham, jp.envelope, jp.measurement, jnp.asarray(coeff), jp.psi0,
        jp.T, jax.random.PRNGKey(0), 6, backend="product", s=1.3,
        chain=chain))
    got = tmc.mc_energy_grad(tp.ham, tp.envelope, tp.measurement,
                             torch.tensor(coeff), tp.psi0, tp.T, None, 6,
                             s=1.3, chain=chain, backend="product_fused")
    _rel_close(got.numpy(), want, 1e-4)
    assert tfp.FWD_LAUNCHES == 0 and tfp.K2_FWD_LAUNCHES == 0


@pytest.mark.parametrize("backend", ["product", "product_fused"])
def test_mc_energy_grad_batch_is_the_mean_of_samples(backend):
    """n_samples split times run as one batch (S members to s, S·2·n_Hs
    branches) give the mean of JAX's single samples at those times."""
    dt_np = np.float64 if backend == "product" else np.float32
    jp, tp, coeff = _problems(N, dt_np)
    ss = np.array([0.3, 0.8, 1.6])
    want = np.mean([np.asarray(jmc.mc_energy_grad(
        jp.ham, jp.envelope, jp.measurement, jnp.asarray(coeff), jp.psi0,
        jp.T, jax.random.PRNGKey(0), 6, backend="product", s=s))
        for s in ss], axis=0)
    got = tmc.mc_energy_grad_batch(tp.ham, tp.envelope, tp.measurement,
                                   torch.tensor(coeff), tp.psi0, tp.T, None,
                                   6, 3, s=torch.tensor(ss), backend=backend)
    _rel_close(got.numpy(), want, 1e-9 if backend == "product" else 1e-4)


@pytest.mark.parametrize("backend", ["product", "product_fused"])
def test_mc_grads_per_sample_per_seed_matches_jax(backend):
    """S samples, each with its own coefficient set and split time (the
    seed population's MC epoch): leg 1 has a grid per member, leg 2 runs
    S·2·n_Hs branches on S group rows. Each sample against JAX's single
    sample with that seed's coefficients, per sample relative to its own
    max-norm, so a branch reading a neighbour's row would show."""
    dt_np = np.float64 if backend == "product" else np.float32
    jp, tp, _ = _problems(N, dt_np)
    ss = np.array([0.3, 1.6, 0.9])
    cs = (0.5 * np.random.default_rng(11).standard_normal(
        (3,) + tp.envelope.coeff_shape)).astype(dt_np)
    got = tmc.mc_grads_per_sample(tp.ham, tp.envelope, tp.measurement,
                                  torch.tensor(cs), tp.psi0, tp.T,
                                  torch.tensor(ss), 6, backend=backend)
    assert got.shape == cs.shape
    for i, (c, s) in enumerate(zip(cs, ss)):
        want = np.asarray(jmc.mc_energy_grad(
            jp.ham, jp.envelope, jp.measurement, jnp.asarray(c), jp.psi0,
            jp.T, jax.random.PRNGKey(0), 6, backend="product", s=s))
        _rel_close(got[i].numpy(), want,
                   1e-9 if backend == "product" else 1e-4)


@pytest.mark.parametrize("strategy,n", [("iid", 4), ("antithetic", 4),
                                        ("stratified", 4)])
def test_split_time_strategies_match_jax(strategy, n, monkeypatch):
    """JAX's mc_energy_grad_batch with its per-sample gradient replaced by
    the powers s^1..s^n: their means identify the multiset of split
    times, which the port's split_times must reproduce from JAX's
    uniforms."""
    T = 2.0
    key = jax.random.PRNGKey(3)
    monkeypatch.setattr(jmc, "mc_energy_grad",
                        lambda *a, s, **kw: jnp.stack(
                            [s**p for p in range(1, n + 1)]))
    moments = np.asarray(jmc.mc_energy_grad_batch(
        None, None, None, None, None, T, key, 6, n, strategy=strategy,
        sample_mode="vmap"))
    if strategy == "iid":
        keys = jax.random.split(key, n)
        u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            jax.random.split(k)[0], dtype=jnp.float64))(keys))
    else:
        m = n // 2 if strategy == "antithetic" else n
        u = np.asarray(jax.random.uniform(key, (m,), dtype=jnp.float64))
    s = tmc.split_times(strategy, torch.tensor(u), T).numpy()
    assert s.shape == (n,) and np.all((s >= 0) & (s <= T))
    np.testing.assert_allclose([np.mean(s**p) for p in range(1, n + 1)],
                               moments, rtol=1e-12)
    gen = torch.Generator().manual_seed(0)
    drawn = tmc.draw_split_times(strategy, n, T, gen, lead=(5,))
    assert drawn.shape == (5, n) and drawn.dtype == torch.float64
    if strategy == "stratified":  # one split time per sub-interval
        assert torch.all(drawn // (T / n) == torch.arange(n))


def test_fd_energy_grad_f64_matches_jax():
    jp, tp, coeff = _problems(N, np.float64, n_basis=3)
    want = np.asarray(jfd.fd_energy_grad(
        jp.ham, jp.envelope, jp.measurement, jnp.asarray(coeff), jp.psi0,
        jp.T, jax.random.PRNGKey(0), 6, backend="product"))
    got = tfd.fd_energy_grad(tp.ham, tp.envelope, tp.measurement,
                             torch.tensor(coeff), tp.psi0, tp.T, None, 6)
    assert got.shape == coeff.shape
    _rel_close(got.numpy(), want, 1e-9)


def test_fd_f32_fused_agrees_with_adjoint():
    """The 2·n_params perturbed sets as one batch through K2's plain path
    approximate the adjoint gradient to the f32 difference quotient's
    error: (~1e-6 energy error) / delta 1e-2 ~ 1e-4."""
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    _, tp, coeff = _problems(N, np.float32, n_basis=3)
    c = torch.tensor(coeff)
    fd = tfd.fd_energy_grad(tp.ham, tp.envelope, tp.measurement, c, tp.psi0,
                            tp.T, None, 6, backend="product_fused",
                            delta=1e-2)
    _, adj = energy_and_grad(tp.ham, tp.envelope, tp.measurement, c,
                             tp.psi0, tp.T, 6, backend="product_fused")
    _rel_close(fd.numpy(), adj.numpy(), 2e-3)
