"""The Monte-Carlo pulse-gradient estimator, finite differences, sampled
and noisy measurement, and the 'mc'/'fd' trainers of the PyTorch port
against the JAX package on the CPU.

Random streams differ between ``jax.random`` and ``torch.Generator``, so
the estimators are compared at injected split times ``s`` (deterministic
given s), the split-time strategies from the same uniforms, and the
sampled measurement by its statistics. Tolerances: f64 through the eager
engines 1e-9 relative to the gradient's max-norm (the same arithmetic in
another order); f32 through the port's fused wrapper (K1 and K2 plain
paths) against JAX's f32 eager engine 1e-4 of the max-norm (differences
of energies that agree to ~1e-6); statistics within 5 standard errors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.gradients import fd as jfd
from diffquantum_tpu.gradients import mc as jmc
from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu.pulses import envelope as jenv
from diffquantum_tpu.train.config import TrainConfig as JConfig
from diffquantum_tpu.train.energy import train_energy as j_train
from diffquantum_tpu_torch import measure as tmeasure
from diffquantum_tpu_torch.gradients import fd as tfd
from diffquantum_tpu_torch.gradients import mc as tmc
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.ops import fused_product as tfp
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.parallel import train_energy_seeds as t_seeds
from diffquantum_tpu_torch.pulses import envelope as tenv
from diffquantum_tpu_torch.train import train_energy_fd
from diffquantum_tpu_torch.train.config import TrainConfig as TConfig
from diffquantum_tpu_torch.train.energy import train_energy as t_train

N = 10


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _problems(n, dtype_np, n_basis=4, **kw):
    tdt = torch.float64 if dtype_np == np.float64 else torch.float32
    jp = jmaxcut.build_maxcut(n, jmaxcut.ring_graph(n), n_basis=n_basis,
                              dense=False, dtype=jnp.dtype(dtype_np), **kw)
    tp = tmaxcut.build_maxcut(n, tmaxcut.ring_graph(n), n_basis=n_basis,
                              dense=False, dtype=tdt, device="cpu", **kw)
    coeff = (0.5 * np.random.default_rng(n).standard_normal(
        tp.envelope.coeff_shape)).astype(dtype_np)
    return jp, tp, coeff


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


# ---------------------------------------------------------------------------
# sampled and noisy measurement
# ---------------------------------------------------------------------------

def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((2, 2**n))
    v /= np.sqrt(np.sum(v**2))
    return v


def test_stochastic_measure_diag_statistics():
    """Mean of many shot estimates within 5 standard errors of the exact
    value, for a state [d] and a batch [B, d]; JAX's sampler gives the
    same mean."""
    n = 4
    jp, tp, _ = _problems(n, np.float64)
    v = _state(n, 0)
    exact = float(np.sum((v[0]**2 + v[1]**2) * tp.cost_diag))
    gen = torch.Generator().manual_seed(1)
    psi = CP(*map(torch.tensor, v))
    one = tmeasure.stochastic_measure_diag(tp.measurement.terms, psi, gen,
                                           per_pauli=50)
    assert one.shape == ()
    batch = CP(psi.re.expand(400, -1), psi.im.expand(400, -1))
    est = tmeasure.stochastic_measure_diag(tp.measurement.terms, batch, gen,
                                           per_pauli=50).numpy()
    assert est.shape == (400,)
    se = est.std() / np.sqrt(len(est))
    assert abs(est.mean() - exact) < 5 * se
    keys = jax.random.split(jax.random.PRNGKey(0), 400)
    from diffquantum_tpu.measure import stochastic_measure_diag as j_smd
    from diffquantum_tpu.ops.cpx import CP as JCP
    j_est = np.asarray(jax.vmap(lambda k: j_smd(
        jp.measurement.terms, JCP(jnp.asarray(v[0]), jnp.asarray(v[1])), k,
        50))(keys))
    se2 = np.sqrt(est.var() / 400 + j_est.var() / 400)
    assert abs(est.mean() - j_est.mean()) < 5 * se2


def test_measurement_noise_statistics():
    gen = torch.Generator().manual_seed(2)
    vals = torch.tensor([-3.0, 0.5, 2.0], dtype=torch.float64)
    draws = torch.stack([tmeasure.measurement_noise(vals, gen)
                         for _ in range(4000)]).numpy()
    assert draws.shape == (4000, 3)
    sigma = np.abs(vals.numpy()) * tmeasure.NOISE_REL_SCALE
    assert np.all(np.abs(draws.mean(0) - vals.numpy())
                  < 5 * sigma / np.sqrt(4000))
    np.testing.assert_allclose(draws.std(0), sigma, rtol=0.1)
    from diffquantum_tpu.measure import NOISE_REL_SCALE
    assert tmeasure.NOISE_REL_SCALE == NOISE_REL_SCALE


@pytest.mark.parametrize("terms", ["terms", "one_term"])
def test_measurement_expectation_sampled_and_noisy(terms):
    """Measurement.expectation with sampling (the term table, or the
    one-term fallback when the measurement has none) and noise: right
    shapes, unbiased within 5 standard errors."""
    n = 4
    _, tp, _ = _problems(n, np.float64, sampling=True, noisy=True)
    m = tp.measurement
    if terms == "one_term":
        m = tmeasure.Measurement(diag=m.diag, sampling=True, noisy=True)
    v = _state(n, 3)
    exact = float(np.sum((v[0]**2 + v[1]**2) * tp.cost_diag))
    psi = CP(*(torch.tensor(x).expand(300, -1) for x in v))
    gen = torch.Generator().manual_seed(4)
    est = m.expectation(psi, gen).numpy()
    assert est.shape == (300,)
    assert abs(est.mean() - exact) < 5 * est.std() / np.sqrt(300)
    with pytest.raises(ValueError, match="Generator"):
        m.expectation(psi)


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

def test_train_energy_fd_matches_jax_epoch_by_epoch():
    """FD is deterministic: the FD trainer follows JAX's epoch by epoch."""
    jp = jmaxcut.demo_problem(dtype=jnp.float64, dense=False)
    tp = tmaxcut.demo_problem(dtype=torch.float64, dense=False, device="cpu")
    coeff = 1e-3 * np.random.default_rng(0).standard_normal(
        tp.envelope.coeff_shape)
    cfg = dict(n_basis=6, n_epoch=4, lr=5e-2, dtype="float64", n_step=20)
    jr = j_train(jp.ham, jp.envelope, jp.measurement, jp.psi0, jp.T,
                 JConfig(grad_mode="fd", **cfg), init_coeff=jnp.asarray(coeff))
    tr = train_energy_fd(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T,
                         TConfig(**cfg), init_coeff=torch.tensor(coeff))
    assert tr.grad_mode == "fd"
    np.testing.assert_allclose(tr.losses_raw, jr.losses_raw, rtol=1e-8)
    np.testing.assert_allclose(tr.coeff.numpy(), np.asarray(jr.coeff),
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("mc_samples", [1, 3])
def test_train_energy_mc_descends(mc_samples):
    """The 4-qubit demo ring with MC gradients (one sample, or the mean of
    three iid samples as one batch) descends toward its max cut."""
    tp = tmaxcut.demo_problem(dtype=torch.float64, dense=False, device="cpu")
    cfg = TConfig(n_basis=6, n_epoch=60, lr=5e-2, dtype="float64",
                  grad_mode="mc", n_step=20, mc_samples=mc_samples)
    r = t_train(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T, cfg)
    assert len(r.losses_raw) == 60 and r.grad_mode == "mc"
    assert min(r.losses_raw) - float(np.min(tp.cost_diag)) < 0.5
    assert r.losses_raw[-1] < r.losses_raw[0] - 1.0


def test_train_energy_mc_sampled_noisy_runs():
    """Shot-sampled, noisy MC training: measured losses are finite and
    scatter around the exact energy."""
    tp = tmaxcut.demo_problem(dtype=torch.float64, dense=False, device="cpu")
    cfg = TConfig(n_basis=6, n_epoch=5, lr=5e-2, dtype="float64",
                  grad_mode="mc", n_step=20, mc_samples=2,
                  sampling_measure=True, is_noisy=True, per_pauli=20)
    r = t_train(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T, cfg)
    assert np.all(np.isfinite(r.losses_raw)) and len(r.losses_raw) == 5
    assert len(set(r.losses_raw)) == 5  # every epoch draws anew


@pytest.mark.parametrize("mc_samples,strategy", [(1, "iid"),
                                                 (2, "stratified")])
def test_train_energy_seeds_mc_mode(mc_samples, strategy):
    """As tests/test_parallel.py holds the JAX trainer: MC gradients over
    4 seeds of the demo ring reach within 1.0 of the optimum."""
    tp = tmaxcut.demo_problem(dtype=torch.float64, dense=False, device="cpu")
    cfg = TConfig(n_basis=6, n_epoch=60, lr=5e-2, dtype="float64", seed=0,
                  grad_mode="mc", n_step=20, mc_samples=mc_samples,
                  mc_strategy=strategy)
    res = t_seeds(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T, cfg,
                  n_seeds=4)
    assert res.losses.shape == (60, 4)
    assert res.best_loss - float(np.min(tp.cost_diag)) < 1.0
    assert res.coeffs.shape == (4,) + tp.envelope.coeff_shape


def test_mc_batch_points_along_the_adjoint_gradient():
    """64 stratified samples through the fused wrapper (K1/K2 plain paths)
    at 10 qubits: the estimate's cosine with the adjoint gradient reads
    0.998 (its bias is the per-leg grid, not the variance); the limit
    0.99 is the one chip_smoke.py holds the 12-qubit run to."""
    from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad
    tp = tmaxcut.build_maxcut(N, tmaxcut.ring_graph(N), n_basis=6,
                              device="cpu")
    c = torch.tensor(0.4 * np.random.default_rng(12).standard_normal(
        tp.envelope.coeff_shape), dtype=torch.float32)
    _, adj = energy_and_grad(tp.ham, tp.envelope, tp.measurement, c,
                             tp.psi0, tp.T, 30, backend="product_fused")
    est = tmc.mc_energy_grad_batch(tp.ham, tp.envelope, tp.measurement, c,
                                   tp.psi0, tp.T,
                                   torch.Generator().manual_seed(0), 30, 64,
                                   strategy="stratified",
                                   backend="product_fused")
    cos = float((est * adj).sum() / (est.norm() * adj.norm()))
    assert cos > 0.99
