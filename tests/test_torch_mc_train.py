"""Sampled and noisy measurement, and the 'mc'/'fd' trainers of the
PyTorch port against the JAX package on the CPU (the estimators are in
``test_torch_mc.py``).

Random streams differ between ``jax.random`` and ``torch.Generator``, so
the sampled measurement is compared by its statistics (within 5 standard
errors) and the MC trainers by their descent; the FD trainer is
deterministic and follows JAX's epoch by epoch (losses to 1e-8
relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu.train.config import TrainConfig as JConfig
from diffquantum_tpu.train.energy import train_energy as j_train
from diffquantum_tpu_torch import measure as tmeasure
from diffquantum_tpu_torch.gradients import mc as tmc
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.parallel import train_energy_seeds as t_seeds
from diffquantum_tpu_torch.train import train_energy_fd
from diffquantum_tpu_torch.train.config import TrainConfig as TConfig
from diffquantum_tpu_torch.train.energy import train_energy as t_train
from torch_estimators_common import N, _problems


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
