"""Pauli-string objectives of the PyTorch port against the JAX package on
the CPU: ``PauliStringSet`` (expectation, apply, its gradient),
``qwc_groups``, ``create_strings`` and ``measure``, the grouped shot
sampler with the JAX package's own draws injected, ``energy_and_grad``,
the MC and FD estimators and the seed trainer on strings, ``build_tfim``
and ``build_heisenberg`` and a short training run, and
``sharded_strings_expectation`` on 2 and 4 gloo ranks.

Tolerances: float64 on both sides, the same arithmetic in another order:
values and states 1e-12 absolute (1e-10 through an evolution),
gradients 1e-9 of their max-norm; the sampled estimate from the same
draws 1e-12; the port's own draws within 5 standard errors of the exact
value; training losses 1e-8 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from diffquantum_tpu import measure as jm
from diffquantum_tpu.gradients import adjoint as jadj
from diffquantum_tpu.gradients import fd as jfd
from diffquantum_tpu.gradients import mc as jmc
from diffquantum_tpu.models import heisenberg as jheis
from diffquantum_tpu.models import tfim as jtfim
from diffquantum_tpu.ops import cpx as jcpx
from diffquantum_tpu.parallel.mesh import train_energy_seeds as j_seeds
from diffquantum_tpu.train.config import TrainConfig as JConfig
from diffquantum_tpu.train.energy import train_energy as j_train
from diffquantum_tpu_torch import measure as tm
from diffquantum_tpu_torch.gradients import adjoint as tadj
from diffquantum_tpu_torch.gradients import fd as tfd
from diffquantum_tpu_torch.gradients import mc as tmc
from diffquantum_tpu_torch.models import heisenberg as theis
from diffquantum_tpu_torch.models import tfim as ttfim
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.parallel import train_energy_seeds as t_seeds
from diffquantum_tpu_torch.train.config import TrainConfig as TConfig
from diffquantum_tpu_torch.train.energy import train_energy as t_train

import test_torch_gloo as ranks


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _random_terms(n, n_terms, seed):
    rng = np.random.default_rng(seed)
    return [("".join(rng.choice(list("IXYZ"), n)),
             float(rng.standard_normal())) for _ in range(n_terms)]


def _pair(psi):
    """(JAX CP, port CP) of a complex numpy array."""
    return (jcpx.CP(jnp.asarray(psi.real), jnp.asarray(psi.imag)),
            CP(torch.tensor(psi.real), torch.tensor(psi.imag)))


def _state(shape, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return psi / np.linalg.norm(psi, axis=-1, keepdims=True)


@pytest.mark.parametrize("n", [3, 6, 10])
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_strings_expectation_and_apply_match_jax(n, lead):
    terms = _random_terms(n, 14, seed=n) + [("Y" * n, 0.3), ("I" * n, -0.7)]
    js = jm.PauliStringSet.create(terms, dtype=jnp.float64)
    ts = tm.PauliStringSet.create(terms, dtype=torch.float64, device="cpu")
    assert (ts.flips, ts.yz_masks, ts.n_ys, ts.n_qubits, ts.n_terms) == \
        (js.flips, js.yz_masks, js.n_ys, js.n_qubits, js.n_terms)
    jp, tp = _pair(_state(lead + (2**n,), seed=n + 1))
    np.testing.assert_allclose(ts.expectation(tp).numpy(),
                               np.asarray(js.expectation(jp)), rtol=0,
                               atol=1e-12)
    ja, ta = js.apply(jp), ts.apply(tp)
    np.testing.assert_allclose(ta.re.numpy(), np.asarray(ja.re), atol=1e-12)
    np.testing.assert_allclose(ta.im.numpy(), np.asarray(ja.im), atol=1e-12)


def test_strings_gradient_matches_jax():
    """The custom VJP (2 M psi) against jax.grad of the JAX expectation,
    on a batch of states with a cotangent per member."""
    n = 7
    terms = _random_terms(n, 20, seed=4)
    js = jm.PauliStringSet.create(terms, dtype=jnp.float64)
    ts = tm.PauliStringSet.create(terms, dtype=torch.float64, device="cpu")
    psi = _state((3, 2**n), seed=5)
    ct = np.array([0.5, -1.0, 2.0])
    want = jax.grad(lambda a, b: jnp.sum(jnp.asarray(ct) * js.expectation(
        jcpx.CP(a, b))), argnums=(0, 1))(jnp.asarray(psi.real),
                                         jnp.asarray(psi.imag))
    re = torch.tensor(psi.real, requires_grad=True)
    im = torch.tensor(psi.imag, requires_grad=True)
    val = (torch.tensor(ct) * ts.expectation(CP(re, im))).sum()
    got = torch.autograd.grad(val, (re, im))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12)


@pytest.mark.parametrize("which", ["random", "tfim", "heisenberg"])
def test_qwc_groups_equal_jax(which):
    terms = {"random": _random_terms(8, 30, seed=9),
             "tfim": [(lb, 1.0) for lb in
                      ["ZZIIII", "IZZIII", "XIIIII", "IXIIII", "IIIIIX"]],
             "heisenberg": jheis.cost_terms(6, 1.0, 0.5)}[which]
    js = jm.PauliStringSet.create(terms, dtype=jnp.float64)
    ts = tm.PauliStringSet.create(terms, dtype=torch.float64, device="cpu")
    assert tm.qwc_groups(ts.flips, ts.yz_masks) == \
        jm.qwc_groups(js.flips, js.yz_masks)


def test_create_strings_and_measure_exact():
    terms = _random_terms(5, 9, seed=3)
    jmeas = jm.Measurement.create_strings(terms, dtype=jnp.float64)
    tmeas = tm.Measurement.create_strings(terms, dtype=torch.float64,
                                          device="cpu", per_pauli=7)
    assert tmeas.matrix is None and tmeas.diag is None
    assert tmeas.per_pauli == 7 and tmeas.strings.n_terms == 9
    jp, tp = _pair(_state((4, 32), seed=6))
    np.testing.assert_allclose(tmeas.expectation(tp).numpy(),
                               np.asarray(jmeas.expectation(jp)), atol=1e-12)
    np.testing.assert_allclose(
        tm.measure(tmeas, tp, None, False, False).numpy(),
        np.asarray(jmeas.expectation(jp)), atol=1e-12)


def _jax_group_draws(js, psi, key, per_pauli):
    """(rotated probabilities [B, d], draws [B, per_pauli]) of each QWC
    group, in group order, as ``jm.stochastic_measure_strings`` makes
    them for ``key``."""
    n = js.n_qubits
    groups = jm.qwc_groups(js.flips, js.yz_masks)
    keys = jax.random.split(key, len(groups))
    h = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    out = []
    for gi, (x_mask, y_mask, _, _) in enumerate(groups):
        rot = psi
        for q in range(n):
            bit = 1 << (n - 1 - q)
            if x_mask & bit:
                rot = jm._apply_local(rot, q, n, h)
            elif y_mask & bit:
                rot = jm._apply_local(rot, q, n, h @ np.diag([1.0, -1j]))
        probs = jcpx.abs2(rot).reshape(-1, 2**n)
        logp = jnp.log(jnp.maximum(probs, 1e-30))
        out.append((np.asarray(probs), np.asarray(jax.random.categorical(
            keys[gi], logp[:, None, :], axis=-1,
            shape=(probs.shape[0], per_pauli)))))
    return out


@pytest.mark.parametrize("lead", [(), (3,)])
def test_sampled_strings_with_jax_draws(monkeypatch, lead):
    """The port's grouped sampler fed the JAX sampler's own draws (its
    :func:`draw_shots` replaced) gives the JAX estimate, and its rotated
    distributions are JAX's (checked on the probabilities it is handed)."""
    n, per_pauli = 6, 40
    terms = _random_terms(n, 12, seed=11) + jheis.cost_terms(n, 1.0, 0.5)
    js = jm.PauliStringSet.create(terms, dtype=jnp.float64)
    ts = tm.PauliStringSet.create(terms, dtype=torch.float64, device="cpu")
    psi = _state(lead + (2**n,), seed=12)
    jp, tp = _pair(psi)
    key = jax.random.PRNGKey(3)
    draws = iter(_jax_group_draws(js, jp, key, per_pauli))

    def injected(probs, k, generator):
        want_probs, want_draws = next(draws)
        assert k == per_pauli
        np.testing.assert_allclose(probs.numpy(), want_probs, atol=1e-12)
        return torch.tensor(want_draws, dtype=torch.long)

    monkeypatch.setattr(tm, "draw_shots", injected)
    got = tm.stochastic_measure_strings(ts, tp, None, per_pauli)
    want = jm.stochastic_measure_strings(js, jp, key, per_pauli)
    assert next(draws, None) is None
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-12)


def test_sampled_strings_statistics():
    """The port's own draws: the mean of 400 grouped estimates lies
    within 5 standard errors of the exact expectation, per state."""
    n = 5
    terms = jheis.cost_terms(n, 1.0, 0.7) + [("XIIIZ", 0.4)]
    meas = tm.Measurement.create_strings(terms, dtype=torch.float64,
                                         device="cpu", sampling=True,
                                         per_pauli=50)
    psi = _state((2, 2**n), seed=2)
    _, tp = _pair(psi)
    exact = meas.strings.expectation(tp).numpy()
    gen = torch.Generator().manual_seed(0)
    est = torch.stack([meas.expectation(tp, gen) for _ in range(400)]
                      ).numpy()
    se = est.std(axis=0) / np.sqrt(400)
    assert np.all(np.abs(est.mean(axis=0) - exact) < 5 * se)


def _tfim_pair(n, dense=False, n_basis=4):
    jp = jtfim.build_tfim(n, n_basis=n_basis, dense=dense,
                          dtype=jnp.float64)
    tp = ttfim.build_tfim(n, n_basis=n_basis, dense=dense,
                          dtype=torch.float64, device="cpu")
    coeff = 0.4 * np.random.default_rng(n).standard_normal(
        tp.envelope.coeff_shape)
    return jp, tp, coeff


@pytest.mark.parametrize("n,dense", [(10, False), (6, True)])
def test_energy_and_grad_strings_matches_jax(n, dense):
    jp, tp, coeff = _tfim_pair(n, dense)
    n_steps = 8
    jv, jg = jadj.energy_and_grad(jp.ham, jp.envelope, jp.measurement,
                                  jnp.asarray(coeff), jp.psi0, jp.T, n_steps)
    tv, tg = tadj.energy_and_grad(tp.ham, tp.envelope, tp.measurement,
                                  torch.tensor(coeff), tp.psi0, tp.T,
                                  n_steps)
    np.testing.assert_allclose(float(tv), float(jv), rtol=0, atol=1e-10)
    _rel_close(tg.numpy(), np.asarray(jg), 1e-9)


def test_mc_and_fd_with_strings_match_jax():
    """MC at injected split times (one sample and a batch of three) and
    FD, 8-qubit TFIM on the eager engines."""
    jp, tp, coeff = _tfim_pair(8)
    n_steps = 6
    jargs = (jp.ham, jp.envelope, jp.measurement, jnp.asarray(coeff),
             jp.psi0, jp.T)
    targs = (tp.ham, tp.envelope, tp.measurement, torch.tensor(coeff),
             tp.psi0, tp.T)
    key = jax.random.PRNGKey(0)
    for s in (0.3, 1.4):
        want = jmc.mc_energy_grad(*jargs, key, n_steps, s=s)
        got = tmc.mc_energy_grad(*targs, None, n_steps, s=s)
        _rel_close(got.numpy(), np.asarray(want), 1e-9)
    ss = np.array([0.2, 0.9, 1.7])
    want = np.mean([np.asarray(jmc.mc_energy_grad(*jargs, key, n_steps,
                                                  s=s)) for s in ss], axis=0)
    got = tmc.mc_energy_grad_batch(*targs, None, n_steps, 3,
                                   s=torch.tensor(ss))
    _rel_close(got.numpy(), want, 1e-9)
    want = jfd.fd_energy_grad(*jargs, key, n_steps)
    got = tfd.fd_energy_grad(*targs, None, n_steps)
    _rel_close(got.numpy(), np.asarray(want), 1e-9)


@pytest.mark.parametrize("grad_mode", ["adjoint", "mc"])
def test_train_energy_seeds_strings(grad_mode):
    """4 seeds of the 6-qubit Heisenberg chain from the JAX trainer's own
    initial coefficients: adjoint losses equal JAX's; MC losses finite,
    the first epoch's equal (it precedes any update)."""
    jp = jheis.build_heisenberg(6, n_basis=4, dense=False,
                                dtype=jnp.float64)
    tp = theis.build_heisenberg(6, n_basis=4, dense=False,
                                dtype=torch.float64, device="cpu")
    cfg = dict(n_basis=4, n_epoch=3, lr=5e-2, dtype="float64", seed=1,
               grad_mode=grad_mode, n_step=8)
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    init = np.asarray(jax.vmap(lambda k: jp.envelope.init_coeff(
        k, scale=0.3, dtype=jnp.float64))(keys))
    jr = j_seeds(jp.ham, jp.envelope, jp.measurement, jp.psi0, jp.T,
                 JConfig(**cfg), n_seeds=4, init_scale=0.3)
    tr = t_seeds(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T,
                 TConfig(**cfg), n_seeds=4, init_coeffs=torch.tensor(init))
    assert tr.losses.shape == (3, 4) and np.all(np.isfinite(tr.losses))
    rows = 3 if grad_mode == "adjoint" else 1
    np.testing.assert_allclose(tr.losses[:rows], np.asarray(jr.losses)[:rows],
                               rtol=1e-8)


def test_build_tfim_matches_jax():
    for n, dense in ((5, None), (10, None), (7, True)):
        jp = jtfim.build_tfim(n, J=0.8, h=1.3, dense=dense,
                              dtype=jnp.float64)
        tp = ttfim.build_tfim(n, J=0.8, h=1.3, dense=dense,
                              dtype=torch.float64, device="cpu")
        assert tp.envelope.omegas == jp.envelope.omegas
        assert tp.T == jp.T and tp.exact_ground == jp.exact_ground
        assert tp.ham.is_structured_only == jp.ham.is_structured_only
        assert [(s.kind, s.qubit) for s in tp.ham.structure] == \
            [(s.kind, s.qubit) for s in jp.ham.structure]
        np.testing.assert_array_equal(tp.psi0.re.numpy(),
                                      np.asarray(jp.psi0.re))
        js, ts = jp.measurement.strings, tp.measurement.strings
        assert (ts.flips, ts.yz_masks, ts.n_ys) == \
            (js.flips, js.yz_masks, js.n_ys)
        np.testing.assert_array_equal(ts.weights.numpy(),
                                      np.asarray(js.weights))
    # the free-fermion energy against dense diagonalisation at 6 qubits
    tp = ttfim.build_tfim(6, dense=True, dtype=torch.float64, device="cpu")
    eye = CP(torch.eye(64, dtype=torch.float64),
             torch.zeros((64, 64), dtype=torch.float64))
    mm = tp.measurement.strings.apply(eye)  # rows: M e_j = column j
    dense_m = (mm.re + 1j * mm.im).numpy().T
    assert abs(np.linalg.eigvalsh(dense_m)[0] - tp.exact_ground) < 1e-10


def test_build_heisenberg_matches_jax():
    for n, dense in ((4, None), (10, None)):
        jp = jheis.build_heisenberg(n, delta=0.6, dense=dense,
                                    dtype=jnp.float64)
        tp = theis.build_heisenberg(n, delta=0.6, dense=dense,
                                    dtype=torch.float64, device="cpu")
        assert tp.envelope.omegas == jp.envelope.omegas and tp.T == jp.T
        assert tp.ham.is_structured_only == jp.ham.is_structured_only
        np.testing.assert_array_equal(tp.psi0.re.numpy(),
                                      np.asarray(jp.psi0.re))
        js, ts = jp.measurement.strings, tp.measurement.strings
        assert (ts.flips, ts.yz_masks, ts.n_ys) == \
            (js.flips, js.yz_masks, js.n_ys)
    assert theis.cost_terms(5, 1.0, 0.3) == jheis.cost_terms(5, 1.0, 0.3)
    assert theis.exact_ground_energy(6, 1.0, 0.5) == \
        jheis.exact_ground_energy(6, 1.0, 0.5)


@pytest.mark.parametrize("model", ["tfim", "heisenberg"])
def test_short_training_matches_jax(model):
    """train_energy on the eager engine from the same initial
    coefficients: the losses of 6 Adam epochs, and the gap to the TFIM's
    free-fermion energy."""
    if model == "tfim":
        jp = jtfim.build_tfim(6, n_basis=4, dense=False, dtype=jnp.float64)
        tp = ttfim.build_tfim(6, n_basis=4, dense=False, dtype=torch.float64,
                              device="cpu")
        lam = jp.exact_ground
    else:
        jp = jheis.build_heisenberg(6, n_basis=4, dense=False,
                                    dtype=jnp.float64)
        tp = theis.build_heisenberg(6, n_basis=4, dense=False,
                                    dtype=torch.float64, device="cpu")
        lam = None
    coeff = 0.3 * np.random.default_rng(7).standard_normal(
        tp.envelope.coeff_shape)
    cfg = dict(n_basis=4, n_epoch=6, lr=5e-2, dtype="float64")
    jr = j_train(jp.ham, jp.envelope, jp.measurement, jp.psi0, jp.T,
                 JConfig(**cfg), init_coeff=jnp.asarray(coeff), lam_min=lam)
    tr = t_train(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T,
                 TConfig(**cfg), init_coeff=torch.tensor(coeff), lam_min=lam)
    np.testing.assert_allclose(tr.losses_raw, jr.losses_raw, rtol=1e-8)
    np.testing.assert_allclose(tr.losses_energy, jr.losses_energy,
                               rtol=1e-8, atol=1e-12)
    assert tr.losses_raw[-1] < tr.losses_raw[0]


# ---------------------------------------------------------------------------
# the sharded expectation on gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def strings_case():
    n = 9
    terms = _random_terms(n, 16, seed=21) + jheis.cost_terms(n, 1.0, 0.4)
    return n, terms, _state((3, 2**n), seed=22)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_strings_on_gloo_ranks(tmp_path, strings_case, world):
    """Each rank's value (one state and a batch of three) against the JAX
    package's expectation of the whole state, and each rank's gradient
    block (through the exchanges) against the unsharded gradient's
    block. (JAX's own sharded form, a shard_map of one ppermute per term,
    takes minutes to compile on the CPU; tests/test_sharded_hop_strings.py
    holds it to the unsharded value.)"""
    n, terms, psi = strings_case
    np.save(tmp_path / "psi.npy", psi)
    np.save(tmp_path / "terms.npy", np.array(terms, dtype=object),
            allow_pickle=True)
    mp.spawn(ranks.strings_rank, args=(world, str(tmp_path)), nprocs=world,
             join=True)
    got = [torch.load(tmp_path / f"strings{r}.pt", weights_only=False)
           for r in range(world)]
    js = jm.PauliStringSet.create(terms, dtype=jnp.float64)
    jp, tp = _pair(psi)
    want_b = np.asarray(js.expectation(jp))
    want_1 = want_b[0]
    ts = tm.PauliStringSet.create(terms, dtype=torch.float64, device="cpu")
    re = tp.re.clone().requires_grad_(True)
    im = tp.im.clone().requires_grad_(True)
    g_re, g_im = torch.autograd.grad(ts.expectation(CP(re, im)).sum(),
                                     (re, im))
    blk = 2**n // world
    for r, out in enumerate(got):
        np.testing.assert_allclose(out["one"], want_1, atol=1e-12)
        np.testing.assert_allclose(out["batch"], want_b, atol=1e-12)
        np.testing.assert_allclose(out["grad_re"],
                                   g_re[:, r * blk:(r + 1) * blk].numpy(),
                                   atol=1e-12)
        np.testing.assert_allclose(out["grad_im"],
                                   g_im[:, r * blk:(r + 1) * blk].numpy(),
                                   atol=1e-12)


def test_sharded_strings_world_of_one(strings_case):
    """At world size 1 the sharded expectation is the unsharded one."""
    import torch.distributed as dist
    from diffquantum_tpu_torch.parallel.mesh import make_mesh
    from diffquantum_tpu_torch.parallel.sharded_state import \
        sharded_strings_expectation
    n, terms, psi = strings_case
    ts = tm.PauliStringSet.create(terms, dtype=torch.float64, device="cpu")
    _, tp = _pair(psi)
    started = not dist.is_initialized()
    mesh = make_mesh({"state": 1}, device="cpu")
    try:
        np.testing.assert_allclose(
            sharded_strings_expectation(tp, ts, mesh).numpy(),
            ts.expectation(tp).numpy(), atol=1e-12)
    finally:
        if started:
            dist.destroy_process_group()
