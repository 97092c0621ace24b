"""The port's reference-API facades (``diffquantum_tpu_torch.compat``:
``diffqc`` and ``SimulatorPlain``) against the JAX package's
(``diffquantum_tpu.compat``) on the same inputs, on the CPU.

Tolerances: ``diffqc`` 1e-9 absolute (both float64, the JAX facade on its
native engine); the facade's ``trotter`` 1e-10; the MC gradient at the
same seed 1e-9 of its max-norm (the draws are the same numpy stream);
FD 1e-8 of its max-norm; the FD trainer's first loss 1e-5 relative and
its gaps over 5 epochs to 3e-3 of the first gap. Both trainers run in float32:
at the demo's 72 steps each package's loss at the init is ~9e-6
(relative) from the float64 loss, and they part by 1.25e-6, since the
JAX package's complex products take three real products and the port's
four, which round differently; the FD gradient divides that rounding by
2 delta = 2e-3, so the updates part by ~1e-3 relative and the 5-epoch
gaps by up to 3.0e-3 (of a first gap of 2.0).

The host algorithms of the JAX facade evaluate their closures one
``jnp`` call at a time (~1.5 ms each), so the MC and FD parity cases run
on small systems; the trainers run on ``tests/test_compat.py``'s 4-qubit
demo."""
import numpy as np
import pytest
import torch

import diffquantum_tpu.compat.sim_plain as jsp
from diffquantum_tpu.compat import diffqc as jdq
from diffquantum_tpu.ops import linalg
from diffquantum_tpu.pulses.envelope import SimpleEnvelope as JEnvelope
from diffquantum_tpu_torch.compat import diffqc as tdq
from diffquantum_tpu_torch.compat import sim_plain as tsp
from diffquantum_tpu_torch.dynamics.hamiltonian import ControlledHamiltonian
from diffquantum_tpu_torch.measure import Measurement
from diffquantum_tpu_torch.ops import cpx
from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope
from diffquantum_tpu_torch.train import (TrainConfig, train_energy,
                                         train_fidelity)
from test_compat import make_demo_sim


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _grad(g):
    return g.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# diffqc
# ---------------------------------------------------------------------------

def test_diffqc_module_surface(capsys):
    assert tdq.__version__ == jdq.__version__ == "dev"
    tdq.print_test()
    assert capsys.readouterr().out.strip() == "hello"
    psi = [1 + 2j, 3j]
    assert tdq.complex_test(psi) == jdq.complex_test(psi)
    assert tdq.test_eigen([[1, 2], [3, 4]]) == jdq.test_eigen([[1, 2],
                                                               [3, 4]])


def _three_channel_system():
    """tests/test_native.py's system in the reference's nested table."""
    rng = np.random.default_rng(0)
    H0 = 0.2 * linalg.pauli_string("ZI")
    Hs = [linalg.pauli_string("XI"), linalg.pauli_string("IX")]
    channels = [[[0.0, np.pi, 5.0, 0], [0.0, 0.5 * np.pi, 9.0, 1]],
                [[0.0, np.pi, 4.0, 2]]]
    return (H0.tolist(), [h.tolist() for h in Hs], channels, 2.0,
            rng.standard_normal((2, 3, 5)) * 0.7,
            linalg.uniform_superposition(2))


def _random_system(n=5, seed=3):
    """A random 5-qubit system: a random Hermitian drift, a control on
    every qubit (X) with one or two carrier channels, vv with a spare
    row."""
    rng = np.random.default_rng(seed)
    d = 2**n
    a = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    H0 = 0.05 * (a + a.conj().T)
    Hs = [linalg.op_on_qubits(linalg.X, [q], n) for q in range(n)]
    channels, idx = [], 0
    for q in range(n):
        rows = [[0.0, 1.0 + 0.2 * q, 1.5 * q, idx]]
        idx += 1
        if q % 2:
            rows.append([0.0, 0.5, 3.0, idx])
            idx += 1
        channels.append(rows)
    vv = rng.standard_normal((2, idx + 1, 4)) * 0.6
    psi = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    return H0, Hs, channels, 1.5, vv, psi / np.linalg.norm(psi)


@pytest.mark.parametrize("case", ["2q_ft0", "2q_ft1", "5q_ft0", "5q_ft1"])
def test_diffqc_trotter_matches_jax(case):
    system, func_type = case.split("_ft")
    H0, Hs, channels, duration, vv, psi0 = (
        _three_channel_system() if system == "2q" else _random_system())
    jdq.set_H(H0, Hs, channels, duration, int(func_type))
    tdq.set_H(H0, Hs, channels, duration, int(func_type), device="cpu")
    for T0, T in ((0.0, duration), (0.4, duration + 1.3)):
        want = jdq.trotter(psi0, T0, T, 10, vv)
        got = tdq.trotter(psi0, T0, T, 10, vv)
        assert isinstance(got, list) and all(isinstance(z, complex)
                                             for z in got)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_diffqc_trotter_needs_set_h(monkeypatch):
    monkeypatch.setitem(tdq._state, "sys", None)
    with pytest.raises(RuntimeError, match="set_H"):
        tdq.trotter([1, 0], 0.0, 1.0, 5, np.zeros((2, 1, 3)))


# ---------------------------------------------------------------------------
# SimulatorPlain: host algorithms
# ---------------------------------------------------------------------------

def _pair(tmp_path, cls_kw, problem):
    """(JAX facade, port facade) with the same attributes."""
    sims = (jsp.SimulatorPlain(log_dir=str(tmp_path), **cls_kw),
            tsp.SimulatorPlain(log_dir=str(tmp_path), device="cpu",
                               **cls_kw))
    for s in sims:
        s.T, s.omegas, s.Pauli_M = problem["T"], problem["omegas"], \
            problem["Pauli_M"]
    return sims


def _small_problem(n_ctrl=3):
    """Two qubits, up to three controls (XI, IX, ZZ), M = ZI + 0.5 XX,
    T = 1 (20 steps)."""
    ops = [linalg.pauli_string(p) for p in ("XI", "IX", "ZZ")][:n_ctrl]
    zi, xx = linalg.pauli_string("ZI"), linalg.pauli_string("XX")
    return dict(T=1.0, omegas=[np.pi, 2.0, 1.5][:n_ctrl],
                Pauli_M=[[zi, 1.0], [xx, 0.5]], M=zi + 0.5 * xx,
                H0=0.3 * linalg.pauli_string("ZI"), Hs=ops,
                psi0=linalg.basis_state(0, 4))


def _drives(n):
    """Numpy envelope closures (fast in both facades)."""
    return [lambda t, args, k=k: np.pi * np.sin(1.3 * t + k) * (0.6 + 0.1 * k)
            for k in range(n)]


def test_trotter_with_closures(tmp_path):
    prob = _small_problem()
    js, ts = _pair(tmp_path, dict(n_basis=4), prob)
    H = [prob["H0"]] + [[h, u] for h, u in zip(prob["Hs"],
                                                _drives(len(prob["Hs"])))]
    for T0, T in ((0.0, 1.0), (0.35, 2.2)):
        want = js.trotter(H, prob["psi0"], T0, T)
        got = ts.trotter(H, prob["psi0"], T0, T)
        assert isinstance(got, np.ndarray) and got.dtype == np.complex128
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert ts.my_solver == ts.trotter


@pytest.mark.parametrize("basis", ["bspline", "legendre", "poly", "fourier"])
def test_generate_u_values(tmp_path, basis):
    prob = _small_problem()
    js, ts = _pair(tmp_path, dict(n_basis=4, basis=basis), prob)
    c = np.random.default_rng(2).standard_normal((3, 4))
    for i in range(3):
        uj, ut = js.generate_u(i, c), ts.generate_u(i, torch.tensor(c))
        for t in (0.0, 0.13, 0.5, 0.97):
            assert abs(uj(t, None) - ut(t, None)) < 1e-12


@pytest.mark.parametrize("basis", ["bspline", "legendre", "poly"])
@pytest.mark.parametrize("noisy", [False, True], ids=["exact", "noisy"])
def test_mc_grad_same_seed(tmp_path, basis, noisy):
    """compute_energy_grad_MC draw for draw: s, then each branch's noise
    (p before m, i ascending); poly keeps the raw-basis rows."""
    prob = _small_problem()
    js, ts = _pair(tmp_path, dict(n_basis=4, basis=basis, seed=11,
                                  is_noisy=noisy), prob)
    c = np.random.default_rng(4).standard_normal((3, 4)) * 0.5
    js.spectral_coeff, ts.spectral_coeff = c, torch.tensor(c)
    H = [prob["H0"]] + [[h, u] for h, u in zip(prob["Hs"], _drives(3))]
    for _ in range(2):  # the generators advance alike
        gj = _grad(js.compute_energy_grad_MC(prob["M"], H, prob["psi0"]))
        gt = ts.compute_energy_grad_MC(prob["M"], H, prob["psi0"])
        assert gt.requires_grad and gt.shape == (3, 4)
        assert _rel(_grad(gt), gj) < 1e-9
    if basis == "poly":  # every row is a multiple of phi(s)
        g = _grad(gt)
        cos = abs(g[0] @ g[1]) / (np.linalg.norm(g[0]) * np.linalg.norm(g[1]))
        assert cos > 1 - 1e-10


def test_fd_grad(tmp_path):
    prob = _small_problem()
    js, ts = _pair(tmp_path, dict(n_basis=4, seed=5), prob)
    c = np.random.default_rng(6).standard_normal((3, 4)) * 0.5
    js.spectral_coeff, ts.spectral_coeff = c, torch.tensor(c)
    H = [prob["H0"]] + [[h, js.generate_u(i, c)]
                        for i, h in enumerate(prob["Hs"])]
    gj = _grad(js.compute_energy_grad_FD(prob["M"], H, prob["psi0"]))
    gt = ts.compute_energy_grad_FD(prob["M"], H, prob["psi0"])
    assert _rel(_grad(gt), gj) < 1e-8


def _eigen_pauli_m(pauli_m):
    out = []
    for m, w in pauli_m:
        evals, vecs = np.linalg.eigh(m)
        out.append([m, w, (evals, list(vecs.T))])
    return out


def test_stochastic_measure_draw_for_draw(tmp_path):
    """With the eigensystem in Pauli_M[i][2], the same seed gives the
    same shots; the training-free MC gradient with sampled measurement
    too."""
    prob = _small_problem()
    prob["Pauli_M"] = _eigen_pauli_m(prob["Pauli_M"])
    js, ts = _pair(tmp_path, dict(n_basis=4, seed=8,
                                  sampling_measure=True), prob)
    psi = np.random.default_rng(1).standard_normal(4) + 0.3j
    psi /= np.linalg.norm(psi)
    for per in (100, 1000):
        assert abs(js.stochastic_measure(psi, per) -
                   ts.stochastic_measure(psi, per)) < 1e-12
    c = np.random.default_rng(4).standard_normal((3, 4)) * 0.5
    js.spectral_coeff, ts.spectral_coeff = c, torch.tensor(c)
    H = [prob["H0"]] + [[h, u] for h, u in zip(prob["Hs"], _drives(3))]
    gj = _grad(js.compute_energy_grad_MC(prob["M"], H, prob["psi0"]))
    gt = _grad(ts.compute_energy_grad_MC(prob["M"], H, prob["psi0"]))
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-12)


def test_stochastic_measure_statistics(tmp_path):
    """Without the eigensystem (taken by torch on the device, with other
    eigenvectors in the degenerate spaces): the mean of the shots is the
    expectation within 5 standard errors, on the demo's degenerate ZZ
    terms."""
    sim, M, _, _, psi0 = make_demo_sim(tmp_path, n_epoch=1)
    ts = tsp.SimulatorPlain(log_dir=str(tmp_path), seed=2, device="cpu")
    ts.Pauli_M = sim.Pauli_M
    psi = np.random.default_rng(3).standard_normal(16) + 0.5j * psi0
    psi /= np.linalg.norm(psi)
    per = 20000
    var = 0.0
    for m, w in ts.Pauli_M:
        p = np.abs(psi) ** 2          # the terms are diagonal
        ev = np.real(np.diag(m))
        var += w**2 * (p @ ev**2 - (p @ ev) ** 2) / per
    want = float(np.real(np.vdot(psi, M @ psi)))
    got = ts.stochastic_measure(psi, per_Pauli=per)
    assert abs(got - want) < 5 * np.sqrt(var)


# ---------------------------------------------------------------------------
# SimulatorPlain: the trainers on the port's engine
# ---------------------------------------------------------------------------

def _demo_pair(tmp_path, n_epoch, **kw):
    js, M, H0, Hs, psi0 = make_demo_sim(tmp_path, n_epoch=n_epoch)
    ts = tsp.SimulatorPlain(lr=5e-2, n_basis=6, n_epoch=n_epoch,
                            log_dir=str(tmp_path), device="cpu", **kw)
    ts.Pauli_M, ts.omegas, ts.T = js.Pauli_M, js.omegas, js.T
    return js, ts, M, H0, Hs, psi0


def test_train_energy_fd_matches_jax(tmp_path, monkeypatch):
    """The FD trainer from JAX's own init draw (PRNGKey(0) split), given
    to the port's trainer: the first epoch's loss to 1e-5 relative, the
    gaps over 5 epochs to 3e-3 of the first (float32, module docstring)."""
    import jax
    js, ts, M, H0, Hs, psi0 = _demo_pair(tmp_path, n_epoch=5)
    _, k_init = jax.random.split(jax.random.PRNGKey(0))
    init = np.asarray(JEnvelope(basis=js.basis, n_basis=6,
                                omegas=tuple(js.omegas)).init_coeff(k_init))
    real = tsp._train_energy
    monkeypatch.setattr(tsp, "_train_energy", lambda *a, **k: real(
        *a, init_coeff=torch.tensor(init), **k))
    cj = js.train_energy_FD(M, H0, Hs, psi0)
    ct = ts.train_energy_FD(M, H0, Hs, psi0)
    lj, lt = np.asarray(js.losses_energy), np.asarray(ts.losses_energy)
    assert abs(lt[0] - lj[0]) <= 1e-5 * abs(lj[0])
    np.testing.assert_allclose(lt, lj, rtol=0, atol=3e-3 * abs(lj[0]))
    assert lt[-1] < lt[0]
    assert ct.requires_grad and ct.shape == tuple(np.shape(cj))
    assert ts.final_state.shape == (16,)


def _built(ts, M, H0, Hs):
    ham = ControlledHamiltonian.create(H0, Hs, dtype=torch.float32,
                                       device="cpu")
    env = SimpleEnvelope(basis=ts.basis, n_basis=ts.n_basis,
                         omegas=tuple(ts.omegas))
    meas = Measurement.create(M, terms=[(np.asarray(m), float(w))
                                        for m, w in ts.Pauli_M],
                              device="cpu")
    cfg = TrainConfig(n_basis=ts.n_basis, basis=ts.basis,
                      n_epoch=ts.n_epoch, lr=ts.lr, per_step=ts.per_step,
                      n_step=ts.n_step, grad_mode="mc")
    return ham, env, meas, cfg


def test_train_energy_mc_descends_and_equals_engine(tmp_path):
    _, ts, M, H0, Hs, psi0 = _demo_pair(tmp_path, n_epoch=8, n_step=30)
    coeff = ts.train_energy(M, H0, Hs, psi0)
    assert ts.losses_energy[-1] < ts.losses_energy[0]
    ham, env, meas, cfg = _built(ts, M, H0, Hs)
    res = train_energy(ham, env, meas, cpx.from_complex(
        psi0, device="cpu"), ts.T, cfg)
    np.testing.assert_array_equal(ts.losses_energy, res.losses_energy)
    assert torch.equal(coeff.detach(), res.coeff)
    assert coeff.requires_grad and coeff.device.type == "cpu"
    state, prob = ts.find_state(ts.final_state)
    assert prob.shape == (16,) and 0 <= state < 16


def test_train_fidelity_descends_and_equals_engine(tmp_path):
    ts = tsp.SimulatorPlain(lr=1e-1, n_basis=6, n_epoch=6,
                            log_dir=str(tmp_path), device="cpu")
    ts.omegas, ts.T = [np.pi, np.pi], 2.0
    H0 = 0.5 * linalg.Z
    Hs = [linalg.X, linalg.Y]
    ini, tgt = [linalg.basis_state(0, 2)], [linalg.basis_state(1, 2)]
    coeff = ts.train_fidelity(H0, Hs, ini, tgt)
    ham = ControlledHamiltonian.create(H0, Hs, dtype=torch.float32,
                                       device="cpu")
    env = SimpleEnvelope(basis=ts.basis, n_basis=6, omegas=tuple(ts.omegas))
    cfg = TrainConfig(n_basis=6, basis=ts.basis, n_epoch=6, lr=1e-1,
                      grad_mode="mc")
    res = train_fidelity(ham, env, cpx.from_complex(np.stack(ini),
                                                    device="cpu"),
                         cpx.from_complex(np.stack(tgt), device="cpu"),
                         ts.T, cfg, per_pair=True)
    np.testing.assert_array_equal(ts.losses_energy, res.losses_energy)
    assert torch.equal(coeff.detach(), res.coeff)
    assert ts.losses_energy[-1] < ts.losses_energy[0]
    assert ts.final_state.shape == (1, 2)


def test_save_plot_writes_png(tmp_path, monkeypatch):
    _, ts, *_ = _demo_pair(tmp_path, n_epoch=1)
    ts.spectral_coeff = torch.tensor(
        np.random.default_rng(1).standard_normal((8, 6)), requires_grad=True)
    monkeypatch.chdir(tmp_path)
    ts.save_plot("test")
    assert (tmp_path / "BSpline_test.png").stat().st_size > 0
