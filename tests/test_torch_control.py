"""The dense trainers and models of the PyTorch port against the JAX
package on the CPU: the dense MaxCut default (the parity repair of the
reference demo), fidelity and gate objectives with their gradients, the
gate, fidelity and energy trainers, the control and H2 models, the MC
estimator on dense Hamiltonians, and sampled measurement.

Tolerances: float64 throughout, the same arithmetic in another order:
1e-12 on values, 1e-9 relative to the max-norm on gradients, 1e-8
relative on training losses over 5 epochs. Where the two packages route
a batch differently (the port evolves a batch of pairs on 'apply', the
JAX package vmaps single pairs onto 'expm'), the two agree to the Taylor
truncation, and the limit is 1e-6. Random streams differ
(``torch.Generator`` against ``jax.random``): MC gradients are compared
at injected split times, sampled measurement by its statistics (5
standard errors)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.dynamics import propagator as jprop
from diffquantum_tpu.gradients import adjoint as jadj
from diffquantum_tpu.gradients import fd as jfd
from diffquantum_tpu.gradients import mc as jmc
from diffquantum_tpu.measure import Measurement as JMeasurement
from diffquantum_tpu.models import control as jcontrol
from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu.models import vqe_h2 as jh2
from diffquantum_tpu.ops import cpx as jcpx
from diffquantum_tpu.train import gate as jgate
from diffquantum_tpu.train.config import TrainConfig as JConfig
from diffquantum_tpu.train.energy import train_energy as j_train
from diffquantum_tpu.train.fidelity import train_fidelity as j_fid
from diffquantum_tpu_torch import measure as tmeasure
from diffquantum_tpu_torch.dynamics import propagator as tprop
from diffquantum_tpu_torch.gradients import adjoint as tadj
from diffquantum_tpu_torch.gradients import fd as tfd
from diffquantum_tpu_torch.gradients import mc as tmc
from diffquantum_tpu_torch.models import control as tcontrol
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.models import vqe_h2 as th2
from diffquantum_tpu_torch.ops import cpx as tcpx
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.train import gate as tgate
from diffquantum_tpu_torch.train.config import TrainConfig as TConfig
from diffquantum_tpu_torch.train.energy import train_energy as t_train
from diffquantum_tpu_torch.train.fidelity import train_fidelity as t_fid

F64 = dict(dtype=torch.float64, device="cpu")
CNOT = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
                dtype=np.complex128)


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _coeff(shape, seed, scale=0.7):
    return scale * np.random.default_rng(seed).standard_normal(shape)


# ---------------------------------------------------------------------------
# the dense MaxCut default (parity repair) and the models
# ---------------------------------------------------------------------------

def test_build_maxcut_default_is_dense_like_jax():
    """With no ``dense`` argument the demo ring is dense in both packages
    (structure tags kept, a dense cost operator), 'auto' takes 'expm' for
    its one state, and energy_and_grad agrees; at 9 qubits both are
    structured."""
    jp = jmaxcut.demo_problem(dtype=jnp.float64)
    tp = tmaxcut.demo_problem(**F64)
    assert not jp.ham.is_structured_only and not tp.ham.is_structured_only
    assert tp.ham.structure is not None and tp.measurement.matrix is not None
    assert tp.measurement.diag is None and jp.measurement.diag is None
    np.testing.assert_array_equal(tcpx.to_complex(tp.measurement.matrix),
                                  jcpx.to_complex(jp.measurement.matrix))
    np.testing.assert_allclose(tcpx.to_complex(tp.ham.Hs),
                               jcpx.to_complex(jp.ham.Hs), rtol=0, atol=0)
    assert tprop.dense_backend(tp.ham, batched=False) == "expm"
    c = _coeff(tp.envelope.coeff_shape, 0)
    kw = dict(horizon=tp.T, n_steps=30)
    j_auto = jprop.evolve(jp.ham, jp.envelope, jnp.asarray(c), jp.psi0, 0.0,
                          jp.T, **kw)
    j_expm = jprop.evolve(jp.ham, jp.envelope, jnp.asarray(c), jp.psi0, 0.0,
                          jp.T, backend="expm", **kw)
    np.testing.assert_array_equal(jcpx.to_complex(j_auto),
                                  jcpx.to_complex(j_expm))
    jv, jg = jadj.energy_and_grad(jp.ham, jp.envelope, jp.measurement,
                                  jnp.asarray(c), jp.psi0, jp.T, 30)
    tv, tg = tadj.energy_and_grad(tp.ham, tp.envelope, tp.measurement,
                                  torch.tensor(c), tp.psi0, tp.T, 30)
    assert abs(float(tv) - float(jv)) < 1e-12
    _rel_close(tg.numpy(), np.asarray(jg), 1e-9)
    assert tmaxcut.build_maxcut(9, tmaxcut.ring_graph(9), n_basis=2,
                                device="cpu").ham.is_structured_only
    assert jmaxcut.build_maxcut(9, jmaxcut.ring_graph(9),
                                n_basis=2).ham.is_structured_only


@pytest.mark.parametrize("model", ["transfer1", "transfer2", "bell",
                                   "hadamard", "h2"])
def test_models_match_jax(model):
    j, t = {
        "transfer1": (lambda: jcontrol.state_transfer(1, dtype=jnp.float64),
                      lambda: tcontrol.state_transfer(1, **F64)),
        "transfer2": (lambda: jcontrol.state_transfer(2, dtype=jnp.float64),
                      lambda: tcontrol.state_transfer(2, **F64)),
        "bell": (lambda: jcontrol.bell_state_preparation(dtype=jnp.float64),
                 lambda: tcontrol.bell_state_preparation(**F64)),
        "hadamard": (lambda: jcontrol.hadamard_synthesis(dtype=jnp.float64),
                     lambda: tcontrol.hadamard_synthesis(**F64)),
        "h2": (lambda: jh2.build_h2(dtype=jnp.float64),
               lambda: th2.build_h2(**F64)),
    }[model]
    jp, tp = j(), t()
    for a, b in ((tp.ham.H0, jp.ham.H0), (tp.ham.Hs, jp.ham.Hs)):
        np.testing.assert_array_equal(tcpx.to_complex(a),
                                      jcpx.to_complex(b))
    assert tp.ham.hs_norms == jp.ham.hs_norms
    assert tp.envelope.omegas == jp.envelope.omegas and tp.T == jp.T
    if model == "h2":
        assert tp.exact_ground_energy == jp.exact_ground_energy
        pairs = ((tp.psi0, jp.psi0), (tp.measurement.matrix,
                                      jp.measurement.matrix))
    else:
        pairs = ((tp.initial_states, jp.initial_states),
                 (tp.target_states, jp.target_states))
    for a, b in pairs:
        np.testing.assert_array_equal(tcpx.to_complex(a),
                                      jcpx.to_complex(b))


# ---------------------------------------------------------------------------
# objectives and their gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["auto", "apply"])
def test_fidelity_and_grad_matches_jax(backend):
    jp = jcontrol.bell_state_preparation(dtype=jnp.float64)
    tp = tcontrol.bell_state_preparation(**F64)
    c = _coeff(tp.envelope.coeff_shape, 1)
    jt = jcpx.CP(jp.target_states.re[0], jp.target_states.im[0])
    tt = CP(tp.target_states.re[0], tp.target_states.im[0])
    jv, jg = jadj.fidelity_and_grad(
        jp.ham, jp.envelope, jt, jnp.asarray(c),
        jcpx.CP(jp.initial_states.re[0], jp.initial_states.im[0]), jp.T, 30,
        backend=backend)
    tv, tg = tadj.fidelity_and_grad(
        tp.ham, tp.envelope, tt, torch.tensor(c),
        CP(tp.initial_states.re[0], tp.initial_states.im[0]), tp.T, 30,
        backend=backend)
    assert abs(float(tv) - float(jv)) < 1e-12
    _rel_close(tg.numpy(), np.asarray(jg), 1e-9)


def test_gate_infidelity_value_and_gradient_match_jax():
    jham, omegas = jcontrol.two_qubit_controls(dtype=jnp.float64)
    tham, _ = tcontrol.two_qubit_controls(**F64)
    jenv = jcontrol.SimpleEnvelope(basis="bspline", n_basis=4, omegas=omegas)
    tenv = tcontrol.SimpleEnvelope(basis="bspline", n_basis=4, omegas=omegas)
    c = _coeff(tenv.coeff_shape, 2)
    g_dag = CNOT.conj().T
    jv, jg = jax.value_and_grad(lambda x: jgate.gate_infidelity(
        jham, jenv, x, jcpx.from_complex(g_dag, jnp.float64),
        jcpx.eye(4, jnp.float64), 4.0, 50))(jnp.asarray(c))
    cg = torch.tensor(c, requires_grad=True)
    tv = tgate.gate_infidelity(tham, tenv, cg, tcpx.from_complex(g_dag, **F64),
                               tcpx.eye(4, **F64), 4.0, 50)
    (tg,) = torch.autograd.grad(tv, cg)
    assert abs(float(tv.detach()) - float(jv)) < 1e-12
    _rel_close(tg.numpy(), np.asarray(jg), 1e-9)


# ---------------------------------------------------------------------------
# trainers, 5 epochs from the same start
# ---------------------------------------------------------------------------

def test_train_gate_cnot_matches_jax():
    jham, omegas = jcontrol.two_qubit_controls(dtype=jnp.float64)
    tham, _ = tcontrol.two_qubit_controls(**F64)
    jenv = jcontrol.SimpleEnvelope(basis="bspline", n_basis=6, omegas=omegas)
    tenv = tcontrol.SimpleEnvelope(basis="bspline", n_basis=6, omegas=omegas)
    c = _coeff(tenv.coeff_shape, 3, 1.0)
    cfg = dict(n_basis=6, n_epoch=5, lr=0.1, dtype="float64")
    jr = jgate.train_gate(jham, jenv, CNOT, 4.0, JConfig(**cfg),
                          init_coeff=jnp.asarray(c))
    tr = tgate.train_gate(tham, tenv, CNOT, 4.0, TConfig(**cfg),
                          init_coeff=torch.tensor(c))
    np.testing.assert_allclose(tr.losses_raw, jr.losses_raw, rtol=1e-8)
    np.testing.assert_allclose(tr.coeff.numpy(), np.asarray(jr.coeff),
                               rtol=1e-7, atol=1e-10)
    assert tr.losses_raw[-1] < tr.losses_raw[0]
    np.testing.assert_allclose(tcpx.to_complex(tr.final_state),
                               jcpx.to_complex(jr.final_state), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("task,per_pair", [("transfer", True),
                                           ("transfer", False),
                                           ("bell", True)])
def test_train_fidelity_matches_jax(task, per_pair):
    make = {"transfer": (jcontrol.state_transfer, tcontrol.state_transfer),
            "bell": (jcontrol.bell_state_preparation,
                     tcontrol.bell_state_preparation)}[task]
    args = (2,) if task == "transfer" else ()
    jp, tp = make[0](*args, dtype=jnp.float64), make[1](*args, **F64)
    if not per_pair:  # the four basis states through CNOT as one batch
        jp = jcontrol.gate_synthesis_pairs(CNOT, jp.ham, jp.envelope, jp.T,
                                           dtype=jnp.float64)
        tp = tcontrol.gate_synthesis_pairs(CNOT, tp.ham, tp.envelope, tp.T,
                                           **F64)
    c = _coeff(tp.envelope.coeff_shape, 4, 1.0)
    cfg = dict(n_basis=6, n_epoch=5, lr=0.05, dtype="float64")
    jr = j_fid(jp.ham, jp.envelope, jp.initial_states, jp.target_states,
               jp.T, JConfig(**cfg), per_pair=per_pair,
               init_coeff=jnp.asarray(c))
    tr = t_fid(tp.ham, tp.envelope, tp.initial_states, tp.target_states,
               tp.T, TConfig(**cfg), per_pair=per_pair,
               init_coeff=torch.tensor(c))
    rel = 1e-8 if per_pair else 1e-6
    np.testing.assert_allclose(tr.losses_raw, jr.losses_raw, rtol=rel)
    np.testing.assert_allclose(tcpx.to_complex(tr.final_state),
                               jcpx.to_complex(jr.final_state), rtol=0,
                               atol=1e-6)
    assert tr.losses_raw[-1] < tr.losses_raw[0]


def test_train_energy_h2_matches_jax():
    jp, tp = jh2.build_h2(dtype=jnp.float64), th2.build_h2(**F64)
    c = _coeff(tp.envelope.coeff_shape, 5, 0.5)
    cfg = dict(n_basis=6, n_epoch=5, lr=0.05, dtype="float64")
    jr = j_train(jp.ham, jp.envelope, jp.measurement, jp.psi0, jp.T,
                 JConfig(**cfg), init_coeff=jnp.asarray(c))
    tr = t_train(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T,
                 TConfig(**cfg), init_coeff=torch.tensor(c))
    np.testing.assert_allclose(tr.losses_raw, jr.losses_raw, rtol=1e-8)
    np.testing.assert_allclose(tr.losses_energy, jr.losses_energy,
                               rtol=1e-8, atol=1e-12)
    assert tr.losses_raw[-1] < tr.losses_raw[0]


def test_train_fidelity_mc_sampled_noisy_runs():
    """Hadamard synthesis with MC gradients over both pairs, one step per
    epoch, with sampled and noisy measurement: finite losses drawn anew
    each epoch."""
    tp = tcontrol.hadamard_synthesis(**F64)
    cfg = TConfig(n_basis=6, n_epoch=4, lr=0.05, dtype="float64",
                  grad_mode="mc", n_step=20, sampling_measure=True,
                  is_noisy=True, per_pauli=50)
    r = t_fid(tp.ham, tp.envelope, tp.initial_states, tp.target_states,
              tp.T, cfg, per_pair=False)
    assert np.all(np.isfinite(r.losses_raw)) and len(set(r.losses_raw)) == 4
    assert r.final_state.re.shape == (2, 2)


# ---------------------------------------------------------------------------
# the MC estimator on dense Hamiltonians
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["energy", "fidelity"])
def test_dense_mc_matches_jax_at_injected_s(objective):
    """One MC sample at a fixed split time: leg 1 on 'expm', the 2 n_Hs
    branches on 'apply' (K7's plain version here) after the dense H_k phi
    gates; energy on the dense demo ring, fidelity (coeff_sign = -1)
    against the Bell target."""
    if objective == "energy":
        jp, tp = jmaxcut.demo_problem(dtype=jnp.float64), \
            tmaxcut.demo_problem(**F64)
        jm, tm, jpsi, tpsi = jp.measurement, tp.measurement, jp.psi0, tp.psi0
        sign = 1.0
    else:
        jp = jcontrol.bell_state_preparation(dtype=jnp.float64)
        tp = tcontrol.bell_state_preparation(**F64)
        jm = JMeasurement(matrix=None, target=jcpx.CP(
            jp.target_states.re[0], jp.target_states.im[0]))
        tm = tmeasure.Measurement(target=CP(tp.target_states.re[0],
                                            tp.target_states.im[0]))
        jpsi = jcpx.CP(jp.initial_states.re[0], jp.initial_states.im[0])
        tpsi = CP(tp.initial_states.re[0], tp.initial_states.im[0])
        sign = -1.0
    c = _coeff(tp.envelope.coeff_shape, 6)
    for s in (0.37, 1.41):
        want = jmc.mc_energy_grad(jp.ham, jp.envelope, jm, jnp.asarray(c),
                                  jpsi, jp.T, jax.random.PRNGKey(0), 20,
                                  s=jnp.asarray(s), coeff_sign=sign)
        got = tmc.mc_energy_grad(tp.ham, tp.envelope, tm, torch.tensor(c),
                                 tpsi, tp.T, None, 20, s=s, coeff_sign=sign)
        _rel_close(got.numpy(), np.asarray(want), 1e-9)


def test_dense_fd_matches_jax():
    """FD on the dense demo ring: the perturbed coefficient sets evolve as
    groups of one member ('expm', as JAX's vmapped members) with the
    dense cost operator."""
    jp = jmaxcut.demo_problem(dtype=jnp.float64, n_basis=3)
    tp = tmaxcut.demo_problem(n_basis=3, **F64)
    c = _coeff(tp.envelope.coeff_shape, 8)
    want = jfd.fd_energy_grad(jp.ham, jp.envelope, jp.measurement,
                              jnp.asarray(c), jp.psi0, jp.T,
                              jax.random.PRNGKey(0), 15)
    got = tfd.fd_energy_grad(tp.ham, tp.envelope, tp.measurement,
                             torch.tensor(c), tp.psi0, tp.T, None, 15)
    _rel_close(got.numpy(), np.asarray(want), 1e-9)


def test_dense_mc_batch_groups_match_single_samples():
    """Several samples as one batch (per-sample grids as groups of
    members) equal the single samples averaged."""
    tp = tmaxcut.demo_problem(**F64)
    c = torch.tensor(_coeff(tp.envelope.coeff_shape, 7))
    ss = torch.tensor([0.2, 0.9, 1.6], dtype=torch.float64)
    got = tmc.mc_energy_grad_batch(tp.ham, tp.envelope, tp.measurement, c,
                                   tp.psi0, tp.T, None, 20, 3, s=ss)
    want = torch.stack([tmc.mc_energy_grad(
        tp.ham, tp.envelope, tp.measurement, c, tp.psi0, tp.T, None, 20,
        s=float(s)) for s in ss]).mean(dim=0)
    _rel_close(got.numpy(), want.numpy(), 1e-12)


# ---------------------------------------------------------------------------
# sampled measurement
# ---------------------------------------------------------------------------

def test_stochastic_measure_statistics():
    """Shot-sampled dense measurement (the demo's Pauli term table):
    300 estimates of 40 shots per term scatter around the exact energy,
    as the JAX package's do."""
    tp = tmaxcut.demo_problem(sampling=True, **F64)
    rng = np.random.default_rng(8)
    v = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    psi = tcpx.from_complex(v / np.linalg.norm(v), **F64)
    exact = float(tmeasure.exact_expectation(tp.measurement.matrix, psi))
    batch = CP(psi.re.expand(300, -1), psi.im.expand(300, -1))
    est = tmeasure.stochastic_measure(tp.measurement.terms, batch,
                                      torch.Generator().manual_seed(0),
                                      per_pauli=40).numpy()
    assert est.shape == (300,)
    assert abs(est.mean() - exact) < 5 * est.std() / np.sqrt(300)
    one = tp.measurement.expectation(psi, torch.Generator().manual_seed(1))
    assert one.shape == () and np.isfinite(float(one))
    j = jmaxcut.demo_problem(dtype=jnp.float64).measurement
    np.testing.assert_allclose(tp.measurement.terms.evals.numpy(),
                               np.asarray(j.terms.evals), rtol=0, atol=1e-14)


def test_sampled_target_statistics():
    rng = np.random.default_rng(9)
    t = rng.standard_normal(4) + 1j * rng.standard_normal(4)
    v = rng.standard_normal(4) + 1j * rng.standard_normal(4)
    target = tcpx.from_complex(t / np.linalg.norm(t), **F64)
    psi = tcpx.from_complex(v / np.linalg.norm(v), **F64)
    p = float(tmeasure.target_overlap_prob(target, psi))
    assert abs(p - abs(np.vdot(t, v)) ** 2 / np.linalg.norm(t) ** 2
               / np.linalg.norm(v) ** 2) < 1e-12
    batch = CP(psi.re.expand(400, -1), psi.im.expand(400, -1))
    est = tmeasure.sampled_target_prob(target, batch,
                                       torch.Generator().manual_seed(0),
                                       shots=50).numpy()
    assert est.shape == (400,)
    assert abs(est.mean() - p) < 5 * np.sqrt(p * (1 - p) / (50 * 400))
    m = tmeasure.Measurement.create_target(t / np.linalg.norm(t),
                                           sampling=True, **F64)
    one = m.expectation(psi, torch.Generator().manual_seed(2))
    assert 0.0 <= float(one) <= 1.0
