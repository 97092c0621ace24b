"""Four faults of the PyTorch port against the JAX package, each held on
the CPU: seed populations on a dense Hamiltonian (the default MaxCut at
8 qubits or fewer) in adjoint and MC mode; the eager Strang engine's
autograd memory, one state per step as the JAX package's checkpointed
scan keeps; and the dense 'apply' backend's route past K7's contract
(float64, d > 1024), the truncated-Taylor recurrence that the JAX
package's 'apply' runs at every size and dtype. (The fourth, the public
names, is tests/test_torch_api.py.)

Tolerances: f64 seed losses atol 1e-6 (readings ~4e-15); the 11-qubit
f64 'apply' step atol 1e-10 on the state and 1e-10 of the gradient's
max-norm (readings ~1e-15)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.dynamics.hamiltonian import \
    ControlledHamiltonian as JHam
from diffquantum_tpu.gradients.adjoint import energy_and_grad as j_eag
from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu.ops import cpx as jcpx
from diffquantum_tpu.parallel.mesh import train_energy_seeds as j_seeds
from diffquantum_tpu.pulses.envelope import SimpleEnvelope as JEnv
from diffquantum_tpu.train.config import TrainConfig as JConfig
from diffquantum_tpu_torch.dynamics import hamiltonian as tham
from diffquantum_tpu_torch.dynamics import propagator as tprop
from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad as t_eag
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.ops import cpx as tcpx
from diffquantum_tpu_torch.ops import linalg
from diffquantum_tpu_torch.ops import taylor_apply as tta
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.parallel import train_energy_seeds as t_seeds
from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope
from diffquantum_tpu_torch.train.config import TrainConfig as TConfig
from diffquantum_tpu_torch.utils import profiling


# ---------------------------------------------------------------------------
# dense seed populations
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ring6():
    """The 6-qubit ring MaxCut, dense by default in both packages, with
    JAX's seed init for 2 seeds and JAX's 2-epoch losses (f64)."""
    jp = jmaxcut.build_maxcut(6, jmaxcut.ring_graph(6), dtype=jnp.float64)
    tp = tmaxcut.build_maxcut(6, tmaxcut.ring_graph(6), dtype=torch.float64,
                              device="cpu")
    cfg = dict(n_epoch=2, seed=0, dtype="float64")
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    init = np.asarray(jax.vmap(lambda k: jp.envelope.init_coeff(
        k, scale=1e-3, dtype=jnp.float64))(keys))
    jr = j_seeds(jp.ham, jp.envelope, jp.measurement, jp.psi0, jp.T,
                 JConfig(**cfg), n_seeds=2)
    return tp, cfg, init, jr


def test_dense_seed_population_matches_jax(ring6):
    tp, cfg, init, jr = ring6
    assert not tp.ham.is_structured_only
    tr = t_seeds(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T,
                 TConfig(**cfg), n_seeds=2, init_coeffs=torch.tensor(init))
    assert tr.losses.shape == (2, 2)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.losses[0], [-3.0, -3.0], atol=1e-3)
    np.testing.assert_allclose(tr.losses[1], [-2.96, -2.966], atol=1e-3)
    assert tr.best_seed == jr.best_seed


def test_dense_seed_population_mc_mode(ring6):
    """MC mode on the dense path: the first epoch's exact energies are
    JAX's (same init); the estimator's draws differ, so the second
    epoch's are only finite and near the start."""
    tp, cfg, init, jr = ring6
    tr = t_seeds(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T,
                 TConfig(grad_mode="mc", **cfg), n_seeds=2,
                 init_coeffs=torch.tensor(init))
    np.testing.assert_allclose(tr.losses[0], jr.losses[0], rtol=0,
                               atol=1e-6)
    assert np.all(np.isfinite(tr.losses))
    assert np.all(np.abs(tr.losses[1] - tr.losses[0]) < 0.2)


# ---------------------------------------------------------------------------
# the eager engine keeps one state per step for autograd
# ---------------------------------------------------------------------------

def _saved_bytes(ham, env, w, c, psi0, n_steps):
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        t_eag(ham, env, w, c, psi0, 1.0, n_steps, backend="product")
    return total[0]


def test_eager_engine_saves_one_state_per_step():
    """8 qubits with X, Y and hop drives (a palindromic plan of 22
    rotations per step): the bytes autograd saves grow by at most ~one
    state (its two planes) per added step, where keeping every sub-step
    grew them by a state per rotation. Fixed tables, saved once, cancel
    in the difference."""
    n = 8
    d = 2**n
    terms = [tham.TermStructure(kind="diag",
                                diag=linalg.zz_diagonal(n, i, (i + 1) % n))
             for i in range(n)]
    terms += [tham.TermStructure(kind="1q", qubit=q, local=linalg.X)
              for q in range(n)]
    terms += [tham.TermStructure(kind="1q", qubit=q, local=linalg.Y)
              for q in (1, 4)]
    terms += [tham.TermStructure(kind="hop", qubit=2, qubit2=5)]
    ham = tham.ControlledHamiltonian.create_structured(
        d, tuple(terms), dtype=torch.float64)
    env = SimpleEnvelope(basis="bspline", n_basis=4,
                         omegas=(1.0,) * len(terms))
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.standard_normal(d))
    c = torch.tensor(0.3 * rng.standard_normal(env.coeff_shape))
    psi0 = CP(torch.full((d,), d ** -0.5, dtype=torch.float64),
              torch.zeros(d, dtype=torch.float64))
    per_step = (_saved_bytes(ham, env, w, c, psi0, 40)
                - _saved_bytes(ham, env, w, c, psi0, 20)) / 20
    state = 2 * d * 8
    assert per_step <= 1.25 * state, per_step / state


# ---------------------------------------------------------------------------
# dense 'apply' past K7's contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,dtype,d,want", [
    ("cuda", torch.float32, 1024, "k7"),
    ("cuda", torch.float32, 16, "k7"),
    ("cuda", torch.float32, 2048, "recurrence"),
    ("cuda", torch.float64, 1024, "recurrence"),
    ("cuda:1", torch.float32, 512, "k7"),
    ("cpu", torch.float32, 1024, "recurrence"),
    ("cpu", torch.float64, 64, "recurrence")])
def test_apply_route(device, dtype, d, want):
    assert tta.apply_route(device, dtype, d) == want


def _dense_11q(pkg):
    """An 11-qubit dense problem (d = 2048) with three controls: ZZ(0, 1),
    X on qubit 0 and Y on qubit 10, and a diagonal drift 0.3 Z_5. Built
    from the constructors with the operators' norms known exactly (1 and
    0.3), where ``create`` would run an eigendecomposition of each
    2048 x 2048 operator."""
    n = 11
    hs = np.stack([np.diag(linalg.zz_diagonal(n, 0, 1)),
                   linalg.op_on_qubits(linalg.X, [0], n),
                   linalg.op_on_qubits(linalg.Y, [10], n)])
    h0 = np.diag(0.3 * linalg.z_diagonal(n, 5)).astype(np.complex128)
    norms = dict(h0_norm=0.3, hs_norms=(1.0, 1.0, 1.0), n_qubits=n)
    omegas = (1.0, 0.8, 0.6)
    if pkg == "jax":
        return (JHam(H0=jcpx.from_complex(h0, dtype=jnp.float64),
                     Hs=jcpx.from_complex(hs, dtype=jnp.float64), **norms),
                JEnv(basis="bspline", n_basis=4, omegas=omegas))
    return (tham.ControlledHamiltonian(
                structure=None, h0_structure=None, dtype=torch.float64,
                H0=tcpx.from_complex(h0, dtype=torch.float64, device="cpu"),
                Hs=tcpx.from_complex(hs, dtype=torch.float64, device="cpu"),
                **norms),
            SimpleEnvelope(basis="bspline", n_basis=4, omegas=omegas))


def test_apply_recurrence_11q_f64_matches_jax():
    """One dense 'apply' grad step at d = 2048 in float64, past K7's
    d <= 1024: state and coefficient gradient against JAX 'apply'; the
    route's counter counts one call per step."""
    d = 2**11
    rng = np.random.default_rng(11)
    psi = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    psi /= np.linalg.norm(psi)
    w = rng.standard_normal(d)
    c = 0.4 * rng.standard_normal((3, 4))
    n_steps, T = 3, 0.6
    jh, je = _dense_11q("jax")
    jpsi = jcpx.from_complex(psi, dtype=jnp.float64)
    j_val, j_grad = j_eag(jh, je, jnp.asarray(w), jnp.asarray(c), jpsi, T,
                          n_steps, backend="apply")
    from diffquantum_tpu.dynamics.propagator import evolve as j_evolve
    j_out = j_evolve(jh, je, jnp.asarray(c), jpsi, 0.0, T, horizon=T,
                     n_steps=n_steps, backend="apply")

    th, te = _dense_11q("torch")
    tpsi = tcpx.from_complex(psi, dtype=torch.float64, device="cpu")
    before = profiling.counters()["apply_recurrence"]
    t_out = tprop.evolve(th, te, torch.tensor(c), tpsi, 0.0, T, horizon=T,
                         n_steps=n_steps, backend="apply")
    assert profiling.counters()["apply_recurrence"] - before == n_steps
    t_val, t_grad = t_eag(th, te, torch.tensor(w), torch.tensor(c), tpsi,
                          T, n_steps, backend="apply")
    np.testing.assert_allclose(tcpx.to_complex(t_out),
                               jcpx.to_complex(j_out), rtol=0, atol=1e-10)
    assert abs(float(t_val) - float(j_val)) < 1e-10
    scale = float(np.max(np.abs(np.asarray(j_grad))))
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=0,
                               atol=1e-10 * scale)
    launched = profiling.counters()
    assert launched["k7_forward"] == 0 and launched["k7_backward"] == 0
