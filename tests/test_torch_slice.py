"""The port's main path, end to end on the CPU, against the JAX package:
the 10-qubit ring MaxCut adjoint gradient (f64 through the eager Strang
engine; f32 through the fused engine's wrapper, whose CPU path is K1's
plain forward and adjoint) and five epochs of Adam training. Parameters
go to both packages from one seeded numpy draw (``params_from_numpy``)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffquantum_tpu.gradients.adjoint import energy_and_grad as j_eag
from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu.train.config import TrainConfig as JConfig
from diffquantum_tpu.train.energy import train_energy as j_train
from diffquantum_tpu_torch.convert import params_from_numpy
from diffquantum_tpu_torch.dynamics.propagator import reference_n_steps
from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad as t_eag
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.train.config import TrainConfig as TConfig
from diffquantum_tpu_torch.train.energy import make_optimizer
from diffquantum_tpu_torch.train.energy import train_energy as t_train
from diffquantum_tpu_torch.utils import profiling

N = 10


def _problems(dtype_np):
    jp = jmaxcut.build_maxcut(N, jmaxcut.ring_graph(N), n_basis=6,
                              dense=False, dtype=jnp.dtype(dtype_np))
    tp = tmaxcut.build_maxcut(N, tmaxcut.ring_graph(N), n_basis=6,
                              dtype=torch.float64 if dtype_np == np.float64
                              else torch.float32, device="cpu")
    coeff = (0.4 * np.random.default_rng(11).standard_normal(
        tp.envelope.coeff_shape)).astype(dtype_np)
    return jp, tp, coeff


def test_energy_and_grad_f64_eager_engine():
    jp, tp, coeff = _problems(np.float64)
    n_steps = reference_n_steps(10, 0.0, tp.T)
    assert n_steps == 30
    jv, jg = j_eag(jp.ham, jp.envelope, jp.measurement, jnp.asarray(coeff),
                   jp.psi0, jp.T, n_steps, backend="product")
    c, _ = params_from_numpy(coeff, device="cpu")
    tv, tg = t_eag(tp.ham, tp.envelope, tp.measurement, c, tp.psi0, tp.T,
                   n_steps)  # 'auto' on a CPU state: the eager engine
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-9)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-9,
                               atol=1e-12)


def test_energy_and_grad_f32_fused_wrapper():
    jp, tp, coeff = _problems(np.float32)
    n_steps = reference_n_steps(10, 0.0, tp.T)
    jv, jg = j_eag(jp.ham, jp.envelope, jp.measurement, jnp.asarray(coeff),
                   jp.psi0, jp.T, n_steps, backend="product")
    c, _ = params_from_numpy(coeff, device="cpu")
    tv, tg = t_eag(tp.ham, tp.envelope, tp.measurement, c, tp.psi0, tp.T,
                   n_steps, backend="product_fused")
    launched = profiling.counters()   # the plain path: no launch
    assert launched["k1_forward"] == 0 and launched["k1_backward"] == 0
    np.testing.assert_allclose(float(tv), float(jv), rtol=0, atol=5e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=1e-4 * np.abs(jg).max())


def test_train_energy_five_epochs_f64():
    jp, tp, coeff = _problems(np.float64)
    coeff = 1e-3 * coeff / 0.4   # the trainer's own init scale
    cfg = dict(n_epoch=5, dtype="float64", lr=2e-2)
    jr = j_train(jp.ham, jp.envelope, jp.measurement, jp.psi0, jp.T,
                 JConfig(**cfg), init_coeff=jnp.asarray(coeff))
    c, _ = params_from_numpy(coeff, device="cpu")
    tr = t_train(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T,
                 TConfig(**cfg), init_coeff=c)
    np.testing.assert_allclose(tr.losses_raw, jr.losses_raw, rtol=1e-7)
    np.testing.assert_allclose(tr.losses_energy, jr.losses_energy,
                               rtol=1e-7)
    np.testing.assert_allclose(tr.coeff.numpy(), np.asarray(jr.coeff),
                               rtol=1e-6, atol=1e-12)
    assert tr.losses_raw[-1] < tr.losses_raw[0]
    assert tr.final_state.re.shape == (2**N,)
    assert tr.grad_mode == "adjoint"


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
def test_optimizer_step_matches_optax(opt_name):
    """One step from converted state (Adam moments included) equals
    optax's next step."""
    rng = np.random.default_rng(4)
    c0 = rng.standard_normal((3, 4))
    grads = [rng.standard_normal((3, 4)) for _ in range(3)]
    tx = optax.adam(2e-2) if opt_name == "adam" else optax.sgd(2e-2)
    c, state = jnp.asarray(c0), None
    state = tx.init(c)
    for g in grads[:2]:
        upd, state = tx.update(jnp.asarray(g), state, c)
        c = optax.apply_updates(c, upd)
    if opt_name == "adam":
        adam = state[0]
        tc, tstate = params_from_numpy(np.asarray(c), np.asarray(adam.mu),
                                       np.asarray(adam.nu), int(adam.count),
                                       device="cpu")
    else:
        tc, tstate = params_from_numpy(np.asarray(c), device="cpu")
        assert tstate is None
    opt = make_optimizer(TConfig(optimizer=opt_name), [tc])
    if tstate is not None:
        opt.state[tc] = tstate
    tc.grad = torch.tensor(grads[2])
    opt.step()
    upd, _ = tx.update(jnp.asarray(grads[2]), state, c)
    want = np.asarray(optax.apply_updates(c, upd))
    np.testing.assert_allclose(tc.detach().numpy(), want, rtol=1e-12,
                               atol=1e-15)
