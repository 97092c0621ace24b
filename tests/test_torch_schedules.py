"""LR schedules and checkpoint/resume of the PyTorch port against the JAX
package on the CPU: the learning rate of each update against optax's
schedules, the trainers under the schedules against JAX's (``train_energy``
on the 6-qubit ring, the dense seed population, ``train_fidelity`` and
``train_gate``), and runs resumed from a checkpoint against straight runs.

Tolerances: the learning rate 1e-7 relative to optax's (the same
formulas in float64); the trainers in float64 from the same initial
coefficients, 1e-8 relative on the losses and 1e-6 on the final
coefficients; a resumed run
equals the straight one bit for bit (``torch.equal``), the MC estimator's
draws included, since the generator's state is restored."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffquantum_tpu.models import control as jcontrol
from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu.parallel.mesh import train_energy_seeds as j_seeds
from diffquantum_tpu.train import gate as jgate
from diffquantum_tpu.train.config import TrainConfig as JConfig
from diffquantum_tpu.train.energy import train_energy as j_train
from diffquantum_tpu.train.fidelity import train_fidelity as j_fid
from diffquantum_tpu_torch.models import control as tcontrol
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.parallel import train_energy_seeds as t_seeds
from diffquantum_tpu_torch.train import energy as tenergy
from diffquantum_tpu_torch.train import gate as tgate
from diffquantum_tpu_torch.train.config import TrainConfig as TConfig
from diffquantum_tpu_torch.train.energy import (lr_schedule, make_optimizer,
                                                train_energy)
from diffquantum_tpu_torch.train.fidelity import train_fidelity as t_fid
from diffquantum_tpu_torch.utils import load_checkpoint, save_checkpoint

CNOT = np.eye(4, dtype=np.complex128)[[0, 1, 3, 2]]
F64 = dict(dtype=torch.float64, device="cpu")


def _optax_schedule(kind, lr, n):
    if kind == "cosine":
        return optax.cosine_decay_schedule(lr, n, alpha=0.05)
    return optax.warmup_cosine_decay_schedule(
        0.0, lr, max(1, n // 20), n, end_value=0.05 * lr)


@pytest.mark.parametrize("kind", ["cosine", "warmup_cosine"])
@pytest.mark.parametrize("n_epoch", [2, 7, 20, 45])
def test_lr_matches_optax(kind, n_epoch):
    """The learning rate at updates 0..n_epoch+2 (optax's count), from the
    schedule and as the optimizer applies it: n SGD updates of a unit
    gradient move the parameter by the schedule's values."""
    lr = 5e-2
    cfg = TConfig(lr=lr, n_epoch=n_epoch, lr_schedule=kind)
    want = _optax_schedule(kind, lr, n_epoch)
    sched = lr_schedule(cfg)
    for k in range(n_epoch + 3):
        np.testing.assert_allclose(sched(k), float(want(k)), rtol=1e-7,
                                   atol=1e-7 * lr)
    if kind == "warmup_cosine":
        assert sched(0) == 0.0  # the warmup's first update does nothing
    p = torch.zeros((), dtype=torch.float64, requires_grad=True)
    opt = make_optimizer(cfg.replace(optimizer="sgd"), [p])
    tx = optax.sgd(want)
    c, state = jnp.zeros(()), None
    state = tx.init(c)
    for k in range(n_epoch + 3):
        p.grad = torch.ones((), dtype=torch.float64)
        opt.step()
        upd, state = tx.update(jnp.ones(()), state, c)
        c = optax.apply_updates(c, upd)
        np.testing.assert_allclose(float(p.detach()), float(c), rtol=1e-7,
                                   atol=1e-9)
    assert opt.param_groups[0]["update_count"] == n_epoch + 3


def test_unknown_schedule_and_empty_decay_raise():
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        lr_schedule(TConfig(lr_schedule="linear"))
    with pytest.raises(ValueError, match="positive decay_steps"):
        lr_schedule(TConfig(lr_schedule="warmup_cosine", n_epoch=1))


def _ring6():
    jp = jmaxcut.build_maxcut(6, jmaxcut.ring_graph(6), n_basis=4,
                              dtype=jnp.float64)
    tp = tmaxcut.build_maxcut(6, tmaxcut.ring_graph(6), n_basis=4, **F64)
    return jp, tp


def test_train_energy_cosine_matches_jax():
    """20 Adam epochs under the cosine schedule on the 6-qubit ring
    (dense, 'expm'), the same start."""
    jp, tp = _ring6()
    c = 0.3 * np.random.default_rng(6).standard_normal(
        tp.envelope.coeff_shape)
    cfg = dict(n_basis=4, n_epoch=20, lr=5e-2, dtype="float64",
               lr_schedule="cosine")
    jr = j_train(jp.ham, jp.envelope, jp.measurement, jp.psi0, jp.T,
                 JConfig(**cfg), init_coeff=jnp.asarray(c))
    tr = train_energy(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T,
                      TConfig(**cfg), init_coeff=torch.tensor(c))
    np.testing.assert_allclose(tr.losses_raw, jr.losses_raw, rtol=1e-8)
    np.testing.assert_allclose(tr.coeff.numpy(), np.asarray(jr.coeff),
                               rtol=1e-6, atol=1e-10)
    assert tr.losses_raw[-1] < tr.losses_raw[0]


def test_dense_seeds_cosine_match_jax():
    """The dense 4-qubit demo's seed population (each seed its own dense
    chain) under the cosine schedule, from JAX's own initial draw."""
    jp = jmaxcut.demo_problem(dtype=jnp.float64)
    tp = tmaxcut.demo_problem(**F64)
    cfg = dict(n_basis=6, n_epoch=6, lr=5e-2, dtype="float64", seed=3,
               lr_schedule="cosine")
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    init = np.asarray(jax.vmap(lambda k: jp.envelope.init_coeff(
        k, scale=1e-3, dtype=jnp.float64))(keys))
    jr = j_seeds(jp.ham, jp.envelope, jp.measurement, jp.psi0, jp.T,
                 JConfig(**cfg), n_seeds=3)
    tr = t_seeds(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T,
                 TConfig(**cfg), n_seeds=3, init_coeffs=torch.tensor(init))
    np.testing.assert_allclose(tr.losses, np.asarray(jr.losses), rtol=1e-8)
    np.testing.assert_allclose(tr.coeffs.numpy(), np.asarray(jr.coeffs),
                               rtol=1e-6, atol=1e-10)
    assert tr.best_seed == int(jr.best_seed)


def test_train_fidelity_warmup_cosine_matches_jax():
    jp = jcontrol.state_transfer(2, dtype=jnp.float64)
    tp = tcontrol.state_transfer(2, **F64)
    c = np.random.default_rng(4).standard_normal(tp.envelope.coeff_shape)
    cfg = dict(n_basis=6, n_epoch=8, lr=0.05, dtype="float64",
               lr_schedule="warmup_cosine")
    jr = j_fid(jp.ham, jp.envelope, jp.initial_states, jp.target_states,
               jp.T, JConfig(**cfg), init_coeff=jnp.asarray(c))
    tr = t_fid(tp.ham, tp.envelope, tp.initial_states, tp.target_states,
               tp.T, TConfig(**cfg), init_coeff=torch.tensor(c))
    np.testing.assert_allclose(tr.losses_raw, jr.losses_raw, rtol=1e-8)
    np.testing.assert_allclose(tr.coeff.numpy(), np.asarray(jr.coeff),
                               rtol=1e-6, atol=1e-10)


def test_train_gate_warmup_cosine_matches_jax():
    jham, omegas = jcontrol.two_qubit_controls(dtype=jnp.float64)
    tham, _ = tcontrol.two_qubit_controls(**F64)
    jenv = jcontrol.SimpleEnvelope(basis="bspline", n_basis=6, omegas=omegas)
    tenv = tcontrol.SimpleEnvelope(basis="bspline", n_basis=6, omegas=omegas)
    c = np.random.default_rng(3).standard_normal(tenv.coeff_shape)
    cfg = dict(n_basis=6, n_epoch=8, lr=0.1, dtype="float64",
               lr_schedule="warmup_cosine")
    jr = jgate.train_gate(jham, jenv, CNOT, 4.0, JConfig(**cfg),
                          init_coeff=jnp.asarray(c))
    tr = tgate.train_gate(tham, tenv, CNOT, 4.0, TConfig(**cfg),
                          init_coeff=torch.tensor(c))
    np.testing.assert_allclose(tr.losses_raw, jr.losses_raw, rtol=1e-8)
    np.testing.assert_allclose(tr.coeff.numpy(), np.asarray(jr.coeff),
                               rtol=1e-6, atol=1e-10)


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def _resume_problem():
    return tmaxcut.build_maxcut(6, tmaxcut.ring_graph(6), n_basis=4,
                                dense=False, device="cpu")


@pytest.mark.parametrize("grad_mode", ["adjoint", "mc"])
def test_resumed_run_equals_straight_run(tmp_path, grad_mode):
    """6 epochs straight against a run of the same config stopped after
    epoch 3's checkpoint and resumed in a fresh call to epoch 6: the same
    losses and coefficients bit for bit (the cosine schedule continues
    from the optimizer's count; MC draws continue from the restored
    generator)."""
    p = _resume_problem()
    args = (p.ham, p.envelope, p.measurement, p.psi0, p.T)
    cfg = TConfig(n_basis=4, n_epoch=6, lr=5e-2, grad_mode=grad_mode,
                  n_step=6, per_step=4, lr_schedule="cosine")
    straight = train_energy(*args, cfg)
    ckpt = str(tmp_path / "ckpt")

    class Interrupt(Exception):
        pass

    def stop_after_3(epoch, **_):
        if epoch == 4:  # epoch 3's checkpoint is on disk
            raise Interrupt
    with pytest.raises(Interrupt):
        train_energy(*args, cfg.replace(checkpoint_dir=ckpt,
                                        checkpoint_every=3),
                     callback=stop_after_3)
    assert load_checkpoint(ckpt)["epoch"] == 3
    resumed = train_energy(*args, cfg.replace(checkpoint_dir=ckpt,
                                              checkpoint_every=3))
    assert len(resumed.losses_raw) == 3
    assert torch.equal(torch.tensor(resumed.losses_raw),
                       torch.tensor(straight.losses_raw[3:]))
    assert torch.equal(resumed.coeff, straight.coeff)
    assert torch.equal(resumed.final_state.re, straight.final_state.re)
    assert load_checkpoint(ckpt)["epoch"] == 6


def test_checkpoints_at_multiples_and_nothing_left_over(tmp_path,
                                                        monkeypatch):
    """Saves at epochs 2 and 4 of 5 with checkpoint_every=2, one file
    ``ckpt.pt`` and no ``.tmp`` beside it, loadable with
    ``weights_only=True``; a run whose epochs are all done returns no
    losses and no final state, as the JAX trainer does."""
    p = _resume_problem()
    args = (p.ham, p.envelope, p.measurement, p.psi0, p.T)
    ckpt = str(tmp_path / "run")
    saved = []

    def spy(directory, state, name="ckpt"):
        saved.append(int(state["epoch"]))
        return save_checkpoint(directory, state, name)
    monkeypatch.setattr(tenergy, "save_checkpoint", spy)
    cfg = TConfig(n_basis=4, n_epoch=5, lr=5e-2, per_step=4,
                  checkpoint_dir=ckpt, checkpoint_every=2)
    res = train_energy(*args, cfg)
    assert saved == [2, 4]
    assert os.listdir(ckpt) == ["ckpt.pt"]
    state = torch.load(os.path.join(ckpt, "ckpt.pt"), weights_only=True)
    assert set(state) == {"coeff", "opt_state", "rng", "epoch"}
    assert state["epoch"] == 4
    assert state["opt_state"]["param_groups"][0]["update_count"] == 4
    again = train_energy(*args, cfg.replace(n_epoch=4))
    assert again.losses_raw == [] and again.final_state is None
    assert len(res.losses_raw) == 5
