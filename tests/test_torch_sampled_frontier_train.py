"""The 'mc' trainers on the 18-24 qubit route and FD's chunks, of the
PyTorch port on the CPU at 10 qubits (the MC samples are in
``test_torch_sampled_frontier.py``): train_energy and train_energy_seeds
with the router forced onto the packed engines (K3 'packed' and K5
'mega' plain paths) against the eager engine; FD's chunked evaluation
(chunks of 1, 7 and all members) against one batch, and its chunk size
from the card's free memory.

Tolerances: the trainers' losses 5e-5 and coefficients 1e-4 absolute
against the eager engine; FD chunks against one batch 1e-13 absolute in
float64 and 1e-6 in float32 (each member's arithmetic is its own; a
batched product may block differently)."""
import types

import numpy as np
import pytest
import torch

from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.gradients import fd as tfd
from diffquantum_tpu_torch.parallel import train_energy_seeds as t_seeds
from diffquantum_tpu_torch.train.config import TrainConfig as TConfig
from diffquantum_tpu_torch.train.energy import train_energy as t_train
from torch_estimators_common import N, _coeffs, _problem
from torch_estimators_common import forced  # noqa: F401 (fixture)


def test_trainers_on_the_forced_route(forced):
    """train_energy and train_energy_seeds in MC mode on the packed
    route against the same runs on the eager engine (same generator
    streams, so the same split times)."""
    tp = _problem(torch.float32)
    init = torch.tensor(_coeffs(tp.envelope.coeff_shape, 4, (2,)),
                        dtype=torch.float32)
    cfg = TConfig(n_basis=4, n_epoch=2, lr=5e-2, grad_mode="mc", n_step=6,
                  per_step=4, mc_samples=2, mc_strategy="stratified")
    runs = [t_seeds(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T,
                    cfg.replace(backend=b), n_seeds=2, init_coeffs=init)
            for b in ("product_fused", "product")]
    assert runs[0].losses.shape == (2, 2)
    np.testing.assert_allclose(runs[0].losses, runs[1].losses, rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(runs[0].coeffs.numpy(),
                               runs[1].coeffs.numpy(), rtol=0, atol=1e-4)
    one = [t_train(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T,
                   cfg.replace(backend=b, mc_samples=1), init_coeff=init[0])
           for b in ("product_fused", "product")]
    np.testing.assert_allclose(one[0].losses_raw, one[1].losses_raw, rtol=0,
                               atol=5e-5)


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-13),
                                        (torch.float32, 1e-6)])
def test_fd_chunks_equal_one_batch(dtype, atol, monkeypatch):
    """fd_energies in chunks of 1, 7 and all members, member for member,
    and fd_energy_grad's quotients from chunks of 7 against its own (one
    batch off the card); float32 on the forced K5 route."""
    if dtype == torch.float32:
        monkeypatch.setattr(tprod, "_PACKED_MIN_QUBITS", 0)
        monkeypatch.setattr(tprod, "_VMEM_PACKED_MAX", N - 1)
    tp = _problem(dtype)
    c = torch.tensor(_coeffs(tp.envelope.coeff_shape, 5), dtype=dtype)
    rng = np.random.default_rng(6)
    all_c = c[None] + torch.tensor(0.1 * rng.standard_normal(
        (11,) + tp.envelope.coeff_shape), dtype=dtype)
    backend = "product_fused" if dtype == torch.float32 else "product"
    args = (tp.ham, tp.envelope, tp.measurement, all_c, tp.psi0, tp.T,
            None, 5)
    whole = tfd.fd_energies(*args, 11, backend=backend)
    assert whole.shape == (11,)
    for chunk in (1, 7):
        np.testing.assert_allclose(
            tfd.fd_energies(*args, chunk, backend=backend).numpy(),
            whole.numpy(), rtol=0, atol=atol)
    gargs = (tp.ham, tp.envelope, tp.measurement, c, tp.psi0, tp.T, None, 5)
    one_batch = tfd.fd_energy_grad(*gargs, backend=backend)
    monkeypatch.setattr(tfd, "fd_chunk_size", lambda ham, m, dev: 7)
    np.testing.assert_allclose(
        tfd.fd_energy_grad(*gargs, backend=backend).numpy(),
        one_batch.numpy(), rtol=0, atol=atol / 1e-3)


def test_fd_chunk_size_from_free_memory(monkeypatch):
    """The chunk: every member below 18 qubits and off the card; from 18
    qubits up what half the card's free memory holds at six state pairs
    a member (the 24q ring's 576 members on 78 GB free: 48 a chunk, 12
    chunks; the 20q ring's 480 fit at once)."""
    free = 78 * 10**9
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 80 * 10**9))
    ham = lambda n: types.SimpleNamespace(n_qubits=n, dim=2**n)  # noqa
    assert tfd.fd_chunk_size(ham(24), 576, "cpu") == 576
    assert tfd.fd_chunk_size(ham(17), 576, "cuda") == 576
    chunk = tfd.fd_chunk_size(ham(24), 576, "cuda")
    assert chunk == int(0.5 * free) // (6 * 8 * 2**24) == 48
    assert -(-576 // chunk) == 12
    assert tfd.fd_chunk_size(ham(20), 480, "cuda") == 480
