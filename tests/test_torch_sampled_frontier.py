"""The MC and FD estimators' 18-24 qubit paths of the PyTorch port, on
the CPU at 10 qubits: the MC samples one after another ('map') against
all samples on the batch axis ('vmap') and against the JAX package's
single samples; the router forced onto the packed engines (K3 'packed'
and K5 'mega' plain paths), as tests/test_torch_frontier.py forces it,
where 'auto' runs the samples one after another and the per-member
time-grid refusal still stands; FD's chunked evaluation (chunks of 1, 7
and all members) against one batch, and its chunk size from the card's
free memory.

Tolerances: float64 eager 'map' against 'vmap' 1e-12 of the max-norm
(the same arithmetic, one sample at a time); float32 packed routes
against the float64 eager engine or JAX's float32 eager engine 1e-4 of
the max-norm, as tests/test_torch_frontier.py; FD chunks against one
batch 1e-13 absolute in float64 and 1e-6 in float32 (each member's
arithmetic is its own; a batched product may block differently)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.gradients import mc as jmc
from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.gradients import fd as tfd
from diffquantum_tpu_torch.gradients import mc as tmc
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.parallel import train_energy_seeds as t_seeds
from diffquantum_tpu_torch.train.config import TrainConfig as TConfig
from diffquantum_tpu_torch.train.energy import train_energy as t_train

N = 10
KW = dict(n_basis=4, omega0=2 * np.pi, omega1=2 * np.pi)  # T = 1


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _problem(dtype=torch.float64):
    return tmaxcut.build_maxcut(N, tmaxcut.ring_graph(N), dense=False,
                                dtype=dtype, device="cpu", **KW)


def _coeffs(shape, seed, lead=()):
    return 0.5 * np.random.default_rng(seed).standard_normal(
        tuple(lead) + tuple(shape))


@pytest.mark.parametrize("layout", ["shared", "per_sample"])
def test_map_equals_vmap_on_the_eager_engine(layout):
    """Samples one after another equal the batched samples: shared
    coefficients and state, or a coefficient set and a state each."""
    tp = _problem()
    ss = torch.tensor([0.15, 0.5, 0.85], dtype=torch.float64)
    if layout == "shared":
        c, psi0 = torch.tensor(_coeffs(tp.envelope.coeff_shape, 1)), tp.psi0
    else:
        c = torch.tensor(_coeffs(tp.envelope.coeff_shape, 2, (3,)))
        psi0 = CP(tp.psi0.re.expand(3, -1).clone(),
                  tp.psi0.im.expand(3, -1).clone())
        psi0.re[1] = torch.roll(psi0.re[1], 3)
    args = (tp.ham, tp.envelope, tp.measurement, c, psi0, tp.T, ss, 6)
    g_map = tmc.mc_grads_per_sample(*args, sample_mode="map")
    g_vmap = tmc.mc_grads_per_sample(*args, sample_mode="vmap")
    assert g_map.shape == (3,) + tp.envelope.coeff_shape
    _rel_close(g_map.numpy(), g_vmap.numpy(), 1e-12)
    assert tmc._mc_sample_mode(tp.ham, "auto") == "vmap"
    with pytest.raises(ValueError, match="sample_mode"):
        tmc.mc_grads_per_sample(*args, sample_mode="scan")


@pytest.fixture(params=["packed", "mega"])
def forced(request, monkeypatch):
    """The port's router sent to K3 ('packed') or K5 ('mega') at 10
    qubits (their plain paths on the CPU)."""
    monkeypatch.setattr(tprod, "_PACKED_MIN_QUBITS", 0)
    if request.param == "mega":
        monkeypatch.setattr(tprod, "_VMEM_PACKED_MAX", N - 1)
    return request.param


def test_mc_on_the_forced_route(forced):
    """'auto' runs the samples one after another there: each sample's
    leg 1 one packed chain, its branches one batched packed evolution
    sharing its split time. Against the float64 eager engine's batched
    samples and JAX's float32 eager single samples; 'vmap' on the packed
    engine still meets the per-member time-grid refusal."""
    tp = _problem(torch.float32)
    assert tprod.select_engine(tp.ham) == forced
    assert tmc._mc_sample_mode(tp.ham, "auto") == "map"
    cs = _coeffs(tp.envelope.coeff_shape, 3, (3,))
    ss = np.array([0.2, 0.55, 0.9])
    args = (tp.ham, tp.envelope, tp.measurement,
            torch.tensor(cs, dtype=torch.float32), tp.psi0, tp.T,
            torch.tensor(ss), 6)
    got = tmc.mc_grads_per_sample(*args, backend="product_fused")
    t64 = _problem(torch.float64)
    want = tmc.mc_grads_per_sample(t64.ham, t64.envelope, t64.measurement,
                                   torch.tensor(cs), t64.psi0, t64.T,
                                   torch.tensor(ss), 6, backend="product",
                                   sample_mode="vmap")
    _rel_close(got.numpy(), want.numpy(), 1e-4)
    jp = jmaxcut.build_maxcut(N, jmaxcut.ring_graph(N), dense=False,
                              dtype=jnp.float32, **KW)
    for i in range(3):
        j = jmc.mc_energy_grad(jp.ham, jp.envelope, jp.measurement,
                               jnp.asarray(cs[i], jnp.float32), jp.psi0,
                               jp.T, jax.random.PRNGKey(0), 6, s=ss[i],
                               backend="product")
        _rel_close(got[i].numpy(), np.asarray(j), 1e-4)
    with pytest.raises(NotImplementedError, match="per-member time grids"):
        tmc.mc_grads_per_sample(*args, backend="product_fused",
                                sample_mode="vmap")


def test_per_member_grid_refusal_kept(forced):
    """The packed engines refuse per-member time grids at the source: the
    drift's half-step phase is one plane per launch."""
    tp = _problem(torch.float32)
    c = torch.zeros(tp.envelope.coeff_shape)
    with pytest.raises(NotImplementedError, match="sample_mode='map'"):
        tprod.packed_chain_inputs(tp.ham, tp.envelope, c,
                                  torch.tensor([0.0, 0.1]), tp.T, tp.T, 4)


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
