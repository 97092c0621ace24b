"""The channel (carrier / two-quadrature) pulse model of the PyTorch port
against the JAX package on the CPU: ``ChannelEnvelope`` (its table, its
amplitudes for one coefficient set and for per-member coefficients and
grids, the N < 1e-6 mask), the dense backends' amplitude bound,
``envelope_jacobian`` against ``jax.jacrev``, and the model through the
structured engines (eager and the fused wrapper's plain path), the dense
4-qubit backends, the MC estimator at fixed split times and FD.

Tolerances: float64 on both sides, the same arithmetic in another order:
amplitudes and Jacobians 1e-12 absolute, evolved values 1e-10 and
gradients 1e-9 of their max-norm; float32 through the fused wrapper
against JAX's float32 eager engine: value 5e-5, gradient 1e-4 of its
max-norm, as tests/test_torch_slice.py holds the streamed slice."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.dynamics import propagator as jprop
from diffquantum_tpu.gradients import adjoint as jadj
from diffquantum_tpu.gradients import fd as jfd
from diffquantum_tpu.gradients import mc as jmc
from diffquantum_tpu.pulses import envelope as jenv
from diffquantum_tpu_torch.dynamics import propagator as tprop
from diffquantum_tpu_torch.gradients import adjoint as tadj
from diffquantum_tpu_torch.gradients import fd as tfd
from diffquantum_tpu_torch.gradients import mc as tmc
from diffquantum_tpu_torch.pulses import envelope as tenv

import test_channel_structured as jring

ROWS = [[[0.0, np.pi, 0.7, 0], [0.0, 1.3, 2.0, 1]],
        [[0.0, np.pi, 3.0, 1]],
        [[0.0, 0.5, 1.0, 2], [0.0, -2.0, 0.3, 0]]]


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _envelopes(func_type=0, n_basis=4):
    return (jenv.ChannelEnvelope.from_rows(ROWS, n_basis, func_type),
            tenv.ChannelEnvelope.from_rows(ROWS, n_basis, func_type))


def test_channel_table_matches_jax():
    je, te = _envelopes()
    assert te.channels == tuple(tenv.Channel(c.control, c.omega, c.w, c.idx)
                                for c in je.channels)
    assert (te.n_controls, te.n_idx, te.n_basis, te.coeff_shape) == \
        (je.n_controls, je.n_idx, je.n_basis, je.coeff_shape)
    assert tprop._amplitude_bound(te) == jprop._amplitude_bound(je)
    c = te.init_coeff(torch.Generator().manual_seed(0), scale=1e-3,
                      device="cpu")
    assert c.shape == je.coeff_shape and float(c.abs().max()) < 1e-2


@pytest.mark.parametrize("func_type", [0, 1])
def test_amplitudes_match_jax(func_type):
    je, te = _envelopes(func_type)
    rng = np.random.default_rng(func_type)
    vv = rng.standard_normal(je.coeff_shape)
    ts = np.linspace(0.0, 2.0, 9)
    want = np.asarray(je.amplitudes(jnp.asarray(vv), jnp.asarray(ts), 2.0))
    got = te.amplitudes(torch.tensor(vv), torch.tensor(ts), 2.0).numpy()
    assert got.shape == (3, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("members", ["coeffs", "grids", "both"])
def test_amplitudes_per_member_match_jax(members):
    """[G, 2, n_idx, n_basis] coefficients and/or [G, n_t] grids give
    [G, n_controls, n_t], as the JAX envelope vmapped over members."""
    je, te = _envelopes()
    rng = np.random.default_rng(5)
    G, ts = 4, np.linspace(0.0, 2.0, 7)
    vv = rng.standard_normal((G,) + je.coeff_shape) \
        if members != "grids" else rng.standard_normal(je.coeff_shape)
    grids = np.stack([ts * (g + 1) / G for g in range(G)]) \
        if members != "coeffs" else ts
    in_axes = (0 if members != "grids" else None,
               0 if members != "coeffs" else None)
    want = np.asarray(jax.vmap(lambda c, t: je.amplitudes(c, t, 2.0),
                               in_axes=in_axes)(jnp.asarray(vv),
                                                jnp.asarray(grids)))
    got = te.amplitudes(torch.tensor(vv), torch.tensor(grids), 2.0).numpy()
    assert got.shape == (G, 3, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("zero", ["one_row", "all"])
def test_masked_channels_have_zero_gradient(zero):
    """A channel whose quadrature norm N is below 1e-6 contributes 0. The
    values match JAX's; the port's gradient there is 0, the derivative of
    the function both packages define (0 in the whole ball), while JAX's
    is NaN: it differentiates sqrt at 0 under its jnp.where mask (a fault
    of the reference, recorded in ROADMAP.md, Queue 3). Outside the mask
    the gradients agree."""
    je, te = _envelopes()
    vv = 0.1 * np.random.default_rng(1).standard_normal(je.coeff_shape)
    masked = [0, 1] if zero == "all" else [1]  # coefficient rows zeroed
    vv[:, masked, :] = 0.0
    ts = np.linspace(0.0, 2.0, 6)
    np.testing.assert_allclose(
        te.amplitudes(torch.tensor(vv), torch.tensor(ts), 2.0).numpy(),
        np.asarray(je.amplitudes(jnp.asarray(vv), jnp.asarray(ts), 2.0)),
        rtol=0, atol=1e-12)
    if zero == "all":
        vv[:] = 0.0
    jg = np.asarray(jax.grad(lambda v: je.amplitudes(
        v, jnp.asarray(ts), 2.0).sum())(jnp.asarray(vv)))
    x = torch.tensor(vv, requires_grad=True)
    (tg,) = torch.autograd.grad(te.amplitudes(x, torch.tensor(ts),
                                              2.0).sum(), x)
    tg = tg.numpy()
    assert np.all(np.isfinite(tg))
    rows = list(range(je.n_idx)) if zero == "all" else masked
    assert np.all(np.isnan(jg[:, rows, :]))          # the reference's NaN
    assert np.all(tg[:, rows, :] == 0.0)             # the port's 0
    live = [r for r in range(je.n_idx) if r not in rows]
    np.testing.assert_allclose(tg[:, live, :], jg[:, live, :], atol=1e-12)


def test_envelope_jacobian_matches_jax_jacrev():
    je, te = _envelopes()
    rng = np.random.default_rng(2)
    vv = rng.standard_normal(je.coeff_shape)
    for s in (0.0, 0.37, 1.9):
        want = np.asarray(jmc.envelope_jacobian(je, jnp.asarray(vv), s, 2.0))
        got = tmc.envelope_jacobian(te, torch.tensor(vv), s, 2.0).numpy()
        assert got.shape == (3,) + je.coeff_shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    ss = np.array([0.2, 1.1, 1.7])
    cs = rng.standard_normal((3,) + je.coeff_shape)
    want = np.asarray(jax.vmap(lambda c, s: jmc.envelope_jacobian(
        je, c, s, 2.0))(jnp.asarray(cs), jnp.asarray(ss)))
    got = tmc.envelope_jacobian(te, torch.tensor(cs), torch.tensor(ss),
                                2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    want = np.asarray(jax.vmap(lambda s: jmc.envelope_jacobian(
        je, jnp.asarray(vv), s, 2.0))(jnp.asarray(ss)))
    got = tmc.envelope_jacobian(te, torch.tensor(vv), torch.tensor(ss),
                                2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _torch_ring(n, dtype, dense):
    """tests/test_channel_structured.py's ring problem, in the port."""
    from diffquantum_tpu_torch.dynamics.hamiltonian import (
        ControlledHamiltonian, TermStructure)
    from diffquantum_tpu_torch.ops import cpx, linalg
    d = 2**n
    edges = [(i, (i + 1) % n) for i in range(n)]
    structure, Hs, nested = [], [], []
    for idx, (i, j) in enumerate(edges):
        diag = linalg.zz_diagonal(n, i, j)
        structure.append(TermStructure(kind="diag", diag=diag))
        if dense:
            Hs.append(np.diag(diag).astype(np.complex128))
        nested.append([[0.0, np.pi, 0.7 * idx, idx]])
    for q in range(n):
        structure.append(TermStructure(kind="1q", qubit=q, local=linalg.X))
        if dense:
            Hs.append(linalg.op_on_qubits(linalg.X, [q], n))
        nested.append([[0.0, np.pi, 3.0 + 0.5 * q, len(edges) + q]])
    env = tenv.ChannelEnvelope.from_rows(nested, n_basis=4, func_type=0)
    h0 = TermStructure(kind="diag", diag=np.zeros(d))
    if dense:
        ham = ControlledHamiltonian.create(np.zeros((d, d)), Hs, dtype=dtype,
                                           structure=structure,
                                           h0_structure=h0, device="cpu")
    else:
        ham = ControlledHamiltonian.create_structured(
            d, structure, h0_structure=h0, dtype=dtype)
    psi0 = cpx.from_complex(np.full(d, d ** -0.5, np.complex128),
                            dtype=dtype, device="cpu")
    return ham, env, psi0


def _weights(n, dtype_np):
    """A random diagonal cost (a linear one in the bits would be blind:
    the ring's global spin flip keeps every <Z_q> at 0 from |+...+>)."""
    return np.random.default_rng(n).standard_normal(2**n).astype(dtype_np)


@pytest.mark.parametrize("n,dense,backend", [(10, False, "product"),
                                             (4, True, "expm"),
                                             (4, True, "apply")])
def test_channel_model_energy_and_grad_matches_jax(n, dense, backend):
    jham, jenv_, vv, jpsi, T = jring._ring_problem(n, jnp.float64, dense)
    tham_, tenv_, tpsi = _torch_ring(n, torch.float64, dense)
    w = _weights(n, np.float64)
    jv, jg = jadj.energy_and_grad(jham, jenv_, jnp.asarray(w), vv, jpsi, T,
                                  8, backend=backend)
    tv, tg = tadj.energy_and_grad(tham_, tenv_, torch.tensor(w),
                                  torch.tensor(np.asarray(vv)), tpsi, T, 8,
                                  backend=backend)
    np.testing.assert_allclose(float(tv), float(jv), rtol=0, atol=1e-10)
    _rel_close(tg.numpy(), np.asarray(jg), 1e-9)


def test_channel_model_on_the_fused_wrapper_matches_jax():
    """12 qubits, float32: the fused wrapper's plain K1 path against the
    JAX eager engine."""
    n = 12
    jham, jenv_, vv, jpsi, T = jring._ring_problem(n, jnp.float32, False)
    tham_, tenv_, tpsi = _torch_ring(n, torch.float32, False)
    w = _weights(n, np.float32)
    jv, jg = jadj.energy_and_grad(jham, jenv_, jnp.asarray(w), vv, jpsi, T,
                                  6, backend="product")
    tv, tg = tadj.energy_and_grad(tham_, tenv_, torch.tensor(w),
                                  torch.tensor(np.asarray(vv)), tpsi, T, 6,
                                  backend="product_fused")
    np.testing.assert_allclose(float(tv), float(jv), rtol=0, atol=5e-5)
    _rel_close(tg.numpy(), np.asarray(jg), 1e-4)


def test_channel_mc_and_fd_match_jax():
    """The MC estimator at fixed split times (one sample; three samples
    with a coefficient set each, the seed trainer's layout, against JAX
    per sample) and FD, on the 6-qubit ring."""
    from diffquantum_tpu_torch.measure import Measurement as TM
    from diffquantum_tpu.measure import Measurement as JM
    n, n_steps = 6, 6
    jham, jenv_, vv, jpsi, T = jring._ring_problem(n, jnp.float64, False)
    tham_, tenv_, tpsi = _torch_ring(n, torch.float64, False)
    w = _weights(n, np.float64)
    jm_ = JM.create_diagonal(w, dtype=jnp.float64)
    tm_ = TM.create_diagonal(w, dtype=torch.float64, device="cpu")
    key = jax.random.PRNGKey(0)
    for s in (0.4, 1.3):
        want = jmc.mc_energy_grad(jham, jenv_, jm_, vv, jpsi, T, key,
                                  n_steps, s=s)
        got = tmc.mc_energy_grad(tham_, tenv_, tm_,
                                 torch.tensor(np.asarray(vv)), tpsi, T, None,
                                 n_steps, s=s)
        assert got.shape == jenv_.coeff_shape
        _rel_close(got.numpy(), np.asarray(want), 1e-9)
    rng = np.random.default_rng(4)
    cs = np.asarray(vv)[None] + 0.3 * rng.standard_normal(
        (3,) + jenv_.coeff_shape)
    ss = np.array([0.3, 1.0, 1.8])
    got = tmc.mc_grads_per_sample(tham_, tenv_, tm_, torch.tensor(cs), tpsi,
                                  T, torch.tensor(ss), n_steps).numpy()
    for i in range(3):
        want = jmc.mc_energy_grad(jham, jenv_, jm_, jnp.asarray(cs[i]), jpsi,
                                  T, key, n_steps, s=ss[i])
        _rel_close(got[i], np.asarray(want), 1e-9)
    want = jfd.fd_energy_grad(jham, jenv_, jm_, vv, jpsi, T, key, n_steps)
    got = tfd.fd_energy_grad(tham_, tenv_, tm_, torch.tensor(np.asarray(vv)),
                             tpsi, T, None, n_steps)
    _rel_close(got.numpy(), np.asarray(want), 1e-9)
