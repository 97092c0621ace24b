"""The dense slice of the PyTorch port against the JAX package on the CPU:
the matrix exponentials, K7's plain forward and backward (the Taylor
apply), the dense 'expm' and 'apply' backends with the router's choice,
per-member groups, trajectories and step-count calibration.

Tolerances: float64 where the algorithm is the point (the same arithmetic
in another order: 1e-12 absolute on exponentials and states, 1e-9
relative to the max-norm on gradients); float32 against the JAX float32
path where the kernel's contract is (K7's plain version against the
Pallas kernel in interpret mode, which sums its Gauss products in
another order: 2e-6 on states of unit norm)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.dynamics import propagator as jprop
from diffquantum_tpu.gradients.adjoint import energy_and_grad as j_eag
from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu.ops import cpx as jcpx
from diffquantum_tpu.ops import expm as jexpm
from diffquantum_tpu.ops.pallas_kernels import taylor_apply_fused
from diffquantum_tpu_torch.dynamics import propagator as tprop
from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad as t_eag
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.ops import cpx as tcpx
from diffquantum_tpu_torch.ops import expm as texpm
from diffquantum_tpu_torch.ops import taylor_apply as tta
from diffquantum_tpu_torch.ops.cpx import CP


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _hermitian(rng, d, norm=1.0):
    a = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    h = (a + a.conj().T) / 2
    return h * (norm / np.linalg.norm(h, 2))


def _kets(rng, shape):
    v = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _t(a, dtype=torch.float64):
    return tcpx.from_complex(a, dtype=dtype, device="cpu")


def _j(a, dtype=jnp.float64):
    return jcpx.from_complex(a, dtype=dtype)


# ---------------------------------------------------------------------------
# matrix exponentials
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bound,tol", [(1e-3, 1e-7), (0.5, 1e-7),
                                       (4.19, 1e-7), (50.0, 1e-6),
                                       (300.0, 1e-12)])
def test_taylor_params_match_jax(bound, tol):
    assert texpm.taylor_params(bound, tol) == jexpm.taylor_params(bound, tol)


@pytest.mark.parametrize("which", ["taylor", "pade13"])
def test_matrix_exponentials_match_jax(which):
    """A batch of anti-Hermitian generators -i dt H, float64."""
    rng = np.random.default_rng(3)
    a = np.stack([-1j * _hermitian(rng, 6, norm) for norm in (0.2, 1.7,
                                                              6.0)])
    bound = 6.0
    if which == "taylor":
        want = jexpm.cexpm_taylor(_j(a), bound)
        got = texpm.cexpm_taylor(_t(a), bound)
    else:
        want = jexpm.cexpm_pade13(_j(a), bound)
        got = texpm.cexpm_pade13(_t(a), bound)
    np.testing.assert_allclose(tcpx.to_complex(got), jcpx.to_complex(want),
                               rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# K7's plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,b,z", [(48, 5, -0.31j), (16, 16, -0.08j),
                                   (4, 4, 0.2 - 0.4j), (2, 3, -1.3j),
                                   (16, 3, 0.0)])
def test_k7_plain_matches_pallas_interpret(d, b, z):
    """K7's plain forward against the TPU kernel in interpret mode, f32,
    with the order and substeps taylor_params gives at |z| ||H||; d = 48,
    B = 5 is tests/test_pallas.py's unaligned case, z = 0 the identity."""
    rng = np.random.default_rng(d + b)
    h, psi = _hermitian(rng, d, 2.0), _kets(rng, (b, d))
    order, s = texpm.taylor_params(max(abs(z) * 2.0, 1e-30), 1e-7)
    want = jcpx.to_complex(taylor_apply_fused(
        _j(h, jnp.float32), _j(psi, jnp.float32), z.real, z.imag,
        order=order, substeps=2**s, interpret=True))
    got = tcpx.to_complex(tta.taylor_apply(
        _t(h, torch.float32), _t(psi, torch.float32), z.real, z.imag,
        order, 2**s))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    if z == 0:
        np.testing.assert_array_equal(got, tcpx.to_complex(
            _t(psi, torch.float32)))


@pytest.mark.parametrize("d,b,z,bound", [(6, 3, -0.4j, 1.2),
                                         (4, 2, 0.3 - 0.5j, 4.0),
                                         (8, 1, -2.5j, 2.5)])
def test_k7_plain_backward_matches_autograd_and_jax_vjp(d, b, z, bound):
    """The plain backward (the kernel's algorithm: the forward's terms,
    then the reverse recurrence with H^dagger) against torch.autograd
    through the plain forward and against jax.vjp of
    cexpm_apply_taylor, float64, in the real-plane convention."""
    rng = np.random.default_rng(b * 10 + d)
    h = _hermitian(rng, d, 1.0) + 0.3 * (rng.standard_normal((d, d))
                                          + 1j * rng.standard_normal((d, d)))
    psi, g = _kets(rng, (b, d)), _kets(rng, (b, d))
    order, s = texpm.taylor_params(bound, 1e-7)
    zs = tta.substep_z(z.real, z.imag, 2**s,
                       torch.zeros((), dtype=torch.float64))
    H, P, G = _t(h), _t(psi), _t(g)
    gh, gp = tta.taylor_apply_backward_plain(H, P, G, zs, order, 2**s)

    leaves = [x.clone().requires_grad_(True) for x in (*H, *P)]
    out = tta.taylor_apply_plain(CP(*leaves[:2]), CP(*leaves[2:]), zs, order,
                                 2**s)
    auto = torch.autograd.grad((out.re, out.im), leaves, (G.re, G.im))
    for a, want in zip((gh.re, gh.im, gp.re, gp.im), auto):
        _rel_close(a.numpy(), want.numpy(), 1e-12)

    def f(h_, p_):
        return jexpm.cexpm_apply_taylor(h_, p_, z.real, z.imag, bound)
    _, vjp = jax.vjp(f, _j(h), _j(psi))
    jh, jp = vjp(_j(g))
    for a, want in zip((gh.re, gh.im, gp.re, gp.im),
                       (jh.re, jh.im, jp.re, jp.im)):
        _rel_close(a.numpy(), np.asarray(want), 1e-12)


def test_taylor_apply_wrapper_on_cpu():
    """The wrapper on CPU tensors: the plain pair behind autograd, a
    single state [d] kept [d], no launch counted."""
    rng = np.random.default_rng(5)
    h, psi = _hermitian(rng, 8, 1.0), _kets(rng, (8,))
    f0, b0 = tta.K7_FWD_LAUNCHES, tta.K7_BWD_LAUNCHES
    H = CP(*(x.requires_grad_(True) for x in _t(h)))
    order, s = texpm.taylor_params(1.4, 1e-7)
    out = tta.taylor_apply(H, _t(psi), 0.0, -0.7, order, 2**s)
    assert out.re.shape == (8,)
    torch.autograd.grad(out.re.sum() + out.im.sum(), [H.re, H.im])
    want = jexpm.cexpm_apply_taylor(_j(h), _j(psi), 0.0, -0.7, 1.4)
    np.testing.assert_allclose(tcpx.to_complex(out), jcpx.to_complex(want),
                               rtol=0, atol=1e-13)
    assert (tta.K7_FWD_LAUNCHES, tta.K7_BWD_LAUNCHES) == (f0, b0)


@pytest.mark.parametrize("case", ["maxcut", "controls", "h2", "drift"])
def test_detect_structure_matches_jax(case):
    """Dense operators classified as 'diag' / '1q' / 'dense' as the JAX
    package does; ``create(auto_structure=True)`` attaches the same tags
    (or none, when a term or H0 is neither)."""
    from diffquantum_tpu.dynamics import hamiltonian as jham
    from diffquantum_tpu_torch.dynamics import hamiltonian as tham
    from diffquantum_tpu_torch.ops import linalg
    h0, hs = {
        "maxcut": (np.zeros((16, 16)), [np.diag(linalg.zz_diagonal(4, 0, 1)),
                                        linalg.op_on_qubits(linalg.X, [2],
                                                            4)]),
        "controls": (0.3 * linalg.pauli_string("IZ"),
                     [linalg.pauli_string(p) for p in ("XI", "IY", "ZZ")]),
        "h2": (np.zeros((4, 4)), [linalg.pauli_string(p)
                                  for p in ("XI", "XX", "ZI")]),
        "drift": (linalg.pauli_string("XX"), [linalg.pauli_string("ZI")]),
    }[case]
    want, want0 = jham.detect_structure(h0, np.stack(hs))
    got, got0 = tham.detect_structure(h0, np.stack(hs))
    assert (got is None) == (want is None)
    if want is not None:
        for g, w in zip(got + (got0,), want + (want0,)):
            assert (g.kind, g.qubit) == (w.kind, w.qubit)
            for a, b in ((g.local, w.local), (g.diag, w.diag)):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
    ham = tham.ControlledHamiltonian.create(h0, hs, auto_structure=True,
                                            device="cpu")
    assert (ham.structure is None) == (want is None)
    assert ham.hs_norms == jham.ControlledHamiltonian.create(
        h0, hs).hs_norms


# ---------------------------------------------------------------------------
# the dense backends
# ---------------------------------------------------------------------------

def _dense_demo(dtype_np=np.float64, n_basis=4):
    tdt = torch.float64 if dtype_np == np.float64 else torch.float32
    jp = jmaxcut.build_maxcut(4, jmaxcut.ring_graph(4), n_basis=n_basis,
                              dense=True, dtype=jnp.dtype(dtype_np))
    tp = tmaxcut.build_maxcut(4, tmaxcut.ring_graph(4), n_basis=n_basis,
                              dense=True, dtype=tdt, device="cpu")
    coeff = (0.6 * np.random.default_rng(4).standard_normal(
        tp.envelope.coeff_shape)).astype(dtype_np)
    return jp, tp, coeff


@pytest.mark.parametrize("backend", ["expm", "apply", "auto"])
@pytest.mark.parametrize("batched", [False, True])
def test_evolve_dense_matches_jax(backend, batched):
    jp, tp, coeff = _dense_demo()
    rng = np.random.default_rng(1)
    psi = _kets(rng, (3, 16) if batched else (16,))
    kw = dict(horizon=tp.T, n_steps=25, backend=backend)
    want = jprop.evolve(jp.ham, jp.envelope, jnp.asarray(coeff), _j(psi),
                        0.0, tp.T, **kw)
    got = tprop.evolve(tp.ham, tp.envelope, torch.tensor(coeff), _t(psi),
                       0.0, tp.T, **kw)
    np.testing.assert_allclose(tcpx.to_complex(got), jcpx.to_complex(want),
                               rtol=0, atol=1e-12)


def test_dense_auto_rule():
    """'auto' on a dense Hamiltonian (structure tags or not): 'expm' for
    one state below d = 512, 'apply' for a batch or at d >= 512, as the
    JAX package's router; the choice is the same evolution bit for
    bit."""
    for dim, batched, want in ((16, False, "expm"), (16, True, "apply"),
                               (512, False, "apply"), (1024, True, "apply"),
                               (256, False, "expm")):
        assert tprop.dense_backend(types.SimpleNamespace(dim=dim),
                                   batched) == want
    _, tp, coeff = _dense_demo()
    assert tp.ham.structure is not None and not tp.ham.is_structured_only
    c = torch.tensor(coeff)
    for psi0, want in ((tp.psi0, "expm"),
                       (CP(tp.psi0.re.expand(2, -1), tp.psi0.im.expand(2, -1)),
                        "apply")):
        kw = dict(horizon=tp.T, n_steps=12)
        auto = tprop.evolve(tp.ham, tp.envelope, c, psi0, 0.0, tp.T, **kw)
        named = tprop.evolve(tp.ham, tp.envelope, c, psi0, 0.0, tp.T,
                             backend=want, **kw)
        assert torch.equal(auto.re, named.re) and torch.equal(auto.im,
                                                              named.im)


def test_evolve_dense_per_member_groups():
    """Per-member coefficients and split times evolve a batch as groups:
    each group equals its own evolution; a group of one state runs
    'expm' under 'auto' (as a vmapped member in the JAX package), a
    larger group 'apply'."""
    jp, tp, coeff = _dense_demo()
    rng = np.random.default_rng(2)
    cs = torch.tensor(np.stack([coeff, 0.5 * coeff, -coeff]))
    t0 = torch.tensor([0.0, 0.3, 0.9], dtype=torch.float64)
    for per in (1, 2):
        psi = _kets(rng, (3 * per, 16))
        got = tprop.evolve(tp.ham, tp.envelope, cs, _t(psi), t0, tp.T,
                           horizon=tp.T, n_steps=10)
        for g in range(3):
            want = jprop.evolve(
                jp.ham, jp.envelope, jnp.asarray(cs[g].numpy()),
                _j(psi[g * per:(g + 1) * per] if per > 1 else psi[g]),
                float(t0[g]), tp.T, horizon=tp.T, n_steps=10,
                dt_bound=tp.T / 10)
            np.testing.assert_allclose(
                tcpx.to_complex(got)[g * per:(g + 1) * per],
                jcpx.to_complex(want).reshape(per, 16), rtol=0, atol=1e-12)


@pytest.mark.parametrize("backend", ["expm", "apply"])
def test_dense_gradient_matches_jax(backend):
    """energy_and_grad on the dense demo ring through each backend
    (autograd through 'expm'; K7's plain backward under 'apply')."""
    jp, tp, coeff = _dense_demo()
    jv, jg = j_eag(jp.ham, jp.envelope, jp.measurement, jnp.asarray(coeff),
                   jp.psi0, jp.T, 20, backend=backend)
    tv, tg = t_eag(tp.ham, tp.envelope, tp.measurement, torch.tensor(coeff),
                   tp.psi0, tp.T, 20, backend=backend)
    assert abs(float(tv) - float(jv)) < 1e-12
    _rel_close(tg.numpy(), np.asarray(jg), 1e-9)


def test_dense_f32_paths_match_jax_f32():
    """float32 both sides: the apply backend's value and gradient."""
    jp, tp, coeff = _dense_demo(np.float32)
    jv, jg = j_eag(jp.ham, jp.envelope, jp.measurement, jnp.asarray(coeff),
                   jp.psi0, jp.T, 20, backend="apply")
    tv, tg = t_eag(tp.ham, tp.envelope, tp.measurement, torch.tensor(coeff),
                   tp.psi0, tp.T, 20, backend="apply")
    assert abs(float(tv) - float(jv)) < 2e-5
    _rel_close(tg.numpy(), np.asarray(jg), 2e-4)


@pytest.mark.parametrize("batched", [False, True])
def test_evolve_trajectory_matches_jax(batched):
    jp, tp, coeff = _dense_demo()
    psi = _kets(np.random.default_rng(7), (2, 16) if batched else (16,))
    want = jprop.evolve_trajectory(jp.ham, jp.envelope, jnp.asarray(coeff),
                                   _j(psi), 0.0, tp.T, tp.T, 15)
    got = tprop.evolve_trajectory(tp.ham, tp.envelope, torch.tensor(coeff),
                                  _t(psi), 0.0, tp.T, tp.T, 15)
    assert got.re.shape == (16,) + psi.shape
    np.testing.assert_allclose(tcpx.to_complex(got), jcpx.to_complex(want),
                               rtol=0, atol=1e-12)


def test_step_doubling_and_calibration_match_jax():
    jp, tp, coeff = _dense_demo()
    jc, tc = jnp.asarray(coeff), torch.tensor(coeff)
    for n in (10, 40):
        want = jprop.step_doubling_error(jp.ham, jp.envelope, jc, jp.psi0,
                                         jp.T, n)
        got = tprop.step_doubling_error(tp.ham, tp.envelope, tc, tp.psi0,
                                        tp.T, n)
        assert abs(got - want) < 1e-12 * max(1.0, want)
    for tol, t_sample in ((1e-2, "left"), (1e-3, "mid")):
        assert tprop.calibrate_n_steps(
            tp.ham, tp.envelope, tc, tp.psi0, tp.T, tol=tol,
            t_sample=t_sample) == jprop.calibrate_n_steps(
            jp.ham, jp.envelope, jc, jp.psi0, jp.T, tol=tol,
            t_sample=t_sample)


def test_trotter_step_rule():
    jp, tp, coeff = _dense_demo()
    want = jprop.trotter(jp.ham, jp.envelope, jnp.asarray(coeff), jp.psi0,
                         0.0, 1.5, horizon=tp.T, per_step=6)
    got = tprop.trotter(tp.ham, tp.envelope, torch.tensor(coeff), tp.psi0,
                        0.0, 1.5, horizon=tp.T, per_step=6)
    np.testing.assert_allclose(tcpx.to_complex(got), jcpx.to_complex(want),
                               rtol=0, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("d, b", [(16, 3), (64, 3), (65, 3), (1024, 3),
                                  (1024, 40)])
def test_k7_kernel_matches_plain_on_card(d, b):
    """K7 against its plain version on the card: a block-resident shape,
    both sides of the configuration boundary (d = 64 and 65) and the
    10-qubit shape at B = 3 and 40 (the nine shapes of the paths run in
    chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 has no CPU mode")
    rng = np.random.default_rng(0)
    h, psi, g = _hermitian(rng, d, 1.0), _kets(rng, (b, d)), _kets(rng, (b, d))
    order, s = texpm.taylor_params(4.19, 1e-7)
    cu = lambda a: tcpx.from_complex(a, device="cuda")  # noqa: E731
    H, P, G = cu(h), cu(psi), cu(g)
    zs = tta.substep_z(0.0, -4.19, 2**s, P.re)
    out = tta._forward_cuda(H.re, H.im, P.re, P.im, zs, order, 2**s)
    ref = tta.taylor_apply_plain(H, P, zs, order, 2**s)
    torch.cuda.synchronize()
    assert float((out[0] - ref.re).abs().max()) < 1e-6
    got = tta._backward_cuda(H.re, H.im, P.re, P.im, G.re, G.im, zs, order,
                             2**s)
    gh, gp = tta.taylor_apply_backward_plain(H, P, G, zs, order, 2**s)
    for a, want in zip(got, (gh.re, gh.im, gp.re, gp.im)):
        _rel_close(a.cpu().numpy(), want.cpu().numpy(), 1e-5)
