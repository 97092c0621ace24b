"""K1 in the PyTorch port (``diffquantum_tpu_torch.ops.fused_product``)
against the JAX package's Pallas kernel, run in interpret mode on the CPU:
forward states and the VJP, for X, X+Y and X+hop op plans. The port's CPU
path is the plain version of its CUDA kernels, so this holds the
arithmetic the kernels implement. f32 throughout: states to atol 5e-5
(the JAX package's own fused-vs-XLA tolerance), gradients to 1e-4 of
their max-norm (sums over 2^n terms in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.ops import fused_product as jfp
from diffquantum_tpu.ops.cpx import CP as JCP
from diffquantum_tpu_torch.ops import fused_product as tfp
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.utils import profiling

N = 10
D = 2**N

PLANS = {
    "x": ((0, 4, 9), ("x", "x", "x")),
    # X and Y share qubit 0: a palindromic plan, as _symmetrize_rots emits
    "xy": ((0, 3, 9, 0, 0, 9, 3, 0), ("x", "y", "y", "y", "y", "y", "y", "x")),
    "xhop": ((1, (2, 8), 8, (0, 9)), ("x", "hop", "x", "hop")),
}


def _inputs(plan, n_steps, seed):
    rng = np.random.default_rng(seed)
    xq, kinds = PLANS[plan]
    psi = (rng.standard_normal((2, D)) / np.sqrt(D)).astype(np.float32)
    th = (0.3 * rng.standard_normal((n_steps, D))).astype(np.float32)
    tx = (0.4 * rng.standard_normal((n_steps, len(xq)))).astype(np.float32)
    lam = rng.standard_normal((2, D)).astype(np.float32)
    return xq, kinds, psi, th, tx, lam


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("plan,n_steps", [("x", 4), ("xy", 3), ("xhop", 4),
                                          ("xhop", 1)])
def test_k1_plain_matches_jax_kernel(plan, n_steps):
    xq, kinds, psi, th, tx, lam = _inputs(plan, n_steps, seed=n_steps)

    def jax_f(p_re, p_im, a, b):
        out = jfp.fused_product_evolve(JCP(p_re, p_im), a, b, xq, N, kinds)
        return out.re, out.im

    (j_re, j_im), vjp = jax.vjp(jax_f, *(jnp.asarray(v) for v in
                                         (psi[0], psi[1], th, tx)))
    jg = vjp((jnp.asarray(lam[0]), jnp.asarray(lam[1])))

    ts = [torch.tensor(v, requires_grad=True) for v in
          (psi[0], psi[1], th, tx)]
    out = tfp.fused_product_evolve(CP(ts[0], ts[1]), ts[2], ts[3], xq, N,
                                   kinds)
    np.testing.assert_allclose(out.re.detach().numpy(), np.asarray(j_re),
                               atol=5e-5)
    np.testing.assert_allclose(out.im.detach().numpy(), np.asarray(j_im),
                               atol=5e-5)
    tg = torch.autograd.grad((out.re, out.im),
                             ts, (torch.tensor(lam[0]), torch.tensor(lam[1])))
    for name, a, b in zip(("dpsi_re", "dpsi_im", "dtheta_half", "dtheta_x"),
                          tg, jg):
        assert a.shape == b.shape, name
        _rel_close(a.numpy(), np.asarray(b), 1e-4)
    launched = profiling.counters()
    assert launched["k1_forward"] == 0 and launched["k1_backward"] == 0


def test_plan_table_conventions():
    """Qubit 0 is the MSB; hops keep (qi < qj) bit masks; order kept."""
    plan = tfp._plan_ops((0, (3, 1), 9), ("y", "hop", "x"), N)
    assert plan.tolist() == [[0, tfp.KIND_Y, 1 << 9, 0],
                             [1, tfp.KIND_HOP, 1 << 8, 1 << 6],
                             [2, tfp.KIND_X, 1, 0]]
    with pytest.raises(ValueError, match="unknown kind"):
        tfp._plan_ops((0,), ("z",), N)


def test_merge_and_parity_helpers_match_jax():
    rng = np.random.default_rng(5)
    th = rng.standard_normal((5, 16))
    np.testing.assert_array_equal(
        tfp.merge_phase_rows(torch.tensor(th)).numpy(),
        np.asarray(jfp.merge_phase_rows(jnp.asarray(th))))
    ga = rng.standard_normal((6, 16))
    np.testing.assert_array_equal(
        tfp.unmerge_phase_grads(torch.tensor(ga)).numpy(),
        np.asarray(jfp.unmerge_phase_grads(jnp.asarray(ga))))
    from diffquantum_tpu.ops import linalg
    rows = [linalg.zz_diagonal(N, 0, 5), linalg.z_diagonal(N, 3),
            np.full(D, 2.0)]
    got = tfp.parity_sign_masks(rows)
    want = jfp.parity_sign_masks(rows)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(
        tfp.diag_rows_device(rows, D, torch.float64, "cpu").numpy(),
        np.asarray(jfp.diag_rows_device(rows, D, jnp.float64)))


def test_wrapper_rejects_bad_inputs():
    xq, kinds, psi, th, tx, _ = _inputs("x", 2, seed=0)
    p = CP(torch.tensor(psi[0]), torch.tensor(psi[1]))
    with pytest.raises(TypeError, match="float32"):
        tfp.fused_product_evolve(p, torch.tensor(th).double(),
                                 torch.tensor(tx), xq, N, kinds)
    with pytest.raises(ValueError, match="contiguous"):
        tfp.fused_product_evolve(p, torch.tensor(th),
                                 torch.tensor(tx.T.copy()).T, xq, N, kinds)
    with pytest.raises(ValueError, match="theta_x"):
        tfp.fused_product_evolve(p, torch.tensor(th),
                                 torch.tensor(tx[:, :2].copy()), xq, N, kinds)
    with pytest.raises(ValueError, match="qubits"):
        tfp.fused_product_evolve(CP(p.re[:D // 2], p.im[:D // 2]),
                                 torch.tensor(th[:, :D // 2].copy()),
                                 torch.tensor(tx), (0, 4, 8), N - 1, kinds)


@pytest.mark.gpu
def test_k1_kernel_matches_plain_on_card():
    """The CUDA kernels against the plain version on the card (the full
    set of shapes runs in chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1's CUDA kernels have no CPU mode")
    for plan in PLANS:
        xq, kinds, psi, th, tx, lam = _inputs(plan, 5, seed=1)
        cu = [torch.tensor(v, device="cuda") for v in (psi[0], psi[1], th,
                                                       tx)]
        before = profiling.counters()
        ts = [t.clone().requires_grad_(True) for t in cu]
        out = tfp.fused_product_evolve(CP(ts[0], ts[1]), ts[2], ts[3], xq,
                                       N, kinds)
        lam_t = [torch.tensor(v, device="cuda") for v in lam]
        got = torch.autograd.grad((out.re, out.im), ts, lam_t)
        torch.cuda.synchronize()
        now = profiling.counters()
        assert (now["k1_forward"] - before["k1_forward"],
                now["k1_backward"] - before["k1_backward"]) == (1, 1)
        ref = tfp.fused_product_evolve_plain(CP(cu[0], cu[1]), cu[2], cu[3],
                                             xq, N, kinds)
        _rel_close(out.re.detach().cpu().numpy(), ref.re.cpu().numpy(),
                   5e-5)
        gp, gth, gtx = tfp._adjoint_plain(ref, CP(*lam_t), cu[2], cu[3], xq,
                                          N, kinds)
        for a, b in zip(got, (gp.re, gp.im, gth, gtx)):
            _rel_close(a.cpu().numpy(), b.cpu().numpy(), 1e-4)
