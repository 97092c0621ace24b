"""The batched fused evolution (K2) of the PyTorch port against the JAX
package on the CPU: K2's plain forward and VJP against the Pallas kernel
in interpret mode (X, X+Y and X+hop plans, per-member and shared phase
rows), the batched branch of ``evolve_product_fused`` (per-seed and
shared coefficients, per-member time grids), the eager engine with
per-seed coefficients, ``apply_structured_terms``, seed-stacked Adam
state, and ``train_energy_seeds`` in adjoint mode epoch by epoch.

Inputs are drawn once from a seeded numpy generator and handed to both
packages. Tolerances: f32 states atol 5e-5 and gradients 1e-4 of their
max-norm (the JAX package's own fused-vs-XLA limits: sums over 2^n terms
in another order); f64 paths 1e-9 relative (the same arithmetic in
another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffquantum_tpu.dynamics import hamiltonian as jham
from diffquantum_tpu.dynamics import product as jprod
from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu.ops import fused_product as jfp
from diffquantum_tpu.ops import linalg as jlinalg
from diffquantum_tpu.ops.cpx import CP as JCP
from diffquantum_tpu.parallel.mesh import train_energy_seeds as j_seeds
from diffquantum_tpu.pulses import envelope as jenv
from diffquantum_tpu.train.config import TrainConfig as JConfig
from diffquantum_tpu_torch.convert import params_from_numpy
from diffquantum_tpu_torch.dynamics import hamiltonian as tham
from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.ops import fused_product as tfp
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.parallel import train_energy_seeds as t_seeds
from diffquantum_tpu_torch.pulses import envelope as tenv
from diffquantum_tpu_torch.train.config import TrainConfig as TConfig
from diffquantum_tpu_torch.train.energy import make_optimizer
from diffquantum_tpu_torch.utils import profiling

N = 10
D = 2**N

PLANS = {
    "x": ((0, 4, 9), ("x", "x", "x")),
    # X and Y share qubit 0: a palindromic plan, as _symmetrize_rots emits
    "xy": ((0, 3, 9, 0, 0, 9, 3, 0), ("x", "y", "y", "y", "y", "y", "y", "x")),
    "xhop": ((1, (2, 8), 8, (0, 9)), ("x", "hop", "x", "hop")),
}


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _k2_inputs(plan, n_steps, b, rows, seed):
    """psi [2, B, D], theta_half [T, rows, D], theta_x [T, rows, n_x] and a
    cotangent [2, B, D]; rows is B (per member), 1 (shared) or a group
    count dividing B."""
    rng = np.random.default_rng(seed)
    xq, kinds = PLANS[plan]
    psi = (rng.standard_normal((2, b, D)) / np.sqrt(D)).astype(np.float32)
    th = (0.3 * rng.standard_normal((n_steps, rows, D))).astype(np.float32)
    tx = (0.4 * rng.standard_normal((n_steps, rows, len(xq)))
          ).astype(np.float32)
    lam = rng.standard_normal((2, b, D)).astype(np.float32)
    return xq, kinds, psi, th, tx, lam


def _jax_k2_vjp(xq, kinds, psi, th, tx, lam, b):
    """The JAX kernel's output and VJP; group rows are repeated onto their
    B/G consecutive members inside the differentiated function, so their
    cotangent is the sum over those members."""
    def f(p_re, p_im, a, c):
        a = jnp.repeat(a, b // a.shape[1], axis=1)
        c = jnp.repeat(c, b // c.shape[1], axis=1)
        out = jfp.fused_product_evolve_batched(JCP(p_re, p_im), a, c, xq, N,
                                               kinds)
        return out.re, out.im

    out, vjp = jax.vjp(f, *(jnp.asarray(v) for v in (psi[0], psi[1], th,
                                                     tx)))
    return out, vjp((jnp.asarray(lam[0]), jnp.asarray(lam[1])))


@pytest.mark.parametrize("plan,n_steps,b,rows,form", [
    ("x", 4, 3, 3, "rows"), ("xy", 3, 2, 2, "rows"),
    ("xhop", 4, 3, 3, "rows"), ("xhop", 1, 2, 2, "rows"),
    ("xy", 3, 3, 1, "rows"), ("xhop", 2, 6, 2, "groups")])
def test_k2_plain_matches_jax_kernel(plan, n_steps, b, rows, form):
    """Per-member rows, one shared row ([T, 1, ...], one MC sample's
    branches) and G group rows for B members, 1 < G < B ('groups': a seed
    population's MC branches, row g serving members g*B/G ..)."""
    assert (form == "groups") == (1 < rows < b)
    xq, kinds, psi, th, tx, lam = _k2_inputs(plan, n_steps, b, rows,
                                             seed=10 * n_steps + b)
    (j_re, j_im), jg = _jax_k2_vjp(xq, kinds, psi, th, tx, lam, b)

    ts = [torch.tensor(v, requires_grad=True) for v in
          (psi[0], psi[1], th, tx)]
    out = tfp.fused_product_evolve_batched(CP(ts[0], ts[1]), ts[2], ts[3],
                                           xq, N, kinds)
    np.testing.assert_allclose(out.re.detach().numpy(), np.asarray(j_re),
                               atol=5e-5)
    np.testing.assert_allclose(out.im.detach().numpy(), np.asarray(j_im),
                               atol=5e-5)
    tg = torch.autograd.grad((out.re, out.im), ts,
                             (torch.tensor(lam[0]), torch.tensor(lam[1])))
    for name, a, want in zip(("dpsi_re", "dpsi_im", "dtheta_half",
                              "dtheta_x"), tg, jg):
        assert a.shape == want.shape, name
        _rel_close(a.numpy(), np.asarray(want), 1e-4)
    launched = profiling.counters()
    assert launched["k2_forward"] == 0 and launched["k2_backward"] == 0


def test_k2_group_rows_equal_repeated_member_rows():
    """G group rows for B members are B/G consecutive members reading one
    row; the plain adjoint returns their summed cotangent."""
    xq, kinds, psi, th, tx, lam = _k2_inputs("xhop", 3, 4, 2, seed=3)
    p, l_ = CP(*map(torch.tensor, psi)), CP(*map(torch.tensor, lam))
    th, tx = torch.tensor(th), torch.tensor(tx)
    rep = lambda t: t.repeat_interleave(2, dim=1)  # noqa: E731
    a = tfp.fused_product_evolve_batched_plain(p, th, tx, xq, N, kinds)
    b = tfp.fused_product_evolve_batched_plain(p, rep(th), rep(tx), xq, N,
                                               kinds)
    assert torch.equal(a.re, b.re) and torch.equal(a.im, b.im)
    ga = tfp._adjoint_batched_plain(a, l_, th, tx, xq, N, kinds)
    gb = tfp._adjoint_batched_plain(b, l_, rep(th), rep(tx), xq, N, kinds)
    assert torch.equal(ga[0].re, gb[0].re)
    for got, full in ((ga[1], gb[1]), (ga[2], gb[2])):
        assert got.shape[1] == 2
        torch.testing.assert_close(got, full.reshape(full.shape[0], 2, 2,
                                                     -1).sum(2))
    with pytest.raises(ValueError, match="dividing"):
        tfp.fused_product_evolve_batched_plain(p, th[:, :1].repeat(1, 3, 1),
                                               tx, xq, N, kinds)
    # one shared row is [T, 1, ...]; a stride-0 expand of it is refused
    with pytest.raises(ValueError, match="contiguous"):
        tfp.fused_product_evolve_batched(p, th[:, :1].expand(-1, 4, -1), tx,
                                         xq, N, kinds)


# ---------------------------------------------------------------------------
# the batched branch of the engines
# ---------------------------------------------------------------------------

def _mixed_structures(n):
    """X and Y drives sharing qubits with two hops (a palindromic plan) and
    two ZZ couplers, as (JAX, port) TermStructure lists."""
    spec = [("diag", jlinalg.zz_diagonal(n, 0, 1), None, None, None),
            ("diag", jlinalg.zz_diagonal(n, 4, 7), None, None, None),
            ("1q", None, 0, jlinalg.X, None), ("1q", None, 3, jlinalg.Y, None),
            ("1q", None, n - 1, jlinalg.X, None),
            ("hop", None, 1, None, 2), ("hop", None, 0, None, n - 1)]
    js, ts = [], []
    for kind, diag, q, local, q2 in spec:
        kw = dict(kind=kind)
        if diag is not None:
            kw["diag"] = diag
        if q is not None:
            kw["qubit"] = q
        if local is not None:
            kw["local"] = local
        if q2 is not None:
            kw["qubit2"] = q2
        js.append(jham.TermStructure(**kw))
        ts.append(tham.TermStructure(**kw))
    return js, ts


def _hams(problem, dtype_np):
    """(JAX ham, envelope), (port ham, envelope) at N qubits, and psi0 as
    numpy; dtype_np sets both packages' real dtype."""
    tdt = torch.float64 if dtype_np == np.float64 else torch.float32
    if problem == "maxcut":
        jp = jmaxcut.build_maxcut(N, jmaxcut.ring_graph(N), n_basis=4,
                                  dense=False, dtype=jnp.dtype(dtype_np))
        tp = tmaxcut.build_maxcut(N, tmaxcut.ring_graph(N), n_basis=4,
                                  dtype=tdt, device="cpu")
        return (jp.ham, jp.envelope), (tp.ham, tp.envelope)
    js, ts = _mixed_structures(N)
    zero = np.zeros(D)
    jh = jham.ControlledHamiltonian.create_structured(
        D, tuple(js), h0_structure=jham.TermStructure(kind="diag", diag=zero),
        dtype=jnp.dtype(dtype_np))
    th = tham.ControlledHamiltonian.create_structured(
        D, tuple(ts), h0_structure=tham.TermStructure(kind="diag", diag=zero),
        dtype=tdt)
    omegas = (np.pi,) * len(js)
    return ((jh, jenv.SimpleEnvelope(basis="bspline", n_basis=4,
                                     omegas=omegas)),
            (th, tenv.SimpleEnvelope(basis="bspline", n_basis=4,
                                     omegas=omegas)))


def _batch_inputs(n_controls, b, per_seed, dtype_np, seed):
    rng = np.random.default_rng(seed)
    shape = ((b,) if per_seed else ()) + (n_controls, 4)
    coeff = (0.5 * rng.standard_normal(shape)).astype(dtype_np)
    psi = (rng.standard_normal((2, b, D)) / np.sqrt(2 * D)).astype(dtype_np)
    return coeff, psi


def _jax_eager(jh, je, coeff, psi, T0, T, n_steps):
    """JAX's eager engine vmapped over the members (coefficients and T0
    per member where they carry the batch axis)."""
    b = psi.shape[1]
    c_ax = 0 if coeff.ndim == 3 else None
    t_ax = 0 if np.ndim(T0) else None
    f = jax.vmap(lambda c, pr, pi, t0: jprod.evolve_product(
        jh, je, c, JCP(pr, pi), t0, T, horizon=2.0, n_steps=n_steps),
        in_axes=(c_ax, 0, 0, t_ax))
    out = f(jnp.asarray(coeff), jnp.asarray(psi[0]), jnp.asarray(psi[1]),
            jnp.asarray(T0))
    assert out.re.shape == (b, D)
    return np.asarray(out.re), np.asarray(out.im)


@pytest.mark.parametrize("problem,per_seed", [("maxcut", True),
                                              ("maxcut", False),
                                              ("mixed", True)])
def test_evolve_product_fused_batched_matches_jax_eager(problem, per_seed):
    """f32 through the port's fused wrapper (K2's plain path) against
    JAX's vmapped eager engine."""
    (jh, je), (th, te) = _hams(problem, np.float32)
    coeff, psi = _batch_inputs(te.n_controls, 3, per_seed, np.float32, 5)
    want = _jax_eager(jh, je, coeff, psi, 0.0, 2.0, 4)
    got = tprod.evolve_product_fused(th, te, torch.tensor(coeff),
                                     CP(*map(torch.tensor, psi)), 0.0, 2.0,
                                     horizon=2.0, n_steps=4)
    np.testing.assert_allclose(got.re.numpy(), want[0], atol=5e-5)
    np.testing.assert_allclose(got.im.numpy(), want[1], atol=5e-5)


@pytest.mark.parametrize("problem", ["maxcut", "mixed"])
def test_eager_engine_per_seed_f64(problem):
    (jh, je), (th, te) = _hams(problem, np.float64)
    coeff, psi = _batch_inputs(te.n_controls, 3, True, np.float64, 6)
    want = _jax_eager(jh, je, coeff, psi, 0.0, 2.0, 5)
    got = tprod.evolve_product(th, te, torch.tensor(coeff),
                               CP(*map(torch.tensor, psi)), 0.0, 2.0,
                               horizon=2.0, n_steps=5)
    np.testing.assert_allclose(got.re.numpy(), want[0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.im.numpy(), want[1], rtol=0, atol=1e-9)


@pytest.mark.parametrize("engine", ["eager_f64", "fused_f32"])
def test_per_member_time_grids_match_jax(engine):
    """The MC estimator's second leg: one coefficient set, a split time
    T0 per member (a tensor, never a host number), evolved to T."""
    dt_np = np.float64 if engine == "eager_f64" else np.float32
    (jh, je), (th, te) = _hams("mixed", dt_np)
    coeff, psi = _batch_inputs(te.n_controls, 3, False, dt_np, 7)
    T0 = np.array([0.1, 0.9, 1.7])
    want = _jax_eager(jh, je, coeff, psi, T0, 2.0, 4)
    run = tprod.evolve_product if engine == "eager_f64" \
        else tprod.evolve_product_fused
    got = run(th, te, torch.tensor(coeff), CP(*map(torch.tensor, psi)),
              torch.tensor(T0), 2.0, horizon=2.0, n_steps=4)
    atol = 1e-9 if engine == "eager_f64" else 5e-5
    np.testing.assert_allclose(got.re.numpy(), want[0], rtol=0, atol=atol)
    np.testing.assert_allclose(got.im.numpy(), want[1], rtol=0, atol=atol)


def test_fused_batched_gradient_matches_eager():
    """d<M>/dcoeff through K2's plain adjoint (per-seed coefficients)
    against autograd through the eager engine, both in the port: the
    population trainer's gradient."""
    (_, _), (th, te) = _hams("mixed", np.float32)
    coeff, psi = _batch_inputs(te.n_controls, 3, True, np.float32, 8)
    w = torch.tensor(np.random.default_rng(1).standard_normal(D),
                     dtype=torch.float32)
    grads = []
    for run in (tprod.evolve_product_fused, tprod.evolve_product):
        c = torch.tensor(coeff, requires_grad=True)
        out = run(th, te, c, CP(*map(torch.tensor, psi)), 0.0, 2.0,
                  horizon=2.0, n_steps=4)
        (g,) = torch.autograd.grad(((out.re**2 + out.im**2) * w).sum(), c)
        grads.append(g.numpy())
    _rel_close(grads[0], grads[1], 1e-4)


@pytest.mark.parametrize("batched", [False, True])
def test_apply_structured_terms_matches_jax(batched):
    js, ts = _mixed_structures(N)
    zero = np.zeros(D)
    jh = jham.ControlledHamiltonian.create_structured(
        D, tuple(js), h0_structure=jham.TermStructure(kind="diag", diag=zero),
        dtype=jnp.float64)
    th = tham.ControlledHamiltonian.create_structured(
        D, tuple(ts), h0_structure=tham.TermStructure(kind="diag", diag=zero),
        dtype=torch.float64)
    rng = np.random.default_rng(9)
    psi = rng.standard_normal((2, 3, D) if batched else (2, D))
    f = lambda pr, pi: jprod.apply_structured_terms(jh, JCP(pr, pi))  # noqa
    if batched:  # JAX maps states; the port takes the batch as it is
        f = jax.vmap(f, out_axes=1)
    w_re, w_im = f(jnp.asarray(psi[0]), jnp.asarray(psi[1]))
    g_re, g_im = tprod.apply_structured_terms(th, CP(*map(torch.tensor,
                                                          psi)))
    assert g_re.shape == w_re.shape == (len(js),) + psi.shape[1:]
    np.testing.assert_allclose(g_re.numpy(), np.asarray(w_re), atol=1e-12)
    np.testing.assert_allclose(g_im.numpy(), np.asarray(w_im), atol=1e-12)


# ---------------------------------------------------------------------------
# seed populations
# ---------------------------------------------------------------------------

def test_seed_stacked_adam_state_continues_the_run():
    """[B, n_controls, n_basis] coefficients and their optax Adam moments
    carry across and the next step equals optax's."""
    rng = np.random.default_rng(4)
    c0 = rng.standard_normal((3, 5, 4))
    grads = [rng.standard_normal((3, 5, 4)) for _ in range(3)]
    tx = optax.adam(5e-2)
    c = jnp.asarray(c0)
    state = tx.init(c)
    for g in grads[:2]:
        upd, state = tx.update(jnp.asarray(g), state, c)
        c = optax.apply_updates(c, upd)
    adam = state[0]
    tc, tstate = params_from_numpy(np.asarray(c), np.asarray(adam.mu),
                                   np.asarray(adam.nu), int(adam.count),
                                   device="cpu")
    assert tc.shape == (3, 5, 4)
    opt = make_optimizer(TConfig(lr=5e-2), [tc])
    opt.state[tc] = tstate
    tc.grad = torch.tensor(grads[2])
    opt.step()
    upd, _ = tx.update(jnp.asarray(grads[2]), state, c)
    np.testing.assert_allclose(tc.detach().numpy(),
                               np.asarray(optax.apply_updates(c, upd)),
                               rtol=1e-12, atol=1e-15)


def _jax_seed_init(envelope, cfg, n_seeds, dtype):
    """JAX's train_energy_seeds init draw, reproduced to hand the port the
    same start."""
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), n_seeds)
    return np.asarray(jax.vmap(lambda k: envelope.init_coeff(
        k, scale=1e-3, dtype=dtype))(keys))


@pytest.mark.parametrize("prec", ["f64_eager", "f32_fused"])
def test_train_energy_seeds_adjoint_matches_jax(prec):
    """Per-epoch per-seed losses and the final coefficients from the same
    init; f64 through both eager engines (rtol 1e-8), f32 through the
    port's fused engine (K2's plain path) against JAX's eager one (loss
    atol 5e-5)."""
    f64 = prec == "f64_eager"
    dtype = "float64" if f64 else "float32"
    jp = jmaxcut.build_maxcut(N, jmaxcut.ring_graph(N), n_basis=4,
                              dense=False,
                              dtype=jnp.float64 if f64 else jnp.float32)
    tp = tmaxcut.build_maxcut(N, tmaxcut.ring_graph(N), n_basis=4,
                              dtype=torch.float64 if f64 else torch.float32,
                              device="cpu")
    cfg = dict(n_epoch=3, lr=5e-2, per_step=2, seed=7, dtype=dtype)
    init = _jax_seed_init(jp.envelope, JConfig(**cfg), 3,
                          jnp.float64 if f64 else jnp.float32)
    jr = j_seeds(jp.ham, jp.envelope, jp.measurement, jp.psi0, jp.T,
                 JConfig(backend="product", **cfg), n_seeds=3)
    tr = t_seeds(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T,
                 TConfig(backend="product" if f64 else "product_fused",
                         **cfg), n_seeds=3, init_coeffs=torch.tensor(init))
    assert tr.losses.shape == jr.losses.shape == (3, 3)
    if f64:
        np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-8)
        np.testing.assert_allclose(tr.coeffs.numpy(), np.asarray(jr.coeffs),
                                   rtol=1e-6, atol=1e-12)
    else:
        np.testing.assert_allclose(tr.losses, jr.losses, rtol=0, atol=5e-5)
    assert tr.best_seed == jr.best_seed
    assert np.all(tr.losses[-1] < tr.losses[0])
    # the CPU takes the plain version
    assert profiling.counters()["k2_forward"] == 0


@pytest.mark.gpu
def test_k2_kernel_matches_plain_on_card():
    """The CUDA kernels against the plain version on the card (the full
    set of shapes runs in chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2's CUDA kernels have no CPU mode")
    for plan, b, rows in (("x", 3, 3), ("xy", 3, 1), ("xhop", 3, 3),
                          ("xhop", 6, 2)):
        xq, kinds, psi, th, tx, lam = _k2_inputs(plan, 5, b, rows, seed=1)
        cu = [torch.tensor(v, device="cuda") for v in (psi[0], psi[1], th,
                                                       tx)]
        before = profiling.counters()
        ts = [t.clone().requires_grad_(True) for t in cu]
        out = tfp.fused_product_evolve_batched(CP(ts[0], ts[1]), ts[2],
                                               ts[3], xq, N, kinds)
        lam_t = [torch.tensor(v, device="cuda") for v in lam]
        got = torch.autograd.grad((out.re, out.im), ts, lam_t)
        torch.cuda.synchronize()
        now = profiling.counters()
        assert (now["k2_forward"] - before["k2_forward"],
                now["k2_backward"] - before["k2_backward"]) == (1, 1)
        ref = tfp.fused_product_evolve_batched_plain(
            CP(cu[0], cu[1]), cu[2], cu[3], xq, N, kinds)
        _rel_close(out.re.detach().cpu().numpy(), ref.re.cpu().numpy(),
                   5e-5)
        gp, gth, gtx = tfp._adjoint_batched_plain(ref, CP(*lam_t), cu[2],
                                                  cu[3], xq, N, kinds)
        for a, b in zip(got, (gp.re, gp.im, gth, gtx)):
            _rel_close(a.cpu().numpy(), b.cpu().numpy(), 1e-4)
