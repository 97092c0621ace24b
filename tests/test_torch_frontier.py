"""The 19-24 qubit engine of the PyTorch port (K5) and the packed routes
end to end, against the JAX package on the CPU: K5's plain forward and
VJP against ``chunked_evolve_mega`` and ``chunked_evolve_mega_batched``
in interpret mode, and ``energy_and_grad`` and ``train_energy_seeds``
with the router forced onto the packed engines at 10 qubits, as the JAX
package's own tests force it (``tests/test_fused_packed.py``).

At 12 qubits the JAX engine's slabs are patched to 4 free row bits, so
that its pass B (rotations on the chunk bit) runs. Inputs come from a
seeded numpy generator. Tolerances: states atol 1e-5 and gradients 1e-4
of their max-norm (readings: states ~3e-7, gradients ~1e-6 relative);
the slice's value atol 5e-5 and gradient 1e-4 of its max-norm, and the
seeds' losses atol 5e-5, as the streamed slice's tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.dynamics import product as jprod
from diffquantum_tpu.gradients.adjoint import energy_and_grad as j_eag
from diffquantum_tpu.models import maxcut as jmaxcut
from diffquantum_tpu.ops import fused_chunked as jfc
from diffquantum_tpu.ops import linalg as jlinalg
from diffquantum_tpu.ops.cpx import CP as JCP
from diffquantum_tpu.parallel.mesh import train_energy_seeds as j_seeds
from diffquantum_tpu.train.config import TrainConfig as JConfig
from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.gradients.adjoint import energy_and_grad as t_eag
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.ops import fused_chunked as tfc
from diffquantum_tpu_torch.ops import fused_product as tfp
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.parallel import train_energy_seeds as t_seeds
from diffquantum_tpu_torch.train.config import TrainConfig as TConfig
from diffquantum_tpu_torch.utils import profiling

N = 12
D = 2**N
# X and Y on the chunk bit (qubit 0), a free row bit (3) and a lane bit
# (9), sharing qubits 0 and 9: a palindromic plan
XQ = (0, 3, 9, 0, 9, 9, 0, 9, 3, 0)
KINDS = ("x", "x", "y", "y", "x", "x", "y", "y", "x", "x")


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.fixture
def jax_slabs(monkeypatch):
    """The JAX engine at 12 qubits with 4 free row bits: _plan(12) is
    (1, 4), one chunk bit, so pass B runs."""
    jax.clear_caches()
    monkeypatch.setattr(jfc, "_F_BITS", 4)
    assert jfc._plan(N) == (1, 4)
    yield
    jax.clear_caches()


def _k5_inputs(n_steps, b, seed):
    rng = np.random.default_rng(seed)
    rows = [jlinalg.zz_diagonal(N, i, (i + 1) % N) for i in range(N)]
    rows.append(-2.0 * jlinalg.z_diagonal(N, 5))
    signs, _, _ = tfp.pack_diag_signs(rows)
    lead = () if b is None else (b,)
    psi = (rng.standard_normal((2,) + lead + (D,)) / np.sqrt(2 * D)
           ).astype(np.float32)
    ud = (0.2 * rng.standard_normal((n_steps,) + lead + (len(rows) + 1,))
          ).astype(np.float32)
    tx = (0.4 * rng.standard_normal((n_steps,) + lead + (len(XQ),))
          ).astype(np.float32)
    h0th = (0.1 * rng.standard_normal(D)).astype(np.float32)
    lam = rng.standard_normal((2,) + lead + (D,)).astype(np.float32)
    return psi, ud, tx, h0th, signs, lam


@pytest.mark.parametrize("form", ["single", "batched"])
def test_k5_plain_matches_jax_kernel(form, jax_slabs):
    b = None if form == "single" else 2
    psi, ud, tx, h0th, signs, lam = _k5_inputs(3, b, seed=5)
    jrun = jfc.chunked_evolve_mega if b is None \
        else jfc.chunked_evolve_mega_batched

    def f(p_re, p_im, u, t):
        out = jrun(JCP(p_re, p_im), u, t, jnp.asarray(h0th),
                   jnp.asarray(signs), XQ, N, KINDS)
        return out.re, out.im

    (j_re, j_im), vjp = jax.vjp(f, *(jnp.asarray(v) for v in
                                     (psi[0], psi[1], ud, tx)))
    jg = vjp((jnp.asarray(lam[0]), jnp.asarray(lam[1])))

    ts = [torch.tensor(v, requires_grad=True) for v in (psi[0], psi[1], ud,
                                                        tx)]
    trun = tfc.chunked_evolve_mega if b is None \
        else tfc.chunked_evolve_mega_batched
    out = trun(CP(ts[0], ts[1]), ts[2], ts[3], torch.tensor(h0th),
               torch.tensor(signs), XQ, N, KINDS)
    np.testing.assert_allclose(out.re.detach().numpy(), np.asarray(j_re),
                               atol=1e-5)
    np.testing.assert_allclose(out.im.detach().numpy(), np.asarray(j_im),
                               atol=1e-5)
    tg = torch.autograd.grad((out.re, out.im), ts,
                             (torch.tensor(lam[0]), torch.tensor(lam[1])))
    for name, a, want in zip(("dpsi_re", "dpsi_im", "dud", "dtheta_x"), tg,
                             jg):
        assert a.shape == want.shape, name
        _rel_close(a.numpy(), np.asarray(want), 1e-4)
    # the plain functions are what the autograd path runs on the CPU
    plain = tfc.chunked_evolve_mega_plain if b is None \
        else tfc.chunked_evolve_mega_batched_plain
    ref = plain(CP(*map(torch.tensor, psi)), *map(torch.tensor, (ud, tx,
                                                                 h0th,
                                                                 signs)),
                XQ, N, KINDS)
    assert torch.equal(ref.re, out.re.detach())
    gp, gud, gtx = tfc._adjoint_mega_plain(
        ref, CP(*map(torch.tensor, lam)), *map(torch.tensor, (ud, tx, h0th,
                                                             signs)),
        XQ, N, KINDS)
    for a, b_ in zip((gp.re, gp.im, gud, gtx), tg):
        torch.testing.assert_close(a, b_)
    launched = profiling.counters()
    assert launched["k5_forward"] == 0 and launched["k5_backward"] == 0


def test_k5_contract_checks():
    psi, ud, tx, h0th, signs, _ = _k5_inputs(2, None, seed=1)
    args = [torch.tensor(v) for v in (ud, tx, h0th, signs)]
    with pytest.raises(ValueError, match="up to 24 qubits"):
        tfc.chunked_evolve_mega(CP(*map(torch.tensor, psi)), *args, XQ, 25,
                                KINDS)
    with pytest.raises(ValueError, match="X and Y ops only"):
        tfc.chunked_evolve_mega(CP(*map(torch.tensor, psi)), *args,
                                (0, (1, 2)), N, ("x", "hop"))
    with pytest.raises(ValueError, match=r"psi0 \[d\]"):
        tfc.chunked_evolve_mega(CP(*(torch.tensor(v)[None] for v in psi)),
                                *args, XQ, N, KINDS)


# ---------------------------------------------------------------------------
# the slice end to end, with the packed routes forced at 10 qubits
# ---------------------------------------------------------------------------

SMALL = 10


@pytest.fixture(params=["packed", "mega"])
def forced(request, monkeypatch):
    """Both routers sent to K3 ('packed') or K5 ('mega') at 10 qubits:
    the packed band lowered to 0 qubits, and for 'mega' its K3 end too."""
    route = request.param
    jax.clear_caches()
    for mod in (jprod, tprod):
        monkeypatch.setattr(mod, "_PACKED_MIN_QUBITS", 0)
        if route == "mega":
            monkeypatch.setattr(mod, "_VMEM_PACKED_MAX", SMALL - 1)
    yield route
    jax.clear_caches()


def _problems(forced):
    """The 10q ring MaxCut in both packages, built after the routers are
    patched (both memoize the engine per Hamiltonian); T = 1 with
    omega = 2 pi keeps the chains short."""
    kw = dict(n_basis=4, omega0=2 * np.pi, omega1=2 * np.pi)
    jp = jmaxcut.build_maxcut(SMALL, jmaxcut.ring_graph(SMALL), dense=False,
                              dtype=jnp.float32, **kw)
    tp = tmaxcut.build_maxcut(SMALL, tmaxcut.ring_graph(SMALL),
                              device="cpu", **kw)
    assert jprod.select_engine(jp.ham) == tprod.select_engine(tp.ham) \
        == forced
    return jp, tp


def test_energy_and_grad_on_the_forced_route(forced):
    jp, tp = _problems(forced)
    coeff = (0.4 * np.random.default_rng(3).standard_normal(
        tp.envelope.coeff_shape)).astype(np.float32)
    jv, jg = j_eag(jp.ham, jp.envelope, jp.measurement, jnp.asarray(coeff),
                   jp.psi0, jp.T, 4, backend="product_fused")
    tv, tg = t_eag(tp.ham, tp.envelope, tp.measurement, torch.tensor(coeff),
                   tp.psi0, tp.T, 4, backend="product_fused")
    np.testing.assert_allclose(float(tv), float(jv), rtol=0, atol=5e-5)
    _rel_close(tg.numpy(), np.asarray(jg), 1e-4)
    # and the port's own eager engine agrees (independent code)
    ev, eg = t_eag(tp.ham, tp.envelope, tp.measurement, torch.tensor(coeff),
                   tp.psi0, tp.T, 4, backend="product")
    np.testing.assert_allclose(float(tv), float(ev), rtol=0, atol=5e-5)
    _rel_close(tg.numpy(), eg.numpy(), 1e-4)


def _jax_seed_init(envelope, cfg, n_seeds):
    """JAX's train_energy_seeds init draw, to hand the port the same
    start."""
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), n_seeds)
    return np.asarray(jax.vmap(lambda k: envelope.init_coeff(
        k, scale=1e-3, dtype=jnp.float32))(keys))


def test_train_energy_seeds_on_the_forced_route(forced):
    """2 seeds x 2 adjoint epochs from the same start: per-epoch per-seed
    losses (in f32 the coefficients are not compared: Adam turns the
    ~1e-6 relative gradient differences of near-zero components into
    steps of up to lr)."""
    jp, tp = _problems(forced)
    cfg = dict(n_epoch=2, lr=5e-2, per_step=2, seed=7, dtype="float32",
               backend="product_fused")
    init = _jax_seed_init(jp.envelope, JConfig(**cfg), 2)
    jr = j_seeds(jp.ham, jp.envelope, jp.measurement, jp.psi0, jp.T,
                 JConfig(**cfg), n_seeds=2)
    tr = t_seeds(tp.ham, tp.envelope, tp.measurement, tp.psi0, tp.T,
                 TConfig(**cfg), n_seeds=2, init_coeffs=torch.tensor(init))
    assert tr.losses.shape == jr.losses.shape == (2, 2)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=0, atol=5e-5)
    assert tr.best_seed == jr.best_seed
    launched = profiling.counters()
    assert launched["k3_forward"] == 0 and launched["k5_forward"] == 0
