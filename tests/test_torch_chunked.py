"""K4, the per-call packed-phase chain of the PyTorch port
(``ops/fused_chunked.py::chunked_evolve``), against the JAX package's
``chunked_evolve`` in interpret mode on the CPU: forward and VJP at 12
qubits, T = 1 (the sharded engine's call) and T = 4, with JAX's slabs
patched to 4 free row bits so that its pass B (the chunk-bit rotations)
runs, and once unpatched, where 12 qubits leave no chunk bit; plus the
entry point's contract checks.

Inputs come from a seeded numpy generator: ring ZZ sign planes and a Z
field, X and Y drives sharing qubits (a palindromic plan). Tolerances:
states atol 1e-5, gradients 1e-4 of their max-norm (the K5 tests'
limits, tests/test_torch_frontier.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.ops import fused_chunked as jfc
from diffquantum_tpu.ops import linalg as jlinalg
from diffquantum_tpu.ops.cpx import CP as JCP
from diffquantum_tpu_torch.ops import fused_chunked as tfc
from diffquantum_tpu_torch.ops import fused_product as tfp
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.utils import profiling

N = 12
D = 2**N
# X and Y on the chunk bit (qubit 0 with 4 free row bits), a free row bit
# (3) and a lane bit (9), in palindromic order
XQ = (0, 3, 9, 0, 9, 9, 0, 9, 3, 0)
KINDS = ("x", "x", "y", "y", "x", "x", "y", "y", "x", "x")


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _inputs(n_steps, seed):
    rng = np.random.default_rng(seed)
    rows = [jlinalg.zz_diagonal(N, i, (i + 1) % N) for i in range(N)]
    rows.append(-2.0 * jlinalg.z_diagonal(N, 5))
    signs, _, _ = tfp.pack_diag_signs(rows)
    psi = (rng.standard_normal((2, D)) / np.sqrt(2 * D)).astype(np.float32)
    ud = (0.2 * rng.standard_normal((n_steps, len(rows) + 1))
          ).astype(np.float32)
    tx = (0.4 * rng.standard_normal((n_steps, len(XQ)))).astype(np.float32)
    h0th = (0.1 * rng.standard_normal(D)).astype(np.float32)
    lam = rng.standard_normal((2, D)).astype(np.float32)
    return psi, ud, tx, h0th, signs, lam


@pytest.mark.parametrize("n_steps,f_bits", [(1, 10), (1, 4), (4, 4)],
                         ids=["T1_no_chunk_bits", "T1_pass_B", "T4_pass_B"])
def test_k4_plain_matches_jax_kernel(n_steps, f_bits, monkeypatch):
    jax.clear_caches()
    monkeypatch.setattr(jfc, "_F_BITS", f_bits)
    assert jfc._plan(N) == ((0, 5) if f_bits == 10 else (1, 4))
    psi, ud, tx, h0th, signs, lam = _inputs(n_steps, seed=40 + n_steps)

    def f(p_re, p_im, u, t):
        out = jfc.chunked_evolve(JCP(p_re, p_im), u, t, jnp.asarray(h0th),
                                 jnp.asarray(signs), XQ, N, KINDS)
        return out.re, out.im

    (j_re, j_im), vjp = jax.vjp(f, *(jnp.asarray(v) for v in
                                     (psi[0], psi[1], ud, tx)))
    jg = vjp((jnp.asarray(lam[0]), jnp.asarray(lam[1])))
    jax.clear_caches()

    ts = [torch.tensor(v, requires_grad=True)
          for v in (psi[0], psi[1], ud, tx)]
    before = profiling.counters()
    out = tfc.chunked_evolve(CP(ts[0], ts[1]), ts[2], ts[3],
                             torch.tensor(h0th), torch.tensor(signs), XQ, N,
                             KINDS)
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
    args = [torch.tensor(v) for v in (ud, tx, h0th, signs)]
    ref = tfc.chunked_evolve_plain(CP(*map(torch.tensor, psi)), *args, XQ,
                                   N, KINDS)
    assert torch.equal(ref.re, out.re.detach())
    gp, gud, gtx = tfc._adjoint_chunked_plain(
        ref, CP(*map(torch.tensor, lam)), *args, XQ, N, KINDS)
    for a, b in zip((gp.re, gp.im, gud, gtx), tg):
        torch.testing.assert_close(a, b)
    now = profiling.counters()
    assert (now["k4_forward"], now["k4_backward"]) == \
        (before["k4_forward"], before["k4_backward"])  # CPU: plain


def test_k4_equals_k5_chain():
    """K4 computes K5's function: at T = 4 their plain chains agree to
    the last bit on the CPU."""
    psi, ud, tx, h0th, signs, _ = _inputs(4, seed=7)
    args = [torch.tensor(v) for v in (ud, tx, h0th, signs)]
    p = CP(*map(torch.tensor, psi))
    a = tfc.chunked_evolve(p, *args, XQ, N, KINDS)
    b = tfc.chunked_evolve_mega(p, *args, XQ, N, KINDS)
    assert torch.equal(a.re, b.re) and torch.equal(a.im, b.im)


def test_k4_contract_checks():
    psi, ud, tx, h0th, signs, _ = _inputs(2, seed=1)
    p = CP(*map(torch.tensor, psi))
    args = [torch.tensor(v) for v in (ud, tx, h0th, signs)]
    with pytest.raises(ValueError, match="up to 24 qubits"):
        tfc.chunked_evolve(p, *args, XQ, 25, KINDS)
    with pytest.raises(ValueError, match="X and Y ops only"):
        tfc.chunked_evolve(p, *args, (0, (1, 2)), N, ("x", "hop"))
    with pytest.raises(ValueError, match=r"psi0 \[d\]"):
        tfc.chunked_evolve(CP(p.re[None], p.im[None]), *args, XQ, N, KINDS)
    # a rank's slice of two sign planes along d is a strided view
    half = torch.tensor(signs).repeat(2, 1)[:, : D // 2]
    assert not half.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        tfc.chunked_evolve(CP(p.re[: D // 2], p.im[: D // 2]), *args[:2],
                           args[2][: D // 2], half, XQ, N - 1, KINDS)
    with pytest.raises(TypeError, match="float32"):
        tfc.chunked_evolve(CP(p.re.double(), p.im.double()), *args, XQ, N,
                           KINDS)
