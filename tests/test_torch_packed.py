"""The packed-phase evolution of the PyTorch port (K3) against the JAX
package on the CPU: the sign-plane tables bit for bit, K3's
plain forward and VJP against the Pallas kernel in interpret mode (X, Y
and hop ops, B = 1 and 2, T = 1), the router's engine names at 10-25
qubits (hops at 18 and 19 included), and the pass plan that the card's
kernels run, emulated here.

Inputs are drawn once from a seeded numpy generator and handed to both
packages. Tolerances: states atol 1e-5; gradients 1e-4 of their max-norm
(readings at 10q, T=3: states ~2e-7, gradients ~1e-6 relative: sums over
2^n terms in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.dynamics import hamiltonian as jham
from diffquantum_tpu.dynamics import product as jprod
from diffquantum_tpu.ops import fused_product as jfp
from diffquantum_tpu.ops import linalg as jlinalg
from diffquantum_tpu.ops.cpx import CP as JCP
from diffquantum_tpu_torch.dynamics import hamiltonian as tham
from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.ops import fused_product as tfp
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.utils import profiling
from test_torch_pk_plan import apply_passes

N = 10
D = 2**N


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


# ---------------------------------------------------------------------------
# (a) the sign-plane tables
# ---------------------------------------------------------------------------

def _parity_rows(n):
    d = 2**n
    rows = [jlinalg.zz_diagonal(n, i, (i + 1) % n) for i in range(n)]
    rows += [3.5 * jlinalg.zz_diagonal(n, 2, 9) - 1.25, np.full(d, 0.75),
             -2.0 * jlinalg.z_diagonal(n, 5),
             jlinalg.z_diagonal(n, 1) * jlinalg.z_diagonal(n, 4)
             * jlinalg.z_diagonal(n, 7)]
    return rows


@pytest.mark.parametrize("case", ["parity", "projector", "two_planes",
                                  "empty"])
def test_pack_diag_signs_matches_jax(case):
    rng = np.random.default_rng(0)
    rows = {
        "parity": lambda: _parity_rows(N),
        "projector": lambda: [np.kron([1.0, 0.0], np.ones(D // 2)),
                              np.array([3.0] * D)],
        # 37 rows spill into a second plane (the 20q-molecule shape)
        "two_planes": lambda: [np.where(rng.random(8) < 0.5, -1.0, 1.0)
                               for _ in range(37)],
        "empty": lambda: [],
    }[case]()
    want, got = jfp.pack_diag_signs(rows), tfp.pack_diag_signs(rows)
    for a, b in zip(got, want):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_array_equal(a, np.asarray(b))
    if case == "two_planes":
        assert got[0].shape == (2, 8)


def test_pack_diag_signs_rejects_like_jax():
    three = [np.array([0.0, 1.0, 2.0, 1.0])]
    many = [np.array([1.0, -1.0])] * 121
    for rows in (three, many):
        assert tfp.pack_diag_signs(rows) is None
        assert jfp.pack_diag_signs(rows) is None
    bad = np.ones(D)
    bad[:3] = -1.0  # two-valued, not a parity set
    assert tfp.parity_sign_masks([bad]) is None
    assert tfp.pack_diag_signs([bad]) is not None


@pytest.mark.parametrize("n_rows", [14, 37])
def test_signs_planes_device_matches_jax(n_rows):
    """parity_sign_masks and the on-device planes, bit for bit the JAX
    package's (one plane, and two for 37 rows)."""
    rows = (_parity_rows(N) * 3)[:n_rows]
    t_par, j_par = tfp.parity_sign_masks(rows), jfp.parity_sign_masks(rows)
    assert t_par[0] == j_par[0]
    np.testing.assert_array_equal(t_par[1], j_par[1])
    np.testing.assert_array_equal(t_par[2], j_par[2])
    got = tfp.signs_planes_device(t_par[0], D, "cpu")
    want = np.asarray(jfp.signs_planes_device(j_par[0], D))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert tfp.signs_planes_device((), D, "cpu").shape == (1, D)


@pytest.mark.parametrize("n_steps", [1, 4])
def test_merge_ud_rows_matches_jax(n_steps):
    ud = np.random.default_rng(n_steps).standard_normal(
        (n_steps, 3, 5)).astype(np.float32)
    got = tfp.merge_ud_rows(torch.tensor(ud))
    want = np.asarray(jfp._merge_ud_rows_b(jnp.asarray(ud)))
    assert got.shape == want.shape == (n_steps + 1, 3, 6)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# (b) K3's plain version against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------

# X and Y share qubit 0 (palindromic, as _symmetrize_rots emits) and two
# hops, one of them across the tile boundary of the card's pass plan
PLANS = {
    "x": ((0, 4, 9), ("x",) * 3),
    "mixed": ((0, (2, 8), 3, 9, (1, 5), 0, 0, (1, 5), 9, 3, (2, 8), 0),
              ("x", "hop", "y", "y", "hop", "y", "y", "hop", "y", "y",
               "hop", "x")),
}


def _k3_inputs(plan, n_steps, b, seed):
    """psi [2, B, D], ud [T, B, n_diag+1], theta_x [T, B, n_x], h0th [D],
    sign planes [P, D] of the parity rows, and a cotangent [2, B, D]."""
    rng = np.random.default_rng(seed)
    xq, kinds = PLANS[plan]
    rows = _parity_rows(N)
    signs, _, _ = tfp.pack_diag_signs(rows)
    psi = (rng.standard_normal((2, b, D)) / np.sqrt(2 * D)).astype(np.float32)
    ud = (0.2 * rng.standard_normal((n_steps, b, len(rows) + 1))
          ).astype(np.float32)
    tx = (0.4 * rng.standard_normal((n_steps, b, len(xq)))).astype(np.float32)
    h0th = (0.1 * rng.standard_normal(D)).astype(np.float32)
    lam = rng.standard_normal((2, b, D)).astype(np.float32)
    return xq, kinds, psi, ud, tx, h0th, signs, lam


def _jax_k3_vjp(xq, kinds, psi, ud, tx, h0th, signs, lam):
    def f(p_re, p_im, u, t):
        out = jfp.fused_product_evolve_packed(
            JCP(p_re, p_im), u, t, jnp.asarray(h0th), jnp.asarray(signs), xq,
            N, kinds)
        return out.re, out.im

    out, vjp = jax.vjp(f, *(jnp.asarray(v) for v in (psi[0], psi[1], ud,
                                                     tx)))
    return out, vjp((jnp.asarray(lam[0]), jnp.asarray(lam[1])))


@pytest.mark.parametrize("plan,n_steps,b", [("mixed", 3, 1), ("mixed", 3, 2),
                                            ("x", 1, 2)])
def test_k3_plain_matches_jax_kernel(plan, n_steps, b):
    xq, kinds, psi, ud, tx, h0th, signs, lam = _k3_inputs(
        plan, n_steps, b, seed=10 * n_steps + b)
    (j_re, j_im), jg = _jax_k3_vjp(xq, kinds, psi, ud, tx, h0th, signs, lam)
    ts = [torch.tensor(v, requires_grad=True) for v in (psi[0], psi[1], ud,
                                                        tx)]
    out = tfp.fused_product_evolve_packed(
        CP(ts[0], ts[1]), ts[2], ts[3], torch.tensor(h0th),
        torch.tensor(signs), xq, N, kinds)
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
    # the explicit plain adjoint is the Function's CPU backward
    gp, gud, gtx = tfp._adjoint_packed_plain(
        CP(*(t.detach() for t in out)), CP(*map(torch.tensor, lam)),
        torch.tensor(ud), torch.tensor(tx), torch.tensor(h0th),
        torch.tensor(signs), xq, N, kinds)
    for a, b_ in zip((gp.re, gp.im, gud, gtx), tg):
        torch.testing.assert_close(a, b_)
    launched = profiling.counters()
    assert launched["k3_forward"] == 0 and launched["k3_backward"] == 0


def test_k3_wrapper_rejects_bad_inputs():
    xq, kinds, psi, ud, tx, h0th, signs, _ = _k3_inputs("x", 2, 2, seed=1)
    p = CP(*map(torch.tensor, psi))
    args = [torch.tensor(v) for v in (ud, tx, h0th, signs)]
    run = lambda u, t, h, s: tfp.fused_product_evolve_packed(  # noqa: E731
        p, u, t, h, s, xq, N, kinds)
    with pytest.raises(TypeError, match="int32"):
        run(*args[:3], args[3].to(torch.int64))
    with pytest.raises(ValueError, match="ud must be"):
        run(args[0][:, :1].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="signs"):
        run(args[0], args[1], args[2], args[3][:, :D // 2].contiguous())


# ---------------------------------------------------------------------------
# the card's pass plan, emulated on the CPU
# ---------------------------------------------------------------------------

def _apply_passes(re, im, passes, table, n, k, lc, tx_row, k2=None):
    """One step's ops as the pass kernels apply them (tile, middle,
    strided and cross passes, each pass round by round): see
    tests/test_torch_pk_plan.py::apply_passes."""
    return apply_passes(re, im, passes, table, n, k, lc, tx_row, k2)


@pytest.mark.parametrize("n,plan", [(10, "mixed"), (12, "ring"),
                                    (14, "ring")])
@pytest.mark.parametrize("planes", [2, 4])
def test_pass_plan_applies_the_plan(n, plan, planes):
    """The grouped passes (tile, strided, cross) with their local masks
    give the ordered plan's product, so the kernels' regrouping is exact
    (here in f64: to rounding)."""
    if plan == "ring":
        xq, kinds = tuple(range(n)) + (0,), ("x",) * n + ("y",)
    else:
        xq, kinds = PLANS[plan]
    ops = tfp._packed_plan(xq, kinds, n)
    k, lc, desc, table, slots, _ = tfp._pass_layout(
        tuple(map(tuple, ops.tolist())), n, planes, 4)
    geo = tfp.pk_plan(n, planes, 4)
    passes, _ = tfp._pass_plan(ops, n, k, lc, geo.k2)
    assert sorted(int(o[0]) for _, p in passes for o in p) \
        == list(range(len(ops)))
    assert len(desc) == len(passes) and desc[0][0] == tfp.PASS_TILE
    for kind, first, count, blocks, off, width, rbits, threads, stages \
            in desc:
        if kind != tfp.PASS_CROSS:
            g = geo.geom(kind)
            assert g.lb == tfp._pass_shape(kind, n, k, lc, geo.k2)[0]
            assert (rbits, threads) == (g.rbits, g.threads)
            # a pass of one round runs direct: no ring, more blocks
            assert (blocks, stages) in ((g.blocks, g.stages),
                                        (g.direct_blocks, 0))
            assert g.block_bytes <= tfp.SMEM_BLOCK  # ring + tables
    rng = np.random.default_rng(n)
    re, im = (torch.tensor(rng.standard_normal(2**n)) for _ in range(2))
    tx_row = 0.7 * rng.standard_normal(len(ops))
    want_re, want_im = re, im
    for op in ops:
        a = tx_row[int(op[0])]
        want_re, want_im = tfp._rot_plain(want_re, want_im, op, np.cos(a),
                                          np.sin(a), 2**n)
    got_re, got_im = _apply_passes(re, im, passes, table, n, k, lc, tx_row,
                                   geo.k2)
    np.testing.assert_allclose(got_re.numpy(), want_re.numpy(), atol=1e-12)
    np.testing.assert_allclose(got_im.numpy(), want_im.numpy(), atol=1e-12)
    if plan == "mixed":  # the hop (2, 8) spans the tile boundary
        assert any(kd == tfp.PASS_CROSS for kd, _ in passes)


@pytest.mark.parametrize("n", [18, 20, 24])
def test_tile_plan_at_the_frontier(n):
    """The ring MaxCut's plan is one tile and one strided pass per step at
    18 and 20 qubits and a tile, a middle and a strided pass at 24 (where
    two passes would hold one 128-256 KB tile a block); each block's ring
    stages (with the tile pass's sign plane and phase tables) and static
    tables fit the card's 227 KB of shared memory, and rows stay 32-byte
    segments or longer."""
    plan = tfp._packed_plan(tuple(range(n)), ("x",) * n, n)
    for planes in (2, 4):
        k, lc, desc, _, slots, stride = tfp._pass_layout(
            tuple(map(tuple, plan.tolist())), n, planes, n)
        geo = tfp.pk_plan(n, planes, n)
        # (qubit q is bit n-1-q: the ring's ops meet the high bits first)
        kinds = [tfp.PASS_TILE, tfp.PASS_STRIDED] if n < 24 else \
            [tfp.PASS_TILE, tfp.PASS_STRIDED, tfp.PASS_MID]
        assert [int(r[0]) for r in desc] == kinds
        assert [int(r[2]) for r in desc] == \
            [k, n - geo.k2] + ([geo.k2 - k] if n == 24 else [])
        for g in geo.passes:
            assert g.stages * 4 * g.words << g.lb \
                <= tfp.SMEM_BLOCK - tfp.PK_STATIC_BYTES[planes] - g.lut_bytes
        assert 4 << lc >= 32
        assert stride == sum(int(r[3]) * int(r[5]) for r in desc)
        assert int(desc[0][5]) == k + n + 1


# ---------------------------------------------------------------------------
# (d) the router against the JAX package's select_engine
# ---------------------------------------------------------------------------

def _min_hams(n, hop=False, rows=None):
    """(JAX, port) Hamiltonians of the ring MaxCut's shape: one ZZ row (or
    ``rows``) and X drives, optionally a hop."""
    d = 2**n
    if rows is None:
        rows = [jlinalg.zz_diagonal(n, 0, 1)]
    out = []
    for mod in (jham, tham):
        structure = [mod.TermStructure(kind="diag", diag=r) for r in rows]
        structure += [mod.TermStructure(kind="1q", qubit=0, local=jlinalg.X),
                      mod.TermStructure(kind="1q", qubit=n - 1,
                                        local=jlinalg.X)]
        if hop:
            structure.append(mod.TermStructure(kind="hop", qubit=1,
                                               qubit2=2))
        kw = dict(dtype=jnp.float32) if mod is jham else {}
        out.append(mod.ControlledHamiltonian.create_structured(
            d, tuple(structure),
            h0_structure=mod.TermStructure(kind="diag",
                                           diag=np.broadcast_to(0.0, (d,))),
            **kw))
    return out


@pytest.mark.parametrize("n", [10, 17, 18, 19, 21, 24, 25])
def test_router_matches_jax(n):
    rows = [np.broadcast_to(1.0, (2**n,))] if n > 24 else None
    jh, th = _min_hams(n, rows=rows)
    assert tprod.select_engine(th) == jprod.select_engine(jh)
    assert tprod.select_engine(th) == {10: "streamed", 17: "streamed",
                                       18: "packed", 25: "xla"}.get(n, "mega")


def test_router_hops_and_unpackable_rows_match_jax():
    jh, th = _min_hams(18, hop=True)
    assert tprod.select_engine(th) == jprod.select_engine(jh) == "packed"
    d = 2**18
    r = np.zeros(d)
    r[: d // 4] = 2.0
    r[d // 4: d // 2] = 1.0
    jh, th = _min_hams(18, rows=[r])
    assert tprod.select_engine(th) == jprod.select_engine(jh) == "xla"
    jh, th = _min_hams(19, hop=True)
    assert tprod.select_engine(th) == jprod.select_engine(jh) == "mega_hop"


@pytest.mark.gpu
def test_packed_kernels_match_plain_on_card():
    """The pass kernels (K3, and K5 single and batched) against the plain
    versions on the card at small sizes, with hops across the tile
    boundary (the full set of shapes runs in chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pass kernels have no CPU mode")
    from diffquantum_tpu_torch.ops import fused_chunked as tfc
    for plan, b in (("mixed", 2), ("x", 1)):
        xq, kinds, psi, ud, tx, h0th, signs, lam = _k3_inputs(plan, 3, b,
                                                              seed=2)
        cu = [torch.tensor(v, device="cuda") for v in (psi[0], psi[1], ud,
                                                       tx, h0th, signs)]
        lam_t = [torch.tensor(v, device="cuda") for v in lam]
        forms = [(tfp.fused_product_evolve_packed, cu, lam_t)]
        if plan == "x" and b == 1:  # K5's single and batched forms
            single = [cu[0][0], cu[1][0], cu[2][:, 0], cu[3][:, 0]] + cu[4:]
            forms += [(tfc.chunked_evolve_mega, single,
                       [lam_t[0][0], lam_t[1][0]]),
                      (tfc.chunked_evolve_mega_batched, cu, lam_t)]
        for entry, args, lam_c in forms:
            ts = [t.clone().requires_grad_(True) for t in args[:4]]
            out = entry(CP(ts[0], ts[1]), ts[2], ts[3], args[4], args[5], xq,
                        N, kinds)
            got = torch.autograd.grad((out.re, out.im), ts, lam_c)
            torch.cuda.synchronize()
            p = CP(args[0], args[1])
            if args[0].ndim == 1:
                ref = tfc.chunked_evolve_mega_plain(p, *args[2:], xq, N,
                                                    kinds)
                want = tfc._adjoint_mega_plain(ref, CP(*lam_c), *args[2:],
                                               xq, N, kinds)
            else:
                ref = tfp.fused_product_evolve_packed_plain(p, *args[2:], xq,
                                                            N, kinds)
                want = tfp._adjoint_packed_plain(ref, CP(*lam_c), *args[2:],
                                                 xq, N, kinds)
            np.testing.assert_allclose(out.re.detach().cpu().numpy(),
                                       ref.re.cpu().numpy(), atol=1e-6)
            for a, w in zip(got, (want[0].re, want[0].im, want[1], want[2])):
                _rel_close(a.cpu().numpy(), w.cpu().numpy(), 1e-4)
