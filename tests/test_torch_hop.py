"""The hop engine of the PyTorch port (K6) against the JAX package on the
CPU: the layout planner and its helpers, K6's per-step op rows, the
scaled-row pass plan that the card's kernels run (emulated here), and
K6's plain forward and VJP against ``chunked_evolve_mega_hop(_batched)``
in interpret mode.

At 10-12 qubits the production chunk plan has no chunk bits, so both
packages' ``_plan`` is patched the same way the JAX package's own tests
patch it (``tests/test_mega_hop.py::_force_small_chunk_plan``): 10
qubits get (c, f) = (1, 2), 12 qubits (2, 3). Inputs come from a seeded
numpy generator. Tolerances: states atol 1e-5; gradients 1e-4 of their
max-norm (the JAX kernel sums each slot's rows in another order)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.ops import fused_mega_hop as jmh
from diffquantum_tpu.ops.cpx import CP as JCP
from diffquantum_tpu_torch.ops import fused_chunked as tfc
from diffquantum_tpu_torch.ops import fused_mega_hop as tmh
from diffquantum_tpu_torch.ops import fused_product as tfp
from diffquantum_tpu_torch.ops.cpx import CP
from diffquantum_tpu_torch.utils import profiling
from test_torch_pk_plan import apply_passes


def _rel_close(got, want, rel):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def molecule_ops(n):
    """The molecule drive set's rotation ops in qubit space, in the
    router's order: X and Y on every qubit, then hops on (i, i+1) and
    (i, i+2); and the ZZ pairs (the same pairs)."""
    pairs = [(i, i + 1) for i in range(n - 1)] + \
        [(i, i + 2) for i in range(n - 2)]
    entries = tuple(q for q in range(n) for _ in (0, 1)) + tuple(pairs)
    kinds = ("x", "y") * n + ("hop",) * len(pairs)
    return entries, kinds, pairs


def to_positions(entries, perm):
    pos_of = tmh.invert_perm(perm)
    return tuple((min(pos_of[e[0]], pos_of[e[1]]),
                  max(pos_of[e[0]], pos_of[e[1]]))
                 if isinstance(e, tuple) else pos_of[e] for e in entries)


def force_small_plan(monkeypatch, f):
    """Both packages' chunk plan with ``f`` free row bits: real chunk
    bits at 10-12 qubits."""
    def plan(n_qubits):
        row_bits = n_qubits - 7
        ff = min(row_bits, f)
        return row_bits - ff, ff
    jax.clear_caches()
    monkeypatch.setattr(jmh, "_plan", plan)
    monkeypatch.setattr(tmh, "_plan", plan)


# ---------------------------------------------------------------------------
# (a) the layout planner and its helpers, identical to JAX's
# ---------------------------------------------------------------------------

def _graph(kind, n):
    if kind == "chain":
        return [(i, i + 1) for i in range(n - 1)] + \
            [(i, i + 2) for i in range(n - 2)]
    if kind == "ladder":  # two legs, rungs and legs
        half = n // 2
        return [(i, i + half) for i in range(half)] + \
            [(i, i + 1) for i in range(n - 1) if i + 1 != half]
    if kind == "random":
        rng = np.random.default_rng(n)
        return [(i, j) for i in range(n) for j in range(i + 1, n)
                if rng.random() < 0.15]
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


@pytest.mark.parametrize("n", [19, 20, 22, 24])
@pytest.mark.parametrize("graph", ["chain", "ladder", "random", "complete"])
def test_layout_planner_matches_jax(graph, n):
    pairs = _graph(graph, n)
    kinds = ("hop",) * len(pairs)
    warns = (lambda: pytest.warns(UserWarning)) if graph == "complete" \
        else contextlib.nullcontext
    with warns():
        got = tmh.plan_chunked_hop_layout(pairs, kinds, n)
    with warns():
        want = jmh.plan_chunked_hop_layout(pairs, kinds, n)
    assert got == want
    if graph == "complete":
        assert got is None
    else:
        assert sorted(got) == list(range(n))
    if graph == "chain":  # the molecule graph needs the relabelling
        assert got != tuple(range(n))


def test_layout_planner_identity_without_chunk_bits():
    pairs = _graph("chain", 17)
    assert tmh.plan_chunked_hop_layout(pairs, ("hop",) * len(pairs), 17) \
        == jmh.plan_chunked_hop_layout(pairs, ("hop",) * len(pairs), 17) \
        == tuple(range(17))
    assert tmh.plan_chunked_hop_layout(pairs, ("hop",) * len(pairs), 25) \
        is None


@pytest.mark.parametrize("perm", [(2, 0, 4, 1, 3), (0, 1, 2, 3, 4),
                                  "planner20"])
def test_permute_amplitude_bits_matches_jax(perm):
    if perm == "planner20":
        pairs = _graph("chain", 20)
        perm = tmh.plan_chunked_hop_layout(pairs, ("hop",) * len(pairs), 20)
    n = len(perm)
    x = np.random.default_rng(n).standard_normal((3, 2**n)).astype(
        np.float32)
    got = tmh.permute_amplitude_bits(torch.tensor(x), perm)
    want = np.asarray(jmh.permute_amplitude_bits(jnp.asarray(x), perm))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tmh.invert_perm(perm) == jmh.invert_perm(perm)
    back = tmh.permute_amplitude_bits(got, tmh.invert_perm(perm))
    np.testing.assert_array_equal(back.numpy(), x)


def test_relabel_mask_builds_the_permuted_planes():
    """Sign planes from relabelled parity masks equal the qubit-space
    planes with their amplitude bits permuted (what the JAX dispatcher
    does to the planes on every call)."""
    n = 10
    perm = (3, 0, 9, 1, 2, 8, 4, 5, 7, 6)
    masks = tuple((1 << (n - 1 - i)) | (1 << (n - 1 - j))
                  for i, j in _graph("chain", n))
    planes = tfp.signs_planes_device(masks, 2**n, "cpu")
    got = tfp.signs_planes_device(
        tuple(tmh.relabel_mask(m, perm, n) for m in masks), 2**n, "cpu")
    torch.testing.assert_close(got, tmh.permute_amplitude_bits(planes, perm))


# the molecule drive set's partition: (c, A ops, B ops, b_commute, rows
# per step)
_PARTITION = {19: (2, 65, 8, False, 146), 20: (3, 65, 12, False, 154),
              24: (7, 65, 28, False, 186)}


@pytest.mark.parametrize("n", [19, 20, 24])
def test_partition_and_rows_match_jax(n):
    """_assign_passes and b_commute equal JAX's on the relabelled
    molecule drive set, and K6's rows per step are A forward, B forward,
    B reversed, A reversed at half angle."""
    entries, kinds, pairs = molecule_ops(n)
    perm = tmh.plan_chunked_hop_layout(entries, kinds, n)
    pos = to_positions(entries, perm)
    c, f = tfc._plan(n)
    assert (c, f) == jmh._plan(n)
    a_idx, b_idx = tmh._assign_passes(pos, kinds, c, n)
    assert (a_idx, b_idx) == jmh._assign_passes(pos, kinds, c, n)
    b_commute = tmh._b_commute(pos, b_idx)
    assert b_commute == jmh._op_tables(pos, kinds, n, c, f)[4]
    assert (c, len(a_idx), len(b_idx), b_commute) == _PARTITION[n][:4]
    rows = tmh._hop_plan(pos, kinds, n)
    assert rows.shape == (_PARTITION[n][4], 5)
    ka, kb = len(a_idx), len(b_idx)
    assert list(rows[:ka, 0]) == a_idx and list(rows[-ka:, 0]) == a_idx[::-1]
    assert list(rows[ka:ka + kb, 0]) == b_idx
    assert list(rows[ka + kb:ka + 2 * kb, 0]) == b_idx[::-1]
    assert set(rows[:, 4]) == {1}  # every row at half angle
    # every row fits one of the pass kernels' op tables
    for planes in (2, 4):
        k, lc, desc, *_ = tfp._pass_layout(tuple(map(tuple, rows.tolist())),
                                           n, planes, len(pairs), len(pos))
        assert all(0 < r[2] <= tfp.MAX_OPS for r in desc)


def test_b_commute_rows_take_full_angle():
    n = 19
    pos = ((0, 1), (4, 9), (12, 17))  # tests/test_mega_hop.py's disjoint set
    kinds = ("hop",) * 3
    rows = tmh._hop_plan(pos, kinds, n)
    assert jmh._op_tables(pos, kinds, n, 2, 10)[4] is True
    # A (½) forward, B at full angle, A (½) reversed
    assert [tuple(r) for r in rows[:, [0, 4]]] == \
        [(1, 1), (2, 1), (0, 2), (2, 1), (1, 1)]


# ---------------------------------------------------------------------------
# (b) the scaled-row pass plan the card's kernels run, emulated
# ---------------------------------------------------------------------------

def _apply_passes(re, im, passes, table, n, k, lc, tx_row, k2=None):
    """One step's rows as the pass kernels apply them, round by round,
    each row by its scale times its slot's angle (see
    tests/test_torch_pk_plan.py::apply_passes)."""
    return apply_passes(re, im, passes, table, n, k, lc, tx_row, k2)


@pytest.mark.parametrize("n,f", [(12, 3), (14, 4)])
@pytest.mark.parametrize("planes", [2, 4])
def test_hop_pass_plan_applies_the_rows(n, f, planes, monkeypatch):
    """The molecule set's K6 rows grouped into tile, strided and cross
    passes give the rows' own product (f64, to rounding), and the slot
    table sends each slot's scaled partials, from every row of it, to its
    gradient."""
    force_small_plan(monkeypatch, f)
    entries, kinds, pairs = molecule_ops(n)
    pos = to_positions(entries, tmh.plan_chunked_hop_layout(entries, kinds,
                                                            n))
    rows = tmh._hop_plan(pos, kinds, n)
    n_x, n_diag = len(pos), len(pairs)
    k, lc, desc, table, slots, stride = tfp._pass_layout(
        tuple(map(tuple, rows.tolist())), n, planes, n_diag, n_x)
    k2 = tfp.pk_plan(n, planes, n_diag).k2
    passes, _ = tfp._pass_plan(rows, n, k, lc, k2)
    assert any(kd == tfp.PASS_CROSS for kd, _ in passes)
    rng = np.random.default_rng(n)
    re, im = (torch.tensor(rng.standard_normal(2**n)) for _ in range(2))
    tx_row = 0.7 * rng.standard_normal(n_x)
    want_re, want_im = re, im
    for op in rows:
        a = tfp._row_scale(op) * tx_row[int(op[0])]
        want_re, want_im = tfp._rot_plain(want_re, want_im, op, np.cos(a),
                                          np.sin(a), 2**n)
    got_re, got_im = _apply_passes(re, im, passes, table, n, k, lc, tx_row,
                                   k2)
    np.testing.assert_allclose(got_re.numpy(), want_re.numpy(), atol=1e-12)
    np.testing.assert_allclose(got_im.numpy(), want_im.numpy(), atol=1e-12)

    # the reduction: each block writes its row's scaled partial (here a
    # per-row value split over the blocks); reduce_partials sums every
    # location of a slot
    g_row = rng.standard_normal(len(table))
    part = np.zeros(stride)
    for i, (kind, first, count, blocks, off, width, *_) in enumerate(desc):
        for col in range(count):
            r = first + col
            part[off + np.arange(blocks) * width + col] = \
                tfp._row_scale(table[r]) * g_row[r] / blocks
    first, loc = slots[:n_x + 1], slots[n_x + 1:].reshape(-1, 4)
    got = np.zeros(n_x)
    for j in range(n_x):
        for o, blocks, width, col in loc[first[j]:first[j + 1]]:
            got[j] += part[o + np.arange(blocks) * width + col].sum()
    want = np.zeros(n_x)
    for r, op in enumerate(table):
        want[int(op[0])] += tfp._row_scale(op) * g_row[r]
    np.testing.assert_allclose(got, want, atol=1e-12)
    assert all(first[j + 1] - first[j] == np.sum(rows[:, 0] == j)
               for j in range(n_x))


# ---------------------------------------------------------------------------
# (c) K6's plain version against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------

def _k6_case(case):
    """(n, f, position entries, kinds, n_diag masks, steps, members)."""
    if case == "bcommute":
        # B ops on distinct positions (one sweep at full angle); A ops
        # share positions
        return (12, 3, ((0, 5), (1, 7), 3, 9, (4, 10), 4),
                ("hop", "hop", "x", "y", "hop", "x"), 3, None)
    n = 10 if case == "molecule10" else 12
    return (n, 2 if n == 10 else 3, None, None,
            1 if case == "t1" else 3, 2 if case == "batched" else None)


def _k6_inputs(case, monkeypatch):
    n, f, pos, kinds, n_steps, b = _k6_case(case)
    force_small_plan(monkeypatch, f)
    d = 2**n
    if pos is None:
        entries, kinds, pairs = molecule_ops(n)
        perm = tmh.plan_chunked_hop_layout(entries, kinds, n)
        assert perm == jmh.plan_chunked_hop_layout(entries, kinds, n)
        pos = to_positions(entries, perm)
        masks = [tmh.relabel_mask((1 << (n - 1 - i)) | (1 << (n - 1 - j)),
                                  perm, n) for i, j in pairs]
    else:
        masks = [(1 << (n - 1 - i)) | (1 << (n - 1 - j))
                 for i, j in (e for e in pos if isinstance(e, tuple))]
    signs = tfp.signs_planes_device(tuple(masks), d, "cpu").numpy()
    rng = np.random.default_rng(n + n_steps + (b or 0))
    lead = () if b is None else (b,)
    psi = (rng.standard_normal((2,) + lead + (d,)) / np.sqrt(2 * d)
           ).astype(np.float32)
    ud = (0.2 * rng.standard_normal((n_steps,) + lead + (len(masks) + 1,))
          ).astype(np.float32)
    tx = (0.4 * rng.standard_normal((n_steps,) + lead + (len(pos),))
          ).astype(np.float32)
    h0th = (0.1 * rng.standard_normal(d)).astype(np.float32)
    lam = rng.standard_normal((2,) + lead + (d,)).astype(np.float32)
    return n, pos, kinds, b, psi, ud, tx, h0th, signs, lam


@pytest.mark.parametrize("case", ["molecule10", "molecule12", "bcommute",
                                  "t1", "batched"])
def test_k6_plain_matches_jax_kernel(case, monkeypatch):
    n, pos, kinds, b, psi, ud, tx, h0th, signs, lam = _k6_inputs(
        case, monkeypatch)
    jrun = jmh.chunked_evolve_mega_hop if b is None \
        else jmh.chunked_evolve_mega_hop_batched

    def f(p_re, p_im, u, t):
        out = jrun(JCP(p_re, p_im), u, t, jnp.asarray(h0th),
                   jnp.asarray(signs), pos, n, kinds)
        return out.re, out.im

    (j_re, j_im), vjp = jax.vjp(f, *(jnp.asarray(v) for v in
                                     (psi[0], psi[1], ud, tx)))
    jg = vjp((jnp.asarray(lam[0]), jnp.asarray(lam[1])))

    ts = [torch.tensor(v, requires_grad=True) for v in (psi[0], psi[1], ud,
                                                        tx)]
    trun = tmh.chunked_evolve_mega_hop if b is None \
        else tmh.chunked_evolve_mega_hop_batched
    out = trun(CP(ts[0], ts[1]), ts[2], ts[3], torch.tensor(h0th),
               torch.tensor(signs), pos, n, kinds)
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
    plain = tmh.chunked_evolve_mega_hop_plain if b is None \
        else tmh.chunked_evolve_mega_hop_batched_plain
    args = tuple(map(torch.tensor, (ud, tx, h0th, signs)))
    ref = plain(CP(*map(torch.tensor, psi)), *args, pos, n, kinds)
    assert torch.equal(ref.re, out.re.detach())
    gp, gud, gtx = tmh._adjoint_mega_hop_plain(
        ref, CP(*map(torch.tensor, lam)), *args, pos, n, kinds)
    for a, b_ in zip((gp.re, gp.im, gud, gtx), tg):
        torch.testing.assert_close(a, b_)
    launched = profiling.counters()
    assert launched["k6_forward"] == 0 and launched["k6_backward"] == 0


def test_k6_contract_checks(monkeypatch):
    n, pos, kinds, _, psi, ud, tx, h0th, signs, _ = _k6_inputs(
        "molecule10", monkeypatch)
    p = CP(*map(torch.tensor, psi))
    args = [torch.tensor(v) for v in (ud, tx, h0th, signs)]
    with pytest.raises(ValueError, match="up to 24 qubits"):
        tmh.chunked_evolve_mega_hop(p, *args, pos, 25, kinds)
    with pytest.raises(ValueError, match=r"theta_x must be"):
        tmh.chunked_evolve_mega_hop(p, args[0],
                                    args[1][:, :-1].contiguous(), *args[2:],
                                    pos, n, kinds)
    with pytest.raises(ValueError, match="high-free boundary"):
        # a hop from a chunk position into the high-free band [c, 2c)
        tmh.chunked_evolve_mega_hop(p, *args, ((0, 1),) + pos[1:], n,
                                    ("hop",) + kinds[1:])
    with pytest.raises(ValueError, match=r"psi0 \[d\]"):
        tmh.chunked_evolve_mega_hop(CP(*(torch.tensor(v)[None]
                                         for v in psi)), *args, pos, n, kinds)


@pytest.mark.gpu
def test_k6_kernels_match_plain_on_card(monkeypatch):
    """K6's kernel pair (single and batched) against the plain versions
    on the card at 12 qubits with the small chunk plan (the full-size
    shapes run in chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pass kernels have no CPU mode")
    for case in ("molecule12", "batched"):
        n, pos, kinds, b, psi, ud, tx, h0th, signs, lam = _k6_inputs(
            case, monkeypatch)
        cu = [torch.tensor(v, device="cuda") for v in (psi[0], psi[1], ud,
                                                       tx, h0th, signs)]
        lam_c = [torch.tensor(v, device="cuda") for v in lam]
        ts = [t.clone().requires_grad_(True) for t in cu[:4]]
        entry = tmh.chunked_evolve_mega_hop if b is None \
            else tmh.chunked_evolve_mega_hop_batched
        out = entry(CP(ts[0], ts[1]), ts[2], ts[3], cu[4], cu[5], pos, n,
                    kinds)
        got = torch.autograd.grad((out.re, out.im), ts, lam_c)
        torch.cuda.synchronize()
        plain = tmh.chunked_evolve_mega_hop_plain if b is None \
            else tmh.chunked_evolve_mega_hop_batched_plain
        ref = plain(CP(cu[0], cu[1]), *cu[2:], pos, n, kinds)
        want = tmh._adjoint_mega_hop_plain(ref, CP(*lam_c), *cu[2:], pos, n,
                                           kinds)
        np.testing.assert_allclose(out.re.detach().cpu().numpy(),
                                   ref.re.cpu().numpy(), atol=1e-6)
        for a, w in zip(got, (want[0].re, want[0].im, want[1], want[2])):
            _rel_close(a.cpu().numpy(), w.cpu().numpy(), 1e-4)
