"""The pass kernels' launch plan (``ops.fused_product.pk_plan`` and
``_pass_layout``) on the CPU: the geometry that csrc/packed_phase.cu is
handed at 2-24 qubits, 2 and 4 state planes, B = 1 and 8, T = 1 and 30
(shared memory per block with its ring stages, phase tables and static
tables within the H100's 227 KB, row segments of 32 bytes wherever such
a split fits, threads, blocks and grids within CUDA's and the kernels'
limits, the tiles of every pass covering the state once, direct passes
exactly those of one round), the rounds of register bits the host groups
each pass's ops into, the plan's product emulated round by round at 4-12
qubits with two and three passes a step (f64, to rounding), and the
zero-drift flag.

``apply_passes`` is the kernels' index map and round structure in plain
PyTorch; tests/test_torch_packed.py and tests/test_torch_hop.py use it
for the K3/K5 and K6 op rows."""
import numpy as np
import pytest
import torch

from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.models import maxcut as tmaxcut
from diffquantum_tpu_torch.ops import fused_product as tfp

# the kernels' limits (csrc/packed_phase.cu: kMaxThreads, kMaxStages,
# kMaxRBits) and CUDA's (grid y, grid x, block size)
KERNEL_THREADS, KERNEL_STAGES, KERNEL_RBITS = 512, 4, 5
GRID_Y, GRID_X, BLOCK = 65535, 2**31 - 1, 1024


def _round_apply(br, bim, rows, mask, lbits, tx_row):
    """One round: every group of ``mask``'s bits (the other bits fixed)
    gathered into a [groups, 2^r] table, the rows applied with their
    masks relabelled to the group's bits, scattered back."""
    bits = [b for b in range(lbits) if mask >> b & 1]
    rest = [b for b in range(lbits) if not mask >> b & 1]
    g, i = torch.arange(2 ** len(rest)), torch.arange(2 ** len(bits))
    base = torch.zeros_like(g)
    for q, b in enumerate(rest):
        base = base + (((g >> q) & 1) << b)
    off = torch.zeros_like(i)
    for q, b in enumerate(bits):
        off = off + (((i >> q) & 1) << b)
    idx = base[:, None] + off[None, :]
    xr, xi = br[idx], bim[idx]
    for op in rows:
        # a bit outside the round's mask raises here (list.index)
        ma, mb = (1 << bits.index(int(op[c]).bit_length() - 1)
                  if int(op[c]) else 0 for c in (2, 3))
        a = tfp._row_scale(op) * tx_row[int(op[0])]
        xr, xi = tfp._rot_plain(xr, xi, (op[0], op[1], ma, mb, op[4]),
                                np.cos(a), np.sin(a), 2 ** len(bits))
    br, bim = br.clone(), bim.clone()
    br[idx], bim[idx] = xr, xi
    return br, bim


def apply_passes(re, im, passes, table, n, k, lc, tx_row, k2=None):
    """One step's op rows as the pass kernels apply them: each tile of a
    tile, middle or strided pass gathered by the kernels' index map
    (amp_index: columns, the tile's low part, rows from bit k1, the
    tile's high part), its pass's rows applied round by round (runs of
    rows sharing the round mask in the table's last column), scattered
    back; a cross pass applies its row to the whole state. A row rotates
    by its scale times its slot's angle."""
    row = 0
    for kind, ops in passes:
        local = table[row:row + len(ops)]
        row += len(ops)
        if kind == tfp.PASS_CROSS:
            for op in local:
                a = tfp._row_scale(op) * tx_row[int(op[0])]
                re, im = tfp._rot_plain(re, im, op, np.cos(a), np.sin(a),
                                        2**n)
            continue
        lbits, lcp, k1, rb = tfp._pass_shape(kind, n, k, lc, k2)
        tl = k1 - lcp
        re, im = re.clone(), im.clone()
        l_ = torch.arange(2**lbits)
        for t in range(tfp._pass_tiles(kind, n, k, lc, k2)):
            idx = (l_ & ((1 << lcp) - 1)) | ((t & ((1 << tl) - 1)) << lcp) \
                | ((l_ >> lcp) << k1) | ((t >> tl) << (k1 + rb))
            br, bim = re[idx], im[idx]
            start = 0
            while start < len(local):
                mask, end = int(local[start][5]), start
                while end < len(local) and int(local[end][5]) == mask:
                    end += 1
                br, bim = _round_apply(br, bim, local[start:end], mask,
                                       lbits, tx_row)
                start = end
            re[idx], im[idx] = br, bim
    return re, im


@pytest.fixture
def passes(request, monkeypatch):
    """The passes a step may take (PK_PASSES), the plan caches cleared
    around the test."""
    monkeypatch.setattr(tfp, "PK_PASSES", request.param)
    tfp.pk_plan.cache_clear()
    tfp._pass_layout.cache_clear()
    yield request.param
    tfp.pk_plan.cache_clear()
    tfp._pass_layout.cache_clear()


def _ring_plan(n):
    return tfp._packed_plan(tuple(range(n)) + (0,), ("x",) * n + ("y",), n)


def _fits_32_byte_rows(n, planes, n_diag):
    """Whether a split with rows of 8 columns fits: some k <= k2 <= n (two
    or three passes a step) whose tile (with its sign planes and phase
    tables) and middle and strided tiles each fit one block's shared
    memory and the kernels' 2^(lb - r) <= 512 groups."""
    static = tfp.PK_STATIC_BYTES[planes]
    signs = -(-n_diag // tfp.PLANE_BITS)
    max_lb = tfp.PK_MAX_RBITS[planes] + 9

    def fits(lb, words, extra=0):
        return 2 <= lb <= max_lb and \
            (4 * words << lb) + static + extra <= tfp.SMEM_BLOCK
    for k in range(3, n):
        for k2 in range(k, n + 1):
            if 1 + (k2 > k) + (k2 < n) not in tfp.PK_PASSES:
                continue
            if fits(k, planes + signs, signs * tfp.PK_LUT_BYTES) \
                    and (k2 == k or fits(k2 - k + 3, planes)) \
                    and (k2 == n or fits(n - k2 + 3, planes)):
                return True
    return False


@pytest.mark.parametrize("n", range(2, 25))
@pytest.mark.parametrize("planes", [2, 4])
def test_plan_fits_the_card(n, planes):
    for members in (1, 8):
        for n_steps in (1, 30):
            geo = tfp.pk_plan(n, planes, n, members)
            k, lc, desc, table, slots, stride = tfp._pass_layout(
                tuple(map(tuple, _ring_plan(n).tolist())), n, planes, n,
                None, members)
            assert (k, lc) == (geo.k, geo.lc) and k <= geo.k2 <= n
            kinds = [tfp.PASS_TILE] + ([tfp.PASS_MID] if geo.k2 > k else []) \
                + ([tfp.PASS_STRIDED] if geo.k2 < n else [])
            assert len(geo.passes) == len(kinds)
            assert len(kinds) in tfp.PK_PASSES or k == n
            signs = -(-n // tfp.PLANE_BITS)
            for kind in kinds:
                g = geo.geom(kind)
                assert g.lb == tfp._pass_shape(kind, n, k, lc, geo.k2)[0]
                # the block's ring, phase and static tables within 227 KB,
                # and its co-resident blocks within the SM's 228 KB
                assert g.block_bytes <= tfp.SMEM_BLOCK
                assert g.per_sm * (g.block_bytes + tfp.SMEM_RESERVED) \
                    <= tfp.SMEM_SM or g.per_sm == 1
                tile = kind == tfp.PASS_TILE
                assert g.stage_bytes == 4 * g.words << g.lb
                assert g.words == planes + (signs if tile else 0)
                assert g.lut_bytes == (tfp.PK_LUT_BYTES * signs if tile
                                       else 0)
                # threads, groups, stages, tiles and grid
                assert g.threads % 32 == 0
                assert 32 <= g.threads <= min(KERNEL_THREADS, BLOCK)
                assert 2 <= g.rbits <= min(KERNEL_RBITS, g.lb)
                assert g.rbits <= tfp.PK_MAX_RBITS[planes]
                assert g.threads >= 1 << (g.lb - g.rbits)
                assert 1 <= g.stages <= min(KERNEL_STAGES, tfp.PK_MAX_STAGES)
                assert 1 <= g.blocks <= g.tiles
                assert g.blocks <= g.direct_blocks <= g.tiles
                assert g.tiles << g.lb == 1 << n  # each amplitude once
                assert g.direct_blocks <= GRID_X and members <= GRID_Y
            if k < n and _fits_32_byte_rows(n, planes, n):
                assert geo.seg_bytes >= 32
            first = 0
            for row in desc:
                kind, count, blocks = int(row[0]), int(row[2]), int(row[3])
                assert 0 < count <= tfp.MAX_OPS and int(row[1]) == first
                if kind != tfp.PASS_CROSS:
                    g = geo.geom(kind)
                    one = len(set(table[first:first + count, 5])) == 1
                    assert tuple(int(v) for v in row[6:]) == (
                        g.rbits, g.threads, 0 if one else g.stages)
                    assert blocks == (g.direct_blocks if one else g.blocks)
                first += count
            # the backward's partials and the reduction's grid
            warps = n_steps * members * (n + 1) \
                + (n_steps + 1) * members * (n + 1)
            assert stride > 0 and (warps * 32 + 255) // 256 <= GRID_X


def test_plan_at_the_main_shapes():
    """24 qubits: a two-pass split would hold one 128-256 KB strided tile
    of y and lambda a block (16-byte rows), so the plan takes three passes
    a step, tile, middle and strided, of 2^12-amplitude tiles in rows of
    256 bytes, every pass two or more tiles resident per SM; 18 and 20
    qubits: two passes, every pass blocks enough for the card."""
    for planes in (2, 4):
        geo = tfp.pk_plan(24, planes, 24)
        assert (geo.k, geo.k2, geo.lc, geo.seg_bytes) == (12, 18, 6, 256)
        assert all(g.lb == 12 and g.resident >= 2 for g in geo.passes)
    for n in (18, 20):
        for planes in (2, 4):
            geo = tfp.pk_plan(n, planes, n)
            assert geo.mid is None and geo.seg_bytes >= 32
            assert min(g.blocks for g in geo.passes) >= 128


@pytest.mark.parametrize("rbits", [2, 4, 5])
def test_rounds_cover_their_ops(rbits):
    """Each op's bits lie in its round's mask of exactly rbits bits; a
    round ends only where the next op's bits would not fit."""
    rng = np.random.default_rng(rbits)
    lb = 11
    masks = []
    for _ in range(200):
        b = rng.choice(lb, size=rng.integers(1, 3), replace=False)
        masks.append(int(sum(1 << int(x) for x in b)))
    rounds = tfp._pass_rounds(masks, lb, rbits)
    assert len(rounds) == len(masks)
    for m, r in zip(masks, rounds):
        assert bin(r).count("1") == rbits and not m & ~r and r >> lb == 0
    starts = [0] + [i for i in range(1, len(masks))
                    if rounds[i] != rounds[i - 1]]
    for s, e in zip(starts, starts[1:] + [len(masks)]):
        used = 0
        for m in masks[s:e]:
            used |= m
        assert bin(used).count("1") <= rbits
        if e < len(masks):
            assert bin(used | masks[e]).count("1") > rbits


def _mixed_plan(n, k, k2):
    """X and Y on every qubit and hops inside the tile, across its
    boundary, across the middle's (k2 > k) and above it (qubit q is bit
    n-1-q), palindromic."""
    hops = [(n - 2, n - 1), (0, 1)]
    if 1 < k < n:
        hops.append((n - k - 1, n - 2))
    if k < k2 < n:
        hops.append((n - 1 - k2, n - k2))
    qubits = tuple(range(n)) + (0, n - 1) + tuple(hops)
    kinds = ("x",) * n + ("y", "y") + ("hop",) * len(hops)
    qubits, kinds = qubits + qubits[::-1], kinds + kinds[::-1]
    return tfp._packed_plan(qubits, kinds, n)


@pytest.mark.parametrize("n", [4, 6, 8, 10, 12])
@pytest.mark.parametrize("planes", [2, 4])
@pytest.mark.parametrize("passes", [(2,), (3,)], indirect=True)
def test_pass_layout_multiplies_out(n, planes, passes):
    """The passes and rounds of a mixed X/Y/hop plan (hops in, across and
    above the tile, and across the middle pass's bits) give the plan's
    own product, at B = 1 and 8, two or three passes a step."""
    rng = np.random.default_rng(n + planes)
    for members in (1, 8):
        geo = tfp.pk_plan(n, planes, n, members)
        assert len(geo.passes) in passes or geo.k == n
        ops = _mixed_plan(n, geo.k, geo.k2)
        k, lc, desc, table, _, _ = tfp._pass_layout(
            tuple(map(tuple, ops.tolist())), n, planes, n, None, members)
        grouped, local = tfp._pass_plan(ops, n, k, lc, geo.k2)
        assert [int(r[0]) for r in desc] == [kd for kd, _ in grouped]
        assert np.array_equal(table[:, :5], local)
        if geo.mid is not None:
            assert any(kd == tfp.PASS_MID for kd, _ in grouped)
        re, im = (torch.tensor(rng.standard_normal(2**n)) for _ in range(2))
        tx_row = 0.7 * rng.standard_normal(len(ops))
        want_re, want_im = re, im
        for op in ops:
            a = tx_row[int(op[0])]
            want_re, want_im = tfp._rot_plain(want_re, want_im, op,
                                              np.cos(a), np.sin(a), 2**n)
        got_re, got_im = apply_passes(re, im, grouped, table, n, k, lc,
                                      tx_row, geo.k2)
        np.testing.assert_allclose(got_re.numpy(), want_re.numpy(),
                                   atol=1e-12)
        np.testing.assert_allclose(got_im.numpy(), want_im.numpy(),
                                   atol=1e-12)


def test_zero_drift_flag():
    """The ring MaxCut has no drift: packed_chain_inputs hands out the
    cached zero h0th, which the kernels are told not to read; any other
    tensor, or that one once written, is read."""
    n = 10
    prob = tmaxcut.build_maxcut(n, tmaxcut.ring_graph(n), n_basis=3,
                                device="cpu")
    coeff = torch.zeros(prob.envelope.coeff_shape)
    _, _, h0th, *_ = tprod.packed_chain_inputs(
        prob.ham, prob.envelope, coeff, 0.0, prob.T, prob.T, 3)
    assert h0th is tfp.zero_drift(2**n, "cpu") and tfp._drift_flag(h0th) == 0
    assert tfp._drift_flag(torch.zeros(2**n)) == 1
    z = tfp.zero_drift(2**n, "cpu")
    z.add_(0.0)  # written in place: no longer known to be zero
    assert tfp._drift_flag(z) == 1
    tfp._ZERO_DRIFT.clear()
