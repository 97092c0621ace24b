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
# kMaxRBits; the TMA ring's kRingConsumers, kMaxRing) and CUDA's (grid y,
# grid x, block size)
KERNEL_THREADS, KERNEL_STAGES, KERNEL_RBITS = 512, 4, 5
RING_CONSUMERS, RING_STAGES = 256, 4
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
                    # direct, the TMA ring (the forward's staged passes
                    # that fit it) or the cp.async ring
                    ring = not one and g.ring_stages > 0
                    assert not ring or planes == 2
                    stages = 0 if one else (g.ring_stages if ring
                                            else g.stages)
                    assert tuple(int(v) for v in row[6:]) == (
                        g.rbits, g.threads, stages, int(ring))
                    assert blocks == (g.direct_blocks if one else
                                      g.ring_blocks if ring else g.blocks)
                else:
                    assert int(row[9]) == 0
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


def _ring_shares(blocks, pairs):
    """The contiguous member-major share of each TMA-ring block
    (pass_ring: [W g / G, W (g + 1) / G) of the W member x tile pairs)."""
    return [range(pairs * g // blocks, pairs * (g + 1) // blocks)
            for g in range(blocks)]


def _ring_box(kind, n, k, lc, k2, w):
    """pass_ring's ring_box: pair w's (member, tile) and its box (c0, c1)
    in the pass's 2-D view of the [B, d] state."""
    lb, lcp, k1, rb = tfp._pass_shape(kind, n, k, lc, k2)
    b, t = w >> (n - lb), w & ((1 << (n - lb)) - 1)
    if kind == tfp.PASS_TILE:
        return b, t, 0, (b << (n - 5)) + (t << (lb - 5))
    tl = k1 - lcp
    return b, t, (t & ((1 << tl) - 1)) << lcp, \
        (b << (n - k1)) + ((t >> tl) << rb)


@pytest.mark.parametrize("n", [18, 20, 24])
@pytest.mark.parametrize("members", [1, 3, 16, 80])
def test_ring_grid_covers_each_pair_once(n, members):
    """The forward's staged passes at 18-24 qubits run on the TMA ring,
    whose blocks' contiguous shares cover every (member, tile) pair of a
    pass exactly once, at most the card's blocks an SM times its SMs and
    no block idle; the backward keeps its ring."""
    geo = tfp.pk_plan(n, 2, n, members)
    for g in geo.passes:
        pairs = members * g.tiles
        assert g.ring_stages and g.ring_per_sm in (1, 2)
        assert g.ring_blocks == min(pairs, g.ring_per_sm * tfp.H100_SMS)
        shares = _ring_shares(g.ring_blocks, pairs)
        assert all(len(r) >= 1 for r in shares)
        assert [w for r in shares for w in r] == list(range(pairs))
    assert not any(g.ring_stages for g in tfp.pk_plan(n, 4, n,
                                                      members).passes)


@pytest.mark.parametrize("n", [18, 19, 20, 24])
@pytest.mark.parametrize("members", [1, 3, 16, 80])
def test_ring_fits_the_sm(n, members):
    """A TMA-ring block's buffers (aligned to the 1024-byte swizzle
    period), phase tables and static tables fit one block's 227 KB, and
    its blocks an SM fit the SM's 228 KB; its register bits are the
    kernel's (pass_ring<3..5>); its consumers are whole warps (one thread
    a group, at most 256) beside one producer warp, and the
    blocks an SM fit its threads and, at the kernel's launch bounds (two
    blocks of 288 threads at r <= 4, one above), its registers."""
    for g in tfp.pk_plan(n, 2, n, members).passes:
        assert g.ring_bytes == (g.ring_stages * 4 * g.words << g.lb) \
            + tfp.PK_RING_ALIGN + g.lut_bytes + tfp.PK_STATIC_BYTES[2]
        assert g.ring_bytes <= tfp.SMEM_BLOCK
        assert g.ring_per_sm * (g.ring_bytes + tfp.SMEM_RESERVED) \
            <= tfp.SMEM_SM
        assert g.threads % 32 == 0 and 3 <= g.rbits <= KERNEL_RBITS
        assert 1 << (g.lb - g.rbits) <= g.threads <= RING_CONSUMERS
        assert g.ring_per_sm <= (2 if g.rbits <= 4 else 1)
        assert g.ring_per_sm * (RING_CONSUMERS + 32) <= 2048


@pytest.mark.parametrize("n", [18, 20, 24])
@pytest.mark.parametrize("members", [1, 16, 80])
def test_ring_depth_overlaps_the_tiles(n, members):
    """Every staged forward pass at 18-24 qubits is on the ring, two to
    four buffers deep, so wherever a block has more than one tile the
    next one loads while this one's rounds run; direct passes (one
    round) stay off it."""
    plan = _ring_plan(n)
    geo = tfp.pk_plan(n, 2, n, members)
    _, _, desc, table, _, _ = tfp._pass_layout(
        tuple(map(tuple, plan.tolist())), n, 2, n, None, members)
    first = 0
    for row in desc:
        kind, count = int(row[0]), int(row[2])
        one = len(set(table[first:first + count, 5])) == 1
        first += count
        if kind == tfp.PASS_CROSS:
            continue
        assert int(row[9]) == (0 if one else 1)
        if not one:
            g = geo.geom(kind)
            assert 2 <= int(row[8]) <= RING_STAGES
            assert int(row[8]) == g.ring_stages
            if members * g.tiles > int(row[3]):
                assert max(map(len, _ring_shares(
                    int(row[3]), members * g.tiles))) > 1


@pytest.mark.parametrize("members,n_steps", [(1, 30), (1, 100), (16, 30),
                                             (80, 100)])
def test_ring_counter_reads_two_passes_a_step(members, n_steps):
    """The ``pk_forward_ring`` count of a 20q ring MaxCut forward chain
    (the benchmark's pk_ring_passes_per_epoch): 2T + 1, both passes of
    every step and the last stage's phase; none in the backward's table."""
    key = tuple(map(tuple, _ring_plan(20).tolist()))
    for planes, want in ((2, 2 * n_steps + 1), (4, 0)):
        desc = tfp._pass_layout(key, 20, planes, 20, None, members)[2]
        assert tfp.ring_passes(desc, n_steps) == want


@pytest.mark.parametrize("n", [12, 14])
@pytest.mark.parametrize("passes", [(2,), (3,)], indirect=True)
def test_ring_boxes_are_the_tiles(n, passes):
    """Each ring pair's box, read from the pass's 2-D view of a [B, d]
    state (a tile pass: 2^lb / 32 rows of 32 words; a middle or strided
    pass: 2^rb rows of 2^lcp words at a 2^k1 stride), holds the tile's
    amplitudes in its local order (amp_index), at B = 3, two and three
    passes a step (a tile pass of fewer than 2^8 words a plane stays off
    the ring)."""
    members = 3
    geo = tfp.pk_plan(n, 2, n, members)
    assert len(geo.passes) in passes
    flat = np.arange(members << n)
    assert any(g.ring_stages for g in geo.passes)
    for g in geo.passes:
        kind = {id(geo.tile): tfp.PASS_TILE, id(geo.mid): tfp.PASS_MID,
                id(geo.strided): tfp.PASS_STRIDED}[id(g)]
        if not g.ring_stages:  # a tile pass under 2^8 words a plane
            assert kind == tfp.PASS_TILE and g.lb < 8
            continue
        lb, lcp, k1, rb = tfp._pass_shape(kind, n, geo.k, geo.lc, geo.k2)
        l_ = np.arange(1 << lb)
        tl = k1 - lcp
        for w in range(members * g.tiles):
            b, t, c0, c1 = _ring_box(kind, n, geo.k, geo.lc, geo.k2, w)
            want = (b << n) + ((l_ & ((1 << lcp) - 1))
                               | ((t & ((1 << tl) - 1)) << lcp)
                               | ((l_ >> lcp) << k1) | ((t >> tl) << (k1 + rb)))
            if kind == tfp.PASS_TILE:
                box = flat.reshape(-1, 32)[c1:c1 + (1 << (lb - 5))]
            else:
                box = flat.reshape(-1, 1 << k1)[c1:c1 + (1 << rb),
                                                c0:c0 + (1 << lcp)]
            assert np.array_equal(box.reshape(-1), want)


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


# the forward's state error against the plain version on the card
# (chip_smoke.py's TOL_PK["fwd"])
TOL_PK_FWD = 1e-7


@pytest.mark.gpu
@pytest.mark.parametrize("members,n_steps", [(80, 100), (3, 30)])
def test_ring_forward_matches_plain_on_card(members, n_steps):
    """K5's batched forward, its staged passes on the TMA ring, against
    the plain version at the 20q MC cell's shape (the 80-branch batch,
    T = 100) and at B = 3 (264 blocks over 768 pairs a pass: shares that
    end inside a member), per-member rows; 2T + 1 passes on the ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pass kernels have no CPU mode")
    from diffquantum_tpu_torch.ops import fused_chunked as tfc
    from diffquantum_tpu_torch.ops.cpx import CP
    from diffquantum_tpu_torch.utils import profiling
    n = 20
    prob = tmaxcut.build_maxcut(n, tmaxcut.ring_graph(n), n_basis=6,
                                device="cuda")
    rng = np.random.default_rng(members)
    coeff = torch.tensor(0.4 * rng.standard_normal(
        (members,) + prob.envelope.coeff_shape), dtype=torch.float32,
        device="cuda")
    ud, tx, h0th, signs, qubits, kinds = tprod.packed_chain_inputs(
        prob.ham, prob.envelope, coeff, 0.0, prob.T, prob.T, n_steps)
    psi = CP(prob.psi0.re.expand(members, -1).contiguous(),
             prob.psi0.im.expand(members, -1).contiguous())
    ring0 = profiling.counters()["pk_forward_ring"]
    out = tfc.chunked_evolve_mega_batched(psi, ud, tx, h0th, signs, qubits,
                                          n, kinds)
    torch.cuda.synchronize()
    assert profiling.counters()["pk_forward_ring"] - ring0 == 2 * n_steps + 1
    ref = tfc.chunked_evolve_mega_batched_plain(psi, ud, tx, h0th, signs,
                                                qubits, n, kinds)
    for got, want in ((out.re, ref.re), (out.im, ref.im)):
        assert float((got - want).abs().max()) <= TOL_PK_FWD
