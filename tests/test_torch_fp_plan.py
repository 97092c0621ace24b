"""K1/K2's launch plan (``ops.fused_product.fp_plan``) on the CPU: the
geometry csrc/fused_product.cu is handed at 2-17 qubits (10-17 planned,
below refused), B = 1, 3, 64 and 3072 with per-member and grouped rows,
forward and backward (threads, blocks, shared memory and registers
within the H100's limits; several K2 members on an SM at 12 qubits; a
grid's members in chunks whose blocks are all resident), the host table
the kernels read, the rounds (every op in exactly one, in plan order, its bits in
the round's lanes or registers), the layouts (each a bijection onto the
state; a step's exchanges start and end at the phase layout), and the
chain emulated round by round as the kernels run it: register slots and
lanes gathered by each round's index map, ops applied at their planned
locations, exchanges between layouts, phases in the last round's layout.
The emulation equals the plain versions in f64 to rounding (the 12-qubit
ring, chip_smoke's mixed X/Y/hop plan in one block and, forced, on a
grid of two blocks, a 15-qubit hop plan on a grid) and the JAX package's kernel, run in interpret
mode on the CPU as its own tests run it, at 10 qubits in f32 to 5e-5 on
the state (the JAX package's fused-vs-XLA tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffquantum_tpu.ops import fused_product as jfp
from diffquantum_tpu.ops.cpx import CP as JCP
from diffquantum_tpu_torch.dynamics import product as tprod
from diffquantum_tpu_torch.ops import fused_product as tfp

# the H100 (sm_90) and the kernels' limits (csrc/fused_product.cu)
SMEM_BLOCK, SM_REGS, BLOCK = 232448, 65536, 1024
KERNEL_ROUNDS = 128


def _ring(n):
    return tfp._plan_ops(tuple(range(n)), ("x",) * n, n)


def _mixed(n, n_steps, seed):
    """chip_smoke.mixed_chain's plan: X on every qubit, Y and hops sharing
    qubits, made palindromic as the engine makes it."""
    rng = np.random.default_rng(seed)
    qubits = tuple(range(n)) + (0, 5, (1, 2), (3, 9), (0, n - 1))
    kinds = ("x",) * n + ("y", "y", "hop", "hop", "hop")
    tx = torch.tensor(rng.standard_normal((n_steps, len(qubits))))
    qubits, kinds, tx = tprod._symmetrize_rots(qubits, kinds, tx, dim=1)
    return tfp._plan_ops(qubits, kinds, n), tx


def _hop15():
    """A 15-qubit drive set: X on every qubit, hops on neighbours and
    across the lane boundary, Y on a few."""
    n = 15
    qubits = tuple(range(n)) + tuple((i, i + 1) for i in range(0, 14, 2)) \
        + ((0, 14), (3, 12), (9, 13), (11, 12)) + (7, 11, 14)
    kinds = ("x",) * n + ("hop",) * 11 + ("y",) * 3
    return tfp._plan_ops(qubits, kinds, n)


def _key(plan):
    return tuple(map(tuple, plan.tolist()))


def _pdep(v, mask):
    out, b = torch.zeros_like(v), 0
    for bit in range(mask.bit_length()):
        if mask >> bit & 1:
            out |= ((v >> b) & 1) << bit
            b += 1
    return out


def layout_index(geo, rd):
    """The kernels' index map of a round: [threads of the member, 2^4 x 32]
    (a thread of block rank r, warp w; local slot i * 32 + lane)."""
    high = ((1 << geo.n) - 1) & ~31
    warps = geo.threads // 32
    t = torch.arange(geo.blocks * warps)[:, None]
    rank, warp = t // warps, t % warps
    loc = torch.arange(32 << geo.rbits)[None, :]
    slot, lane = loc >> 5, loc & 31
    return lane | _pdep(warp, high & ~rd.reg & ~rd.blk) \
        | _pdep(rank, rd.blk) | _pdep(slot, rd.reg)


def _local_row(geo, o):
    """Op row o with its masks in the local index space (lane bits 0-4,
    register rank r at bit 5 + r)."""
    slot, kind, a, b = geo.ops[o]
    mask = lambda v: 0 if v < 0 else (  # noqa: E731
        1 << (v - tfp.FP_LOC_LANE) if v >= tfp.FP_LOC_LANE else 1 << (5 + v))
    return (slot, kind, mask(a), mask(b))


def _rounds(geo, backward):
    rng = range(len(geo.rounds))
    return reversed(rng) if backward else rng


def emulate_forward(geo, re, im, th, tx):
    """K1's forward as the plan runs it, on one state [d]."""
    a = tfp.merge_phase_rows(th)
    last = geo.rounds[-1]
    P = layout_index(geo, last)
    x = [re[P], im[P]]
    local = 32 << geo.rbits
    for k in range(th.shape[0] + 1):
        c, s = torch.cos(a[k][P]), torch.sin(a[k][P])
        x = [c * x[0] + s * x[1], c * x[1] - s * x[0]]
        if k == th.shape[0]:
            break
        cur = last
        for r in _rounds(geo, False):
            rd = geo.rounds[r]
            if (rd.reg, rd.blk) != (cur.reg, cur.blk):
                x = _exchange(geo, x, cur, rd, re.shape[0])
                cur = rd
            for o in range(rd.begin, rd.begin + rd.count):
                row = _local_row(geo, o)
                th_o = tx[k, row[0]]
                x = list(tfp._rot_plain(x[0], x[1], row, torch.cos(th_o),
                                        torch.sin(th_o), local))
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    out_re[P], out_im[P] = x
    return out_re, out_im


def emulate_adjoint(geo, y_re, y_im, l_re, l_im, th, tx):
    """K1's backward as the plan runs it: (dpsi0 re, im, d theta_half,
    d theta_x)."""
    n_steps, d = th.shape
    a = tfp.merge_phase_rows(th)
    last = geo.rounds[-1]
    P = layout_index(geo, last)
    x = [v[P] for v in (y_re, y_im, l_re, l_im)]
    local = 32 << geo.rbits
    gth = torch.zeros_like(th)
    gtx = torch.zeros_like(tx)
    gprev = None
    for k in range(n_steps, -1, -1):
        if k < n_steps:
            cur = last
            for r in _rounds(geo, True):
                rd = geo.rounds[r]
                if (rd.reg, rd.blk) != (cur.reg, cur.blk):
                    x = _exchange(geo, x, cur, rd, d)
                    cur = rd
                for o in range(rd.begin + rd.count - 1, rd.begin - 1, -1):
                    row = _local_row(geo, o)
                    th_o = tx[k, row[0]]
                    *x, g = tfp._undo_rot_plain(*x, row, torch.cos(th_o),
                                                torch.sin(th_o), local)
                    gtx[k, row[0]] = g.sum()
            if (cur.reg, cur.blk) != (last.reg, last.blk):
                x = _exchange(geo, x, cur, last, d)
        c, s = torch.cos(a[k][P]), torch.sin(a[k][P])
        y0, y1, l0, l1 = x
        g = l0 * y1 - l1 * y0
        if k < n_steps:
            gth[k][P] = g + gprev
        gprev = g
        x = [c * y0 - s * y1, s * y0 + c * y1, c * l0 - s * l1,
             s * l0 + c * l1]
    out = [torch.empty_like(y_re), torch.empty_like(y_im)]
    out[0][P], out[1][P] = x[2], x[3]
    return out[0], out[1], gth, gtx


def _exchange(geo, x, frm, to, d):
    """Every thread writes its amplitudes in index order, reads the new
    layout's."""
    src, dst = layout_index(geo, frm), layout_index(geo, to)
    out = []
    for v in x:
        buf = torch.full((d,), float("nan"), dtype=v.dtype)
        buf[src] = v
        out.append(buf[dst])
    return out


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(2, 18))
@pytest.mark.parametrize("backward", [False, True])
def test_plan_fits_the_card(n, backward):
    if n < tfp.MIN_QUBITS:
        with pytest.raises(ValueError):
            tfp.fp_plan(n, _key(_ring(max(n, 1))), 1, 1, 132, backward)
        return
    for plan in (_ring(n), _mixed(n, 1, 0)[0]):
        for b, g in ((1, 1), (3, 3), (3, 1), (64, 64), (64, 8),
                     (3072, 64)):
            geo = tfp.fp_plan(n, _key(plan), b, g, 132, backward)
            d, rb = 1 << n, geo.rbits
            assert geo.launches * geo.chunk >= b > (geo.launches - 1) \
                * geo.chunk
            assert rb in tfp.FP_RBITS
            assert geo.threads * geo.blocks << rb == d
            assert 32 <= geo.threads <= BLOCK
            assert geo.threads & (geo.threads - 1) == 0
            assert geo.threads <= tfp.FP_MAX_THREADS[backward, rb]
            regs = tfp.FP_GRID_REGS if geo.mode == "grid" else \
                tfp.FP_REGS[backward, rb]
            assert geo.threads * regs * geo.per_sm <= SM_REGS
            assert geo.smem + tfp.FP_STATIC_BYTES <= SMEM_BLOCK
            assert geo.per_sm >= 1 and geo.grid == geo.chunk * geo.blocks
            assert len(geo.rounds) <= KERNEL_ROUNDS
            assert geo.xplanes in ((2, 4) if backward else (2,))
            if geo.mode == "block":
                assert geo.blocks == 1 and geo.bufs in (1, 2)
                assert geo.chunk == b
            else:  # every block of a cooperative launch resident
                assert geo.mode == "grid" and geo.bufs == 1 and rb == 3
                assert geo.grid <= geo.per_sm * 132
            exch = 0 if geo.mode == "grid" else \
                4 * geo.xplanes * (d // geo.blocks) * geo.bufs
            ring = (12 if backward else 8) * geo.threads << rb
            tables = len(plan) * 12 + len(geo.rounds) * 4
            assert geo.smem == exch + geo.threads // 32 * tables + ring
            assert geo.warp_bits + geo.block_bits + rb + 5 == n
            for rd in geo.rounds:
                assert bin(rd.reg).count("1") == rb
                assert bin(rd.blk).count("1") == geo.block_bits
                assert not rd.reg & rd.blk and not (rd.reg | rd.blk) & 31
    # one block a member up to 13 qubits forward and 12 backward; past
    # that a cooperative grid of 256-thread blocks for one chain
    geo = tfp.fp_plan(n, _key(_ring(n)), 1, 1, 132, backward)
    assert geo.rbits == 3
    assert geo.mode == ("block" if n <= (12 if backward else 13) else "grid")


@pytest.mark.parametrize("n_steps", [1, 30])
@pytest.mark.parametrize("backward", [False, True])
def test_several_members_an_sm(n_steps, backward):
    """K2 at 12 qubits: 3 forward or 2 backward members resident an SM,
    B = 3072 in ~8-12 waves, not 23; the backward's partial scratch is
    small beside the state."""
    geo = tfp.fp_plan(12, _key(_ring(12)), 3072, 64, 132, backward)
    assert geo.threads == 256 and geo.per_sm == (2 if backward else 3)
    assert -(-3072 // (geo.per_sm * 132)) <= 12
    part = 3072 * n_steps * 12 * geo.warps
    assert part <= 3072 * (1 << 12) * n_steps // 8
    one = tfp.fp_plan(12, _key(_ring(12)), 1, 1, 132, backward)
    assert one.rbits == 3 and one.threads == 512
    assert one.bufs == 2 and one.exchanges == 3


@pytest.mark.parametrize("n", [15, 16, 17])
@pytest.mark.parametrize("backward", [False, True])
def test_grid_mode_fits(n, backward):
    """Past one block a member: a cooperative grid of 256-thread blocks,
    every block resident (B = 1, and chip_smoke's B = 8 at 16 qubits and
    B = 4 at 17, each one launch)."""
    for b in (1, 8 if n == 16 else 4):
        geo = tfp.fp_plan(n, _key(_ring(n)), b, b, 132, backward)
        assert geo.mode == "grid" and geo.threads == 256 and geo.bufs == 1
        assert geo.grid <= geo.per_sm * 132 and geo.launches == 1
        ring = (12 if backward else 8) * geo.threads << geo.rbits
        tables = n * 12 + len(geo.rounds) * 4
        assert geo.smem == geo.threads // 32 * tables + ring


@pytest.mark.parametrize("n,b,g", [(14, 64, 64), (14, 136, 136),
                                   (16, 16, 16), (17, 8, 8), (17, 3072, 64)])
@pytest.mark.parametrize("backward", [False, True])
def test_grid_chunks(n, b, g, backward):
    """A batch whose grid blocks are not all resident goes in the fewest
    launches whose blocks are, of equal chunks of members (the last one
    no larger)."""
    geo = tfp.fp_plan(n, _key(_ring(n)), b, g, 132, backward)
    assert geo.mode == "grid" and geo.rbits == 3
    fit = geo.per_sm * 132 // geo.blocks
    assert b > fit and geo.chunk <= fit
    assert geo.launches == -(-b // fit)
    assert geo.chunk == -(-b // geo.launches)


def test_launch_record(monkeypatch):
    """The host table csrc/fused_product.cu checks and launches from:
    the header, the op rows and the rounds; one record a plan, shapes,
    direction and device, built once."""
    monkeypatch.setattr(tfp, "_sm_count", lambda device: 132)
    monkeypatch.setattr(tfp, "_FP_RECORDS", {})
    plan, _ = _mixed(14, 1, 2)
    th, tx = torch.zeros(30, 8, 1 << 14), torch.zeros(30, 4, len(plan))
    rec = tfp._fp_launch(plan, 14, th, tx, 64, True, torch.device("cpu"))
    assert tfp._fp_launch(plan, 14, th, tx, 64, True,
                          torch.device("cpu")) is rec
    geo, ops, host, addr = rec
    assert addr == host.ctypes.data and host.dtype == np.int32
    assert geo == tfp.fp_plan(14, _key(plan), 64, 8, 132, True)
    head = (14, 30, len(plan), len(geo.rounds), 64, 8, 4, 3, 1, 256, 8, 1,
            4, geo.smem, 32)
    assert tuple(host[:15]) == head
    rows = host[15:15 + 4 * len(plan)].reshape(-1, 4)
    assert torch.equal(ops, torch.tensor(rows))
    assert [tuple(r) for r in rows] == list(geo.ops)
    assert [tuple(r) for r in host[15 + 4 * len(plan):].reshape(-1, 4)] \
        == [(r.begin, r.count, r.reg, r.blk) for r in geo.rounds]
    fwd = tfp._fp_launch(plan, 14, th[:1], tx[:1], 64, False,
                         torch.device("cpu"))
    assert fwd is not rec and fwd[2][1] == 1 and len(tfp._FP_RECORDS) == 2


def _plans():
    return {"12q ring": _ring(12), "12q mixed": _mixed(12, 1, 3)[0],
            "15q hops": _hop15(), "17q ring": _ring(17)}


@pytest.mark.parametrize("name", ["12q ring", "12q mixed", "15q hops",
                                  "17q ring"])
@pytest.mark.parametrize("backward", [False, True])
def test_rounds_cover_their_ops(name, backward):
    plan = _plans()[name]
    n = int(name[:2])
    geo = tfp.fp_plan(n, _key(plan), 1, 1, 132, backward)
    nxt = 0
    for rd in geo.rounds:  # contiguous, in plan order, each op once
        assert rd.begin == nxt and rd.count >= 0
        nxt += rd.count
        for o in range(rd.begin, rd.begin + rd.count):
            slot, kind, a, b = geo.ops[o]
            assert (slot, kind) == tuple(plan[o][:2])
            for loc, mask in ((a, int(plan[o][2])), (b, int(plan[o][3]))):
                if mask == 0:
                    assert loc == -1
                elif loc >= tfp.FP_LOC_LANE:   # a lane bit
                    assert mask == 1 << (loc - tfp.FP_LOC_LANE) < 32
                else:                          # its rank among the reg bits
                    bits = [1 << i for i in range(n) if rd.reg >> i & 1]
                    assert bits[loc] == mask
            if kind == tfp.KIND_HOP:  # both bits local in its round
                assert a >= 0 and b >= 0 and a != b
    assert nxt == len(plan)


def _geometry(n, plan, backward, mode):
    """fp_plan's choice (mode None), or the plan forced into ``mode`` at
    r = 3."""
    if mode is None:
        return tfp.fp_plan(n, _key(plan), 1, 1, 132, backward)
    return tfp._fp_geometry(n, _key(plan), 1, 1, 132, backward, mode, 3)


@pytest.mark.parametrize("name", ["12q ring", "12q mixed", "15q hops"])
@pytest.mark.parametrize("mode", [None, "grid"])
def test_layouts_relabel_to_the_identity(name, mode):
    """Every layout covers the state once; a step's exchanges, carried on
    the amplitude indices themselves, end where they began (the phase
    layout), so the chain ends in index order."""
    plan = _plans()[name]
    n = int(name[:2])
    geo = _geometry(n, plan, True, mode)
    assert geo.mode == mode or mode is None
    d = 1 << n
    for rd in geo.rounds:
        idx = layout_index(geo, rd).flatten()
        assert torch.equal(torch.sort(idx).values, torch.arange(d))
    labels = [torch.arange(d, dtype=torch.float64)]
    last = geo.rounds[-1]
    P = layout_index(geo, last)
    x = [labels[0][P]]
    cur = last
    for rd in geo.rounds:
        if (rd.reg, rd.blk) != (cur.reg, cur.blk):
            x = _exchange(geo, x, cur, rd, d)
            cur = rd
    assert (cur.reg, cur.blk) == (last.reg, last.blk)
    assert torch.equal(x[0], P.to(torch.float64))
    assert geo.exchanges <= len(geo.rounds)


# ---------------------------------------------------------------------------
# the rounds and layouts emulated against the plain versions
# ---------------------------------------------------------------------------

def _chain(plan, n, n_steps, seed, tx=None):
    rng = np.random.default_rng(seed)
    d = 1 << n
    f = lambda *s: torch.tensor(rng.standard_normal(s))  # noqa: E731
    th = 0.3 * f(n_steps, d)
    if tx is None:
        tx = 0.4 * f(n_steps, int(plan[:, 0].max()) + 1)
    psi = f(2, d) / np.sqrt(2 * d)
    lam = f(2, d)
    return th, tx[:n_steps].to(torch.float64), psi, lam


@pytest.mark.parametrize("name,mode", [("12q ring", None),
                                       ("12q mixed", None),
                                       ("12q mixed", "grid"),
                                       ("15q hops", None)])
def test_emulation_equals_plain(name, mode):
    n = int(name[:2])
    d = 1 << n
    n_steps = 3 if n == 15 else 5
    if name == "12q mixed":
        plan, tx = _mixed(n, n_steps, 5)
    else:
        plan, tx = _plans()[name], None
    th, tx, psi, lam = _chain(plan, n, n_steps, seed=n, tx=tx)
    a = tfp.merge_phase_rows(th)
    fwd = _geometry(n, plan, False, mode)
    got = emulate_forward(fwd, psi[0], psi[1], th, tx)
    want = tfp._evolve_core(psi[0], psi[1], a, tx, plan, d)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)
    bwd = _geometry(n, plan, True, mode)
    got = emulate_adjoint(bwd, want[0], want[1], lam[0], lam[1], th, tx)
    want = tfp._adjoint_core(want[0], want[1], lam[0], lam[1], a, tx, plan,
                             d)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-11 * float(w.abs().max()))


PLANS10 = {
    "x": ((0, 4, 9, 6, 2, 7), ("x",) * 6),
    "xy": ((0, 3, 9, 0, 0, 9, 3, 0), ("x", "y", "y", "y", "y", "y", "y", "x")),
    "xhop": ((1, (2, 8), 8, (0, 9), (4, 5), 6), ("x", "hop", "x", "hop",
                                                 "hop", "x")),
}


@pytest.mark.parametrize("name", sorted(PLANS10))
def test_emulation_equals_jax_kernel(name):
    """At 10 qubits the emulated forward equals the JAX package's K1
    (Pallas in interpret mode on the CPU) to 5e-5 on the state, f32."""
    n, n_steps = 10, 3
    d = 1 << n
    xq, kinds = PLANS10[name]
    rng = np.random.default_rng(10)
    psi = (rng.standard_normal((2, d)) / np.sqrt(d)).astype(np.float32)
    th = (0.3 * rng.standard_normal((n_steps, d))).astype(np.float32)
    tx = (0.4 * rng.standard_normal((n_steps, len(xq)))).astype(np.float32)
    out = jfp.fused_product_evolve(JCP(jnp.asarray(psi[0]),
                                       jnp.asarray(psi[1])),
                                   jnp.asarray(th), jnp.asarray(tx), xq, n,
                                   kinds)
    plan = tfp._plan_ops(xq, kinds, n)
    geo = tfp.fp_plan(n, _key(plan), 1, 1, 132, False)
    got = emulate_forward(geo, torch.tensor(psi[0]), torch.tensor(psi[1]),
                          torch.tensor(th), torch.tensor(tx))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(out.re), atol=5e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(out.im), atol=5e-5)
    assert jax.default_backend() == "cpu"
