"""K7's launch plan (``ops/taylor_apply.py::k7_plan``) on the CPU: plain
Python, so the geometry the kernels are given can be checked without a
card. For every shape: each row of H (row-split) or each state
(block-resident) is covered exactly once, the shared memory fits the
H100's 232,448 bytes a block, the cooperative grid fits the card's 132
SMs, and the block-resident configuration is chosen exactly up to
``BLOCK_MAX_D``. The kernels themselves are held against the plain
versions on the card (``tests/test_torch_dense.py``, marked ``gpu``, and
``chip_smoke.py``)."""
import numpy as np
import pytest

from diffquantum_tpu_torch.ops import taylor_apply as ta

DS = [1, 2, 4, 16, 48, 63, 64, 65, 128, 256, 512, 1000, 1024]
BS = [1, 4, 5, 16, 40, 64, 3072]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("d", DS)
def test_plan_covers_once_and_fits(d, backward):
    for b in BS:
        plan = ta.k7_plan(d, b, backward)
        assert 0 < plan.smem <= ta.SMEM_LIMIT == 232_448
        assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
        assert (plan.config == "block") == (d <= ta.BLOCK_MAX_D)
        if plan.config == "block":
            # a block holds all d rows; the blocks split the states
            assert plan.rows == d and plan.chunks == plan.steps == 1
            assert plan.stride == d
            seen = np.zeros(b, dtype=int)
            for blk in range(plan.grid):
                seen[blk * plan.states:(blk + 1) * plan.states] += 1
            assert plan.states <= ta.block_states(d)
            if b <= 16:
                assert plan.grid == 1   # the control paths: no second pass
        else:
            # blocks of 8 rows cover the rows of H, every block all states
            seen = np.zeros(d, dtype=int)
            for blk in range(plan.grid):
                seen[blk * plan.rows:(blk + 1) * plan.rows] += 1
            assert plan.grid <= ta.SMS        # one block per SM, resident
            assert plan.threads <= 32 * ta.MAX_WARPS
            cols = plan.steps * plan.threads                # a chunk
            assert plan.chunks * cols >= d                  # every column
            assert (plan.chunks - 1) * cols < d             # no empty chunk
            assert plan.chunks * plan.steps <= 2            # a lane's steps
            assert plan.stride >= d and plan.stride % 4 == 0
            assert plan.states == (2 if b <= 2 else 8)
            assert not plan.terms_in_smem
            assert plan.threads >= 8 * plan.states   # one per output
        assert np.all(seen == 1), (d, b, plan)


def test_plan_keeps_terms_in_shared_memory_only_when_they_fit():
    """The block-resident backward keeps order x substeps terms of its
    states in shared memory when they fit, else global scratch."""
    demo = ta.k7_plan(16, 16, True, terms=8)      # the 4q demo branches
    assert demo.terms_in_smem and demo.grid == 1
    big = ta.k7_plan(64, 16, True, terms=64)
    assert not big.terms_in_smem and big.smem <= ta.SMEM_LIMIT
    for d in (2, 4, 16, 48, 64):
        for terms in (1, 8, 64, 512):
            plan = ta.k7_plan(d, 16, True, terms)
            assert plan.smem <= ta.SMEM_LIMIT
            plane = plan.states * d * 4 * 2
            if plan.terms_in_smem:
                assert plan.smem >= terms * plane
    assert not ta.k7_plan(16, 16, False).terms_in_smem


def test_plan_main_path_shapes():
    """The shapes the dense paths run: d = 1024 on 128 blocks of 16 warps
    (one per SM), d = 256 on 32 blocks of 8 warps, the control shapes on
    one block."""
    for b in (1, 40, 64):
        for bw in (False, True):
            plan = ta.k7_plan(1024, b, bw)
            assert (plan.config, plan.grid, plan.threads) == (
                "rows", 128, 512)
            assert (plan.chunks, plan.steps) == ((1, 2) if b == 1 else (2, 1))
    plan = ta.k7_plan(256, 1, True)
    assert (plan.config, plan.grid, plan.threads, plan.states) == (
        "rows", 32, 256, 2)
    for d, b in ((2, 4), (4, 4), (16, 16), (48, 5)):
        plan = ta.k7_plan(d, b, True, terms=64)
        assert (plan.config, plan.grid, plan.states) == ("block", 1, b)


def test_plan_refuses_empty_shapes():
    for d, b in ((0, 1), (4, 0)):
        with pytest.raises(ValueError, match="k7_plan needs"):
            ta.k7_plan(d, b, False)
