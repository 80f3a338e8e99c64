"""The ``alloc_objective`` kernel's launch plan (``ops.launch_plan``), on the
CPU: which rows each block and warp carries, how much shared memory the
stage takes, and the column order in which a lane accumulates a row.

The kernel's indexing (``csrc/alloc_objective.cu``): block j of problem b
holds rows ``j * rows_per_block + i``, i < rows_per_block, below T; in pass
1 warp w of its 8 carries rows i = w (i = 2w and 2w + 1 where a block
holds more than 8); lane l visits the 4-wide column vectors l, l + 32, ...
of each tile where n % 4 == 0, else the single columns l, l + 32, ...,
summing each 4 of them as a tree; tiles are ``n_tile`` columns wide, in
order, and start at multiples of 512 columns (``TILE_COLS``), so that no
tile splits a lane's 4 vectors.
"""
import itertools

import pytest

pytest.importorskip("torch")

from repro_torch.kernels.alloc_objective import ops  # noqa: E402

SHAPES = list(itertools.product(
    (1, 3, 64, 300),                    # B
    (1, 2, 3, 4, 5, 12, 47, 48, 300),   # T
))
WIDTHS = [(2048, 4, 2), (1880, 4, 2), (37, 3, 3), (513, 8, 8), (7, 2, 2),
          (4096, 8, 8), (3501, 8, 8), (16, 2, 8), (0, 4, 2)]


def _rows(plan, T):
    """The rows below T that the warps of one problem's blocks carry."""
    per_warp = 2 if plan.rows_per_block > 8 else 1
    out = []
    for j, w, r in itertools.product(range(plan.blocks), range(8),
                                     range(per_warp)):
        i = w * per_warp + r
        t = j * plan.rows_per_block + i
        if i < plan.rows_per_block and t < T:
            out.append(t)
    return out


def _lane_order(n, n_tile, lane):
    """The columns lane ``lane`` accumulates, in the kernel's order."""
    cols = []
    for col0 in range(0, n, max(n_tile, 1)):
        width = min(n_tile, n - col0)
        if n % 4 == 0:
            for k in range(lane, width // 4, 32):
                cols.extend(range(col0 + 4 * k, col0 + 4 * k + 4))
        else:
            cols.extend(range(col0 + lane, col0 + width, 32))
    return cols


@pytest.mark.parametrize("B,T", SHAPES)
def test_plan_covers_every_row_once(B, T):
    for n, m, p in WIDTHS:
        plan = ops.launch_plan(B, T, n, m, p)
        assert 1 <= plan.rows_per_block <= ops.MAX_ROWS == 16
        assert sorted(_rows(plan, T)) == list(range(T))
        # no block lies wholly past T
        assert (plan.blocks - 1) * plan.rows_per_block < T


@pytest.mark.parametrize("n,m,p", WIDTHS)
def test_stage_fits_in_shared_memory(n, m, p):
    for B, T in SHAPES:
        plan = ops.launch_plan(B, T, n, m, p)
        assert plan.smem_bytes == (4 * (1 + m + p) * plan.n_tile
                                   + ops.WEIGHT_BYTES)
        assert plan.smem_bytes <= ops.SMEM_LIMIT == 227 * 1024
        assert plan.n_tile == n or (
            0 < plan.n_tile < n and plan.n_tile % ops.TILE_COLS == 0)
    # tiled exactly where the whole stage would not fit
    tiled = ops.launch_plan(1, 1, n, m, p).n_tile < n
    assert tiled == (4 * (1 + m + p) * n + ops.WEIGHT_BYTES > ops.SMEM_LIMIT)


@pytest.mark.parametrize("n", [2048, 1880, 513, 37, 7, 4096, 3501, 1])
def test_reduction_order_depends_on_n_alone(n):
    """Whatever B, T, m and p (and so the plan and its tiles), each lane
    visits the same columns in the same order as with one untiled stage."""
    untiled = [_lane_order(n, n, lane) for lane in range(32)]
    assert sorted(c for cols in untiled for c in cols) == list(range(n))
    span = 32 * 4 * (4 if n % 4 == 0 else 1)      # a sub-group of each lane
    for (B, T), (m, p) in itertools.product(
            SHAPES, [(2, 2), (4, 2), (3, 3), (8, 8)]):
        plan = ops.launch_plan(B, T, n, m, p)
        assert plan.n_tile == n or plan.n_tile % span == 0
        assert [_lane_order(n, plan.n_tile, lane)
                for lane in range(32)] == untiled


@pytest.mark.parametrize("B,T", SHAPES)
def test_plan_leaves_no_sm_without_rows(B, T):
    """No block holds more rows than an even spread of the B T rows over
    the 132 SMs gives each, so the grid fills the card where it can."""
    plan = ops.launch_plan(B, T, 2048, 4, 2, sms=132)
    assert plan.rows_per_block <= max(1, -(-B * T // 132))


@pytest.mark.parametrize("T,blocks,rows", [(48, 3, 16), (12, 2, 6),
                                           (4, 2, 2), (1, 1, 1)])
def test_plan_at_replay_shapes(T, blocks, rows):
    """The replay's shapes (B = 64, n = 2048, m = 4, p = 2): 192, 128, 128
    and 64 blocks, the stage all of n."""
    plan = ops.launch_plan(64, T, 2048, 4, 2, sms=132)
    assert (plan.blocks, plan.rows_per_block, plan.n_tile) == (blocks, rows,
                                                               2048)
