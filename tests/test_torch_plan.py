"""The host-side launch plan of the tile kernels #1, #2, #3, #4 and #5
(``plan.launch_plan`` and ``plan.k_split``): how many blocks the grid
gives, how large the cluster is, and how the cluster's blocks split K.
Pure functions: no card needed.
"""
import math

import pytest

from repro_torch.kernels import DECODE_M_MAX
from repro_torch.kernels import plan as kp

# one smollm-135m decoder layer's (K, N): q, o; k, v; gate, up; down
LAYER_SHAPES = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
RAGGED_SHAPES = [(16, 8), (40, 33), (592, 200), (8, 8), (0, 16)]


@pytest.mark.parametrize("k", [0, 1, 15, 16, 17, 40, 576, 592, 1536, 4099])
@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 8])
def test_k_split_covers_every_block_once(k, cluster):
    ranges = kp.k_split(k, cluster)
    assert len(ranges) == cluster
    covered = []
    for lo, hi in ranges:
        assert lo % 16 == 0                      # cuts only at block boundaries
        assert hi % 16 == 0 or hi == k
        assert lo <= hi <= k
        covered.extend(range(lo, hi))
    assert covered == list(range(k))             # every row once, in order
    blocks = -(-k // 16)
    sizes = [-(-(hi - lo) // 16) for lo, hi in ranges]
    assert sum(sizes) == blocks
    assert max(sizes) - min(sizes) <= 1          # balanced


@pytest.mark.parametrize("k,n", [(576, 576), (576, 1536), (1536, 576)])
def test_decode_grid_fills_the_card(k, n):
    plan = kp.launch_plan(4, k, n)
    assert math.prod(plan.grid) >= 132
    assert plan.rows == DECODE_M_MAX


@pytest.mark.parametrize("m", [1, 4, 8, 9, 64, 200])
@pytest.mark.parametrize("k,n", LAYER_SHAPES + RAGGED_SHAPES)
def test_plan_is_a_valid_cluster_launch(m, k, n):
    plan = kp.launch_plan(m, k, n)
    cols, row_tiles, z = plan.grid
    assert 1 <= plan.cluster <= kp.MAX_CLUSTER
    assert plan.cluster & (plan.cluster - 1) == 0   # a power of two
    assert z == plan.cluster                        # one cluster along grid z
    assert plan.rows == (DECODE_M_MAX if m <= DECODE_M_MAX else kp.PREFILL_ROWS)
    assert cols * kp.COL_TILE >= n > (cols - 1) * kp.COL_TILE
    assert row_tiles * plan.rows >= m > (row_tiles - 1) * plan.rows
    # no rank of the cluster is left without a 16-row block (when K has any)
    assert all(hi > lo for lo, hi in kp.k_split(k, plan.cluster)) or k == 0
    # the cluster grows only while the grid is short of its target: the
    # card's SMs at decode, half of them at prefill
    target = 132 if m <= DECODE_M_MAX else 66
    if plan.cluster > 1:
        assert cols * row_tiles * plan.cluster // 2 < target


def test_plan_at_the_layer_shapes():
    """The decode grid at smollm-135m's widths: 144-192 blocks where
    N >= 576, and the 8-block cluster's 96 at N = 192 (12 column tiles)."""
    got = {(k, n): kp.launch_plan(4, k, n) for k, n in LAYER_SHAPES}
    assert {s: (p.grid, math.prod(p.grid)) for s, p in got.items()} == {
        (576, 576): ((36, 1, 4), 144), (576, 192): ((12, 1, 8), 96),
        (576, 1536): ((96, 1, 2), 192), (1536, 576): ((36, 1, 4), 144)}
    assert kp.launch_plan(4, 576, 192, sms=64).cluster == 8
    assert kp.launch_plan(4, 576, 576, sms=16).cluster == 1
    # prefill (M=64: two 32-row tiles) aims at half the SMs
    assert kp.launch_plan(64, 576, 576).grid == (36, 2, 1)
    assert kp.launch_plan(64, 576, 192).grid == (12, 2, 4)


def test_plane_kernel_grids_at_the_layer_shapes():
    """#2 and #3 (decode M, x's K, the logical columns) take #1's decode grid;
    #4 at the M=128 of the stored-plane checks takes 4 row tiles of 32
    and a cluster only at N = 192 (12 column tiles x 4 < 66)."""
    for m in (1, 4, 8):
        got = {(k, n): kp.launch_plan(m, k, n).grid for k, n in LAYER_SHAPES}
        assert got == {(576, 576): (36, 1, 4), (576, 192): (12, 1, 8),
                       (576, 1536): (96, 1, 2), (1536, 576): (36, 1, 4)}
    got = {(k, n): kp.launch_plan(128, k, n) for k, n in LAYER_SHAPES}
    assert {s: (p.rows, p.grid) for s, p in got.items()} == {
        (576, 576): (32, (36, 4, 1)), (576, 192): (32, (12, 4, 2)),
        (576, 1536): (32, (96, 4, 1)), (1536, 576): (32, (36, 4, 1))}


@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("kx,rows", [(40, 32), (16, 32), (576, 96), (592, 96),
                                     (300, 64), (8, 32), (1536, 192)])
def test_k_split_stops_at_x_for_short_x(m, kx, rows):
    """The plane kernels plan and split at x's K, which may be shorter
    than the planes' canonical K (8 x rows): every 16-row block of x is
    assigned once, none past x's last, and no rank is left without one."""
    assert kx <= 8 * rows
    plan = kp.launch_plan(m, kx, 192)
    ranges = kp.k_split(kx, plan.cluster)
    blocks = sorted(b for lo, hi in ranges for b in range(lo // 16, -(-hi // 16)))
    assert blocks == list(range(-(-kx // 16)))
    assert max(hi for _, hi in ranges) == kx
    assert all(hi > lo for lo, hi in ranges)
