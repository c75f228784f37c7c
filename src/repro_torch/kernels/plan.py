"""The grid of the tile kernels of ``csrc/ternary_tile.cuh``: #1
(``ternary_cim_matmul``), #5 (``ternary_exact_matmul``), #4
(``packed_cim_matmul``), #3 (``packed_cim_matmul_decode_stream``) and #2
(``packed_cim_matmul_decode``).

A block owns 16 output columns (:data:`COL_TILE`) and ``rows`` x rows (8
in the decode class, 32 above it); the ``cluster`` blocks along grid z
form one thread-block cluster and split x's K extent at 16-row block
boundaries (:func:`k_split`). :func:`launch_plan` picks the cluster so
that the grid fills the card's SMs. :func:`tuned_plan` is the grid of a
tile-sweep winner or of a forced shape class
(``core.execution.autotune`` / ``set_shape_class_override``); with
neither it is :func:`launch_plan` itself. Pure functions, pinned on the
CPU by ``tests/test_torch_plan.py`` and ``tests/test_torch_calibrate.py``.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import DECODE_M_MAX

BLOCK = 16        # rows of one CiM block: the K split never cuts one
# the decode class (M <= DECODE_M_MAX) takes DECODE_M_MAX-row M tiles,
# the prefill class 32-row tiles
PREFILL_ROWS = 32
COL_TILE = 16     # output columns per block: the int8 MMA's 16 rows
MAX_CLUSTER = 8   # the largest portable thread-block cluster
H100_SMS = 132
# the launch parameters the compiled instances of tile_kernel accept: the
# M tile of a block (#2 and #3 have only the decode one) and the cluster
TILE_ROWS = (DECODE_M_MAX, PREFILL_ROWS)
CLUSTERS = (1, 2, 4, 8)


class LaunchPlan(NamedTuple):
    """The grid of a tile kernel for one call: ``rows`` x rows per block,
    ``grid`` = (column tiles, row tiles, ``cluster``); the ``cluster``
    blocks along grid z form one cluster and split K (:func:`k_split`)."""
    rows: int
    grid: Tuple[int, int, int]
    cluster: int


def launch_plan(m: int, k: int, n: int, sms: int = H100_SMS) -> LaunchPlan:
    """The grid for x (m, k) against a (k, n) weight (for the plane
    kernels, k is x's extent and n the logical columns): the smallest
    power-of-two cluster (<= MAX_CLUSTER, and no larger than K has 16-row
    blocks to go around) that gives at least ``sms`` blocks at decode, or
    ``sms // 2`` at prefill (where a block does 4x the MMAs per K row and
    longer K ranges ran faster on the card), or the largest allowed."""
    return _class_plan(m, k, n, sms, m <= DECODE_M_MAX)


def _class_plan(m: int, k: int, n: int, sms: int, decode: bool) -> LaunchPlan:
    """:func:`launch_plan`'s rule for the class ``decode`` names."""
    rows = DECODE_M_MAX if decode else PREFILL_ROWS
    target = sms if decode else sms // 2
    cols, row_tiles = -(-n // COL_TILE), -(-m // rows)
    k_blocks = -(-k // BLOCK)
    cluster = 1
    while (cluster < MAX_CLUSTER and cols * row_tiles * cluster < target
           and 2 * cluster <= k_blocks):
        cluster *= 2
    return LaunchPlan(rows, (cols, row_tiles, cluster), cluster)


def bounded_cluster(cluster: int, k: int) -> int:
    """``cluster`` halved until K has a 16-row block for every rank, as
    :func:`launch_plan` bounds its own (1 at least)."""
    k_blocks = -(-k // BLOCK)
    while cluster > 1 and cluster > k_blocks:
        cluster //= 2
    return cluster


def tuned_plan(m: int, k: int, n: int, sms: int = H100_SMS, *,
               winner: Optional[Sequence[int]] = None,
               cls: Optional[str] = None,
               rows: Optional[int] = None) -> LaunchPlan:
    """The grid of one call under the tile sweep's choices.

    ``winner``: a tile-sweep winner ``(rows, cluster[, nbuf])``: its rows,
    its cluster bounded by K (:func:`bounded_cluster`). Else ``cls``: the
    shape class forced by ``set_shape_class_override``, whose
    :func:`launch_plan` rule (rows and SM target) then applies at this M.
    ``rows``: the kernel's own M tile where it has only one (#2 and #3:
    8), which replaces the winner's or the class's. With none of the
    three the result is ``launch_plan(m, k, n, sms)``, bit for bit.
    """
    if winner is not None:
        tile = int(winner[0])
        cluster = bounded_cluster(int(winner[1]), k)
    else:
        decode = m <= DECODE_M_MAX if cls is None else cls == "decode"
        base = _class_plan(m, k, n, sms, decode)
        tile, cluster = base.rows, base.cluster
    tile = tile if rows is None else rows
    return LaunchPlan(tile, (-(-n // COL_TILE), -(-m // tile), cluster), cluster)


def k_split(k: int, cluster: int) -> List[Tuple[int, int]]:
    """The K rows [lo, hi) that each block of a cluster takes, as the
    kernels cut them: rank r gets the 16-row blocks [r*kb/S, (r+1)*kb/S)
    of the kb = ceil(k/16), S = ``cluster``."""
    kb = -(-k // BLOCK)
    return [(r * kb // cluster * BLOCK, min((r + 1) * kb // cluster * BLOCK, k))
            for r in range(cluster)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sms(device: torch.device) -> int:
    """The SM count of CUDA ``device`` (its index, or the current one)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _sm_count(index)


def device_plan(m: int, k: int, n: int) -> LaunchPlan:
    """:func:`launch_plan` for the SMs of the current CUDA device."""
    return launch_plan(m, k, n, _sm_count(torch.cuda.current_device()))
