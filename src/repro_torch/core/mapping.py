"""The paper's data-mapping scheme onto NAND-SPIN subarrays (§4.1,
Fig. 8 & 12).

On NAND-SPIN the mapping is: input bit-planes resident one-per-subarray
(256 rows x 128 cols), the weight plane in a small buffer reused across the
whole input plane (one buffer write per plane), and bit-count partial sums
"cross-written" into disjoint columns of an accumulator subarray.
:func:`plan_subarrays` counts how one (M, K, N) contraction maps onto that
geometry. (The card's tile shapes are the kernels' own launch plans,
``kernels/bitserial_matmul.py::_plan``.)
"""
from __future__ import annotations

import dataclasses
import math

# Paper subarray geometry (§5.2): 256 rows x 128 columns.
SUBARRAY_ROWS = 256
SUBARRAY_COLS = 128


@dataclasses.dataclass(frozen=True)
class SubarrayPlan:
    """How one conv/matmul layer maps onto physical subarrays (paper Fig. 12)."""

    input_planes: int       # = activation bits; one subarray set per plane
    weight_planes: int      # = weight bits; broadcast through buffers
    rows_per_pass: int      # input rows resident per subarray pass
    cols: int               # output columns per subarray (bit-counters)
    passes: int             # sequential passes over the subarray grid
    and_ops: int            # total AND-plane row operations
    buffer_writes: int      # weight buffer programming events


def plan_subarrays(m: int, k: int, n: int, a_bits: int, w_bits: int,
                   rows: int = SUBARRAY_ROWS, cols: int = SUBARRAY_COLS) -> SubarrayPlan:
    """Map an (M,K,N) contraction onto the paper's subarray geometry.

    Each subarray holds one activation bit-plane tile (rows x cols bits);
    every weight plane row triggers one AND + bitcount across all columns in
    parallel (Fig. 8 step semantics).
    """
    col_tiles = math.ceil(n / cols)
    row_tiles = math.ceil(m / rows)
    k_steps = k  # one AND per contraction element row (serial rows, parallel cols)
    passes = row_tiles * col_tiles
    return SubarrayPlan(
        input_planes=a_bits,
        weight_planes=w_bits,
        rows_per_pass=min(m, rows),
        cols=min(n, cols),
        passes=passes,
        and_ops=a_bits * w_bits * k_steps * passes,
        buffer_writes=w_bits * col_tiles,
    )
