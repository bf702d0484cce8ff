"""Layer -> subarray operation counts (the paper's mapping scheme, §4).

Every layer expands into the NAND-SPIN micro-operations its schedule would
issue, following Fig. 8 (bitwise convolution), Fig. 9 (addition), Fig. 10
(multiplication), Fig. 11 (comparison) and the Fig. 12 layer pipeline:

  and_rowops      one 128-column sense-amp AND + bit-count per weight-plane
                  row step
  read_rowops     plain row reads (operand fetch for add/mul/compare)
  program_steps   5 ns STT program steps, 128-column parallel (count
                  write-backs, product/sum bits, activation stores)
  erase_ops       SOT strip erases preceding program bursts
  bus_bits        global bus traffic (weight broadcast, initial input)
  buffer_bits     SRAM weight-buffer writes
  local_bits      in-mat movement (cross-written counts)

Parallelism is *residency-limited* (the paper minimizes data duplication,
§4.2): a layer's row-ops can only run in subarrays that physically hold its
operands, so each count carries the tensor footprint that bounds its
parallel width (`par_bits` = bits of resident data the phase fans out over).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.models.cnn.specs import GemmSpec

from .hierarchy import Geometry


@dataclasses.dataclass
class OpCounts:
    and_rowops: int = 0
    read_rowops: int = 0
    program_steps: int = 0
    erase_ops: int = 0
    bus_bits: int = 0
    buffer_bits: int = 0
    local_bits: int = 0
    par_bits: int = 1        # resident-data footprint bounding parallelism
    seq_floor: int = 0       # minimum sequential row-ops (critical path)


def _count_bits(k: int) -> int:
    return max(1, math.ceil(math.log2(k + 1)))


def map_gemm(spec: GemmSpec, g: Geometry, ab: int, wb: int) -> OpCounts:
    """Convolution / FC via the Fig. 8 schedule.

    The input lives once (ab bit-planes); weights stream from buffers. For
    each (plane pair, output channel, 128-column output batch) the K
    contraction rows are sensed serially while 128 bit-counters accumulate;
    the count is then cross-written (cb bits vertically) into the
    accumulator subarray, and a Fig. 9 addition folds the ab*wb counts.
    """
    # Output elements (m positions x n channels) tile the 128 bit-counter
    # columns; each group accumulates its K contraction serially. FC (m=1)
    # therefore still fills whole column groups with output channels — the
    # paper's "FC as 1x1 conv" mapping.
    out_groups = math.ceil(spec.m * spec.n / g.cols)
    cb = _count_bits(spec.k)
    pairs = ab * wb
    oc = OpCounts()
    oc.and_rowops = pairs * spec.k * out_groups
    writebacks = pairs * out_groups
    oc.program_steps = writebacks * cb
    oc.erase_ops = writebacks
    oc.local_bits = writebacks * cb * g.cols
    # Fig. 9 addition over the pairs (weighted by 2^(n+m) via row placement):
    add_bits = cb + math.ceil(math.log2(pairs)) + 1
    adds = out_groups
    oc.read_rowops += adds * pairs  # read each operand bit-position group
    oc.program_steps += adds * add_bits
    oc.erase_ops += adds
    # Output activations stored for the next layer (re-quantized to ab bits).
    out_rows = math.ceil(spec.out_elems * ab / (g.cols * 8))
    oc.program_steps += out_rows * 8
    oc.erase_ops += out_rows
    # Stationary weights: broadcast once, reused across the whole plane sweep.
    oc.bus_bits = spec.weight_elems * wb
    oc.buffer_bits = spec.weight_elems * wb
    # Parallelism is bounded by whichever operand is resident across
    # subarrays — input planes for conv, the weight matrix for FC.
    oc.par_bits = max(spec.in_elems * ab, spec.out_elems * ab,
                      spec.weight_elems * wb)
    oc.seq_floor = pairs * spec.k
    return oc


def map_pool_max(spec: GemmSpec, g: Geometry, ab: int) -> OpCounts:
    """Iterative comparison (Fig. 11): per bit, ~2 reads + 2 ANDs + tag/result
    updates (2 program steps), MSB -> LSB, per window reduction step."""
    comparisons = spec.out_elems * max(1, spec.window - 1)
    col_batches = math.ceil(comparisons / g.cols)
    oc = OpCounts()
    oc.and_rowops = col_batches * ab * 2
    oc.read_rowops = col_batches * ab * 2
    oc.program_steps = col_batches * ab * 2
    oc.erase_ops = col_batches * 2
    # winner selectively copied to the next layer's operand rows
    out_rows = math.ceil(spec.out_elems * ab / (g.cols * 8))
    oc.program_steps += out_rows * 8
    oc.erase_ops += out_rows
    oc.local_bits = spec.out_elems * ab
    oc.par_bits = spec.in_elems * ab
    oc.seq_floor = ab * 6 * max(1, spec.window - 1)
    return oc


def map_pool_avg(spec: GemmSpec, g: Geometry, ab: int) -> OpCounts:
    """Fig. 9 addition over the window + Fig. 10 multiply by 1/window."""
    col_batches = math.ceil(spec.out_elems / g.cols)
    sum_bits = ab + _count_bits(spec.window)
    oc = OpCounts()
    oc.read_rowops = col_batches * spec.window * ab
    oc.and_rowops = col_batches * ab * ab
    oc.program_steps = col_batches * (sum_bits + 2 * ab)
    oc.erase_ops = col_batches * 2
    oc.par_bits = spec.in_elems * ab
    oc.seq_floor = spec.window * ab + ab * ab
    return oc


def map_affine(spec: GemmSpec, g: Geometry, ab: int) -> OpCounts:
    """BN (Eq. 3) / quantization (Eq. 2): Fig. 10 multiply + Fig. 9 add.

    Per 128-column batch: the multiply runs 2*ab bit-position steps, each
    reading operand rows, counting, writing the product bit back and
    right-shifting the carries (program-heavy, 5 ns steps)."""
    col_batches = math.ceil(spec.out_elems / g.cols)
    oc = OpCounts()
    oc.and_rowops = col_batches * ab * ab          # bit-products
    oc.read_rowops = col_batches * 2 * ab          # operand/carry reads
    oc.program_steps = col_batches * (2 * ab + ab) # product bits + sum bits
    oc.erase_ops = col_batches * 2
    oc.par_bits = spec.out_elems * ab
    oc.seq_floor = 2 * ab * (ab + 2)
    return oc


def map_relu(spec: GemmSpec, g: Geometry, ab: int) -> OpCounts:
    oc = OpCounts()
    oc.read_rowops = math.ceil(spec.out_elems / g.cols)
    oc.program_steps = math.ceil(spec.out_elems * ab / g.cols / 2)
    oc.erase_ops = math.ceil(spec.out_elems / g.cols / 2)
    oc.par_bits = spec.out_elems * ab
    oc.seq_floor = 2
    return oc


def map_layer(spec: GemmSpec, g: Geometry, ab: int, wb: int) -> tuple[str, OpCounts]:
    """Returns (phase, counts); phases follow the paper's Fig. 16 split."""
    if spec.kind in ("conv", "fc"):
        return "conv", map_gemm(spec, g, ab, wb)
    if spec.kind == "pool_max":
        return "pool", map_pool_max(spec, g, ab)
    if spec.kind == "pool_avg":
        return "pool", map_pool_avg(spec, g, ab)
    if spec.kind == "bn":
        return "bn", map_affine(spec, g, ab)
    if spec.kind == "quant":
        return "quant", map_affine(spec, g, ab)
    if spec.kind == "act":
        return "bn", map_relu(spec, g, ab)
    raise ValueError(f"unknown layer kind {spec.kind}")
