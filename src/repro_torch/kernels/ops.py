"""Public wrappers for the bit-serial kernels.

Dispatch is by tensor device only: a CUDA tensor launches the hand-written
CUDA kernel (or raises), a CPU tensor runs the kernel's plain PyTorch
version in the same module. Nothing falls back from one to the other.

``bitserial_matmul`` is one launch: the weight planes arrive prepacked
(``pw=``, from :class:`repro_torch.core.packed.PackedWeight`), and the
activation codes are sliced and packed inside the matmul kernel.
``bitserial_matmul_batched`` is one launch for a whole MoE expert bank.
``bitserial_matmul_packed`` takes activation planes packed beforehand
(``pack_planes``), the ``popcount`` backend's two launches.
``conv2d_bitserial`` is two: the channel pack of the padded activation
codes, then the fused implicit-im2col conv. ``wkv_chunked`` is the chunked
RWKV-6 WKV recurrence, one launch per prefill chunk of a layer, under
autograd: its gradient is ``wkv_chunked_bwd``, one launch a backward.

K is zero-padded to a whole word, and C to whole channel words, inside the
kernels (lanes past the edge read the zero code), which is the zero padding
the JAX wrappers apply with ``jnp.pad``, without the copy.
"""
from __future__ import annotations

import torch

from . import bitplane_pack as _pack
from . import bitserial_matmul as _bsm
from . import conv2d_fused as _conv
from . import rwkv_chunk as _wkv

# Each kernel's launch counter: (wrapper module, counter attribute).
_KERNEL_MODULES = {
    "bitplane_pack": (_pack, "launches"),
    "bitserial_matmul_fused": (_bsm, "launches"),
    "bitserial_matmul_packed": (_bsm, "packed_launches"),
    "bitserial_matmul_fused_batched": (_bsm, "batched_launches"),
    "conv2d_bitserial_fused": (_conv, "launches"),
    "wkv_chunked": (_wkv, "launches"),
    "wkv_chunked_bwd": (_wkv, "bwd_launches"),
}


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod, attr in _KERNEL_MODULES.values():
        setattr(mod, attr, 0)


def pack_planes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer codes (M, K) -> packed planes (bits, M, ceil(K/32))."""
    return _pack.bitplane_pack(q, bits)


def matmul_tiles(m: int, n: int, kw: int, a_bits: int, w_bits: int,
                 bm: int | None = None, bn: int | None = None,
                 bkw: int | None = None) -> tuple:
    """Legal (bm, bn, bkw) for an (M, N, KW-words) product on kernels 2
    and 4, the counterpart of the JAX package's ``ops.matmul_tiles``.

    ``bm``/``bn``/``bkw`` are *requests* (an autotuner decision's, or a
    caller's), legalized against ``_plan``'s tiles: ``bm`` picks the row
    tile (16 rows at a request of 16 or less, or for M <= 16 without one;
    else 64), ``bn`` has one legal value, the tiles' 128 columns, and
    ``bkw`` asks for the words of a K split, rounded up to the tile's
    4-word step and capped at ``SLAB_WORDS`` and at K. A ``bkw`` of None
    stays None: the plan then splits K to fill the card, as it does
    untuned. The bits do not enter: the tiles hold 1..8 bits alike.
    """
    small = (m if bm is None else bm) <= _bsm.SMALL_M
    tm, tn, _ = _bsm.TILES[_bsm.SMALL if small else _bsm.LARGE]
    if bkw is None:
        return tm, tn, None
    return tm, tn, _bsm._plan(m, n, kw, 1, 1, tm, bkw).split_words


def _plan_requests(m: int, n: int, kw: int, bm, bkw) -> dict:
    """A tile request as ``_plan``'s keywords (none without a request)."""
    if bm is None and bkw is None:
        return {}
    tm, _, words = matmul_tiles(m, n, kw, 0, 0, bm, None, bkw)
    return dict(bm=tm, bkw=words)


def bitserial_matmul(qa: torch.Tensor, *, a_bits: int, w_bits: int,
                     pw: torch.Tensor, bm: int | None = None,
                     bkw: int | None = None) -> torch.Tensor:
    """Eq. 1 bit-serial integer matmul -> (M, N) int32.

    ``qa`` (M, K) activation codes; ``pw`` (w_bits, N, ceil(K/32))
    prepacked weight planes (``PackedWeight.planes``). ``bm``/``bkw`` are
    tile requests (:func:`matmul_tiles`; the column tile has one legal
    value, so a decision's ``bn`` is not passed); the autotuner threads
    its decisions through here. They move the launch plan only, never P.
    """
    return _bsm.bitserial_matmul_fused(
        qa, pw, a_bits, w_bits,
        **_plan_requests(qa.shape[0], pw.shape[1], pw.shape[-1], bm, bkw))


def bitserial_matmul_batched(qa: torch.Tensor, *, a_bits: int, w_bits: int,
                             pw: torch.Tensor, bm: int | None = None,
                             bkw: int | None = None) -> torch.Tensor:
    """Eq. 1 over an expert bank in one launch -> (E, M, N) int32.

    ``qa`` (E, M, K) activation codes; ``pw`` (E, w_bits, N, ceil(K/32))
    the bank's prepacked planes (a bank ``PackedWeight.planes``); tile
    requests as :func:`bitserial_matmul` takes them.
    """
    return _bsm.bitserial_matmul_fused_batched(
        qa, pw, a_bits, w_bits,
        **_plan_requests(qa.shape[1], pw.shape[2], pw.shape[-1], bm, bkw))


def bitserial_matmul_packed(pa: torch.Tensor, pw: torch.Tensor, *,
                            a_bits: int, w_bits: int, bm: int | None = None,
                            bkw: int | None = None) -> torch.Tensor:
    """Eq. 1 on two prepacked plane sets -> (M, N) int32.

    ``pa`` (a_bits, M, KW) activation planes (:func:`pack_planes`); ``pw``
    (w_bits, N, KW) weight planes; tile requests as
    :func:`bitserial_matmul` takes them.
    """
    return _bsm.bitserial_matmul_packed(
        pa, pw, a_bits, w_bits,
        **_plan_requests(pa.shape[1], pw.shape[1], pw.shape[-1], bm, bkw))


def conv2d_bitserial(qx: torch.Tensor, pw: torch.Tensor, *, a_bits: int,
                     stride: int = 1, bo: int | None = None) -> torch.Tensor:
    """Implicit-im2col bit-serial conv -> P (N, OH, OW, O) int32.

    ``qx`` (N, Hp, Wp, C) int32 activation codes, already spatially padded
    with the zero code; ``pw`` (KH, w_bits, O, KW, CW) fused planes.
    ``bo`` is the reference's O-block request (an autotuner decision's).
    Kernel 3 has one O block, ``conv2d_fused.BN`` = 64 channels, so every
    request legalizes to it and the launch plan does not move.

    Under an active :func:`repro_torch.pim.faults.read_disturb_scope`
    each call reads a freshly disturbed view of the fused planes, the
    site's field drawn in im2col code space, so the fused and im2col
    routes read the same state; outside a scope nothing extra runs.
    """
    n, hp, wp, c = qx.shape
    kh, _, o, kw_sz, cw = pw.shape
    from repro_torch.pim import faults   # lazy: pim imports core

    if faults.read_disturb_active():
        pw = faults.disturb_fused_planes(pw, (kh, kw_sz, c, o))
    oh = (hp - kh) // stride + 1
    ow = (wp - kw_sz) // stride + 1
    pa = pack_planes(qx.reshape(n * hp * wp, c), a_bits)
    if pa.shape[-1] != cw:
        raise ValueError(f"channel words {pa.shape[-1]} != weight words {cw}")
    pa = pa.reshape(a_bits, n * hp, wp, cw)
    return _conv.conv2d_bitserial_fused(pa, pw, n=n, hp=hp, oh=oh, ow=ow,
                                        stride=stride, c=c)


def wkv_chunked(r, k, v, lw, u, s0, *, chunk: int = 16):
    """Chunked RWKV-6 WKV -> (y (BH, S, D), s_final (BH, D, D)) float32.

    r, k, v, lw (BH, S, D) float32, ``lw`` the clamped log decay <= 0;
    u (BH, D); s0 (BH, D, D); S a multiple of ``chunk``. Differentiable:
    the backward launches :func:`wkv_chunked_bwd`'s kernel on the card.
    """
    return _wkv.WKVChunked.apply(r, k, v, lw, u, s0, chunk)


def wkv_chunked_bwd(r, k, v, lw, u, s0, dy, ds_final=None, *,
                    chunk: int = 16):
    """The gradient of :func:`wkv_chunked` -> (dr, dk, dv, dlw (BH, S, D),
    du (BH, D), ds0 (BH, D, D)) float32, given dy (BH, S, D) and
    ``ds_final`` (BH, D, D; None is zero)."""
    return _wkv.wkv_chunked_bwd(r, k, v, lw, u, s0, dy, ds_final, chunk)
