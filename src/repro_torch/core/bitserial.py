"""Bit-serial arithmetic built from AND + bitcount + shift (paper Eq. 1).

    I * W = sum_n sum_m 2^(n+m) * bitcount(AND(c_n(I), c_m(W)))

Four interchangeable execution backends, all bit-exact w.r.t. each other:

``popcount``   the paper-faithful dataflow on packed planes: the activation
               codes are packed (kernel ``bitplane_pack``), then ANDed and
               popcounted against the stored weight planes (kernel
               ``bitserial_matmul_packed``) with the 2^(n+m) shifts.
``mxu-plane``  each (n, m) plane pair as a {0,1} matrix product: one
               float32 product of all activation planes against all weight
               planes, whose counts are exact integers while K < 2^24; the
               counts are combined with integer shifts.
``int-direct`` one library product of the multi-bit codes, what Eq. 1
               decomposes.
``cuda``       the counterpart of the JAX package's ``pallas``: one launch
               of ``bitserial_matmul_fused``, which packs the activation
               codes inside the matmul.

The kernels run on a CUDA tensor; on a CPU tensor their plain PyTorch
versions run. Accumulation wraps mod 2^32 in every backend, as the
reference's int32 accumulation does, so the backends agree bit for bit
wherever the reference's do.

Weights may arrive as a :class:`repro_torch.core.packed.PackedWeight` — the
deployment path where codes, planes and column sums were computed once at
prepack time (the paper's "program subarrays once"). An MoE expert bank
(an (E, K, N) PackedWeight) is contracted by
:func:`int_matmul_prepacked_bank`, on ``cuda`` in one launch for the whole
bank.
"""
from __future__ import annotations

import torch

from . import bitslice
from .packed import PackedWeight
from .quantize import QuantParams, affine_correction, calibrate_minmax, quantize

BACKENDS = ("popcount", "mxu-plane", "int-direct", "cuda")
# The backends that contract the codes and read no planes.
CODE_BACKENDS = ("mxu-plane", "int-direct")


def _kernels():
    from repro_torch.kernels import ops   # lazy: the kernels import core

    return ops


# Weight codes a CPU ``int_matmul_direct`` converts to float64 at a time.
_DIRECT_BLOCK = 1 << 20


def _wrap_int32(p: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with the same low 32 bits (mod 2^32)."""
    return bitslice.to_int32_bits(p & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Integer core: P = qa @ qw  (qa: (M, K) codes, qw: (K, N) codes)
# ---------------------------------------------------------------------------

def int_matmul_popcount_packed(pa: torch.Tensor, pw: torch.Tensor,
                               a_bits: int, w_bits: int,
                               **tiles) -> torch.Tensor:
    """Eq. 1 on prepacked planes. pa (a_bits, M, KW), pw (w_bits, N, KW);
    ``tiles``: kernel 4's tile requests (``bm``/``bkw``)."""
    return _kernels().bitserial_matmul_packed(pa, pw, a_bits=a_bits,
                                              w_bits=w_bits, **tiles)


def int_matmul_popcount(qa: torch.Tensor, qw: torch.Tensor, a_bits: int,
                        w_bits: int) -> torch.Tensor:
    """Eq. 1 with packed planes + popcount. qa (M, K), qw (K, N) -> (M, N)."""
    return int_matmul(qa, qw, a_bits, w_bits, backend="popcount")


def int_matmul_mxu_plane(qa: torch.Tensor, qw: torch.Tensor, a_bits: int,
                         w_bits: int) -> torch.Tensor:
    """Eq. 1 with every plane pair contracted as a {0,1} matrix product.

    One float32 product (a_bits*M, K) @ (K, w_bits*N): each count is a sum
    of at most K ones, exact in float32 while K < 2^24 (float32 products
    keep their type, unlike a bf16 product, whose counts above 256 would
    round). The counts become integers and are combined with shifts, not
    float plane weights, so the result is exact.
    """
    m, k = qa.shape
    n = qw.shape[1]
    if k >= 2**24:
        raise ValueError(f"K={k}: float32 plane counts are exact below 2^24")
    pa = bitslice.bitplanes(qa, a_bits).to(torch.float32).reshape(
        a_bits * m, k)
    pw = bitslice.bitplanes(qw, w_bits).to(torch.float32)     # (w, K, N)
    pw = pw.permute(1, 0, 2).reshape(k, w_bits * n)
    cnt = (pa @ pw).to(torch.int64).reshape(a_bits, m, w_bits, n)
    shifts = (torch.arange(a_bits, device=qa.device)[:, None, None, None]
              + torch.arange(w_bits, device=qa.device)[None, None, :, None])
    return _wrap_int32((cnt << shifts).sum((0, 2)))


def int_matmul_direct(qa: torch.Tensor, qw: torch.Tensor, a_bits: int = 0,
                      w_bits: int = 0) -> torch.Tensor:
    """One product of the codes (what Eq. 1 decomposes), wrapped mod 2^32.

    CUDA has no int32 matmul, so the product runs in float64: exact while
    every partial sum is below 2^53, i.e. (2^b - 1)^2 * K < 2^53 for codes
    of b bits (K < 1.3e11 at 8 bits, K < 2.1e6 at 16). On the CPU byte
    codes of a 2-D weight take an int8 GEMM (``_int_mm_bytes``), exact
    and several times faster on a vocabulary head (10^8-10^9 codes), which
    it never widens; other codes
    go to float64 a block of columns at a time, so that each block is read
    from cache rather than a float64 copy of the whole weight from memory.
    """
    if qa.device.type == "cpu" and _byte_codes(qa, qw):
        return _wrap_int32(_int_mm_bytes(qa, qw))
    a = qa.to(torch.float64)
    if qa.device.type != "cpu":
        p = a @ qw.to(torch.float64)
    else:
        step = max(1, _DIRECT_BLOCK // max(1, qw.numel() // qw.shape[-1]))
        p = torch.cat([a @ qw[..., i:i + step].to(torch.float64)
                       for i in range(0, qw.shape[-1], step)], -1)
    return _wrap_int32(p.to(torch.int64))


def _byte_codes(qa: torch.Tensor, qw: torch.Tensor) -> bool:
    """A 2-D weight, 0 < K < 2^17, and both operands' codes in [0, 255]
    (a uint8 weight is; int32 codes are read once)."""
    if qw.dim() != 2 or not 0 < qw.shape[0] < 1 << 17:
        return False
    for q in (qa, qw):
        if q.dtype != torch.uint8 and q.numel():
            lo, hi = torch.aminmax(q)
            if int(lo) < 0 or int(hi) > 255:
                return False
    return True


def _int_mm_bytes(qa: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """P = qa @ qw (int64) for byte codes through one int8 GEMM on the
    CPU: both operands shifted by -128 into int8, and the shift's cross
    terms added back, sum_k (a + 128)(w + 128) = sum_k a w + 128 sum_k a
    + 128 sum_k w + 2^14 K; the weight's column sums come from a row of
    ones under the activations. The int32 GEMM is exact: |sum_k a w| <=
    2^14 K < 2^31."""
    k = qw.shape[0]
    lead = qa.shape[:-1]
    a8 = (qa.reshape(-1, k).to(torch.int32) - 128).to(torch.int8)
    w8 = (qw.view(torch.int8) ^ -128 if qw.dtype == torch.uint8
          else (qw.to(torch.int32) - 128).to(torch.int8))
    p = torch._int_mm(torch.cat([a8, torch.ones((1, k), dtype=torch.int8)]),
                      w8).to(torch.int64)
    rows = a8.sum(-1, dtype=torch.int64)[:, None]
    return (p[:-1] + 128 * (p[-1:] + rows) + (k << 14)).reshape(
        *lead, qw.shape[1])


def _pack_codes(qw: torch.Tensor, wq: QuantParams,
                planes: bool = True) -> PackedWeight:
    """Weight codes (K, N) as a PackedWeight (planes of ``qw.T``). With
    ``planes=False`` the planes are left out (None): the backends of
    ``CODE_BACKENDS`` contract the codes and never read them.

    The codes stay int32 here, unlike ``prepack``'s bytes: this is the
    per-call route of a float weight (a tied head), whose codes live for
    one product, so narrowing them would add a pass and save no memory
    that outlives the call."""
    return PackedWeight(
        codes=qw, planes=_kernels().pack_planes(qw.T.contiguous(), wq.bits)
        if planes else None,
        col_sums=qw.sum(0, dtype=torch.int32), wq=wq)


def int_matmul(qa, qw, a_bits, w_bits, backend="popcount"):
    """P = qa @ qw on ``backend`` from the codes (no read disturb: the
    reference's ``int_matmul`` reads no stored array)."""
    unit = QuantParams(torch.ones((), device=qw.device),
                       torch.zeros((), device=qw.device), w_bits)
    return _int_matmul_packed(qa, _pack_codes(qw, unit), a_bits, backend)


def _tiles(w: PackedWeight) -> dict:
    """The tile requests of ``w``'s decision (none without one). Its
    ``bn`` is not passed: the column tile has one legal value."""
    t = w.tune
    return {} if t is None else dict(bm=t.bm, bkw=t.bkw)


def int_matmul_prepacked(qa: torch.Tensor, w: PackedWeight, a_bits: int,
                         backend: str = "cuda") -> torch.Tensor:
    """P = qa @ w.codes using whatever representation the backend wants.

    The popcount and cuda backends consume the prepacked planes directly:
    the weight side of quantize -> slice -> pack never runs again. The
    code backends widen byte codes first (``int-direct`` to float64,
    ``mxu-plane`` to int32 before its shifts).

    A :class:`~repro_torch.core.packed.TuneDecision` attached at prepack
    time (``w.tune``, see :mod:`repro_torch.pim.autotune`) overrides
    ``backend`` and supplies the tile requests of kernels 2 (``cuda``) and
    4 (``popcount``). Tuning redirects dispatch only: every backend and
    plan computes the same P bit for bit.

    Inside an active :func:`repro_torch.pim.faults.read_disturb_scope`
    every call reads a freshly disturbed view of the stored weight (STT-
    MRAM read disturb): the site's flip field XOR-ed into the form the
    backend reads. Outside a scope nothing extra runs.
    """
    if w.tune is not None:
        backend = w.tune.backend
    return _int_matmul_packed(qa, _disturbed(w, backend), a_bits, backend)


def _disturbed(w: PackedWeight, backend: str) -> PackedWeight:
    """``w`` as one read under an active read-disturb scope sees it (``w``
    itself outside one)."""
    from repro_torch.pim import faults   # lazy: pim imports core

    if not faults.read_disturb_active():
        return w
    return faults.disturb_packed(
        w, reads="codes" if backend in CODE_BACKENDS else "planes")


def _int_matmul_packed(qa: torch.Tensor, w: PackedWeight, a_bits: int,
                       backend: str) -> torch.Tensor:
    """The product on the resolved ``backend``."""
    w_bits = w.bits
    if backend == "int-direct":
        return int_matmul_direct(qa, w.codes)
    if backend == "mxu-plane":
        return int_matmul_mxu_plane(qa, w.codes32, a_bits, w_bits)
    ops = _kernels()
    if backend == "popcount":
        pa = ops.pack_planes(qa, a_bits)
        return int_matmul_popcount_packed(pa, w.planes, a_bits, w_bits,
                                          **_tiles(w))
    if backend == "cuda":
        return ops.bitserial_matmul(qa, a_bits=a_bits, w_bits=w_bits,
                                    pw=w.planes, **_tiles(w))
    raise ValueError(f"unknown backend {backend!r} (ported: {BACKENDS})")


def int_matmul_prepacked_bank(qa: torch.Tensor, w: PackedWeight, a_bits: int,
                              backend: str = "cuda") -> torch.Tensor:
    """P[e] = qa[e] @ w.codes[e] over an (E, K, N) expert bank: qa (E, M,
    K) codes -> (E, M, N) int32, what the JAX package computes with
    ``int_matmul_prepacked`` under ``vmap`` over the bank.

    ``cuda`` is one launch of kernel 2's batched entry for the whole bank;
    ``int-direct`` one float64 batched product of the codes; ``popcount``
    packs every expert's codes in one pack, then runs kernel 4 expert by
    expert; ``mxu-plane`` runs expert by expert. ``w.tune`` overrides
    ``backend`` and supplies tile requests, as in
    :func:`int_matmul_prepacked`. Under a read-disturb scope the bank
    takes one flip field for all its experts, as the reference's ``vmap``
    draws it.
    """
    if w.tune is not None:
        backend = w.tune.backend
    w = _disturbed(w, backend)
    e, m, k = qa.shape
    ops = _kernels()
    if backend == "cuda":
        return ops.bitserial_matmul_batched(qa, a_bits=a_bits, w_bits=w.bits,
                                            pw=w.planes, **_tiles(w))
    if backend == "int-direct":
        return int_matmul_direct(qa, w.codes)    # a batched product
    if backend == "mxu-plane":
        return torch.stack([
            int_matmul_mxu_plane(qa[i], w.codes[i].to(torch.int32), a_bits,
                                 w.bits) for i in range(e)])
    if backend == "popcount":
        pa = ops.pack_planes(qa.reshape(e * m, k), a_bits).reshape(
            a_bits, e, m, -1)
        return torch.stack([
            int_matmul_popcount_packed(pa[:, i], w.planes[i], a_bits, w.bits,
                                       **_tiles(w))
            for i in range(e)])
    raise ValueError(f"unknown backend {backend!r} (ported: {BACKENDS})")


# ---------------------------------------------------------------------------
# Float-facing quantized matmul (Eq. 2 calibration + Eq. 1 core + correction)
# ---------------------------------------------------------------------------

def quantized_matmul(a: torch.Tensor, w, a_bits: int = 8, w_bits: int = 8,
                     backend: str = "cuda", wq: QuantParams | None = None,
                     qw: torch.Tensor | None = None) -> torch.Tensor:
    """Full paper pipeline: calibrate -> quantize -> bit-serial P -> dequant.

    ``a`` (..., K) float; ``w`` a :class:`PackedWeight` (the deployment
    mode), or a (K, N) float weight quantized per call, or, with the legacy
    pre-quantized ``wq``/``qw``, taken from those codes.
    """
    lead = a.shape[:-1]
    k = a.shape[-1]
    a2 = a.reshape(-1, k)
    aq = calibrate_minmax(a2, a_bits)
    qa = quantize(a2, aq)
    if isinstance(w, PackedWeight):
        packed = w
    else:
        if qw is None:
            wq = calibrate_minmax(w, w_bits)
            qw = quantize(w, wq)
        packed = _pack_codes(qw, wq, planes=backend not in CODE_BACKENDS)
    p = int_matmul_prepacked(qa, packed, a_bits, backend)
    sa = qa.sum(-1, keepdim=True)
    y = affine_correction(p, sa, packed.col_sums, k, aq, packed.wq)
    return y.reshape(*lead, packed.shape[-1])
