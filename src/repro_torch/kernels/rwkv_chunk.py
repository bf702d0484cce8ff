"""Chunked RWKV-6 WKV: the CUDA kernel's wrapper and its plain PyTorch
versions.

``wkv_chunked(r, k, v, lw, u, s0, chunk)`` takes r, k, v and the clamped
log decay lw (BH, S, D) float32, the bonus u (BH, D) and the state s0
(BH, D, D), and returns (y (BH, S, D), s_final (BH, D, D)) float32. The
state is key-major: y_t = r_t (S + (u k_t)^T v_t), S <- diag(e^{lw_t}) S +
k_t^T v_t, computed L = ``chunk`` tokens at a time with the algebra of the
JAX package's ``_chunked_wkv``.

A CUDA tensor launches ``csrc/wkv_chunked.cu`` with the launch plan of
:func:`_plan`, reading r, k, v and lw through one shared layout of
strides (D contiguous), so a (1, S, H, D) tensor seen as (H, S, D) is
not copied; y comes back in that layout. Inputs whose layouts differ are
copied to contiguous ones. A CPU tensor runs :func:`wkv_chunked_plain`,
the same chunked algebra. Either way D must be 8, 16, 32 or 64, ``chunk``
8, 16 or 32 and S a positive multiple of ``chunk``.
:func:`wkv_chunked_ref` is the sequential scan, the oracle of both.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

launches = 0

HEAD_DIMS = (8, 16, 32, 64)
CHUNKS = (8, 16, 32)

_ARGTYPES = {
    "repro_wkv_chunked": [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "repro_wkv_chunked_smem": [ctypes.c_int] * 4,
}

# Dynamic shared memory a block may take (the C entry's kSmemLimit), and
# the threads of a block (kThreads): a block stages at most 8 * THREADS / D
# tokens at a time.
SMEM_LIMIT = 227 * 1024
THREADS = 512
# State columns a block may own, and tokens it may stage at a time.
COLS = (16, 32, 64)
TOKENS = (64, 32)
# A block's time that does not shrink with its columns (the staging, the
# cumsum, the exponentials and A, recomputed by every column slice of a
# head, and the latency of each step), in columns' worth of the time that
# does (dS, the carry-in, A v): a block of 16 columns takes 0.88x the
# cycles of one of 32 at S = 256 on the H100
# (examples/torch_wkv_phase_timers.py).
REPLICATED_COLS = 100


class Plan(NamedTuple):
    """How one call is launched: ``cols`` state columns a block (D / cols
    blocks a head), ``tokens`` staged and computed at a time."""
    cols: int
    tokens: int


def smem_bytes(d: int, cols: int, tokens: int, chunk: int) -> int:
    """Shared memory of a block (``wkv_chunked.cu``'s ``layout``): two
    staging buffers of r, k, lw (rows of D + 4 floats) and v (rows of cols
    + 4), r u k, dS_c / S_c of each chunk of a batch, A' (a row of chunk +
    4 a key), e^{P_L} of each chunk, and u."""
    ldd, ldv, n = d + 4, cols + 4, tokens // chunk
    raw = 3 * tokens * ldd + tokens * ldv
    return 4 * (2 * raw + tokens * ldd + n * d * ldv + tokens * (chunk + 4)
                + n * d + d)


@functools.lru_cache(maxsize=4096)
def _plan(bh: int, s: int, d: int, chunk: int, sms: int) -> Plan:
    """The launch plan of a call on a card of ``sms`` SMs: the column slice
    that takes the least time, counted as waves of blocks (BH * D / cols
    blocks over the SMs) times a block's work (``REPLICATED_COLS`` +
    cols), then the most tokens at a time that fit in shared memory."""
    best = None
    for cols in sorted({min(c, d) for c in COLS}):
        for tokens in TOKENS:
            tokens = min(tokens, s)
            if (tokens % chunk or tokens * d > 8 * THREADS
                    or smem_bytes(d, cols, tokens, chunk) > SMEM_LIMIT):
                continue
            waves = -(-bh * (d // cols) // sms)
            key = (waves * (REPLICATED_COLS + cols), -tokens, cols)
            if best is None or key < best[0]:
                best = (key, Plan(cols, tokens))
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    """SMs of a card (a ``torch.device`` or its index)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library():
    return _build.load("wkv_chunked", _ARGTYPES)


def wkv_chunked_plain(r, k, v, lw, u, s0, chunk: int):
    """The chunked algebra in PyTorch, one chunk of L tokens at a time."""
    bh, s, d = r.shape
    n = s // chunk
    rc, kc, vc, lwc = (t.reshape(bh, n, chunk, d) for t in (r, k, v, lw))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)   # s < t
    state = s0
    ys = []
    for c in range(n):
        rj, kj, vj, lwj = rc[:, c], kc[:, c], vc[:, c], lwc[:, c]
        p = torch.cumsum(lwj, dim=1)                      # inclusive
        r_t = rj * torch.exp(p - lwj)                     # <= |r|
        k_t = kj * torch.exp(-p)                          # <= |k| e^{5L}
        a = torch.where(mask, r_t @ k_t.transpose(1, 2), 0.0)
        y = r_t @ state                                   # carry-in term
        y = y + a @ vj                                    # intra-chunk
        y = y + torch.sum(rj * u[:, None, :] * kj, -1, keepdim=True) * vj
        p_last = p[:, -1:, :]                             # (BH, 1, D)
        k_rem = kj * torch.exp(p_last - p)
        state = (torch.exp(p_last).transpose(1, 2) * state
                 + k_rem.transpose(1, 2) @ vj)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def wkv_chunked_ref(r, k, v, lw, u, s0):
    """Sequential scan, one token at a time (``kernels/ref.py`` of the JAX
    package)."""
    w = torch.exp(lw)
    state = s0
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        ys.append(torch.einsum("bk,bkv->bv", r[:, t],
                               state + u[:, :, None] * kv))
        state = w[:, t, :, None] * state + kv
    return torch.stack(ys, dim=1), state


def _check(r, k, v, lw, u, s0, chunk):
    if r.dim() != 3:
        raise ValueError(f"want r (BH, S, D), got {tuple(r.shape)}")
    shape = r.shape
    bh, s, d = shape
    device, cuda = r.get_device(), r.is_cuda     # -1 off the card
    for name, x, want in (("r", r, shape), ("k", k, shape), ("v", v, shape),
                          ("lw", lw, shape), ("u", u, (bh, d)),
                          ("s0", s0, (bh, d, d))):
        if x.shape != want or x.dtype != torch.float32:
            raise ValueError(f"want {name} {tuple(want)} float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.get_device() != device or x.is_cuda != cuda:
            raise ValueError(f"{name} on {x.device}, r on {r.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim D={d}: the kernel takes {HEAD_DIMS}")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk={chunk}: the kernel takes {CHUNKS}")
    if s == 0 or s % chunk:
        raise ValueError(f"S={s} is not a positive multiple of chunk={chunk}")


def _layout(r, k, v, lw, y):
    """(head stride, token stride) that r, k, v, lw and y share where the
    kernel can read them through it (D contiguous, strides and bases in
    whole 16-byte words), else None."""
    st = r.stride()
    hs = st[0] if r.shape[0] > 1 else 0
    if (st[2] == 1 and hs % 4 == 0 and st[1] % 4 == 0
            and k.stride() == st and v.stride() == st and lw.stride() == st
            and y.stride() == st
            and not (r.data_ptr() | k.data_ptr() | v.data_ptr()
                     | lw.data_ptr()) % 16):
        return hs, st[1]
    return None


def wkv_chunked(r, k, v, lw, u, s0, chunk: int = 16):
    _check(r, k, v, lw, u, s0, chunk)
    if not r.is_cuda:
        if r.device.type == "cpu":
            return wkv_chunked_plain(r, k, v, lw, u, s0, chunk)
        raise ValueError(f"no wkv_chunked for device {r.device}")
    u, s0 = u.contiguous(), s0.contiguous()
    bh, s, d = r.shape
    y = torch.empty_like(r)             # r's strides where r is dense
    s_final = torch.empty_like(s0)
    if bh == 0:
        return y, s_final
    layout = _layout(r, k, v, lw, y)
    if layout is None:
        # One layout for all five; the batch-1 prefill's views share one.
        r, k, v, lw = (t.contiguous() for t in (r, k, v, lw))
        y = torch.empty_like(r)
        layout = (d * s if bh > 1 else 0, d)
    device = r.get_device()
    plan = _plan(bh, s, d, chunk, _sm_count(device))
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_final.data_ptr(),
            *layout, bh, s, d, chunk, *plan)
    fn = _library().repro_wkv_chunked
    if device == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(r.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        _build.check(_library(), rc, "wkv_chunked")
    global launches
    launches += 1
    return y, s_final
