"""Chunked RWKV-6 WKV: the CUDA kernel's wrapper and its plain PyTorch
versions.

``wkv_chunked(r, k, v, lw, u, s0, chunk)`` takes r, k, v and the clamped
log decay lw (BH, S, D) float32, the bonus u (BH, D) and the state s0
(BH, D, D), and returns (y (BH, S, D), s_final (BH, D, D)) float32. The
state is key-major: y_t = r_t (S + (u k_t)^T v_t), S <- diag(e^{lw_t}) S +
k_t^T v_t, computed L = ``chunk`` tokens at a time with the algebra of the
JAX package's ``_chunked_wkv``.

A CUDA tensor launches ``csrc/wkv_chunked.cu``; a CPU tensor runs
:func:`wkv_chunked_plain`, the same chunked algebra. Either way D must be
8, 16, 32 or 64, ``chunk`` 8, 16 or 32 and S a positive multiple of
``chunk``. :func:`wkv_chunked_ref` is the sequential scan, the oracle of
both.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

HEAD_DIMS = (8, 16, 32, 64)
CHUNKS = (8, 16, 32)

_ARGTYPES = {"repro_wkv_chunked": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
             + [ctypes.c_void_p]}


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
    bh, s, d = r.shape
    want = {"r": (r, (bh, s, d)), "k": (k, (bh, s, d)), "v": (v, (bh, s, d)),
            "lw": (lw, (bh, s, d)), "u": (u, (bh, d)),
            "s0": (s0, (bh, d, d))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"want {name} {shape} float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != r.device:
            raise ValueError(f"{name} on {x.device}, r on {r.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim D={d}: the kernel takes {HEAD_DIMS}")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk={chunk}: the kernel takes {CHUNKS}")
    if s == 0 or s % chunk:
        raise ValueError(f"S={s} is not a positive multiple of chunk={chunk}")


def wkv_chunked(r, k, v, lw, u, s0, chunk: int = 16):
    _check(r, k, v, lw, u, s0, chunk)
    if r.device.type == "cpu":
        return wkv_chunked_plain(r, k, v, lw, u, s0, chunk)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv_chunked for device {r.device}")
    r, k, v, lw, u, s0 = (t.contiguous() for t in (r, k, v, lw, u, s0))
    bh, s, d = r.shape
    y = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    if bh == 0:
        return y, s_final
    lib = _build.load("wkv_chunked", _ARGTYPES)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_wkv_chunked(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_final.data_ptr(),
            bh, s, d, chunk, stream)
    _build.check(lib, rc, "wkv_chunked")
    global launches
    launches += 1
    return y, s_final
