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

``wkv_chunked_bwd`` is the gradient: given dy (BH, S, D) and dS_final
(BH, D, D, or None for zero) it returns dr, dk, dv, dlw (BH, S, D), du
(BH, D) and ds0 (BH, D, D). A CUDA tensor launches
``csrc/wkv_chunked_bwd.cu`` (the chunk-start states recomputed into
scratch, then a reverse sweep over the chunks); a CPU tensor runs
:func:`wkv_chunked_bwd_plain`, the same equations. :class:`WKVChunked`
ties the two directions into a ``torch.autograd.Function``. The kernels
take float32; on the CPU the plain versions also take float64 operands
(all of r's type), for ``torch.autograd.gradcheck``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

launches = 0
bwd_launches = 0

HEAD_DIMS = (8, 16, 32, 64)
CHUNKS = (8, 16, 32)

_ARGTYPES = {
    "repro_wkv_chunked": [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "repro_wkv_chunked_smem": [ctypes.c_int] * 4,
}
_BWD_ARGTYPES = {
    "repro_wkv_chunked_bwd": [ctypes.c_void_p] * 15 + [ctypes.c_longlong] * 2
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "repro_wkv_chunked_bwd_smem": [ctypes.c_int] * 2,
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


@functools.lru_cache(maxsize=None)
def _bwd_library():
    return _build.load("wkv_chunked_bwd", _BWD_ARGTYPES)


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


def _revcumsum(x):
    """Sums over dim 1 from each position to the end."""
    return torch.flip(torch.cumsum(torch.flip(x, (1,)), 1), (1,))


def wkv_chunked_bwd_plain(r, k, v, lw, u, s0, dy, ds_final, chunk: int):
    """The gradient of :func:`wkv_chunked_plain` in PyTorch, one chunk at a
    time: a forward sweep for the chunk-start states S_c, then a reverse
    sweep carrying dS back. Per chunk, with P = cumsum(lw), Pp = P - lw,
    r~ = r e^{Pp}, k~ = k e^{-P}, k_rem = k e^{P_L - P}, A = strict_lower(
    r~ k~^T), b = sum_d r u k and dS the carry from the next chunk:

        dv  = A^T dy + b dy + k_rem dS
        dA  = strict_lower(dy v^T),  db = sum_v dy v
        dr~ = dA k~ + dy S_c^T,  dk~ = dA^T r~,  dk_rem = v dS^T
        dr  = dr~ e^{Pp} + db u k
        dk  = dk~ e^{-P} + dk_rem e^{P_L - P} + db u r
        du += sum_t db r k
        dP  = -dk~ k~ - dk_rem k_rem, and at P_L
              + sum_s dk_rem k_rem + e^{P_L} sum_v dS S_c
        dlw = revcumsum(dP) + revcumsum(dPp) - dPp,  dPp = dr~ r~
        dS <- e^{P_L} dS (row-wise) + r~^T dy

    ds0 is the last dS. ``ds_final`` None is zero. Returns (dr, dk, dv,
    dlw, du, ds0)."""
    bh, s, d = r.shape
    n = s // chunk
    rc, kc, vc, lwc, dyc = (t.reshape(bh, n, chunk, d)
                            for t in (r, k, v, lw, dy))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)   # s < t
    states, state = [], s0
    for c in range(n):
        p = torch.cumsum(lwc[:, c], dim=1)
        p_last = p[:, -1:, :]
        states.append(state)
        state = (torch.exp(p_last).transpose(1, 2) * state
                 + (kc[:, c] * torch.exp(p_last - p)).transpose(1, 2)
                 @ vc[:, c])
    ds = torch.zeros_like(s0) if ds_final is None else ds_final
    du = torch.zeros_like(u)
    ub = u[:, None, :]
    grads = []
    for c in reversed(range(n)):
        rj, kj, vj, lwj, dyj = (t[:, c] for t in (rc, kc, vc, lwc, dyc))
        p = torch.cumsum(lwj, dim=1)
        pp = p - lwj
        p_last = p[:, -1:, :]
        e_pp, e_np, e_rem = torch.exp(pp), torch.exp(-p), torch.exp(
            p_last - p)
        r_t, k_t, k_rem = rj * e_pp, kj * e_np, kj * e_rem
        a = torch.where(mask, r_t @ k_t.transpose(1, 2), 0.0)
        b = torch.sum(rj * ub * kj, -1, keepdim=True)
        da = torch.where(mask, dyj @ vj.transpose(1, 2), 0.0)
        db = torch.sum(dyj * vj, -1, keepdim=True)
        sc = states[c]
        dv = a.transpose(1, 2) @ dyj + b * dyj + k_rem @ ds
        dr_t = da @ k_t + dyj @ sc.transpose(1, 2)
        dk_t = da.transpose(1, 2) @ r_t
        dk_rem = vj @ ds.transpose(1, 2)
        dr = dr_t * e_pp + db * ub * kj
        dk = dk_t * e_np + dk_rem * e_rem + db * ub * rj
        du = du + torch.sum(db * rj * kj, 1)
        q = dk_rem * k_rem
        dp = -dk_t * k_t - q
        dp_last = (torch.sum(q, 1) + torch.exp(p_last[:, 0])
                   * torch.sum(ds * sc, -1))
        dp = torch.cat([dp[:, :-1], dp[:, -1:] + dp_last[:, None]], 1)
        dpp = dr_t * r_t
        dlw = _revcumsum(dp) + _revcumsum(dpp) - dpp
        ds = (torch.exp(p_last).transpose(1, 2) * ds
              + r_t.transpose(1, 2) @ dyj)
        grads.append((dr, dk, dv, dlw))
    dr, dk, dv, dlw = (torch.cat(g[::-1], dim=1) for g in zip(*grads))
    return dr, dk, dv, dlw, du, ds


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
    dtype = (torch.float64 if r.dtype == torch.float64 and not cuda
             else torch.float32)
    for name, x, want in (("r", r, shape), ("k", k, shape), ("v", v, shape),
                          ("lw", lw, shape), ("u", u, (bh, d)),
                          ("s0", s0, (bh, d, d))):
        if x.shape != want or x.dtype != dtype:
            raise ValueError(f"want {name} {tuple(want)} "
                             f"{str(dtype).split('.')[-1]}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.get_device() != device or x.is_cuda != cuda:
            raise ValueError(f"{name} on {x.device}, r on {r.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim D={d}: the kernel takes {HEAD_DIMS}")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk={chunk}: the kernel takes {CHUNKS}")
    if s == 0 or s % chunk:
        raise ValueError(f"S={s} is not a positive multiple of chunk={chunk}")


def _layout(r, *others):
    """(head stride, token stride) that r and every tensor of ``others``
    share where the kernel can read them through it (D contiguous, strides
    and bases in whole 16-byte words), else None."""
    st = r.stride()
    hs = st[0] if r.shape[0] > 1 else 0
    if (st[2] == 1 and hs % 4 == 0 and st[1] % 4 == 0
            and all(x.stride() == st for x in others)
            and all(x.data_ptr() % 16 == 0 for x in (r, *others))):
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


def _check_grads(r, dy, ds_final):
    bh, _, d = r.shape
    checks = [("dy", dy, tuple(r.shape))]
    if ds_final is not None:
        checks.append(("ds_final", ds_final, (bh, d, d)))
    for name, x, want in checks:
        if tuple(x.shape) != want or x.dtype != r.dtype:
            raise ValueError(f"want {name} {want} {r.dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.get_device() != r.get_device() or x.is_cuda != r.is_cuda:
            raise ValueError(f"{name} on {x.device}, r on {r.device}")


def wkv_chunked_bwd(r, k, v, lw, u, s0, dy, ds_final=None, chunk: int = 16):
    """The gradient of :func:`wkv_chunked` -> (dr, dk, dv, dlw, du, ds0),
    float32. A CUDA tensor launches the backward kernel (or raises); a CPU
    tensor runs :func:`wkv_chunked_bwd_plain`."""
    _check(r, k, v, lw, u, s0, chunk)
    _check_grads(r, dy, ds_final)
    if not r.is_cuda:
        if r.device.type == "cpu":
            return wkv_chunked_bwd_plain(r, k, v, lw, u, s0, dy, ds_final,
                                         chunk)
        raise ValueError(f"no wkv_chunked_bwd for device {r.device}")
    u, s0 = u.contiguous(), s0.contiguous()
    if ds_final is not None:
        ds_final = ds_final.contiguous()
    bh, s, d = r.shape
    grads = [torch.empty_like(r) for _ in range(4)]     # dr, dk, dv, dlw
    du, ds0 = torch.empty_like(u), torch.empty_like(s0)
    if bh == 0:
        return (*grads, du, ds0)
    layout = _layout(r, k, v, lw, dy, *grads)
    if layout is None:
        r, k, v, lw, dy = (t.contiguous() for t in (r, k, v, lw, dy))
        grads = [torch.empty_like(r) for _ in range(4)]
        layout = (d * s if bh > 1 else 0, d)
    # The chunk-start states of the forward sweep, read back in reverse.
    states = torch.empty((bh, s // chunk, d, d), dtype=torch.float32,
                         device=r.device)
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), dy.data_ptr(),
            0 if ds_final is None else ds_final.data_ptr(),
            *(g.data_ptr() for g in grads), du.data_ptr(), ds0.data_ptr(),
            states.data_ptr(), *layout, bh, s, d, chunk)
    fn = _bwd_library().repro_wkv_chunked_bwd
    with torch.cuda.device(r.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        _build.check(_bwd_library(), rc, "wkv_chunked_bwd")
    global bwd_launches
    bwd_launches += 1
    return (*grads, du, ds0)


class WKVChunked(torch.autograd.Function):
    """:func:`wkv_chunked` with :func:`wkv_chunked_bwd` as its gradient.

    Inputs (r, k, v, lw, u, s0, chunk); outputs (y, s_final). The
    backward takes a missing gradient of either output as zero and returns
    None for every input that needs none. Kernel 5 on a CUDA tensor runs
    forward, the backward kernel backward; on the CPU the plain versions."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, s0, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, lw, u, s0)
        return wkv_chunked(r, k, v, lw, u, s0, chunk)

    @staticmethod
    def backward(ctx, dy, ds_final):
        r, k, v, lw, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        grads = wkv_chunked_bwd(r, k, v, lw, u, s0, dy, ds_final, ctx.chunk)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)

