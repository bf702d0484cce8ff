#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit (``nvcc`` with sm_90a). It imports nothing of JAX or of the
JAX package ``repro``, and fails (non-zero exit, no result line) on any
failed phase, without a GPU, or outside a checkout.

1. Prints the card's name and power limit; turns TF32 off.
2. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. Holds each of the four kernels against its plain PyTorch version on the
   card with ``torch.equal`` at the shapes ResNet-50, AlexNet and VGG19
   give it at 224 px in a bucket of 8, plus ragged shapes at <2:2>, <4:4>
   and <8:8>; prints one JSON line per shape with the kernel's time, the
   plain version's, a PyTorch library call's where one computes the same P
   exactly, and the least time the card could take for the same P
   (``bound_ms``), beside the least time of the kernel's own algorithm at
   the card's popcount rate (``popc_bound_ms``). Then holds the four Eq. 1
   backends' P equal to each other at AlexNet conv1's im2col shape.
4. Serves 12 requests (buckets 8 + 4) through ``VisionEngine`` with
   ResNet-50 (random weights from a seed, 1000 classes, 224 px, <8:8>,
   backend "cuda") twice, a warm run and a timed run, and checks that every
   kernel of the path launched during the timed run and that the logits are
   finite. Then times five buckets of 8 and profiles one, for the device's
   idle share of a bucket, and serves the float path.
5. Serves AlexNet on the "cuda" and on the "popcount" backend and VGG19 on
   "cuda" the same way (224 px, full width and depth, <8:8>, buckets of 8
   timed and profiled), each path's launch counts set to 0 just before its
   timed run and read just after.
6. Serves 2 images at a small size on the card and on the CPU (plain
   versions) with the same weights, for each served model and backend:
   equal top-1, logits within rtol 1e-3 and atol 1e-3*max|cpu| (the
   integer P is exact on both; the global average pool and the float
   epilogues reduce in another order on the GPU).

Each phase prints its wall seconds on a line of its own. The last three
lines are the card's name and power limit, the per-kernel summary
``{"kernels": [...]}`` (launches counted on the ResNet-50 path for kernels
1-3 and on the AlexNet popcount path for kernel 4), and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Peak rates of the card (NVIDIA H100 SXM data sheet, dense): memory
# 3.35 TB/s; int8 tensor cores 1,979 TOP/s, one multiply-add being two
# operations. Eq. 1's P is a product of codes of at most 8 bits, so the
# int8 rate bounds the function at every precision the slice serves, and
# ``bound_ms`` is the larger of its operations' and its bytes' time.
# ``popc_bound_ms`` is the bit-serial algorithm's own floor, a secondary
# number: its AND+POPC pairs at 16 __popc per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput table, compute
# capability 9.0) times the SM count and the card's maximum SM clock.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
POPC_PER_CLOCK_PER_SM = 16

KERNEL_INFO = {
    "bitplane_pack": dict(
        source="src/repro_torch/kernels/csrc/bitplane_pack.cu",
        replaces="src/repro/kernels/bitplane_pack.py:28"),
    "bitserial_matmul_fused": dict(
        source="src/repro_torch/kernels/csrc/bitserial_matmul.cu",
        replaces="src/repro/kernels/bitserial_matmul.py:159"),
    "bitserial_matmul_packed": dict(
        source="src/repro_torch/kernels/csrc/bitserial_matmul.cu",
        replaces="src/repro/kernels/bitserial_matmul.py:120"),
    "conv2d_bitserial_fused": dict(
        source="src/repro_torch/kernels/csrc/conv2d_fused.cu",
        replaces="src/repro/kernels/conv2d_fused.py:73"),
}


class phase:
    """Prints a phase's wall seconds on a line of its own when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s",
                  flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class KernelChecks:
    """Kernel-vs-plain comparisons; one JSON line per (kernel, shape)."""

    def __init__(self, torch, popc_per_s: float):
        self.torch = torch
        self.popc_per_s = popc_per_s
        self.gen = torch.Generator(device="cuda").manual_seed(0)
        self.rows = []

    @staticmethod
    def _bound(nbytes: float, macs: float) -> tuple:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * macs / INT8_OPS_PER_S * 1e3
        return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")

    def _codes(self, shape, bits):
        return self.torch.randint(0, 2**bits, shape, generator=self.gen,
                                  device="cuda", dtype=self.torch.int32)

    def _record(self, name, shape, bits, got, want, kernel_fn, plain_fn,
                library_fn, nbytes, macs, popcs, timing):
        torch = self.torch
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            diff = (got.long() - want.long()).abs().max().item() \
                if got.shape == want.shape else None
            raise AssertionError(f"{name} {shape} {bits}: kernel != plain "
                                 f"(max |diff| {diff})")
        row = dict(kernel=name, shape=shape, bits=bits, max_abs_err=0)
        if timing:
            bound_ms, bound_by = self._bound(nbytes, macs)
            row.update(
                kernel_ms=timed_ms(kernel_fn, 20),
                plain_ms=timed_ms(plain_fn, 2),
                library_ms=None if library_fn is None
                else timed_ms(library_fn, 5),
                bound_ms=bound_ms, bound_by=bound_by,
                popc_bound_ms=popcs / self.popc_per_s * 1e3 if popcs
                else None)
        print(json.dumps(row), flush=True)
        self.rows.append(row)

    def pack(self, m, k, bits, timing=True):
        from repro_torch.kernels import bitplane_pack as kp

        q = self._codes((m, k), bits)
        kw = (k + 31) // 32
        self._record(
            "bitplane_pack", dict(M=m, K=k), f"{bits} planes",
            kp.bitplane_pack(q, bits), kp.bitplane_pack_plain(q, bits),
            lambda: kp.bitplane_pack(q, bits),
            lambda: kp.bitplane_pack_plain(q, bits), None,
            nbytes=4 * m * k + 4 * bits * m * kw, macs=0, popcs=0,
            timing=timing)

    def matmul(self, m, k, n, wb, ab, timing=True):
        torch = self.torch
        from repro_torch.core.packed import prepack
        from repro_torch.kernels import bitserial_matmul as km

        qa = self._codes((m, k), ab)
        w = torch.randn((k, n), generator=self.gen, device="cuda")
        pw = prepack(w, wb)
        kw = pw.planes.shape[-1]
        a64, w64 = qa.double(), pw.codes.double()
        self._record(
            "bitserial_matmul_fused", dict(M=m, K=k, N=n), f"<{wb}:{ab}>",
            km.bitserial_matmul_fused(qa, pw.planes, ab, wb),
            km.bitserial_matmul_fused_plain(qa, pw.planes, ab, wb),
            lambda: km.bitserial_matmul_fused(qa, pw.planes, ab, wb),
            lambda: km.bitserial_matmul_fused_plain(qa, pw.planes, ab, wb),
            lambda: torch.matmul(a64, w64),
            nbytes=4 * m * k + 4 * wb * n * kw + 4 * m * n, macs=m * n * k,
            popcs=m * n * kw * ab * wb, timing=timing)

    def packed(self, m, k, n, wb, ab, timing=True):
        torch = self.torch
        from repro_torch.core.packed import prepack
        from repro_torch.kernels import bitserial_matmul as km
        from repro_torch.kernels import ops

        qa = self._codes((m, k), ab)
        w = torch.randn((k, n), generator=self.gen, device="cuda")
        pw = prepack(w, wb)
        pa = ops.pack_planes(qa, ab)
        kw = pa.shape[-1]
        a64, w64 = qa.double(), pw.codes.double()
        self._record(
            "bitserial_matmul_packed", dict(M=m, K=k, N=n), f"<{wb}:{ab}>",
            km.bitserial_matmul_packed(pa, pw.planes, ab, wb),
            km.packed_matmul_plain(pa, pw.planes),
            lambda: km.bitserial_matmul_packed(pa, pw.planes, ab, wb),
            lambda: km.packed_matmul_plain(pa, pw.planes),
            lambda: torch.matmul(a64, w64),
            nbytes=4 * ab * m * kw + 4 * wb * n * kw + 4 * m * n,
            macs=m * n * k, popcs=m * n * kw * ab * wb, timing=timing)

    def conv(self, n, h, c, o, ks, stride, pad, wb, ab, timing=True):
        torch = self.torch
        import torch.nn.functional as F

        from repro_torch.core.packed import prepack_conv
        from repro_torch.kernels import conv2d_fused as kc
        from repro_torch.kernels import ops

        qx = F.pad(self._codes((n, h, h, c), ab), (0, 0, pad, pad, pad, pad))
        w = torch.randn((ks, ks, c, o), generator=self.gen, device="cuda")
        pk = prepack_conv(w, wb)
        hp = h + 2 * pad
        oh = (hp - ks) // stride + 1
        cw = pk.fused_planes.shape[-1]
        pa = ops.pack_planes(qx.reshape(n * hp * hp, c), ab).reshape(
            ab, n * hp, hp, cw)
        geo = dict(n=n, hp=hp, oh=oh, ow=oh, stride=stride)
        x64 = qx.permute(0, 3, 1, 2).double()
        w64 = pk.mat.codes.reshape(ks, ks, c, o).permute(3, 2, 0, 1).double()
        self._record(
            "conv2d_bitserial_fused",
            dict(N=n, H=h, C=c, O=o, k=ks, stride=stride, pad=pad),
            f"<{wb}:{ab}>",
            kc.conv2d_bitserial_fused(pa, pk.fused_planes, **geo),
            kc.conv2d_fused_plain(pa, pk.fused_planes, **geo),
            lambda: kc.conv2d_bitserial_fused(pa, pk.fused_planes, **geo),
            lambda: kc.conv2d_fused_plain(pa, pk.fused_planes, **geo),
            lambda: F.conv2d(x64, w64, stride=stride),
            nbytes=4 * ab * n * hp * hp * cw + pk.fused_planes.numel() * 4
            + 4 * n * oh * oh * o, macs=n * oh * oh * o * ks * ks * c,
            popcs=n * oh * oh * o * ks * ks * cw * ab * wb, timing=timing)


def profile_bucket(torch, eng, imgs, request_cls, model) -> dict:
    """Device time by kernel over one served bucket (torch.profiler), the
    bucket's wall time under the profiler and the device's idle share of
    it, and the host-to-device copies and stream synchronisations that
    stall the host."""
    from torch.profiler import ProfilerActivity, profile

    for rid in range(len(imgs)):
        eng.submit(request_cls(rid=rid, image=imgs[rid], model=model))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.run(strict=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    host_calls = {e.key: e.count for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU}
    dev = {e.key: (e.device_time_total / 1e3, e.count) for e in kernels}
    device_ms = sum(ms for ms, _ in dev.values())
    ours = {k: v for k, v in dev.items()
            if any(s in k for s in ("bitplane_pack_kernel",
                                    "bitserial_matmul_kernel",
                                    "conv2d_fused_kernel"))}
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=1 - device_ms / wall_ms if wall_ms else None,
                bitserial_kernels_ms=sum(ms for ms, _ in ours.values()),
                launches_on_device=sum(n for _, n in dev.values()),
                htod_copies=sum(n for k, (_, n) in dev.items()
                                if "HtoD" in k),
                syncs=sum(host_calls.get(k, 0) for k in (
                    "cudaStreamSynchronize", "cudaDeviceSynchronize",
                    "cudaMemcpy")),
                top=[[k[:80], ms, n] for k, (ms, n) in top])


def summary(rows, name, launches, headline):
    """The summary entry of one kernel: its headline shape's numbers."""
    row = next(r for r in rows if r["kernel"] == name and r["shape"] == headline)
    return dict(name=name, route="cuda", **KERNEL_INFO[name],
                launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in rows
                                if r["kernel"] == name),
                ms=row["kernel_ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"],
                popc_bound_ms=row["popc_bound_ms"], shape=headline)


# Kernels each served path must launch (the rest may stay at 0).
PATH_KERNELS = {
    "cuda": ("bitplane_pack", "bitserial_matmul_fused",
             "conv2d_bitserial_fused"),
    "popcount": ("bitplane_pack", "bitserial_matmul_packed"),
}


def serve_path(torch, np, ops, eng, model, backend, imgs, request_cls):
    """One served path: a warm run (prepack, first launches), a timed run of
    every image with the launch counts set to 0 just before it and read just
    after, then five buckets of 8 timed without the profiler (whose
    host-side tracing slows dispatch; the last one's launches are the
    launches per bucket) and one profiled bucket, for the device's idle
    share. Fails if a kernel of the path never launched, on wrong buckets
    or on non-finite or misshapen logits."""

    def serve(n):
        for rid in range(n):
            eng.submit(request_cls(rid=rid, image=imgs[rid], model=model))
        t = time.perf_counter()
        done = eng.run(strict=True)
        torch.cuda.synchronize()
        return sorted(done, key=lambda c: c.rid), time.perf_counter() - t

    serve(len(imgs))
    ops.reset_launch_counts()
    done, dt = serve(len(imgs))
    launches = ops.launch_counts()
    buckets = sorted({c.batch for c in done})
    if buckets != [4, 8] or len(done) != 12:
        raise AssertionError(f"{model}/{backend}: buckets {buckets} for "
                             f"{len(done)} completions")
    if not all(np.isfinite(c.logits).all() and c.logits.shape == (1000,)
               for c in done):
        raise AssertionError(f"{model}/{backend}: non-finite or misshapen "
                             "logits")
    missing = [k for k in PATH_KERNELS[backend] if not launches[k]]
    if missing:
        raise AssertionError(f"{model}/{backend}: {missing} never launched on "
                             f"the main path: {launches}")
    walls = []
    for _ in range(5):
        ops.reset_launch_counts()
        walls.append(serve(8)[1] * 1e3)
    print(json.dumps(dict(
        serving=model, backend=backend, image=imgs.shape[1],
        precision="<8:8>", requests=12, buckets=[8, 4], seconds=dt,
        img_per_s=12 / dt, launches=launches,
        launches_per_bucket_of_8=ops.launch_counts(),
        bucket_of_8_wall_ms=walls)), flush=True)
    prof = profile_bucket(torch, eng, imgs[:8], request_cls, model)
    prof["idle_share_unprofiled"] = 1 - prof["device_ms"] / float(
        np.median(walls))
    print(json.dumps(dict(profile_bucket_of_8=prof, serving=model,
                          backend=backend)), flush=True)
    return done, launches


def gpu_vs_cpu(torch, np, module, model, backend, image):
    """2 images at ``image`` px through the engine on the card and on the
    CPU (plain versions), the same weights: equal top-1, logits within rtol
    1e-3 and atol 1e-3*max|cpu|."""
    from repro_torch.serving import VisionEngine, VisionRequest

    params = module.init(torch.Generator().manual_seed(0), num_classes=1000,
                         image=image)
    small = np.random.default_rng(1).standard_normal(
        (2, image, image, 3)).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        e = VisionEngine({model: params}, backend=backend, max_batch=2,
                         device=device)
        for rid in range(2):
            e.submit(VisionRequest(rid=rid, image=small[rid], model=model,
                                   precision="<8:8>"))
        out[device] = sorted(e.run(strict=True), key=lambda c: c.rid)
    gpu = np.stack([c.logits for c in out["cuda"]])
    cpu = np.stack([c.logits for c in out["cpu"]])
    err = float(np.abs(gpu - cpu).max())
    scale = float(np.abs(cpu).max())
    top1 = ([c.top1 for c in out["cuda"]], [c.top1 for c in out["cpu"]])
    if top1[0] != top1[1] or not np.allclose(gpu, cpu, rtol=1e-3,
                                             atol=1e-3 * scale):
        raise AssertionError(f"{model}/{backend} GPU vs CPU at {image} px: "
                             f"max |diff| {err} (max|cpu| {scale}), top1 "
                             f"{top1[0]} vs {top1[1]}")
    print(json.dumps(dict(gpu_vs_cpu=model, backend=backend, image=image,
                          max_abs_diff=err, max_abs_cpu=scale)), flush=True)


def backends_agree(torch, m, k, n, bits):
    """P of the four Eq. 1 backends on the card, equal bit for bit."""
    from repro_torch.core import bitserial
    from repro_torch.core.packed import prepack

    gen = torch.Generator(device="cuda").manual_seed(1)
    qa = torch.randint(0, 2**bits, (m, k), generator=gen, device="cuda",
                       dtype=torch.int32)
    pk = prepack(torch.randn((k, n), generator=gen, device="cuda"), bits)
    ps = {b: bitserial.int_matmul_prepacked(qa, pk, bits, b)
          for b in bitserial.BACKENDS}
    torch.cuda.synchronize()
    want = ps["int-direct"]
    bad = [b for b, p in ps.items() if not torch.equal(p, want)]
    if bad:
        raise AssertionError(f"backends {bad} differ from int-direct at "
                             f"M={m}, K={k}, N={n}, <{bits}:{bits}>")
    print(json.dumps(dict(backends_equal=sorted(ps), M=m, K=k, N=n,
                          bits=f"<{bits}:{bits}>")), flush=True)


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from the root of a checkout "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; the port's "
              "smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    from repro_torch import disable_tf32
    from repro_torch.kernels import _build, ops
    from repro_torch.models.cnn import alexnet, resnet, vgg
    from repro_torch.serving import VisionEngine, VisionRequest

    disable_tf32()
    for mod in ("jax", "repro"):
        if mod in sys.modules:
            raise AssertionError(f"the port imported {mod}")

    # -- 2. build ------------------------------------------------------------
    with phase("build"):
        t0 = time.perf_counter()
        build_s = _build.build()
        print(f"built {sorted(build_s)} in {time.perf_counter() - t0:.1f}s "
              f"(per nvcc: { {k: round(v, 1) for k, v in build_s.items()} })",
              flush=True)
        for name in _build.KERNELS:
            log = _build.BUILD_DIR / f"{name}.log"
            if log.exists():
                print(f"--- nvcc {name} ---\n{log.read_text().strip()}",
                      flush=True)

    # -- 3. kernels against their plain versions -----------------------------
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    popc_per_s = POPC_PER_CLOCK_PER_SM * props.multi_processor_count \
        * clock_mhz * 1e6
    print(f"bounds: memory {HBM_BYTES_PER_S:.3g} B/s, int8 "
          f"{INT8_OPS_PER_S:.4g} op/s; popcount {props.multi_processor_count} "
          f"SMs at {clock_mhz:.0f} MHz -> {popc_per_s:.4g} popc/s",
          flush=True)
    kc = KernelChecks(torch, popc_per_s)
    with phase("kernels"):
        # ResNet-50 shapes at 224 px, bucket of 8, <8:8>.
        kc.pack(8 * 230 * 230, 3, 8)          # stem input, C=3 -> one word
        kc.pack(8 * 58 * 58, 64, 8)           # s0 3x3 input
        kc.pack(8 * 58 * 58, 128, 8)          # s1b0.c2 input
        kc.conv(8, 224, 3, 64, 7, 2, 3, 8, 8)     # stem 7x7/2
        kc.conv(8, 56, 64, 64, 3, 1, 1, 8, 8)     # s0 3x3
        kc.conv(8, 56, 128, 128, 3, 2, 1, 8, 8)   # s1b0.c2 3x3/2
        kc.matmul(8 * 56 * 56, 256, 64, 8, 8)     # s0 1x1 (c1 of s0b1)
        kc.matmul(8, 2048, 1000, 8, 8)            # head
        # AlexNet: its convs on "cuda", its im2col GEMMs on "popcount".
        kc.conv(8, 224, 3, 96, 11, 4, 2, 8, 8)    # conv1 11x11/4
        kc.conv(8, 27, 96, 256, 5, 1, 2, 8, 8)    # conv2 5x5
        kc.packed(8 * 55 * 55, 363, 96, 8, 8)     # conv1 im2col
        kc.packed(8 * 27 * 27, 2400, 256, 8, 8)   # conv2 im2col
        kc.packed(8 * 13 * 13, 2304, 384, 8, 8)   # conv3 im2col
        kc.packed(8 * 13 * 13, 3456, 384, 8, 8)   # conv4 im2col
        kc.packed(8 * 13 * 13, 3456, 256, 8, 8)   # conv5 im2col
        kc.packed(8, 9216, 4096, 8, 8)            # fc1
        kc.packed(8, 4096, 4096, 8, 8)            # fc2
        kc.packed(8, 4096, 1000, 8, 8)            # head
        kc.packed(8, 64, 192, 4, 4)               # the Pallas bn % 128 != 0
        kc.packed(8, 64, 320, 4, 4)               # regression shapes
        # VGG19 on "cuda": its first conv, a C=O=512 conv at 28 and at 14
        # px, and fc1.
        kc.conv(8, 224, 3, 64, 3, 1, 1, 8, 8)     # conv1_1
        kc.conv(8, 28, 512, 512, 3, 1, 1, 8, 8)   # conv4_2
        kc.conv(8, 14, 512, 512, 3, 1, 1, 8, 8)   # conv5_1
        kc.matmul(8, 25088, 4096, 8, 8)           # fc1
        # Ragged cases at each paper precision.
        for bits in (2, 4, 8):
            kc.pack(37, 70, bits, timing=False)
            kc.matmul(37, 70, 131, bits, bits, timing=False)
            kc.packed(37, 70, 131, bits, bits, timing=False)
            kc.packed(8, 4000, 1000, bits, bits, timing=bits == 8)
            kc.conv(2, 9, 5, 131, 3, 2, 1, bits, bits, timing=False)
        backends_agree(torch, 8 * 55 * 55, 363, 96, 8)   # AlexNet conv1

    imgs = np.random.default_rng(0).standard_normal(
        (12, 224, 224, 3)).astype(np.float32)

    # -- 4. serving ResNet-50 -------------------------------------------------
    with phase("serve resnet50 cuda"):
        params = resnet.init(torch.Generator().manual_seed(0),
                             num_classes=1000, image=224)
        eng = VisionEngine({"resnet50": params}, backend="cuda", max_batch=8)
        done, launches = serve_path(torch, np, ops, eng, "resnet50", "cuda",
                                    imgs, VisionRequest)
    with phase("serve resnet50 float"):
        fdone = None
        for _ in range(2):                          # warm, then timed
            for rid in range(len(imgs)):
                eng.submit(VisionRequest(rid=rid, image=imgs[rid],
                                         model="resnet50", precision=None))
            t = time.perf_counter()
            fdone = sorted(eng.run(strict=True), key=lambda c: c.rid)
            torch.cuda.synchronize()
            fdt = time.perf_counter() - t
        agree = float(np.mean([a.top1 == b.top1 for a, b in zip(done, fdone)]))
        print(json.dumps(dict(float_path_img_per_s=12 / fdt,
                              top1_agreement_with_float=agree)), flush=True)
    del eng, params

    # -- 5. serving AlexNet and VGG19 -----------------------------------------
    paths = {}
    for model, module, backend in (("alexnet", alexnet, "cuda"),
                                   ("alexnet", alexnet, "popcount"),
                                   ("vgg19", vgg, "cuda")):
        with phase(f"serve {model} {backend}"):
            params = module.init(torch.Generator().manual_seed(0),
                                 num_classes=1000, image=224)
            eng = VisionEngine({model: params}, backend=backend, max_batch=8)
            _, paths[(model, backend)] = serve_path(
                torch, np, ops, eng, model, backend, imgs, VisionRequest)
            del eng, params
            torch.cuda.empty_cache()

    # -- 6. end to end against the CPU's plain versions ----------------------
    for module, model, backend, image in (
            (resnet, "resnet50", "cuda", 32), (alexnet, "alexnet", "cuda", 64),
            (alexnet, "alexnet", "popcount", 64), (vgg, "vgg19", "cuda", 32)):
        with phase(f"gpu vs cpu {model} {backend}"):
            gpu_vs_cpu(torch, np, module, model, backend, image)

    kernels = [
        summary(kc.rows, "bitplane_pack", launches["bitplane_pack"],
                dict(M=8 * 58 * 58, K=64)),
        summary(kc.rows, "bitserial_matmul_fused",
                launches["bitserial_matmul_fused"],
                dict(M=8 * 56 * 56, K=256, N=64)),
        summary(kc.rows, "bitserial_matmul_packed",
                paths[("alexnet", "popcount")]["bitserial_matmul_packed"],
                dict(M=8 * 27 * 27, K=2400, N=256)),
        summary(kc.rows, "conv2d_bitserial_fused",
                launches["conv2d_bitserial_fused"],
                dict(N=8, H=56, C=64, O=64, k=3, stride=1, pad=1)),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
