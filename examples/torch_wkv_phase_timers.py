#!/usr/bin/env python3
"""Where kernel 5 (the chunked WKV) spends a call, step by step, on the GPU.

    python3 examples/torch_wkv_phase_timers.py

Builds an instrumented copy of ``kernels/csrc/wkv_chunked.cu`` into
``kernels/build/`` (git-ignored): a barrier and a ``clock64`` read by
block 0's first thread after each step, summed over the batches of a call
into a device array. Runs it at rwkv6-3b's prefill shapes (40 heads of 64,
chunk 16) under every launch plan that fits (``cols`` state columns a
block, ``tokens`` at a time), holds each y to the plain version within
1e-4 of max|y|, and prints the card's name and power limit, then one JSON
line a plan: ms a call (CUDA events around 20 calls queued behind a spin)
and block 0's SM cycles a call by step. The added barriers make each
step's count the time of its slowest warp.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STEPS = ("prologue", "stage first batch", "wait + barrier", "stage next batch",
         "1 cumsum + barrier", "2a A'", "2b dS + barrier", "3 scan + barrier",
         "4 y", "batch end")
SHAPES = ((40, 16), (40, 64), (40, 256), (40, 512), (80, 256))


def instrumented(src: str) -> str:
    """The kernel's source with a timer after each step."""
    marks = [
        ("  const int nbatch = (g.seq + T - 1) / T;\n",
         "  const int nbatch = (g.seq + T - 1) / T;\n  MARK(0);\n"),
        ("  stage(g, lo, sm, head, c0, 0, min(T, g.seq));\n  cp_async_commit();\n",
         "  stage(g, lo, sm, head, c0, 0, min(T, g.seq));\n  cp_async_commit();\n"
         "  MARK(1);\n"),
        ("    __syncthreads();  // the batch staged; every thread done with the last\n",
         "    __syncthreads();  // the batch staged; every thread done with the last\n"
         "    MARK(2);\n"),
        ("    cp_async_commit();\n    float* rs = buf;",
         "    cp_async_commit();\n    MARK(3);\n    float* rs = buf;"),
        ("    // 2a. A'", "    MARK(4);\n    // 2a. A'"),
        ("    // 2b. dS_c", "    MARK(5);\n    // 2b. dS_c"),
        ("    // 3. The scan", "    MARK(6);\n    // 3. The scan"),
        ("    // 4. y =", "    MARK(7);\n    // 4. y ="),
        ("      }\n    }\n  }\n\n  if (owner) {",
         "      }\n    }\n    MARK(8);\n  }\n\n  MARK(9);\n  if (owner) {"),
        ("  extern __shared__ __align__(16) float sm[];\n",
         "  extern __shared__ __align__(16) float sm[];\n"
         "  unsigned long long t_last = clock64();\n"),
        ('#include "common.cuh"\n',
         '#include "common.cuh"\n'
         "__device__ unsigned long long step_cycles[16];\n"
         "#define MARK(i) do { __syncthreads(); if (blockIdx.x == 0 && "
         "threadIdx.x == 0) { unsigned long long n_ = clock64(); "
         "step_cycles[i] += n_ - t_last; t_last = n_; } } while (0)\n"),
    ]
    for old, new in marks:
        if src.count(old) != 1:
            raise RuntimeError(f"wkv_chunked.cu changed: {old.strip()!r}")
        src = src.replace(old, new)
    return src + """
REPRO_EXPORT int repro_step_cycles(unsigned long long* out, int zero) {
  if (zero) {
    unsigned long long z[16] = {};
    return int(cudaMemcpyToSymbol(step_cycles, z, sizeof(z)));
  }
  return int(cudaMemcpyFromSymbol(out, step_cycles, sizeof(step_cycles)));
}
"""


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv_chunk as K

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    cu = _build.BUILD_DIR / "wkv_chunked_timers.cu"
    lib_path = cu.with_suffix(".so")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu.write_text(instrumented((_build.SRC_DIR / "wkv_chunked.cu").read_text()))
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(_build.SRC_DIR), "-o", str(lib_path), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_wkv_chunked.argtypes = K._ARGTYPES["repro_wkv_chunked"]
    lib.repro_step_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gen = torch.Generator(device="cuda").manual_seed(0)
    d, chunk, reps = 64, 16, 20
    for bh, s in SHAPES:
        r, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda") * 0.5
                   for _ in range(3))
        lw = torch.clamp_min(-torch.exp(torch.randn(
            bh, s, d, generator=gen, device="cuda") - 2), -5.0)
        u = torch.randn(bh, d, generator=gen, device="cuda") * 0.2
        s0 = torch.randn(bh, d, d, generator=gen, device="cuda") * 0.1
        y, s_fin = torch.empty_like(r), torch.empty_like(s0)
        y_want, _ = K.wkv_chunked_plain(r, k, v, lw, u, s0, chunk)
        for cols in K.COLS:
            for tokens in sorted({min(t, s) for t in K.TOKENS}, reverse=True):
                if (tokens * d > 8 * K.THREADS
                        or K.smem_bytes(d, cols, tokens, chunk) > K.SMEM_LIMIT):
                    continue

                def call():
                    rc = lib.repro_wkv_chunked(
                        r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        lw.data_ptr(), u.data_ptr(), s0.data_ptr(),
                        y.data_ptr(), s_fin.data_ptr(), s * d, d, bh, s, d,
                        chunk, cols, tokens,
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"wkv_chunked: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                err = ((y - y_want).abs().max() / y_want.abs().max()).item()
                if err > 1e-4:
                    raise AssertionError(f"BH={bh} S={s} cols={cols} "
                                         f"tokens={tokens}: y off by {err}")
                cycles = (ctypes.c_ulonglong * 16)()
                lib.repro_step_cycles(cycles, 1)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(int(2e6))
                start.record()
                for _ in range(reps):
                    call()
                end.record()
                torch.cuda.synchronize()
                lib.repro_step_cycles(cycles, 0)
                print(json.dumps(dict(
                    BH=bh, S=s, D=d, chunk=chunk, cols=cols, tokens=tokens,
                    plan=K._plan(bh, s, d, chunk, K._sm_count(r.device))
                    == (cols, tokens),
                    ms=start.elapsed_time(end) / reps, y_rel_err=err,
                    block0_cycles={n: cycles[i] / reps
                                   for i, n in enumerate(STEPS)})),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
