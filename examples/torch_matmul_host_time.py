#!/usr/bin/env python3
"""Host time of one call of kernel 2's wrapper at rwkv6-3b's decode shape
(M = 4, K = N = 2560, <8:8>) on the GPU.

    python3 examples/torch_matmul_host_time.py [--batches 40] [--calls 100]

Issues ``ops.bitserial_matmul`` in batches of back-to-back calls and times
each batch on the host's clock; the card runs such a call in about 0.01 ms,
less than the host takes to issue it, so no call waits on the card. Prints
the card's name and power limit, then one JSON line: the median and
quartiles over the batches of the host's ms a call. It finds the package
beside itself (``../src``), so a copy placed in another checkout measures
that checkout's wrapper.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--calls", type=int, default=100)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core.packed import prepack
    from repro_torch.kernels import ops

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    m, k, n = 4, 2560, 2560
    qa = torch.randint(0, 256, (m, k), generator=gen, device="cuda",
                       dtype=torch.int32)
    pw = prepack(torch.randn((k, n), generator=gen, device="cuda"), 8).planes

    def call():
        return ops.bitserial_matmul(qa, a_bits=8, w_bits=8, pw=pw)

    for _ in range(3 * args.calls):      # build, load, warm
        call()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(args.batches):
        t = time.perf_counter()
        for _ in range(args.calls):
            call()
        per_call.append((time.perf_counter() - t) * 1e3 / args.calls)
        torch.cuda.synchronize()
    q1, med, q3 = (float(x) for x in np.percentile(per_call, [25, 50, 75]))
    print(json.dumps(dict(kernel="bitserial_matmul_fused", M=m, K=k, N=n,
                          bits="<8:8>", batches=args.batches,
                          calls=args.calls, host_ms_median=med,
                          host_ms_q1=q1, host_ms_q3=q3)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
