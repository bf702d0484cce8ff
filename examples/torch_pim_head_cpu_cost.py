"""CPU seconds of one <8:8> product with a float weight, with and without
the weight's planes.

``quantized_matmul`` quantizes a float weight at every call, as a tied
head at <8:8> is (``embed.T``). On the backends that contract the codes
(``int-direct``, ``mxu-plane``) it packs no planes, which they never read;
packing them anyway is what ``prepack`` does. This times both on the CPU
at llama3.2-3b's tied head (K = 3072, N = 128,256, float32, random from a
seed; ``--rows`` cuts N) for M = 1 and 4 activation rows, holds the two
outputs equal, and prints one JSON line per M with the host's seconds.

  PYTHONPATH=src python examples/torch_pim_head_cpu_cost.py --rows 16032
"""
import argparse
import json
import time

import torch

from repro_torch.core.bitserial import quantized_matmul
from repro_torch.core.packed import prepack


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=128256)
    ap.add_argument("--k", type=int, default=3072)
    ap.add_argument("--backend", default="int-direct",
                    choices=("int-direct", "mxu-plane"))
    args = ap.parse_args()
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((args.k, args.rows), generator=gen)
    for m in (1, 4):
        a = torch.randn((m, args.k), generator=gen)
        t = time.perf_counter()
        codes_only = quantized_matmul(a, w, 8, 8, backend=args.backend)
        codes_only_s = time.perf_counter() - t
        t = time.perf_counter()
        with_planes = quantized_matmul(a, prepack(w, 8), 8, 8,
                                       backend=args.backend)
        with_planes_s = time.perf_counter() - t
        if not torch.equal(codes_only, with_planes):
            raise AssertionError("the two routes differ")
        print(json.dumps(dict(
            M=m, K=args.k, N=args.rows, backend=args.backend,
            threads=torch.get_num_threads(), codes_only_s=codes_only_s,
            with_planes_s=with_planes_s)), flush=True)


if __name__ == "__main__":
    main()
