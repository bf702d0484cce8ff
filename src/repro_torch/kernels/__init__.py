"""Hand-written CUDA kernels for sm_90a (H100): the paper's Eq. 1 hot spot
and the RWKV-6 WKV recurrence.

  csrc/*.cu            the kernels, each a plain-C shared library
  _build.py            nvcc build at first use + ctypes loading
  bitplane_pack.py     bit-plane slice + lane pack (+ plain version)
  bitserial_matmul.py  AND/popcount matmul from codes (fused pack) or from
                       packed planes (+ plain versions)
  conv2d_fused.py      implicit-im2col bit-serial conv (+ plain version)
  rwkv_chunk.py        chunked RWKV-6 WKV (+ plain chunked version and
                       the sequential scan)
  ops.py               public wrappers and launch counters

The submodules are imported by name (``from repro_torch.kernels import
ops``); nothing is re-exported, so no function shadows a module.
"""
