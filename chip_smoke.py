#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-rows   # build, then kernels 1 and 5's
                                          # timed rows only
    python3 chip_smoke.py --autotune      # build, then phase 9 only
    python3 chip_smoke.py --faults        # build, then phase 10 only
    python3 chip_smoke.py --train         # build, then phase 11 only

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit (``nvcc`` with sm_90a). It imports nothing of JAX or of the
JAX package ``repro``, and fails (non-zero exit, no result line) on any
failed phase, without a GPU, or outside a checkout.

1. Prints the card's name and power limit; turns TF32 off.
2. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, and
   checks that kernels 2-4 were built onto the int8 tensor cores (IMMA in
   the SASS of ``bitserial_matmul`` and ``conv2d_fused``) without spills.
3. Holds each of kernels 1-4 against its plain PyTorch version on the
   card with ``torch.equal`` at the shapes ResNet-50, AlexNet and VGG19
   give it at 224 px in a bucket of 8, plus ragged shapes at <2:2>, <4:4>
   and <8:8>; prints one JSON line per shape with the kernel's time, the
   plain version's, a PyTorch library call's where one computes the same P
   exactly, and the least time the card could take for the same P
   (``bound_ms``).
   ``kernel_ms`` and ``library_ms`` are CUDA events around 20 and 5
   back-to-back calls (the median of five rounds), so they hold the host's
   launch time where that is the longer; ``kernel_device_ms`` and
   ``library_device_ms`` time the same calls queued behind a spin of the
   card, the device alone; ``kernel_host_ms`` is the host's median time
   to issue one kernel call.
   Kernel 3 is held at every row of ``CONV_ROWS`` (each prints its launch
   plan, and ``im2col_route_device_ms``, the device time of the route
   ``pim_conv2d`` takes with ``conv_mode="im2col"``: the codes' patch
   matrix, then kernel 2, whose P is held equal), ``RAGGED_CONV_ROWS``
   and ``CONV_WRAP_ROW`` (all codes 255, K past one slab, P past 2^31).
   Kernels 2 and 4 are held at every row of ``FUSED_ROWS`` and
   ``PACKED_ROWS``: every projection shape of rwkv6-3b (K x N of 2560 x
   2560, 2560 x 8960, 8960 x 2560 and the head's 2560 x 65536) at prefill
   M = 256, 16 and 1 and at decode M = 4, K = N = 2560 for each other
   power-of-two chunk; every projection shape of llama3.2-3b (3072 x 3072,
   3072 x 1024, 3072 x 8192, 8192 x 3072) at M = 256, 16 and 4 and its
   tied head 3072 x 128256 at M = 1 and 4; every projection shape of
   recurrentgemma-9b (4096 x 4096, 4096 x 256, 4096 x 12288, 12288 x 4096)
   at M = 256 and 4 and its untied head 4096 x 256000 at M = 1 and 4; every
   projection shape of musicgen-large (2048 x 2048, also its head, 2048 x
   8192, 8192 x 2048) at its batch prefill's M = 1024 and at M = 4; every
   projection shape of llama-3.2-vision-90b (8192 x 8192, 8192 x 1024,
   8192 x 28672, 28672 x 8192) at M = 128 and 1, its head 8192 x 128256
   at M = 1 and a cross layer's wk / wv on 6,400 image tokens (M = 6400,
   8192 x 1024); the edges of their launch plan
   (each row prints its tile and K splits), and ``WRAP_ROW`` (all codes
   255, P past 2^31). A plain version whose checking call takes over
   ``PLAIN_ONCE_MS`` is timed by that one cold call, and every timed row
   says which timing its ``plain_ms`` has (``plain_ms_of``).
   Kernel 2's batched entry (one launch an MoE expert bank) is held at ``BATCHED_ROWS``: phi3.5-moe's banks (16 experts,
   4096 x 6400 and 6400 x 4096) at M = 8, 40 and 80, grok-1's (8 experts,
   6144 x 32768 and 32768 x 6144) at M = 8, ragged rows at E = 3, and
   ``BATCHED_WRAP_ROW``; each timed row prints its plan, ``kernel_ms`` /
   ``kernel_device_ms``, ``bound_ms``, a float64 ``torch.bmm`` of the
   codes (``library_ms``) and the device ms of the same bank as E single
   launches (``loop_device_ms``).
   Then holds the four Eq. 1 backends' P equal to each other at AlexNet
   conv1's im2col shape, and kernel 5 against its plain version at a
   batch-1 prefill's shapes (40 heads of 64, S = 16, 64, 256, 512), a
   batch-2 prefill (BH = 80), on strided (H, S, D) views of (1, S, H, D)
   tensors, and at the reference test's sweep (each row prints its launch
   plan). Kernel 1 is held at ResNet-50's and VGG19's input shapes, at the
   tied head's pack of <8:8> llama3.2-3b (128,256 rows of K = 3072) and at
   ragged rows of 1-16 bits.
   Then prepacks one linear and one conv weight on the card at 8 and 16
   bits: the planes of each layout (linear, conv ``mat``, conv ``fused``)
   equal the plain version's bit for bit, and each pack launched kernel 1.
   ``--kernel-rows`` runs the build and kernels 1 and 5's timed rows and
   stops, to time another tree's kernels with this script (copy it into
   that tree).
4. Serves 12 requests (buckets 8 + 4) through ``VisionEngine`` with
   ResNet-50 (random weights from a seed, 1000 classes, 224 px, <8:8>,
   backend "cuda") twice, a warm run and a timed run, and checks that every
   kernel of the path launched during the timed run and that the logits are
   finite. Then times five buckets of 8 and profiles one, for the device's
   idle share of a bucket, and serves the float path. The warm run's
   prepack must pack every weight on the card through kernel 1, and no
   plain pack (``bitslice.slice_and_pack`` or ``pack_bits``) may run on a
   CUDA tensor anywhere on a served path (phases 4, 5 and 7). The warm run keeps
   the operands of kernel 3's call at each distinct geometry; they must be
   ``SERVED_CONVS`` at buckets of 8 and 4, and each is then held with
   ``torch.equal`` against the plain version at its own launch plan
   (untimed; each row prints its plan).
5. Serves AlexNet on the "cuda" and on the "popcount" backend and VGG19 on
   "cuda" the same way (224 px, full width and depth, <8:8>, buckets of 8
   timed and profiled, kernel 3 held at every served conv), each path's
   launch counts set to 0 just before its timed run and read just after.
6. Serves 2 images at a small size on the card and on the CPU (plain
   versions) with the same weights, for each served model and backend:
   equal top-1, logits within rtol 1e-3 and atol 1e-3*max|cpu| (the
   integer P is exact on both; the global average pool and the float
   epilogues reduce in another order on the GPU).
7. Serves rwkv6-3b at its published width (d_model 2560, vocab 65,536;
   random weights from a seed) and 4 of its 32 layers (``RWKV_LAYERS``)
   through ``ServeEngine``:
   in bf16 (projections in ``torch.matmul``, every prefill chunk of 16 or
   more tokens through kernel 5), then with <8:8> on the "cuda" backend in
   float32 (every projection and the head through kernel 2 as well). Eight
   requests with prompts of 64-512 tokens on 4 slots, greedy, a warm run
   and a timed run with the launch counts set to 0 just before it and read
   just after; prints prefill and decode tok/s and the ms of a decode_n
   dispatch and the peak device memory from deploy on, checks the path's
   kernels launched (and, at <8:8>, that prepack packed every weight
   through kernel 1, one pack a projection) and the logits are finite,
   then profiles one admission and one decode dispatch for the idle share.
   Then serves llama3.2-3b the same way at its published width and 7 of
   its 28 layers (``LLAMA_LAYERS``; d_model 3072, 24 query and 8 KV heads
   of 128, d_ff 8192, vocab 128,256, tied embeddings): bf16 (projections,
   scores and PV in
   ``torch.matmul``, no bit-serial kernel may launch), then <8:8> on
   "cuda" in float32 (every projection on kernel 2, prepacked through
   kernel 1; the tied head quantized and packed through kernel 1 at every
   call, then kernel 2), each followed by the device ms of the attention
   core at the decode shape (path dtype and float32) and, at <8:8>, of the
   tied head (``lm_part_costs``).
   Then serves recurrentgemma-9b the same way at its published width and
   11 of its 38 layers (``RG_LAYERS``: 3 units of rglru, rglru, local_attn
   and two more rglru, the remainder its 38 layers end on; d_model and
   lru_width 4096, 16 query heads and one KV head of 256, window 2048,
   d_ff 12288, vocab 256,000, untied head): bf16 (the float32 masters
   cast leaf by leaf, ``cast_in_place``; no bit-serial kernel may launch),
   then <8:8> on "cuda" in float32 (every projection and the head on
   kernel 2, prepacked through kernel 1, one pack a projection; the
   RG-LRU gate products stay float32 ``torch.matmul``), each followed by
   ``lm_part_costs`` (the attention core, and the RG-LRU's scan at a
   256-token chunk, its decode step and its two gate products).
   Then serves phi3.5-moe-42b-a6.6b the same way at its published width
   (d_model 4096, 32 query and 8 KV heads of 128, 16 experts top-2 with
   d_ff 6400, SiLU-gated, layernorm, vocab 32,064, untied head) and 4 of
   its 32 layers (``PHI_LAYERS``: 80 GB forces a cut, the time limit this
   one): bf16 (no bit-serial kernel), then <8:8> on "cuda" in float32 (the
   attention projections and the head on kernel 2, each expert bank stage
   one launch of kernel 2's batched entry: 12 a decode step; 29 packs
   through kernel 1), each followed by ``lm_part_costs`` (the first MoE layer's
   router and dispatch, expert FFN and combine at a decode step and a
   256-token chunk); the serving line carries ``moe_drop_frac`` from
   ``stats()``.
   Then the two archs fed by the stub frontends, through the model
   functions (a batch prefill, then decode steps), as the JAX package
   drives them (its ServeEngine and launcher refuse them; ``STUB_PATHS``):
   musicgen-large at its published width and 12 of its 48 layers (d_model
   2048, 32 heads of 64, d_ff 8192, the tanh gelu, layernorm, 2,048
   codes), 4 prompts of 256 stub frames (``audio_frame_embeddings``), then
   one stub frame a decode step (32 steps in bf16, 16 at <8:8>; the codes
   are read, not fed back); and one unit of llama-3.2-vision-90b at full
   width (4 attn + 1 cross_attn layers; d_model 8192, 64 query and 8 KV
   heads of 128, d_ff 28672, vocab 128,256; its cross gates set to 0.7,
   ``set_cross_gates``), one image of 6,400 stub patch
   embeddings (``image_patch_embeddings``) and a 128-token prompt, then 16
   greedy decode steps, the same image at every call. Each in bf16 (no
   bit-serial kernel) and at <8:8> on "cuda" in float32 (every projection
   and the head prepacked through kernel 1, one launch a weight, and on
   kernel 2: one launch a projection and the head each decode step), a
   warm run, a timed run with the launch counts set to 0 just before it
   and read just after (prefill and decode tok/s, peak memory from deploy
   on) and a profile of the prefill and 8 steps (``serve_stub``); the
   vision paths also print the device ms of the cross layer at the prefill
   and at a decode step beside those of its wk / wv projection of the
   image tokens (``cross_layer_costs``). The warm run at <8:8> records
   kernel 2's calls, which must be ``served_stub_matmuls`` (the cross
   layer's wk / wv at M = 6400 among them), each held against the plain
   version.
   The warm run of each path serves the timed run's eight requests; at
   <8:8> it keeps the operands of kernel 2's first call at each distinct
   shape, which must be ``served_lm_matmuls`` (every projection at each
   power-of-two chunk of the prompts, 1 to 256, and at decode's M = 4; the
   head at M = 1 and 4), and of its batched entry's, which must be
   ``served_bank_matmuls`` (each bank at the capacity of every chunk and
   of a decode step), and each is then held with ``torch.equal`` against
   the plain version at its own launch plan (untimed; each row prints its
   plan).
8. Serves rwkv6-3b and llama3.2-3b at full width, 2 layers, float32, on
   the card and on the CPU from the same weights: a 48-token prompt
   (chunks 32 + 16; rwkv6-3b's through kernel 5 on the card) and 4 greedy
   tokens: equal tokens, and prefill logits within rtol 1e-3 and atol
   1e-3*max|cpu| (the prompt prefilled in those chunks on both devices);
   llama3.2-3b also with the int8 KV cache, where ``quantize_kv`` on the
   first k tensor gives equal codes and scales on both devices.
   recurrentgemma-9b the same way at one unit (rglru, rglru, local_attn),
   with a 2,100-token prompt (chunks 2048 + 32 + 16 + 4), so the
   2,048-row ring wraps, and 4 greedy tokens past it; phi3.5-moe at one
   layer. Then one layer of each at <8:8> on "cuda" against the CPU
   (recurrentgemma-9b one rglru and one local_attn layer; prefill of two
   prompts into a 4-slot grid, two decode steps at M = 4):
   prepacked planes and banks equal bit for bit, every quantized product
   within 1e-5 of the CPU's on the same input, every bank product equal
   to the CPU's, logits within 0.1 in relative L2, printed beside the
   card's own spread under a 1e-6 jitter of the weights
   (``lm_pim_gpu_vs_cpu``). The stub-frontend archs the same way through
   the model functions (``stub_gpu_vs_cpu``: two prompts of 48 frames or
   tokens in one batch prefill, 4 greedy decode steps, equal codes; 16
   at <8:8>, two decode steps): musicgen-large at 2 layers in float32
   and 1 at <8:8>; the vision arch at 2 layers (attn, then cross_attn)
   with all 6,400 image tokens in float32, and with 64 of them at <8:8>
   (the CPU's plain products at 6,400 would take minutes), where the cross
   layer alone is held too. Every cross gate
   is set (``set_cross_gates``; 0 at init zeroes the branch), the images
   share a component across their patches (``stub_host_inputs``), and
   the card's logits at gate 0 must be further from the CPU's than 1e-2
   of max|cpu| (float32) or 0.1 in relative L2 (<8:8>). The vision <8:8> prompts are 16 tokens: at 48, the two layers'
   reading came near the gate, and so did the card's own spread.

9. The autotuner (``repro_torch.pim.autotune``). The backend grid:
   ``AUTOTUNE_SHAPES`` (benchmarks/autotune_bench.py's five) at <2:2>,
   <4:4> and <8:8>; at each GEMM every candidate (the four backends, and
   kernel 2 at each legalized tile request) gives the same P, held with
   ``torch.equal`` to int-direct's and to kernel 2's plain version; each
   is timed (``measure_gemm``, CUDA events); one JSON line a GEMM with each
   backend's ms, the fastest, the cost-mode pick under the committed
   "cuda" rates and the measure-mode pick with their regrets. The served
   convs' GEMMs (``autotune_conv_grid``: each distinct conv GEMM of
   ResNet-50 and AlexNet at buckets 8 and 4, the library backends' P
   equal, each timed at the rows served and priced at the engine's
   ``conv_m_hint``), then a summary line with the match counts and the
   rates fitted on both (``fit_cuda_rates``). Then AlexNet and ResNet-50
   (224 px, <8:8>, 12 requests in buckets 8 + 4) through
   ``VisionEngine(backend="cuda")`` untuned and with
   ``autotune="measure"`` on a cache file: logits equal bit for bit, the
   picks, img/s and a profiled bucket of each (an
   ``autotune_slower_than_untuned`` line where the tuned bucket takes
   more device ms), and a second engine on the file calling
   ``measure_gemm`` 0 times with the same decisions; then llama3.2-3b
   <8:8> at ``LLAMA_LAYERS`` through ``ServeEngine`` untuned and with
   ``autotune="measure"``: equal tokens, a 256-token prefill's logits
   ``torch.equal`` (two untuned prefills held equal first), tok/s and the
   picks. Each tuned path's timed run has its launch counts set to 0 just
   before it and read just after, and each kernel a dispatched decision
   names must have launched.

10. The fault model (``repro_torch.pim.faults``), the watchdog and
   snapshot / restore, at ``FAULT_KW``'s rates (the persistent half alone
   where a step says so). ResNet-50 (224 px, full depth, <8:8>, "cuda")
   through ``VisionEngine``: fault-free; with the faults, a watchdog and
   an injector raising once at dispatch 1 (at least one rollback, the
   repair fixing columns; kernels 1-3 launched in the timed run, finite
   logits; every leaf of the corrupted tree self-consistent,
   ``check_fault_tree``; at one disturbed bucket of 8 the operands of
   kernel 3 at each conv geometry and of kernel 2 at each 1x1 conv and
   the FC held with ``torch.equal`` against the plain versions); with the
   persistent half alone (a bucket launches exactly the fault-free
   engine's kernels); and with an injector raising until the cohort is
   degraded (then no bit-serial launch). img/s, the bucket's device ms
   and the prepack + inject ms beside fault-free. llama3.2-3b
   (``LLAMA_LAYERS``, full width, <8:8>, "cuda") through ``ServeEngine``,
   the eight requests on 4 slots, greedy, ``FAULT_MAX_NEW`` tokens:
   fault-free and persistent-only (each decode dispatch launching the
   same kernels), faults + watchdog without and with an injector raising
   once at dispatch 1 (equal tokens, transient disturb included),
   a snapshot after three steps restored into an engine of another seed
   at temperature 0.7 (equal tokens), and three failures past a budget
   of 2 (degraded, ``cfg.pim.enabled`` false, no kernel-2 launch after);
   tok/s with faults beside fault-free. Then kernel 2's batched entry on
   one disturbed phi3.5-moe bank (E = 16, M = 8, 4096 x 6400) and kernel
   4 at AlexNet conv2's im2col shape on corrupted and disturbed planes,
   each held against its plain version (the disturbed planes equal to
   the plain pack of the codes XOR the site's field, kernel 4's P to
   int-direct's on that state). ``--faults`` runs the build and this
   phase alone.

11. Training (``examples/train_lm.py``'s settings): llama3.2-3b at its
   published width (28 layers, d_model 3072, vocab 128,256,
   tied head; random weights from seed 0) built by the launcher's
   ``build`` (bf16 params, float32 AdamW masters, ``remat="block"``,
   ``SyntheticLM`` seed 0, batch 16 x seq 256, lr 6e-4) and stepped
   ``TRAIN_STEPS`` times in bf16, then again with <8:8> QAT (every
   projection and the tied head fake-quantized with straight-through
   gradients), also at 28 layers; one more step of each is profiled on
   the card. Prints
   each run's losses, grad norms, the median step ms after
   ``TRAIN_WARM`` steps, tok/s (the launcher's formula), peak GB and the
   profiled step's idle share; fails unless every loss is finite, the
   last is below the first and no bit-serial kernel launched during the
   steps (the reference's training path reaches no Pallas kernel). Then
   ``train_gpu_vs_cpu``: one full-width layer in float32, batch 2 x seq
   64, one train step on the card and on the CPU from the same params
   (loss rtol 1e-4, every gradient leaf 1e-3 relative L2, grad norm
   1e-3; with QAT every fake-quantized weight equal bit for bit and the
   training loss within 1e-3); then the launcher's ``main`` with the argv
   of ``python -m repro_torch.launch.train --arch llama3.2-3b --reduced
   --steps 20`` on the card, whose loss must fall.
   ``--train`` runs the build and this phase alone.

Kernel 5 (the chunked WKV) is float32 arithmetic that sums in another
order than its plain version, so it is held to the reference's tolerances
(y relative 1e-4, state absolute 1e-3), not ``torch.equal``.

Each phase prints its wall seconds on a line of its own. The last three
lines are the card's name and power limit, the per-kernel summary
``{"kernels": [...]}`` (launches counted on the ResNet-50 path for kernels
1-3, on the AlexNet popcount path for kernel 4, on the bf16 rwkv6-3b
path for kernel 5 and on the <8:8> phi3.5-moe path for kernel 2's batched
entry), and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
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
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FP32_FLOPS_PER_S = 67e12      # float32 outside the tensor cores
# A plain version whose checking call takes longer than this (ms) is timed
# by that one call (a row of a served prefill takes it seconds).
PLAIN_ONCE_MS = 100.0

# LM serving (rwkv6-3b and llama3.2-3b): decode slots, and the longest
# prompt (512) plus 32 new tokens.
LM_MAX_BATCH = 4
LM_MAX_LEN = 544

# Rows (M, K, N, w_bits, a_bits, timed) of kernel 2 (fused) and kernel 4
# (packed): the shapes the served paths give them, then the edges of the
# launch plan (kernels/bitserial_matmul.py::_plan): M around the 16- and
# 64-row tiles at K = N = 2560, K off every multiple of 32 and 256, N off
# the tiles, and every bit width, a_bits != w_bits among them.
MATMUL_EDGES = [
    *[(m, 2560, 2560, 8, 8, False) for m in (1, 5, 15, 16, 17, 63, 65)],
    *[(m, k, n, 8, 8, False) for k in (363, 4000, 70)
      for m, n in ((8, 1000), (77, 96))],
    *[(m, 2560, n, 8, 8, False) for n in (1000, 96, 8) for m in (8, 65)],
    *[(37, 70, 131, b, b, False) for b in range(1, 9)],
    (37, 70, 131, 5, 3, False), (20, 300, 40, 2, 7, False)]
FUSED_ROWS = [
    (8 * 56 * 56, 256, 64, 8, 8, True),   # ResNet-50 s0 1x1, a bucket of 8
    (8, 2048, 1000, 8, 8, True),          # ResNet-50 head
    (8, 25088, 4096, 8, 8, True),         # VGG19 fc1
    # rwkv6-3b: prefill runs M = each power-of-two chunk (256 down to 1),
    # decode M = LM_MAX_BATCH; K x N is 2560 x 2560 (time mix, channel-mix
    # w_r), 2560 x 8960 (channel-mix w_k), 8960 x 2560 (w_v), 2560 x 65536
    # (the head, M = 1 in prefill).
    *[(m, k, n, 8, 8, True) for m in (256, 16, LM_MAX_BATCH)
      for k, n in ((2560, 2560), (2560, 8960), (8960, 2560))],
    (1, 2560, 65536, 8, 8, True), (LM_MAX_BATCH, 2560, 65536, 8, 8, True),
    # llama3.2-3b at the same M: K x N is 3072 x 3072 (wq, wo), 3072 x 1024
    # (wk, wv), 3072 x 8192 (w_in, w_gate), 8192 x 3072 (w_out), and the
    # tied head 3072 x 128256 (M = 1 in prefill).
    *[(m, k, n, 8, 8, True) for m in (256, 16, LM_MAX_BATCH)
      for k, n in ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072))],
    (1, 3072, 128256, 8, 8, True), (LM_MAX_BATCH, 3072, 128256, 8, 8, True),
    # recurrentgemma-9b at M = 256 and decode's M: K x N is 4096 x 4096 (wq,
    # wo and the RG-LRU's w_x, w_gate, w_out), 4096 x 256 (wk, wv of the one
    # KV head), 4096 x 12288 (w_in, w_gate), 12288 x 4096 (w_out), and the
    # untied head 4096 x 256000 (M = 1 in prefill).
    *[(m, k, n, 8, 8, True) for m in (256, LM_MAX_BATCH)
      for k, n in ((4096, 4096), (4096, 256), (4096, 12288), (12288, 4096))],
    (1, 4096, 256000, 8, 8, True), (LM_MAX_BATCH, 4096, 256000, 8, 8, True),
    # musicgen-large at its batch prefill (4 prompts of 256 frames: M =
    # 1024) and a decode step (M = 4): K x N is 2048 x 2048 (wq, wk, wv,
    # wo and the head, 2,048 codes), 2048 x 8192 (w_in) and 8192 x 2048
    # (w_out).
    *[(m, k, n, 8, 8, True) for m in (4 * 256, 4)
      for k, n in ((2048, 2048), (2048, 8192), (8192, 2048))],
    # One llama-3.2-vision-90b unit at its prefill (one 128-token prompt)
    # and a decode step (M = 1): K x N is 8192 x 8192 (wq, wo), 8192 x 1024
    # (wk, wv), 8192 x 28672 (w_in, w_gate), 28672 x 8192 (w_out); the
    # untied head 8192 x 128256 at M = 1; and the cross layer's wk / wv on
    # the 6,400 image tokens, at every call.
    *[(m, k, n, 8, 8, True) for m in (128, 1)
      for k, n in ((8192, 8192), (8192, 1024), (8192, 28672),
                   (28672, 8192))],
    (1, 8192, 128256, 8, 8, True), (6400, 8192, 1024, 8, 8, True),
    *[(m, 2560, 2560, 8, 8, False) for m in (128, 64, 32, 8, 2, 1)],
    *MATMUL_EDGES]
PACKED_ROWS = [
    # AlexNet on "popcount", a bucket of 8: the convs' im2col GEMMs and the
    # FC layers.
    (8 * 55 * 55, 363, 96, 8, 8, True), (8 * 27 * 27, 2400, 256, 8, 8, True),
    (8 * 13 * 13, 2304, 384, 8, 8, True), (8 * 13 * 13, 3456, 384, 8, 8, True),
    (8 * 13 * 13, 3456, 256, 8, 8, True), (8, 9216, 4096, 8, 8, True),
    (8, 4096, 4096, 8, 8, True), (8, 4096, 1000, 8, 8, True),
    # The Pallas bn % 128 != 0 regression shapes, and KW = 125.
    (8, 64, 192, 4, 4, True), (8, 64, 320, 4, 4, True),
    *[(8, 4000, 1000, b, b, b == 8) for b in (2, 4, 8)],
    *MATMUL_EDGES]
# (M, K, N) with every code 255 at <8:8>: P = 65,025 * K passes 2^31, and K
# passes one 32,768-K slab.
WRAP_ROW = (8, 40000, 64)
# Rows (E, M, K, N, w_bits, a_bits, timed) of kernel 2's batched entry, one
# launch an MoE expert bank: phi3.5-moe's banks (16 experts; w_in and
# w_gate 4096 x 6400, w_out 6400 x 4096) at the capacity of a decode step
# of LM_MAX_BATCH tokens (8 rows), of a 256-token prefill chunk (40) and of
# a 512-token one (80); grok-1's (8 experts; 6144 x 32768 and 32768 x
# 6144) at decode; then ragged rows at E = 3: M off the 16- and 64-row
# tiles, K off a word, N off the tile, bits below 8.
BATCHED_ROWS = [
    *[(16, m, k, n, 8, 8, True) for m in (8, 40, 80)
      for k, n in ((4096, 6400), (6400, 4096))],
    *[(8, 8, k, n, 8, 8, True) for k, n in ((6144, 32768), (32768, 6144))],
    (3, 37, 70, 131, 8, 8, False), (3, 17, 300, 40, 4, 4, False),
    (3, 65, 33, 200, 8, 8, False), (3, 5, 2560, 96, 2, 7, False)]
# (E, M, K, N) with every code 255 at <8:8>, through the batched entry.
BATCHED_WRAP_ROW = (2, 8, 40000, 64)
# phi3.5-moe's depth on the card: its published 32 layers are 41.87 B
# parameters (83.7 GB in bf16), so it could be served at 8 at most (10.67
# B; at <8:8> the float32 masters 42.7 GB, byte codes and planes ~10.5 GB
# each); it is served at 4, as the other LM paths below are cut.
PHI = "phi3.5-moe-42b-a6.6b"
PHI_LAYERS = 4
# The served depth of the earlier LM paths, cut from their published 32,
# 28 and 38 layers to keep the script inside its time limit: their serving
# phases are host-bound and scale with depth, and the widths, the kernels
# each layer launches and the calls they give kernel 2 stay.
# recurrentgemma-9b keeps three whole units and the two rglru layers its
# 38 end on (at 38 it filled the card, ~69 GB at <8:8>).
RWKV_LAYERS = 4
LLAMA_LAYERS = 7
RG_LAYERS = 11
# The archs fed by the stub frontends. They run through the model
# functions, as in the JAX package (its ServeEngine and launcher refuse
# them): a batch prefill, then decode steps. musicgen-large at 12 of its
# 48 layers (cut for time, as the paths above) takes 4 prompts of 256
# frames (5.1 s of audio at EnCodec's 50 Hz); llama-3.2-vision-90b is
# served one unit deep (4 attn + 1 cross_attn layers of its 100: a second
# unit would need ~76 GB at <8:8>), one image of 6,400 patch embeddings
# and a 128-token prompt.
MUSICGEN = "musicgen-large"
VISION = "llama-3.2-vision-90b"
STUB_PATHS = {MUSICGEN: dict(layers=12, batch=4, prompt=256),
              VISION: dict(layers=5, batch=1, prompt=128)}
STUB_MAX_LEN = 256 + 32
# Rows (N, H, C, O, k, stride, pad) of kernel 3 at <8:8>: the convs the
# served paths give it at 224 px in a bucket of 8.
CONV_ROWS = [
    (8, 224, 3, 64, 7, 2, 3),      # ResNet-50 stem 7x7/2
    (8, 56, 64, 64, 3, 1, 1),      # ResNet-50 s0 3x3
    (8, 56, 128, 128, 3, 2, 1),    # ResNet-50 s1b0.c2 3x3/2
    (8, 224, 3, 96, 11, 4, 2),     # AlexNet conv1 11x11/4
    (8, 27, 96, 256, 5, 1, 2),     # AlexNet conv2 5x5
    (8, 224, 3, 64, 3, 1, 1),      # VGG19 conv1_1
    (8, 28, 512, 512, 3, 1, 1),    # VGG19 conv4_2
    (8, 14, 512, 512, 3, 1, 1),    # VGG19 conv5_1
]
# Ragged rows, each at <2:2>, <4:4> and <8:8>: O off the 64-channel tile,
# odd widths, C = 5 (narrow) and 40 (wide, off the word), stride 2.
RAGGED_CONV_ROWS = [(2, 9, 5, 131, 3, 2, 1), (2, 9, 40, 131, 3, 1, 1)]
# (N, H, C, O, k) at <8:8>, pad 0, every code 255: a 3x3 kernel over a 3x3
# map, K = 9 * C = 33,408 passes one 32,768-K slab and P = 65,025 * K
# passes 2^31.
CONV_WRAP_ROW = (1, 3, 3712, 8, 3)
# Every distinct conv (H, C, O, k, stride, pad) larger than 1x1 of each
# served model at 224 px: ResNet-50's stem and the 3x3 convs of its stages
# (s0 at 55 px, after the stem's VALID pool), AlexNet's five, VGG19's nine.
# At a bucket, kernel 3 runs those where ``fuse_conv_heuristic`` fires
# (``served_conv_calls``). The warm run of each "cuda" path records the
# operands of its kernel-3 calls, which must be these at buckets of 8 and
# 4, and each is held against the plain version at its own launch plan
# (``KernelChecks.served_conv``).
SERVED_CONVS = {
    "resnet50": [(224, 3, 64, 7, 2, 3), (55, 64, 64, 3, 1, 1),
                 (55, 128, 128, 3, 2, 1), (28, 128, 128, 3, 1, 1),
                 (28, 256, 256, 3, 2, 1), (14, 256, 256, 3, 1, 1),
                 (14, 512, 512, 3, 2, 1), (7, 512, 512, 3, 1, 1)],
    "alexnet": [(224, 3, 96, 11, 4, 2), (27, 96, 256, 5, 1, 2),
                (13, 256, 384, 3, 1, 1), (13, 384, 384, 3, 1, 1),
                (13, 384, 256, 3, 1, 1)],
    "vgg19": [(h, c, o, 3, 1, 1) for h, c, o in (
        (224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
        (56, 128, 256), (56, 256, 256), (28, 256, 512), (28, 512, 512),
        (14, 512, 512))],
}
SERVED_BUCKETS = (8, 4)
# K x N of the <8:8> projections of each served LM, and of its head. The
# warm run of each <8:8> LM path serves the eight prompts of the timed run
# and records the operands of kernel 2's first call at each distinct
# shape, which must be ``served_lm_matmuls``; each is held against the
# plain version at its own launch plan (``KernelChecks.served_matmul``).
# phi3.5-moe's expert banks are kernel 2's batched calls
# (``served_bank_matmuls``). The warm run of each <8:8> stub-frontend path
# (musicgen-large, llama-3.2-vision-90b) records the same way; its calls
# must be ``served_stub_matmuls``.
LM_PROJ_SHAPES = {
    "rwkv6-3b": ((2560, 2560), (2560, 8960), (8960, 2560)),
    "llama3.2-3b": ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072)),
    "recurrentgemma-9b": ((4096, 4096), (4096, 256), (4096, 12288),
                          (12288, 4096)),
    PHI: ((4096, 4096), (4096, 1024)),
    MUSICGEN: ((2048, 2048), (2048, 8192), (8192, 2048)),
    VISION: ((8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192)),
}
LM_HEADS = {"rwkv6-3b": (2560, 65536), "llama3.2-3b": (3072, 128256),
            "recurrentgemma-9b": (4096, 256000), PHI: (4096, 32064),
            MUSICGEN: (2048, 2048), VISION: (8192, 128256)}
# K x N of a cross layer's wk / wv, which project the image tokens.
CROSS_KV_SHAPES = {VISION: (8192, 1024)}

# Rows (M, K, bits) of kernel 1, timed: the padded activation maps the
# "cuda" paths pack at 224 px in a bucket of 8 (ResNet-50's stem, s0 3x3
# and s1b0.c2 inputs; VGG19's conv1_1 and conv1_2 inputs), and the tied
# head's weight codes that <8:8> llama3.2-3b packs at every call (128,256
# vocabulary rows of K = 3072).
PACK_ROWS = [
    (8 * 230 * 230, 3, 8), (8 * 58 * 58, 64, 8), (8 * 58 * 58, 128, 8),
    (8 * 226 * 226, 3, 8), (8 * 226 * 226, 64, 8), (128256, 3072, 8)]
# Untimed rows of kernel 1: ragged K at every width it takes (1-16 bits),
# K under a word, on a word, on four.
PACK_EDGES = [*[(37, 70, b) for b in range(1, 17)], (5, 3, 12), (300, 3, 16),
              (64, 256, 9), (33, 32, 16), (1, 1, 1)]
# Rows (BH, S, D, chunk) of kernel 5, timed: a batch-1 prefill of rwkv6-3b
# (40 heads of 64) at S = 16, 64, 256 and 512, and a batch-2 one.
WKV_ROWS = [(40, 16, 64, 16), (40, 64, 64, 16), (40, 256, 64, 16),
            (40, 512, 64, 16), (80, 256, 64, 16)]
# Untimed: the reference test's sweep, and an odd S against the plan's
# token batches.
WKV_EDGES = [(2, 32, 8, 8), (6, 64, 16, 16), (1, 48, 32, 16), (4, 128, 16, 32),
             (3, 80, 64, 16), (2, 96, 64, 32), (5, 40, 8, 8)]

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
    # The same Pallas kernel under jax.vmap over an expert bank
    # (src/repro/models/lm/moe.py:120-138): one batched pallas_call.
    "bitserial_matmul_fused_batched": dict(
        source="src/repro_torch/kernels/csrc/bitserial_matmul.cu",
        replaces="src/repro/kernels/bitserial_matmul.py:159"),
    "conv2d_bitserial_fused": dict(
        source="src/repro_torch/kernels/csrc/conv2d_fused.cu",
        replaces="src/repro/kernels/conv2d_fused.py:73"),
    "wkv_chunked": dict(
        source="src/repro_torch/kernels/csrc/wkv_chunked.cu",
        replaces="src/repro/kernels/rwkv_chunk.py:67"),
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


def timed_ms(fn, reps: int, rounds: int = 5) -> tuple:
    """Ms of ``fn`` a call, after one warm call: the median over ``rounds``
    rounds of the mean between two CUDA events around ``reps`` back-to-back
    calls (so the host's time to launch a call where that is longer than
    the card's to run it), and the median of the host's time to issue one
    of those calls."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    events, host = [], []
    for _ in range(rounds):
        start.record()
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t)
        end.record()
        torch.cuda.synchronize()
        events.append(start.elapsed_time(end) / reps)
    return float(np.median(events)), float(np.median(host)) * 1e3


def device_ms(fn, reps: int, clock_hz: float) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls between two
    CUDA events, after one warm call, with the calls queued up behind a
    spin of the card (``torch.cuda._sleep``, ``clock_hz`` the SM clock) as
    long as twice the host's time to issue them all, so that the events
    time the card's runs without the host's launch gaps."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    fn()
    launch_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda._sleep(int((2 * reps * launch_s + 1e-3) * clock_hz))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class KernelChecks:
    """Kernel-vs-plain comparisons; one JSON line per (kernel, shape)."""

    def __init__(self, torch, clock_hz: float):
        self.torch = torch
        self.clock_hz = clock_hz
        self.gen = torch.Generator(device="cuda").manual_seed(0)
        self.rows = []

    @staticmethod
    def _bound(nbytes: float, macs: float, ops_per_s=INT8_OPS_PER_S) -> tuple:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * macs / ops_per_s * 1e3
        return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")

    def _codes(self, shape, bits):
        return self.torch.randint(0, 2**bits, shape, generator=self.gen,
                                  device="cuda", dtype=self.torch.int32)

    def _record(self, name, shape, bits, got, want, kernel_fn, plain_fn,
                library_fn, nbytes, macs, timing, plan=None, extra=None):
        """Holds ``got`` equal to ``want`` and prints the row. ``want``
        None: the plain version's checking call (``plain_fn``) makes it,
        timed; where that call took over ``PLAIN_ONCE_MS``, its time (a
        cold call, first use's allocations in it) is the row's
        ``plain_ms``, and the plain version runs no more; ``plain_ms_of``
        says which timing a row has."""
        torch = self.torch
        first_plain_ms = None
        if want is None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = plain_fn()
            end.record()
            torch.cuda.synchronize()
            first_plain_ms = start.elapsed_time(end)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            diff = (got.long() - want.long()).abs().max().item() \
                if got.shape == want.shape else None
            raise AssertionError(f"{name} {shape} {bits}: kernel != plain "
                                 f"(max |diff| {diff})")
        row = dict(kernel=name, shape=shape, bits=bits, max_abs_err=0)
        if plan is not None:
            row["plan"] = plan
        if timing:
            once = (first_plain_ms or 0) > PLAIN_ONCE_MS
            bound_ms, bound_by = self._bound(nbytes, macs)
            kernel_ms, kernel_host_ms = timed_ms(kernel_fn, 20)
            row.update(
                kernel_ms=kernel_ms, kernel_host_ms=kernel_host_ms,
                kernel_device_ms=device_ms(kernel_fn, 20, self.clock_hz),
                plain_ms=first_plain_ms if once
                else timed_ms(plain_fn, 2, rounds=1)[0],
                plain_ms_of="one cold call" if once
                else "two calls after a warm one",
                library_ms=None if library_fn is None
                else timed_ms(library_fn, 5)[0],
                library_device_ms=None if library_fn is None
                else device_ms(library_fn, 5, self.clock_hz),
                bound_ms=bound_ms, bound_by=bound_by)
        row.update(extra or {})
        print(json.dumps(row), flush=True)
        self.rows.append(row)

    def pack(self, m, k, bits, timing=True):
        from repro_torch.kernels import bitplane_pack as kp

        q = self._codes((m, k), bits)
        if bits > 8:   # the top bit too, as a code of the full width
            q[0, :] = 2**bits - 1
        kw = (k + 31) // 32
        self._record(
            "bitplane_pack", dict(M=m, K=k), f"{bits} planes",
            kp.bitplane_pack(q, bits), None,
            lambda: kp.bitplane_pack(q, bits),
            lambda: kp.bitplane_pack_plain(q, bits), None,
            nbytes=4 * m * k + 4 * bits * m * kw, macs=0, timing=timing)

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
            km.bitserial_matmul_fused(qa, pw.planes, ab, wb), None,
            lambda: km.bitserial_matmul_fused(qa, pw.planes, ab, wb),
            lambda: km.bitserial_matmul_fused_plain(qa, pw.planes, ab, wb),
            lambda: torch.matmul(a64, w64),
            nbytes=4 * m * k + 4 * wb * n * kw + 4 * m * n, macs=m * n * k,
            timing=timing, plan=self._plan(m, n, kw))

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
            km.bitserial_matmul_packed(pa, pw.planes, ab, wb), None,
            lambda: km.bitserial_matmul_packed(pa, pw.planes, ab, wb),
            lambda: km.packed_matmul_plain(pa, pw.planes),
            lambda: torch.matmul(a64, w64),
            nbytes=4 * ab * m * kw + 4 * wb * n * kw + 4 * m * n,
            macs=m * n * k, timing=timing, plan=self._plan(m, n, kw))

    def batched(self, e, m, k, n, wb, ab, timing=True):
        """Kernel 2's batched entry on an (E, K, N) bank prepacked on the
        card: equal to its plain version (the plain fused version expert by
        expert, ``plain_ms`` the time of that one checking call); timed
        beside a float64 ``torch.bmm`` of the codes (the library reading)
        and the device time of the same bank as E single launches
        (``loop_device_ms``)."""
        torch = self.torch
        from repro_torch.core.packed import prepack
        from repro_torch.kernels import bitserial_matmul as km

        qa = self._codes((e, m, k), ab)
        w = torch.randn((e, k, n), generator=self.gen, device="cuda")
        bank = prepack(w, wb)
        del w
        pw = bank.planes
        kw = pw.shape[-1]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = km.bitserial_matmul_fused_batched_plain(qa, pw, ab, wb)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        got = km.bitserial_matmul_fused_batched(qa, pw, ab, wb)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"bitserial_matmul_fused_batched "
                                 f"{(e, m, k, n)} <{wb}:{ab}>: kernel != "
                                 "plain")
        del want
        row = dict(kernel="bitserial_matmul_fused_batched",
                   shape=dict(E=e, M=m, K=k, N=n), bits=f"<{wb}:{ab}>",
                   max_abs_err=0, plan=self._plan(m, n, kw, e))
        if timing:
            def kernel():
                return km.bitserial_matmul_fused_batched(qa, pw, ab, wb)

            def loop():
                return [km.bitserial_matmul_fused(qa[i], pw[i], ab, wb)
                        for i in range(e)]

            a64, w64 = qa.double(), bank.codes.double()
            bound_ms, bound_by = self._bound(
                4 * e * m * k + 4 * e * wb * n * kw + 4 * e * m * n,
                e * m * n * k)
            kernel_ms, kernel_host_ms = timed_ms(kernel, 20)
            row.update(
                kernel_ms=kernel_ms, kernel_host_ms=kernel_host_ms,
                kernel_device_ms=device_ms(kernel, 20, self.clock_hz),
                loop_device_ms=device_ms(loop, 20, self.clock_hz),
                plain_ms=plain_ms, plain_ms_of="one cold call",
                library_ms=timed_ms(lambda: torch.bmm(a64, w64), 5)[0],
                library_device_ms=device_ms(lambda: torch.bmm(a64, w64), 5,
                                            self.clock_hz),
                bound_ms=bound_ms, bound_by=bound_by)
            del a64, w64
        print(json.dumps(row), flush=True)
        self.rows.append(row)

    def batched_wrap(self, e, m, k, n):
        """Every code 255 at <8:8> through the batched entry: equal to its
        plain version, and every expert's P equal to 65,025 * K wrapped mod
        2^32 like the reference's int32."""
        torch = self.torch
        from repro_torch.kernels import bitplane_pack as kp
        from repro_torch.kernels import bitserial_matmul as km

        qa = torch.full((e, m, k), 255, dtype=torch.int32, device="cuda")
        pw = kp.bitplane_pack_plain(
            torch.full((e * n, k), 255, dtype=torch.int32, device="cuda"),
            8).reshape(8, e, n, -1).transpose(0, 1).contiguous()
        p = 65025 * k % 2**32
        want = torch.full((e, m, n), p - 2**32 * (p >= 2**31),
                          dtype=torch.int32, device="cuda")
        plain = km.bitserial_matmul_fused_batched_plain(qa, pw, 8, 8)
        if not torch.equal(plain, want):
            raise AssertionError(f"batched plain version does not wrap to "
                                 f"{want[0, 0, 0]}")
        self._record("bitserial_matmul_fused_batched",
                     dict(E=e, M=m, K=k, N=n, codes=255), "<8:8>",
                     km.bitserial_matmul_fused_batched(qa, pw, 8, 8), plain,
                     None, None, None, 0, 0, timing=False,
                     plan=self._plan(m, n, pw.shape[-1], e))

    def served_bank(self, arch, qa, pw, a_bits):
        """Kernel 2's batched entry on operands a served MoE path gave it,
        untimed: equal to its plain version at that call's own plan."""
        from repro_torch.kernels import bitserial_matmul as km

        e, m, k = qa.shape
        _, w_bits, n, kw = pw.shape
        self._record(
            "bitserial_matmul_fused_batched",
            dict(served=arch, E=e, M=m, K=k, N=n), f"<{w_bits}:{a_bits}>",
            km.bitserial_matmul_fused_batched(qa, pw, a_bits, w_bits),
            km.bitserial_matmul_fused_batched_plain(qa, pw, a_bits, w_bits),
            None, None, None, 0, 0, timing=False,
            plan=self._plan(m, n, kw, e))

    def _plan(self, m, n, kw, e=1):
        """Kernel 2/4's launch plan (of E products at once for the batched
        entry), as printed."""
        from repro_torch.kernels import bitserial_matmul as km

        plan = km._plan(m, n, kw, km._sm_count(self.torch.device("cuda", 0)),
                        e)
        return dict(variant=plan.variant, tile=km.TILES[plan.variant][:2],
                    split_words=plan.split_words, splits=plan.splits)

    def _conv_plan(self, n_oh, ow, cw, c, o, kh, kw, stride):
        """Kernel 3's launch plan, as printed."""
        from repro_torch.kernels import conv2d_fused as kc

        plan = kc._plan(n_oh, ow, cw, c, o, kh, kw, stride,
                        kc._sm_count(self.torch.device("cuda", 0)))
        return dict(plan._asdict(), variant=("wide", "narrow")[plan.variant],
                    tile=[plan.tr, plan.tw, kc.BN],
                    smem_bytes=kc.smem_bytes(
                        plan.variant, plan.tw, plan.tr, plan.ks,
                        plan.split_pairs, plan.stages, stride, kw, c))

    def wrap(self, m, k, n):
        """Every code 255 at <8:8> through both entries: each equals its
        plain version, and both equal 65,025 * K wrapped mod 2^32 like the
        reference's int32."""
        torch = self.torch
        from repro_torch.kernels import bitplane_pack as kp
        from repro_torch.kernels import bitserial_matmul as km

        qa = torch.full((m, k), 255, dtype=torch.int32, device="cuda")
        pw = kp.bitplane_pack_plain(
            torch.full((n, k), 255, dtype=torch.int32, device="cuda"), 8)
        pa = kp.bitplane_pack_plain(qa, 8)
        p = 65025 * k % 2**32
        want = torch.full((m, n), p - 2**32 * (p >= 2**31), dtype=torch.int32,
                          device="cuda")
        plain = (km.bitserial_matmul_fused_plain(qa, pw, 8, 8),
                 km.packed_matmul_plain(pa, pw))
        if not all(torch.equal(x, want) for x in plain):
            raise AssertionError(f"plain versions do not wrap to {want[0, 0]}")
        kw = pw.shape[-1]
        for name, got, ref in (
                ("bitserial_matmul_fused",
                 km.bitserial_matmul_fused(qa, pw, 8, 8), plain[0]),
                ("bitserial_matmul_packed",
                 km.bitserial_matmul_packed(pa, pw, 8, 8), plain[1])):
            self._record(name, dict(M=m, K=k, N=n, codes=255), "<8:8>", got,
                         ref, None, None, None, 0, 0, timing=False,
                         plan=self._plan(m, n, kw))

    def conv(self, n, h, c, o, ks, stride, pad, wb, ab, timing=True):
        """Kernel 3 against its plain version, and the im2col route (the
        patch matrix of the codes, then kernel 2) held to the same P and
        timed on the device alone."""
        torch = self.torch
        import torch.nn.functional as F

        from repro_torch.core import bitserial, pim_layers
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

        def im2col_route():
            cols, _, _ = pim_layers._im2col(qx, ks, ks, stride, 0)
            return bitserial.int_matmul_prepacked(cols, pk.mat, ab, "cuda")

        got = kc.conv2d_bitserial_fused(pa, pk.fused_planes, c=c, **geo)
        if not torch.equal(im2col_route().reshape(got.shape), got):
            raise AssertionError(f"conv {n, h, c, o, ks, stride}: the im2col "
                                 "route's P differs from kernel 3's")
        self._record(
            "conv2d_bitserial_fused",
            dict(N=n, H=h, C=c, O=o, k=ks, stride=stride, pad=pad),
            f"<{wb}:{ab}>", got, None,
            lambda: kc.conv2d_bitserial_fused(pa, pk.fused_planes, c=c,
                                              **geo),
            lambda: kc.conv2d_fused_plain(pa, pk.fused_planes, **geo),
            lambda: F.conv2d(x64, w64, stride=stride),
            nbytes=4 * ab * n * hp * hp * cw + pk.fused_planes.numel() * 4
            + 4 * n * oh * oh * o, macs=n * oh * oh * o * ks * ks * c,
            timing=timing,
            plan=self._conv_plan(n * oh, oh, cw, c, o, ks, ks, stride),
            extra=dict(im2col_route_device_ms=device_ms(
                im2col_route, 20, self.clock_hz)))

    def conv_wrap(self, n, h, c, o, ks):
        """Every code 255 at <8:8>, pad 0: kernel 3 equals its plain
        version, and both equal 65,025 * KH*KW*C wrapped mod 2^32 like the
        reference's int32."""
        torch = self.torch
        from repro_torch.kernels import bitplane_pack as kp
        from repro_torch.kernels import conv2d_fused as kc

        cw = -(-c // 32)
        pa = kp.bitplane_pack_plain(
            torch.full((n * h * h, c), 255, dtype=torch.int32, device="cuda"),
            8).reshape(8, n * h, h, cw)
        pw = kp.bitplane_pack_plain(
            torch.full((ks * o * ks, c), 255, dtype=torch.int32,
                       device="cuda"), 8).reshape(8, ks, o, ks, cw)
        pw = pw.permute(1, 0, 2, 3, 4).contiguous()
        oh = h - ks + 1
        geo = dict(n=n, hp=h, oh=oh, ow=oh, stride=1)
        p = 65025 * ks * ks * c % 2**32
        want = torch.full((n, oh, oh, o), p - 2**32 * (p >= 2**31),
                          dtype=torch.int32, device="cuda")
        plain = kc.conv2d_fused_plain(pa, pw, **geo)
        if not torch.equal(plain, want):
            raise AssertionError(f"conv plain version does not wrap to "
                                 f"{want.flatten()[0]}")
        self._record("conv2d_bitserial_fused",
                     dict(N=n, H=h, C=c, O=o, k=ks, codes=255), "<8:8>",
                     kc.conv2d_bitserial_fused(pa, pw, c=c, **geo), plain,
                     None, None, None, 0, 0, timing=False,
                     plan=self._conv_plan(n * oh, oh, cw, c, o, ks, ks, 1))

    def served_conv(self, model, pa, pw, geo):
        """Kernel 3 on operands a served path gave it, untimed: equal to
        its plain version at that call's own launch plan."""
        from repro_torch.kernels import conv2d_fused as kc

        a_bits, _, wp, cw = pa.shape
        kh, w_bits, o, kw, _ = pw.shape
        plain_geo = {k: v for k, v in geo.items() if k != "c"}
        self._record(
            "conv2d_bitserial_fused",
            dict(model=model, N=geo["n"], Hp=geo["hp"], Wp=wp, C=geo["c"],
                 O=o, k=kh, stride=geo["stride"], OH=geo["oh"]),
            f"<{w_bits}:{a_bits}>", kc.conv2d_bitserial_fused(pa, pw, **geo),
            kc.conv2d_fused_plain(pa, pw, **plain_geo), None, None, None, 0,
            0, timing=False,
            plan=self._conv_plan(geo["n"] * geo["oh"], geo["ow"], cw,
                                 geo["c"], o, kh, kw, geo["stride"]))

    def served_matmul(self, arch, qa, pw, a_bits):
        """Kernel 2 on operands a served LM path gave it, untimed: equal to
        its plain version at that call's own launch plan."""
        from repro_torch.kernels import bitserial_matmul as km

        m, k = qa.shape
        w_bits, n, kw = pw.shape
        self._record(
            "bitserial_matmul_fused", dict(served=arch, M=m, K=k, N=n),
            f"<{w_bits}:{a_bits}>",
            km.bitserial_matmul_fused(qa, pw, a_bits, w_bits),
            km.bitserial_matmul_fused_plain(qa, pw, a_bits, w_bits), None,
            None, None, 0, 0, timing=False, plan=self._plan(m, n, kw))

    def served_packed(self, label, pa, pw, a_bits, w_bits):
        """Kernel 4 on operands a served path gave it, untimed: equal to
        its plain version at that call's own launch plan."""
        from repro_torch.kernels import bitserial_matmul as km

        _, m, kw = pa.shape
        n = pw.shape[1]
        self._record(
            "bitserial_matmul_packed", dict(served=label, M=m, K=kw * 32,
                                            N=n), f"<{w_bits}:{a_bits}>",
            km.bitserial_matmul_packed(pa, pw, a_bits, w_bits),
            km.packed_matmul_plain(pa, pw), None, None, None, 0, 0,
            timing=False, plan=self._plan(m, n, kw))

    def wkv(self, bh, s, d, chunk, timing=True, strided=False):
        """Kernel 5 against its plain chunked version on the reference
        test's distributions: y within 1e-4 of max|y| and the state within
        1e-3 absolute (float32 sums in another order). ``strided``: r, k,
        v and lw are (H, S, D) views of (1, S, H, D) tensors, the layout
        a batch-1 prefill hands the kernel."""
        torch = self.torch
        from repro_torch.kernels import rwkv_chunk as kw

        def randn(*shape):
            return torch.randn(shape, generator=self.gen, device="cuda")

        def rows(*shape):
            if not strided:
                return randn(*shape)
            return randn(1, s, bh, d).permute(0, 2, 1, 3).reshape(bh, s, d)

        r, k, v = (rows(bh, s, d) * 0.5 for _ in range(3))
        lw = torch.clamp_min(-torch.exp(rows(bh, s, d) - 2), -5.0)
        a = (r, k, v, lw, randn(bh, d) * 0.2, randn(bh, d, d) * 0.1)
        y, s_fin = kw.wkv_chunked(*a, chunk=chunk)
        y_want, s_want = kw.wkv_chunked_plain(*a, chunk)
        torch.cuda.synchronize()
        y_err = (y - y_want).abs().max().item()
        s_err = (s_fin - s_want).abs().max().item()
        shape = dict(BH=bh, S=s, D=d, chunk=chunk)
        if strided:
            shape["layout"] = "(1, S, H, D) view"
        if not (y_err <= 1e-4 * y_want.abs().max().item()
                and s_err <= 1e-3):
            raise AssertionError(f"wkv_chunked {shape}: kernel != plain "
                                 f"(y {y_err}, state {s_err})")
        row = dict(kernel="wkv_chunked", shape=shape, bits="float32",
                   max_abs_err=y_err, state_max_abs_err=s_err)
        if hasattr(kw, "_plan"):     # a tree before kernel 5 had a plan
            plan = kw._plan(bh, s, d, chunk,
                            kw._sm_count(torch.device("cuda", 0)))
            row["plan"] = dict(plan._asdict(), blocks=bh * (d // plan.cols),
                               smem_bytes=kw.smem_bytes(d, plan.cols,
                                                        plan.tokens, chunk))
        if timing:
            # Each input read once, each output written once; the work is
            # the chunked algebra's multiply-adds (the strict lower A and
            # A v, the carry-in r~ S, the state update), at the float32
            # rate outside the tensor cores.
            nbytes = 4 * (5 * bh * s * d + bh * d + 2 * bh * d * d)
            n_chunks = s // chunk
            macs = bh * n_chunks * (chunk * (chunk - 1) * d
                                    + 2 * chunk * d * d + chunk * d)
            bound_ms, bound_by = self._bound(nbytes, macs, FP32_FLOPS_PER_S)
            kernel_ms, kernel_host_ms = timed_ms(
                lambda: kw.wkv_chunked(*a, chunk=chunk), 20)
            row.update(
                kernel_ms=kernel_ms, kernel_host_ms=kernel_host_ms,
                kernel_device_ms=device_ms(
                    lambda: kw.wkv_chunked(*a, chunk=chunk), 20,
                    self.clock_hz),
                plain_ms=timed_ms(lambda: kw.wkv_chunked_plain(*a, chunk),
                                  2, rounds=1)[0],
                library_ms=None, library_device_ms=None, bound_ms=bound_ms,
                bound_by=bound_by)
        print(json.dumps(row), flush=True)
        self.rows.append(row)


def check_imma_build(build, name) -> None:
    """Kernels 2-4 run on the int8 tensor cores without spills: the
    library's SASS holds IMMA instructions (``cuobjdump``, beside ``nvcc``)
    and ``ptxas -v`` reports no spilled bytes in the build of that same
    library (its log carries the library's digest in its name)."""
    log = build.log_path(name).read_text()
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build.library_path(name))],
        check=True, capture_output=True, text=True, timeout=300).stdout
    imma = len(re.findall(r"\bIMMA\.", sass))
    print(json.dumps({f"{name}_imma_instructions": imma,
                      f"{name}_spill_bytes": spills}), flush=True)
    if not imma or spills:
        raise AssertionError(f"{name}: {imma} IMMA instructions, "
                             f"{spills} spilled bytes")


def profile_call(torch, fn) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler), its
    wall time under the profiler and the device's idle share of it, and
    the host's synchronising CUDA calls. It traces the card's activity
    (kernels, copies and the CUDA runtime calls) alone: the host's
    operator events would slow the host they measure, and their processing
    after a call of ~100k launches (musicgen-large's 48 layers at <8:8>)
    takes about a minute."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    dev = {e.key: (e.device_time_total / 1e3, e.count) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA}
    host_calls = {e.key: e.count for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU}
    device_ms = sum(ms for ms, _ in dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=1 - device_ms / wall_ms if wall_ms else None,
                launches_on_device=sum(n for _, n in dev.values()),
                syncs=sum(host_calls.get(k, 0) for k in (
                    "cudaStreamSynchronize", "cudaDeviceSynchronize",
                    "cudaMemcpy")),
                top=[[k[:80], ms, n] for k, (ms, n) in top])


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
                                    "conv2d_fused_"))}
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
                ms=row["kernel_ms"], device_ms=row["kernel_device_ms"],
                plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"], shape=headline)


# Kernels each served path must launch (the rest may stay at 0).
PATH_KERNELS = {
    "cuda": ("bitplane_pack", "bitserial_matmul_fused",
             "conv2d_bitserial_fused"),
    "popcount": ("bitplane_pack", "bitserial_matmul_packed"),
}


class recorded_convs:
    """While open, keeps a copy of the operands of kernel 3's first call at
    each distinct geometry (all that its launch plan depends on) in
    ``calls``; every call runs the kernel as before."""

    def __enter__(self):
        from repro_torch.kernels import conv2d_fused as kc

        self.module, self.kernel = kc, kc.conv2d_bitserial_fused
        self.calls = {}

        def spy(pa, pw, **geo):
            key = (tuple(pa.shape), tuple(pw.shape), *sorted(geo.items()))
            if key not in self.calls:
                self.calls[key] = (pa.clone(), pw.clone(), geo)
            return self.kernel(pa, pw, **geo)

        kc.conv2d_bitserial_fused = spy
        return self

    def __exit__(self, *exc):
        self.module.conv2d_bitserial_fused = self.kernel


class recorded_matmuls:
    """While open, keeps a host copy of the operands of kernel 2's first
    call at each distinct shape (all that its launch plan depends on) in
    ``calls``, and of its batched entry's in ``bank_calls``, so that the
    path's device memory stays its own; every call runs the kernel as
    before."""

    ENTRIES = ("bitserial_matmul_fused", "bitserial_matmul_fused_batched")

    def __enter__(self):
        from repro_torch.kernels import bitserial_matmul as km

        self.module = km
        self.kernels = {name: getattr(km, name) for name in self.ENTRIES}
        self.calls, self.bank_calls = {}, {}

        def spy(name, calls):
            def fn(qa, pw, a_bits, w_bits):
                key = (tuple(qa.shape), tuple(pw.shape), a_bits)
                if key not in calls:
                    calls[key] = (qa.to("cpu", copy=True),
                                  pw.to("cpu", copy=True), a_bits)
                return self.kernels[name](qa, pw, a_bits, w_bits)
            return fn

        for name, calls in zip(self.ENTRIES, (self.calls, self.bank_calls)):
            setattr(km, name, spy(name, calls))
        return self

    def __exit__(self, *exc):
        for name, fn in self.kernels.items():
            setattr(self.module, name, fn)


class prepack_packs:
    """While open, counts prepack's weight packs (``core.packed.
    pack_planes``, which ``prepack`` and ``prepack_conv`` call) on CUDA
    tensors, and kernel 1's launches inside them; :meth:`check` fails
    unless there were some and each launched kernel 1 once."""

    def __enter__(self):
        from repro_torch.core import packed
        from repro_torch.kernels import bitplane_pack as kp

        self.module, self.real = packed, packed.pack_planes
        self.packs = self.launches = 0

        def spy(q, bits):
            before = kp.launches
            out = self.real(q, bits)
            if q.is_cuda:
                self.packs += 1
                self.launches += kp.launches - before
            return out

        packed.pack_planes = spy
        return self

    def __exit__(self, *exc):
        self.module.pack_planes = self.real

    def check(self, label):
        if not self.packs or self.launches != self.packs:
            raise AssertionError(f"{label}: prepack packed {self.packs} "
                                 f"weights on the card with {self.launches} "
                                 "launches of kernel 1")
        return dict(prepack_packs=self.packs,
                    prepack_bitplane_pack_launches=self.launches)


class no_plain_pack:
    """While open, the plain pack (``bitslice.slice_and_pack`` and
    ``pack_bits``) raises on a CUDA tensor: on the served paths kernel 1
    packs on the card."""

    def __enter__(self):
        from repro_torch.core import bitslice

        self.module = bitslice
        self.real = {n: getattr(bitslice, n)
                     for n in ("slice_and_pack", "pack_bits")}

        def guard(name):
            def fn(x, *a, **k):
                if x.is_cuda:
                    raise AssertionError(f"plain {name} ran on a CUDA tensor "
                                         f"{tuple(x.shape)} on a served path")
                return self.real[name](x, *a, **k)
            return fn

        for name in self.real:
            setattr(bitslice, name, guard(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.module, name, fn)


def prepack_layouts(torch):
    """One linear and one conv weight prepacked on the card at 8 and 16
    bits: the planes of each layout (linear, conv ``mat``, conv ``fused``)
    equal the plain version's on the same codes bit for bit, and every
    pack launched kernel 1."""
    from repro_torch.core import packed
    from repro_torch.kernels import bitplane_pack as kp

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for bits in (8, 16):
        lin = torch.randn((2560, 1000), generator=gen, device="cuda")
        conv = torch.randn((3, 3, 64, 96), generator=gen, device="cuda")
        with prepack_packs() as spy:
            pl = packed.prepack(lin, bits)
            pc = packed.prepack_conv(conv, bits)
        kh, kw, c, o = conv.shape
        codes = pc.mat.codes32.reshape(kh, kw, c, o)
        want = {
            "linear": (pl.planes, kp.bitplane_pack_plain(
                pl.codes32.T.contiguous(), bits)),
            "conv mat": (pc.mat.planes, kp.bitplane_pack_plain(
                pc.mat.codes32.T.contiguous(), bits)),
            "conv fused": (pc.fused_planes, kp.bitplane_pack_plain(
                codes.permute(0, 3, 1, 2).contiguous(), bits).permute(
                    1, 0, 2, 3, 4))}
        for layout, (got, plain) in want.items():
            if got.shape != plain.shape or not torch.equal(got, plain):
                raise AssertionError(f"prepack {layout} at {bits} bits: "
                                     "kernel 1's planes != plain")
        rows.append(dict(bits=bits, layouts=sorted(want),
                         **spy.check(f"prepack at {bits} bits")))
    print(json.dumps(dict(prepack_planes_equal_plain=rows)), flush=True)


def served_conv_calls(model) -> list:
    """(N, Hp, C, O, k, stride, OH) of each distinct kernel-3 call of
    ``model``'s served path at the buckets of ``SERVED_BUCKETS``: the convs
    of ``SERVED_CONVS`` where ``pim_conv2d`` takes the fused path."""
    from repro_torch.core.pim_layers import fuse_conv_heuristic

    calls = []
    for n in SERVED_BUCKETS:
        for h, c, o, k, s, p in SERVED_CONVS[model]:
            oh = (h + 2 * p - k) // s + 1
            if fuse_conv_heuristic(n, oh, oh, k, k, c, "cuda"):
                calls.append((n, h + 2 * p, c, o, k, s, oh))
    return sorted(calls)


def check_served_convs(kc, model, calls):
    """The kernel-3 calls a served path's warm run recorded are
    ``served_conv_calls(model)``, and each equals the plain version."""
    want = served_conv_calls(model)
    got = sorted((geo["n"], geo["hp"], geo["c"], pw.shape[2], pw.shape[0],
                  geo["stride"], geo["oh"]) for _, pw, geo in calls.values())
    if got != want:
        raise AssertionError(f"{model}: kernel 3 ran at (N, Hp, C, O, k, "
                             f"stride, OH) {got}, SERVED_CONVS lists {want}")
    for pa, pw, geo in calls.values():
        kc.served_conv(model, pa, pw, geo)


def served_lm_matmuls(proj, head, lens) -> list:
    """(M, K, N) of each distinct kernel-2 call of a <8:8> LM served
    prompts of ``lens`` tokens on ``LM_MAX_BATCH`` slots: each projection
    (K x N in ``proj``) at every power-of-two prefill chunk and at decode
    (M = LM_MAX_BATCH), and the head (``head``) at a chunk's last token
    (M = 1) and at decode."""
    from repro_torch.serving.engine import _pow2_chunks

    ms = {c for n in lens for c in _pow2_chunks(n)} | {LM_MAX_BATCH}
    return sorted({(m, k, n) for k, n in proj for m in ms}
                  | {(m, *head) for m in (1, LM_MAX_BATCH)})


def served_stub_matmuls(proj, head, batch, prompt, cross=None,
                        n_image=0) -> list:
    """(M, K, N) of each distinct kernel-2 call of a <8:8> stub-frontend
    path (a batch prefill of ``batch`` prompts of ``prompt`` frames or
    tokens, then decode steps): each projection (K x N in ``proj``) at the
    prefill (M = batch x prompt) and at a decode step (M = batch), the head
    (``head``) at M = batch (the prefill's last tokens and each step), and
    a cross layer's wk / wv (``cross``) on the ``n_image`` image tokens a
    row at every call."""
    calls = {(m, k, n) for k, n in proj for m in (batch * prompt, batch)}
    calls.add((batch, *head))
    if cross:
        calls.add((batch * n_image, *cross))
    return sorted(calls)


def stub_path_matmuls(arch) -> list:
    """``served_stub_matmuls`` of ``arch``'s path on the card
    (``STUB_PATHS``)."""
    from repro_torch.configs import get_config

    return served_stub_matmuls(
        LM_PROJ_SHAPES[arch], LM_HEADS[arch], STUB_PATHS[arch]["batch"],
        STUB_PATHS[arch]["prompt"], CROSS_KV_SHAPES.get(arch),
        get_config(arch).model.n_image_tokens)


def served_bank_matmuls(cfg, lens) -> list:
    """(E, M, K, N) of each distinct batched kernel-2 call of an MoE LM
    (``cfg``) served prompts of ``lens`` tokens on ``LM_MAX_BATCH`` slots at
    <8:8>: each expert bank (w_in and w_gate d_model x d_ff, w_out d_ff x
    d_model) at the capacity (``moe._capacity``) of every power-of-two
    prefill chunk and of a decode step (``LM_MAX_BATCH`` tokens)."""
    from repro_torch.models.lm.moe import _capacity
    from repro_torch.serving.engine import _pow2_chunks

    ts = {c for n in lens for c in _pow2_chunks(n)} | {LM_MAX_BATCH}
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    return sorted({(e, _capacity(t, cfg), k, n) for t in ts
                   for k, n in ((d, f), (f, d))})


def check_served_matmuls(np, kc, arch, rec):
    """The kernel-2 calls the warm run of ``arch``'s <8:8> path recorded
    (``recorded_matmuls`` ``rec``) are ``served_lm_matmuls`` of its eight
    prompts, and, for an MoE arch, its batched calls
    ``served_bank_matmuls``; each equals the plain version."""
    from repro_torch.configs import get_config

    head = LM_HEADS[arch]
    lens = [len(p) for p in lm_prompts(np, head[1])]
    want = served_lm_matmuls(LM_PROJ_SHAPES[arch], head, lens)
    got = sorted((qa.shape[0], qa.shape[1], pw.shape[1])
                 for qa, pw, _ in rec.calls.values())
    if got != want:
        raise AssertionError(f"{arch}: kernel 2 ran at (M, K, N) {got}, "
                             f"served_lm_matmuls gives {want}")
    cfg = get_config(arch).model
    want = served_bank_matmuls(cfg, lens) if cfg.moe else []
    got = sorted((*qa.shape, pw.shape[2]) for qa, pw, _ in
                 rec.bank_calls.values())
    if got != want:
        raise AssertionError(f"{arch}: kernel 2's batched entry ran at (E, "
                             f"M, K, N) {got}, served_bank_matmuls gives "
                             f"{want}")
    for qa, pw, a_bits in rec.calls.values():
        kc.served_matmul(arch, qa.cuda(), pw.cuda(), a_bits)
    for qa, pw, a_bits in rec.bank_calls.values():
        kc.served_bank(arch, qa.cuda(), pw.cuda(), a_bits)


def check_stub_matmuls(kc, arch, rec):
    """The kernel-2 calls the warm run of ``arch``'s <8:8> stub-frontend
    path recorded are ``stub_path_matmuls(arch)``, none batched, and each
    equals the plain version."""
    got = sorted((qa.shape[0], qa.shape[1], pw.shape[1])
                 for qa, pw, _ in rec.calls.values())
    want = stub_path_matmuls(arch)
    if got != want or rec.bank_calls:
        raise AssertionError(f"{arch}: kernel 2 ran at (M, K, N) {got} and "
                             f"{len(rec.bank_calls)} batched shapes, "
                             f"served_stub_matmuls gives {want}")
    for qa, pw, a_bits in rec.calls.values():
        kc.served_matmul(arch, qa.cuda(), pw.cuda(), a_bits)


def serve_path(torch, np, ops, eng, model, backend, imgs, request_cls):
    """One served path: a warm run (prepack, first launches), a timed run of
    every image with the launch counts set to 0 just before it and read just
    after, then five buckets of 8 timed without the profiler (whose
    host-side tracing slows dispatch; the last one's launches are the
    launches per bucket) and one profiled bucket, for the device's idle
    share. Fails if a kernel of the path never launched, on wrong buckets
    or on non-finite or misshapen logits. Returns the completions, the
    timed run's launches and the warm run's kernel-3 calls
    (``recorded_convs``)."""

    def serve(n):
        for rid in range(n):
            eng.submit(request_cls(rid=rid, image=imgs[rid], model=model))
        t = time.perf_counter()
        done = eng.run(strict=True)
        torch.cuda.synchronize()
        return sorted(done, key=lambda c: c.rid), time.perf_counter() - t

    with recorded_convs() as convs, prepack_packs() as packs:
        serve(len(imgs))
    packed = packs.check(f"{model}/{backend} prepack")
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
        launches_per_bucket_of_8=ops.launch_counts(), **packed,
        bucket_of_8_wall_ms=walls)), flush=True)
    prof = profile_bucket(torch, eng, imgs[:8], request_cls, model)
    prof["idle_share_unprofiled"] = 1 - prof["device_ms"] / float(
        np.median(walls))
    print(json.dumps(dict(profile_bucket_of_8=prof, serving=model,
                          backend=backend)), flush=True)
    return done, launches, convs.calls


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


# Kernels each served LM path must launch. A bf16 path launches none of
# the bit-serial kernels (its projections are ``torch.matmul``); at <8:8>
# llama3.2-3b packs its tied head through kernel 1 at every call, and an
# untied head (rwkv6-3b, recurrentgemma-9b) is packed once, at prepack.
LM_PATH_KERNELS = {
    (PHI, "bf16"): (),
    (PHI, "<8:8> cuda"): ("bitserial_matmul_fused",
                          "bitserial_matmul_fused_batched"),
    ("rwkv6-3b", "bf16"): ("wkv_chunked",),
    ("rwkv6-3b", "<8:8> cuda"): ("wkv_chunked", "bitserial_matmul_fused"),
    ("llama3.2-3b", "bf16"): (),
    ("llama3.2-3b", "<8:8> cuda"): ("bitserial_matmul_fused",
                                    "bitplane_pack"),
    ("recurrentgemma-9b", "bf16"): (),
    ("recurrentgemma-9b", "<8:8> cuda"): ("bitserial_matmul_fused",),
    (MUSICGEN, "bf16"): (),
    (MUSICGEN, "<8:8> cuda"): ("bitserial_matmul_fused",),
    (VISION, "bf16"): (),
    (VISION, "<8:8> cuda"): ("bitserial_matmul_fused",),
}
BITSERIAL_KERNELS = ("bitplane_pack", "bitserial_matmul_fused",
                     "bitserial_matmul_packed", "conv2d_bitserial_fused",
                     "bitserial_matmul_fused_batched")

def lm_part_costs(torch, cfg, params, label, clock_hz):
    """Device ms (calls queued behind a spin) of parts of an attention
    model's step that the profile does not name on their own: the
    attention core (scores, softmax, PV) of one layer at the decode shape
    (``LM_MAX_BATCH`` slots against ``LM_MAX_LEN`` cached rows) with the
    path's KV dtype, and again with float32 q, k and v (the difference is
    the cost of the float32 upcasts); at <8:8> the tied head at M =
    ``LM_MAX_BATCH`` (quantize ``embed.T``, pack it through kernel 1,
    kernel 2, the correction); and with RG-LRU blocks, the first one's
    recurrence at a 256-token prefill chunk (gates and scan, and the scan
    alone) and at a decode step of ``LM_MAX_BATCH`` slots, and its two
    float32 gate products at both M; with MoE FFNs, the first one's router
    and dispatch, expert FFN (at <8:8> three batched kernel-2 launches and
    their epilogues) and combine at a decode step and a 256-token chunk."""
    from repro_torch.models.lm import attention as A
    from repro_torch.models.lm import model as M
    from repro_torch.models.lm import moe as MOE
    from repro_torch.models.lm import rglru as RG

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, hkv, d = LM_MAX_BATCH, cfg.n_kv_heads, cfg.head_dim

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = randn(b, 1, cfg.n_heads, d)
    k, v = randn(b, LM_MAX_LEN, hkv, d), randn(b, LM_MAX_LEN, hkv, d)
    mask = torch.ones((b, 1, 1, LM_MAX_LEN), dtype=torch.bool,
                      device="cuda")
    core = {"float32": device_ms(
        lambda: A.gqa_scores_softmax_v(q, k, v, mask), 20, clock_hz)}
    dt = M.torch_dtype(cfg.dtype)
    if dt != torch.float32:
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        core[str(dt).split(".")[-1]] = device_ms(
            lambda: A.gqa_scores_softmax_v(qd, kd, vd, mask), 20, clock_hz)
    row = dict(lm_part_costs=cfg.name, path=label, layers=cfg.n_layers,
               attention_core_device_ms=core)
    if cfg.pim and cfg.tie_embeddings:
        x = randn(b, 1, cfg.d_model)
        with torch.no_grad():
            row["tied_head_device_ms"] = device_ms(
                lambda: M.lm_head(params, cfg, x), 5, clock_hz)
    if "rglru" in cfg.blocks:
        p = {k: v[0] for k, v in params["scan"][0]["rglru"].items()}
        w = cfg.lru_width or cfg.d_model
        x256, x4 = randn(1, 256, w).to(dt), randn(b, w).to(dt)
        h1, h4 = randn(1, w), randn(b, w)
        a, bb = RG._gates(p, x256)
        wa, wi = p["w_a"], p["w_i"]

        def gate_products(x):
            xf = x.to(torch.float32)
            return (xf @ wa.to(torch.float32), xf @ wi.to(torch.float32))

        row["rglru_device_ms"] = dict(
            scan_256=device_ms(lambda: RG.rglru_scan(p, x256, h1), 20,
                               clock_hz),
            affine_scan_256=device_ms(lambda: RG.affine_scan(a, bb), 20,
                                      clock_hz),
            step_decode=device_ms(lambda: RG.rglru_step(p, x4, h4), 20,
                                  clock_hz),
            gate_products_256=device_ms(lambda: gate_products(x256), 20,
                                        clock_hz),
            gate_products_decode=device_ms(lambda: gate_products(x4), 20,
                                           clock_hz))
    if cfg.moe:
        # The caller's float tree: its first layer's banks packed here.
        ffn = M.prepack_params(M._rep(params["scan"][0]["ffn"], 0), cfg.pim)
        row["moe_device_ms"] = {}
        with torch.no_grad():
            for t in (LM_MAX_BATCH, 256):
                x = randn(t, cfg.d_model).to(dt)
                r = MOE.route(ffn, cfg, x)
                disp = MOE.dispatch(ffn, cfg, x, r)
                yb = MOE.experts(ffn, cfg, disp, dt)
                row["moe_device_ms"][f"tokens_{t}"] = dict(
                    capacity=r.cap,
                    route_dispatch=device_ms(lambda: MOE.dispatch(
                        ffn, cfg, x, MOE.route(ffn, cfg, x)), 20, clock_hz),
                    experts=device_ms(lambda: MOE.experts(ffn, cfg, disp, dt),
                                      20, clock_hz),
                    combine=device_ms(lambda: MOE.combine(yb, r, t), 20,
                                      clock_hz))
    print(json.dumps(row), flush=True)


def lm_prompts(np, vocab: int) -> list:
    """Eight prompts of 64-512 tokens from numpy seed 0."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=8)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in lens]


def serve_lm(torch, np, ops, cfg, params, label, max_new):
    """One served LM path (``cfg.name`` is the arch): a warm run of the
    eight requests, which keeps the operands of kernel 2's first call at
    each distinct shape (``recorded_matmuls``), then the timed run of the
    same eight with the launch counts set to 0 just before it and read just
    after. Admission and decode dispatches are timed on the host (each ends
    in a device-to-host read), for prefill and decode tok/s. Then checks
    the path's kernels launched (``LM_PATH_KERNELS``; a bf16 path launches
    no bit-serial kernel), that prepack packed every projection through
    kernel 1 (at <8:8>), the tokens and the logits of one prefill, and
    profiles one admission plus one decode dispatch of 8 steps for the
    device's idle share. An MoE path at <8:8> must launch kernel 2's
    batched entry three times a layer a decode step (one a bank stage).
    Returns the timed run's launches and the recorded kernel-2 calls
    (``recorded_matmuls``)."""
    from repro_torch.models.lm import model as M
    from repro_torch.serving import Request, SamplerConfig, ServeEngine

    arch = cfg.name
    prompts = lm_prompts(np, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with prepack_packs() as packs:
        eng = ServeEngine(cfg, params, max_batch=LM_MAX_BATCH,
                          max_len=LM_MAX_LEN,
                          sampler=SamplerConfig(temperature=0.0),
                          device="cuda")
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t
    packed = {}
    if cfg.pim:
        packed = packs.check(f"{arch} {label} prepack")
        n_proj = len(list(_packed_leaves(eng.params)))
        if packed["prepack_packs"] != n_proj:
            raise AssertionError(f"{arch} {label}: prepack packed "
                                 f"{packed['prepack_packs']} weights on the "
                                 f"card, the tree has {n_proj} projections")
    stats = {}
    admit, decode_n = eng._admit, eng._decode_n

    def timed_admit():
        before = sum(len(r.prompt) for r in eng.queue)
        t = time.perf_counter()
        admit()
        torch.cuda.synchronize()
        stats["prefill_s"] += time.perf_counter() - t
        stats["prefill_tokens"] += before - sum(len(r.prompt)
                                                for r in eng.queue)

    def timed_decode(n):
        before = ops.launch_counts()["bitserial_matmul_fused_batched"]
        t = time.perf_counter()
        out = decode_n(n)                     # ends in the host read
        ms = (time.perf_counter() - t) * 1e3
        stats["decode_s"] += ms / 1e3
        stats["dispatch_ms"].setdefault(n, []).append(ms)
        stats["decode_steps"] += n
        stats["decode_batched"] += ops.launch_counts()[
            "bitserial_matmul_fused_batched"] - before
        return out

    eng._admit, eng._decode_n = timed_admit, timed_decode

    def serve(n_req):
        stats.update(prefill_s=0.0, prefill_tokens=0, decode_s=0.0,
                     dispatch_ms={}, decode_steps=0, decode_batched=0)
        for rid in range(n_req):
            eng.submit(Request(rid=rid, prompt=prompts[rid],
                               max_new_tokens=max_new))
        t = time.perf_counter()
        done = eng.run(strict=True)
        torch.cuda.synchronize()
        return sorted(done, key=lambda c: c.rid), time.perf_counter() - t

    with recorded_matmuls() as matmuls:
        serve(len(prompts))
    ops.reset_launch_counts()
    done, wall = serve(len(prompts))
    launches = ops.launch_counts()
    del eng._admit, eng._decode_n
    if [len(c.tokens) for c in done] != [max_new] * len(prompts) or not all(
            0 <= tok < cfg.vocab for c in done for tok in c.tokens):
        raise AssertionError(f"{arch} {label}: wrong completions "
                             f"{[(c.rid, len(c.tokens)) for c in done]}")
    missing = [k for k in LM_PATH_KERNELS[(arch, label)] if not launches[k]]
    if missing:
        raise AssertionError(f"{arch} {label}: {missing} never launched "
                             f"on the main path: {launches}")
    stray = [k for k in BITSERIAL_KERNELS if label == "bf16" and launches[k]]
    if stray:
        raise AssertionError(f"{arch} {label}: the float path launched "
                             f"{stray}: {launches}")
    per_step = stats["decode_batched"] / stats["decode_steps"]
    want_per_step = 3 * cfg.n_layers if cfg.moe and cfg.pim else 0
    if per_step != want_per_step:
        raise AssertionError(f"{arch} {label}: {per_step} batched kernel-2 "
                             f"launches a decode step, want {want_per_step}")
    with torch.no_grad():
        st = M.init_state(cfg, 1, LM_MAX_LEN, "cuda")
        logits, _ = M.prefill(eng.params, cfg, torch.from_numpy(
            prompts[0][:256]).cuda()[None], st)
    if logits.shape != (1, 1, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} {label}: non-finite or misshapen "
                             "logits")
    decode_tokens = sum(len(c.tokens) - 1 for c in done)
    row = dict(
        serving=arch, path=label, layers=cfg.n_layers,
        d_model=cfg.d_model, vocab=cfg.vocab, requests=len(prompts),
        max_batch=LM_MAX_BATCH, max_new=max_new,
        prompt_tokens=stats["prefill_tokens"], wall_s=wall,
        deploy_s=deploy_s, tok_per_s=sum(len(c.tokens) for c in done) / wall,
        prefill_s=stats["prefill_s"],
        prefill_tok_per_s=stats["prefill_tokens"] / stats["prefill_s"],
        decode_s=stats["decode_s"],
        decode_tok_per_s=decode_tokens / stats["decode_s"],
        decode_dispatch_ms={n: float(np.median(v))
                            for n, v in stats["dispatch_ms"].items()},
        decode_dispatches={n: len(v) for n, v in stats["dispatch_ms"].items()},
        launches=launches, **packed,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    if cfg.moe:
        row.update(batched_launches_per_decode_step=per_step,
                   moe_drop_frac=eng.stats()["moe_drop_frac"])
    print(json.dumps(row), flush=True)
    # One admission of a 256-token prompt (one chunk) and one decode
    # dispatch of 8 steps, profiled.
    eng.submit(Request(rid=99, prompt=prompts[0][:256], max_new_tokens=9))
    ops.reset_launch_counts()
    got = []
    prof = profile_call(torch, lambda: got.extend(eng.step()))
    if [c.rid for c in got] != [99] or len(got[0].tokens) != 9:
        raise AssertionError(f"{arch} {label}: profiled step gave {got}")
    prof["launches"] = ops.launch_counts()
    print(json.dumps(dict(profile_admit_256_decode_8=prof, serving=arch,
                          path=label)), flush=True)
    eng.close()
    return launches, matmuls


def set_cross_gates(torch, params, value=0.7):
    """Sets every cross-attention gate of an LM tree (0 at init, where
    tanh(0) zeroes the cross branch) to ``value`` plus 0.1 a rep, as the
    tests do, so that the branch counts and the reps differ; ``value``
    None sets them to 0. Returns the tree."""
    for blk in params["scan"] + params["rest"]:
        a = blk.get("attn", {})
        if "gate" in a:
            g = a["gate"]
            a["gate"] = torch.zeros_like(g) if value is None else (
                value + 0.1 * torch.arange(g.numel(), dtype=g.dtype,
                                           device=g.device)).reshape(g.shape)
    return params


def row_rel_l2(a, b):
    """The worst row's relative L2 distance of logits ``a`` from ``b``
    (numpy, the vocab last)."""
    import numpy as np

    return float(np.max(np.linalg.norm(a - b, axis=-1)
                        / np.linalg.norm(b, axis=-1)))


def stub_host_inputs(np, cfg, batch, prompt, steps, seed):
    """The host inputs of a stub-frontend comparison, float32 numpy from
    ``seed``: musicgen's ``prompt + steps`` frames (normal draws times
    d_model**-0.5, as the stub draws; the prompt, then one frame a decode
    step), or a vision prompt of token ids and one image of
    ``cfg.n_image_tokens`` patch embeddings a row. An image is one draw
    shared by its patches plus a draw a patch, at unit scale: the stub's
    independent patches at d_model**-0.5 average out over 6,400 keys and
    sit at 1/sqrt(d_model) of the residual the cross layer adds to, so the
    cross branch would move the logits by ~1e-4 of their largest and a
    fault in it would not show. Returns (prompt, step frames or None,
    image or None)."""
    rng = np.random.default_rng(seed)
    if not cfg.embed_inputs:
        frames = (rng.standard_normal((batch, prompt + steps, cfg.d_model))
                  * cfg.d_model**-0.5).astype(np.float32)
        return frames[:, :prompt], frames[:, prompt:], None
    toks = rng.integers(0, cfg.vocab, (batch, prompt)).astype(np.int32)
    img = (rng.standard_normal((batch, cfg.n_image_tokens, cfg.d_model))
           + rng.standard_normal((batch, 1, cfg.d_model))).astype(
        np.float32) if cfg.cross_attn_every else None
    return toks, None, img


def stub_inputs(torch, np, cfg, batch, prompt, steps):
    """A served stub-frontend path's inputs on the card, in the model's
    dtype, from the port's stubs: musicgen's ``prompt + steps`` frames
    (``audio_frame_embeddings``; the prompt, then one frame a decode step),
    or a vision prompt of token ids (numpy seed 0) and one image a row
    (``image_patch_embeddings``). Returns (prompt, step frames or None,
    image or None)."""
    from repro_torch.models.lm import model as M
    from repro_torch.models.lm import stubs

    dt = M.torch_dtype(cfg.dtype)
    if not cfg.embed_inputs:
        frames = stubs.audio_frame_embeddings(cfg, batch, prompt + steps,
                                              dtype=dt, device="cuda")
        return frames[:, :prompt], frames[:, prompt:], None
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (batch, prompt))
    img = stubs.image_patch_embeddings(cfg, batch, dtype=dt, device="cuda") \
        if cfg.cross_attn_every else None
    return torch.from_numpy(toks.astype(np.int32)).cuda(), None, img


def stub_run(torch, ops, params, cfg, inputs, steps):
    """A batch prefill of ``inputs``' prompt, then ``steps`` greedy decode
    steps, the same image at every call (a musicgen step takes the stub's
    next frame: its codebook frontend is a stub, so the sampled codes are
    read, not fed back). The prefill and the decode loop are each timed on
    the host and end in a synchronise. Returns the host seconds of each,
    the greedy codes (B, steps + 1) and the last step's logits, on the
    card, and the kernel launches of the decode loop."""
    from repro_torch.models.lm import model as M

    x0, frames, img = inputs
    with torch.no_grad():
        st = M.init_state(cfg, x0.shape[0], STUB_MAX_LEN, "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        lo, st = M.prefill(params, cfg, x0, st, image_embeds=img)
        codes = [lo[:, -1].argmax(-1).to(torch.int32)]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        before = ops.launch_counts()
        t = time.perf_counter()
        for i in range(steps):
            x = codes[-1][:, None] if frames is None else frames[:, i:i + 1]
            lo, st = M.decode_step(params, cfg, x, st, image_embeds=img)
            codes.append(lo[:, -1].argmax(-1).to(torch.int32))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
    after = ops.launch_counts()
    return dict(prefill_s=prefill_s, decode_s=decode_s,
                codes=torch.stack(codes, 1), logits=lo,
                decode_launches={k: after[k] - before[k] for k in after})


def serve_stub(torch, np, ops, cfg, params, label, steps):
    """One stub-frontend path (``cfg.name`` is the arch; its batch and
    prompt in ``STUB_PATHS``): deploy (at <8:8> ``prepack_params``, every
    projection and the head packed through kernel 1, one launch a weight),
    a warm run that keeps the operands of kernel 2's first call at each
    distinct shape (``recorded_matmuls``), then the timed run
    (``stub_run``) with the launch counts set to 0 just before it and read
    just after. Checks the path's kernels launched (``LM_PATH_KERNELS``; a
    bf16 path launches no bit-serial kernel; at <8:8> each decode step
    launches kernel 2 once a projection and the head, and kernel 1 never),
    and the codes and logits; prints prefill and decode tok/s and the peak
    device memory from deploy on; then profiles a prefill and 8 decode
    steps for the device's idle share. Returns the deployed tree and the
    recorded kernel-2 calls."""
    from repro_torch.models.lm import model as M

    arch = cfg.name
    b, s = STUB_PATHS[arch]["batch"], STUB_PATHS[arch]["prompt"]
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with torch.no_grad(), prepack_packs() as packs:
        deployed = M.prepack_params(params, cfg.pim)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t
    packed, n_proj = {}, len(list(_packed_leaves(deployed)))
    if cfg.pim:
        packed = packs.check(f"{arch} {label} prepack")
        if packed["prepack_packs"] != n_proj:
            raise AssertionError(f"{arch} {label}: prepack packed "
                                 f"{packed['prepack_packs']} weights on the "
                                 f"card, the tree has {n_proj} projections")
    inputs = stub_inputs(torch, np, cfg, b, s, steps)
    with recorded_matmuls() as matmuls:
        stub_run(torch, ops, deployed, cfg, inputs, steps)
    ops.reset_launch_counts()
    run = stub_run(torch, ops, deployed, cfg, inputs, steps)
    launches = ops.launch_counts()
    codes, logits = run["codes"].cpu(), run["logits"]
    if codes.shape != (b, steps + 1) or not bool(
            ((codes >= 0) & (codes < cfg.vocab)).all()) \
            or logits.shape != (b, 1, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} {label}: codes {tuple(codes.shape)}, "
                             f"logits {tuple(logits.shape)} or non-finite")
    missing = [k for k in LM_PATH_KERNELS[(arch, label)] if not launches[k]]
    stray = [k for k in BITSERIAL_KERNELS if label == "bf16" and launches[k]]
    if missing or stray:
        raise AssertionError(f"{arch} {label}: {missing} never launched, "
                             f"{stray} launched on the float path: "
                             f"{launches}")
    per_step = {k: v / steps for k, v in run["decode_launches"].items() if v}
    want = {"bitserial_matmul_fused": n_proj} if cfg.pim else {}
    if per_step != want:
        raise AssertionError(f"{arch} {label}: kernel launches a decode "
                             f"step {per_step}, want {want}")
    print(json.dumps(dict(
        serving=arch, path=label, layers=cfg.n_layers, blocks=cfg.blocks[:5],
        d_model=cfg.d_model, vocab=cfg.vocab, batch=b, prompt_tokens=b * s,
        image_tokens=cfg.n_image_tokens if cfg.cross_attn_every else 0,
        decode_steps=steps, deploy_s=deploy_s, prefill_s=run["prefill_s"],
        prefill_tok_per_s=b * s / run["prefill_s"],
        decode_s=run["decode_s"],
        decode_tok_per_s=b * steps / run["decode_s"],
        decode_step_ms=run["decode_s"] / steps * 1e3, launches=launches,
        kernel_launches_per_decode_step=per_step, **packed,
        codes=codes[0, :8].tolist(),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)), flush=True)
    ops.reset_launch_counts()
    t = time.perf_counter()
    prof = profile_call(torch, lambda: stub_run(torch, ops, deployed, cfg,
                                                inputs, min(8, steps)))
    prof.update(launches=ops.launch_counts(),
                profile_s=time.perf_counter() - t)
    print(json.dumps(dict(profile_prefill_decode_8=prof, serving=arch,
                          path=label)), flush=True)
    return deployed, matmuls


def cross_layer_costs(torch, cfg, deployed, label, clock_hz):
    """Device ms (calls queued behind a spin) of the first cross layer of
    a vision path (norm, gated cross-attention, FFN) at its prefill (the
    prompt's tokens; the image keys and values written) and at a decode
    step (one token a row; the image cache kept), and of its wk / wv
    projection of the image tokens alone, which the layer runs at every
    call, as the JAX package's does (``less_projection`` is the layer's
    time less the projection's)."""
    from repro_torch.core.pim_layers import pim_linear
    from repro_torch.models.lm import cache as C
    from repro_torch.models.lm import model as M
    from repro_torch.models.lm import stubs

    unit = M.layer_plan(cfg)[0]
    blk = M._rep(deployed["scan"][unit.index("cross_attn")], 0)
    b, s = STUB_PATHS[cfg.name]["batch"], STUB_PATHS[cfg.name]["prompt"]
    dt = M.torch_dtype(cfg.dtype)
    gen = torch.Generator(device="cuda").manual_seed(6)
    img = stubs.image_patch_embeddings(cfg, b, gen, dt, device="cuda")
    st = C.init_layer_state("cross_attn", cfg, b, STUB_MAX_LEN, "cuda", dt)
    row = {}
    with torch.no_grad():
        for name, sq, start in (("prefill", s, 0), ("decode", 1, s)):
            x = (torch.randn((b, sq, cfg.d_model), generator=gen,
                             device="cuda") * 0.1).to(dt)
            idx = torch.full((b,), start, dtype=torch.int32, device="cuda")
            pos = idx[:, None] + torch.arange(sq, dtype=torch.int32,
                                              device="cuda")[None]
            layer = device_ms(lambda: M.apply_block(
                "cross_attn", blk, cfg, x, pos, st, idx, img), 5, clock_hz)
            proj = device_ms(lambda: [pim_linear(img, blk["attn"][k],
                                                 cfg=cfg.pim)
                                      for k in ("wk", "wv")], 5, clock_hz)
            row[name] = dict(tokens=b * sq, layer=layer,
                             image_kv_projection=proj,
                             less_projection=layer - proj)
    print(json.dumps(dict(cross_layer_device_ms=row, serving=cfg.name,
                          path=label, image_tokens=img.shape[1])),
          flush=True)


def stub_gpu_vs_cpu(torch, np, ops, arch, **cfg_kw):
    """``arch`` (a stub-frontend arch) at full width, float32, cut as
    ``cfg_kw`` says (its layers), one set of weights, on the card and on
    the CPU (plain versions): two prompts of 48 frames or tokens (and two
    images of the arch's patch embeddings) in one batch prefill, then 4
    greedy decode steps. Equal codes; the prefill logits within rtol 1e-3
    and atol 1e-3*max|cpu|. The cross gates are set (``set_cross_gates``),
    and the CPU's prefill logits must differ from the card's at gate 0 by
    more than 1e-2 of max|cpu|, so that the cross branch is held."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import model as M

    cfg = dataclasses.replace(get_config(arch).model, dtype="float32",
                              **cfg_kw)
    # Drawn on the card, kept on the CPU (the CPU's generator is slower).
    params = M.init(cfg, torch.Generator(device="cuda").manual_seed(1),
                    device="cpu")
    if cfg.cross_attn_every:
        set_cross_gates(torch, params)
    x0, frames, img = stub_host_inputs(np, cfg, 2, 48, 4, seed=2)
    logits, codes = {}, {}
    ops.reset_launch_counts()
    for device in ("cuda", "cpu"):
        def conv(a):
            return None if a is None else torch.from_numpy(a).to(device)

        with torch.no_grad():
            p = M.to_device(params, device)
            st = M.init_state(cfg, 2, 64, device)
            image = conv(img)
            lo, st = M.prefill(p, cfg, conv(x0), st, image_embeds=image)
            logits[device] = lo.cpu().numpy()
            got = [lo[:, -1].argmax(-1).to(torch.int32)]
            for i in range(4):
                x = got[-1][:, None] if frames is None \
                    else conv(frames[:, i:i + 1])
                lo, st = M.decode_step(p, cfg, x, st, image_embeds=image)
                got.append(lo[:, -1].argmax(-1).to(torch.int32))
            codes[device] = torch.stack(got, 1).cpu().tolist()
            del p, st, image
    launches = ops.launch_counts()
    gpu, cpu = logits["cuda"], logits["cpu"]
    err = float(np.abs(gpu - cpu).max())
    scale = float(np.abs(cpu).max())
    gate_moves = None
    if cfg.cross_attn_every:
        with torch.no_grad():
            p = set_cross_gates(torch, M.to_device(params, "cuda"), None)
            lo, _ = M.prefill(p, cfg, torch.from_numpy(x0).cuda(),
                              M.init_state(cfg, 2, 64, "cuda"),
                              image_embeds=torch.from_numpy(img).cuda())
            gate_moves = float(np.abs(lo.cpu().numpy() - cpu).max()) / scale
            del p, lo
    stray = [k for k in BITSERIAL_KERNELS if launches[k]]
    if codes["cuda"] != codes["cpu"] or stray or not np.allclose(
            gpu, cpu, rtol=1e-3, atol=1e-3 * scale) or (
            gate_moves is not None and gate_moves <= 1e-2):
        raise AssertionError(
            f"{arch} GPU vs CPU: codes {codes['cuda']} vs {codes['cpu']}, "
            f"max |dlogit| {err} (max|cpu| {scale}), the cross gate moves "
            f"{gate_moves} of max|cpu|, launches {launches}")
    print(json.dumps(dict(
        gpu_vs_cpu=arch, layers=cfg.n_layers, blocks=cfg.blocks,
        batch=2, prompt=48, decode_steps=4,
        image_tokens=cfg.n_image_tokens if cfg.cross_attn_every else 0,
        codes=codes["cuda"], max_abs_diff=err, max_abs_cpu=scale,
        gate_moves_of_max_abs_cpu=gate_moves)), flush=True)


def lm_gpu_vs_cpu(torch, np, ops, arch, kv_quant=False, n_layers=2,
                  prompt_len=48):
    """``arch`` at full width, ``n_layers`` layers, float32, one set of
    weights, on the card and on the CPU (plain versions): a
    ``prompt_len``-token prompt prefilled in the engine's power-of-two
    chunks (32 + 16 at 48), and 4 greedy tokens. Equal tokens; the last
    chunk's logits within rtol 1e-3 and atol 1e-3*max|cpu|. With
    ``kv_quant`` (the int8 KV cache), also ``quantize_kv`` on the first k
    tensor the CPU run quantized gives equal codes and scales on both
    devices."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import cache as C
    from repro_torch.models.lm import model as M
    from repro_torch.serving import Request, SamplerConfig, ServeEngine
    from repro_torch.serving.engine import _pow2_chunks

    cfg = dataclasses.replace(get_config(arch).model, n_layers=n_layers,
                              dtype="float32", kv_quant=kv_quant)
    # Drawn on the card, kept on the CPU: the CPU's generator draws ~110 M
    # normals a second, ~20 s for a full-width embedding and head.
    params = M.init(cfg, torch.Generator(device="cuda").manual_seed(1),
                    device="cpu")
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab, prompt_len).astype(np.int32)
    chunks, max_len = _pow2_chunks(prompt_len), prompt_len + 16
    logits, toks, kv_inputs = {}, {}, []
    real_quantize_kv = C.quantize_kv

    def spy(x):
        if not kv_inputs:
            kv_inputs.append(x.clone())
        return real_quantize_kv(x)

    ops.reset_launch_counts()
    for device in ("cuda", "cpu"):
        C.quantize_kv = spy if device == "cpu" else real_quantize_kv
        try:
            with torch.no_grad():
                p_dev = M.to_device(params, device)
                st, pos = M.init_state(cfg, 1, max_len, device), 0
                for c in chunks:
                    lo, st = M.prefill(p_dev, cfg, torch.from_numpy(
                        prompt[pos:pos + c])[None].to(device), st)
                    pos += c
                del p_dev, st
            logits[device] = lo.cpu().numpy()
            eng = ServeEngine(cfg, params, max_batch=1, max_len=max_len,
                              sampler=SamplerConfig(temperature=0.0),
                              device=device)
            eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
            toks[device] = eng.run(strict=True)[0].tokens
            eng.close()
        finally:
            C.quantize_kv = real_quantize_kv
    launches = ops.launch_counts()
    gpu, cpu = logits["cuda"], logits["cpu"]
    err = float(np.abs(gpu - cpu).max())
    scale = float(np.abs(cpu).max())
    # The float32 path launches the bf16 path's kernels.
    missing = [k for k in LM_PATH_KERNELS[(arch, "bf16")] if not launches[k]]
    label = f"{arch}{' kv_quant' if kv_quant else ''}"
    if toks["cuda"] != toks["cpu"] or missing or not np.allclose(
            gpu, cpu, rtol=1e-3, atol=1e-3 * scale):
        raise AssertionError(
            f"{label} GPU vs CPU: tokens {toks['cuda']} vs {toks['cpu']}, "
            f"max |dlogit| {err} (max|cpu| {scale}), launches {launches}")
    row = dict(gpu_vs_cpu=label, layers=n_layers, prompt=prompt_len,
               chunks=chunks, tokens=toks["cuda"], max_abs_diff=err,
               max_abs_cpu=scale,
               launches={k: v for k, v in launches.items() if v})
    if kv_quant:
        x = kv_inputs[0]
        want = real_quantize_kv(x)
        got = [y.cpu() for y in real_quantize_kv(x.cuda())]
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{label}: quantize_kv codes or scales on "
                                 f"the card != the CPU's, {tuple(x.shape)}")
        row["quantize_kv_equal"] = dict(shape=list(x.shape), codes=True,
                                        scales=True)
    print(json.dumps(row), flush=True)


def cast_in_place(torch, tree, dtype):
    """``cast_params`` leaf by leaf in place: each float32 leaf of two or
    more dimensions is replaced by its cast, so the float32 copy is freed
    before the next cast is made (the tree must hold the only reference),
    and recurrentgemma-9b's 41.8 GB of float32 and 20.9 GB of bf16 are
    never on the card together."""
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            cast_in_place(torch, v, dtype)
        elif v.dtype == torch.float32 and v.dim() >= 2:
            tree[k] = v.to(dtype)


def _packed_leaves(tree, path=""):
    """(path, leaf) of every prepacked leaf (PackedWeight, or a CNN's
    PackedConvWeight) of a tree."""
    from repro_torch.core.packed import PackedConvWeight, PackedWeight

    if isinstance(tree, (PackedWeight, PackedConvWeight)):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _packed_leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _packed_leaves(v, f"{path}/{i}")


def lm_pim_gpu_vs_cpu(torch, np, ops, arch, block_pattern=None,
                      shared=None, **cfg_kw):
    """``arch`` at full width, 1 layer (of ``block_pattern``'s kind where
    given; ``cfg_kw`` overrides the config further), <8:8> on "cuda",
    float32, one set of weights, on the card and on the CPU. Two prompts
    (48 = 32 + 16 and 20 = 16 + 4) are prefilled chunk by chunk into slots
    0 and 1 of a 4-slot grid, then two decode steps run at M = 4 on the
    same tokens; a stub-frontend arch instead prefills two prompts of 16
    frames or tokens (and two images) in one batch, then runs two decode
    steps at M = 2 (``stub_host_inputs``). Calls that pass one ``shared``
    dict serve the first call's embedding and head, and the CPU prepacks
    the head once (a 4096 x 256,000 head takes it ~25 s).

    The path is chaotic end to end: one float ulp of jitter flips an
    activation code at a quantization boundary, a flip moves an output by a
    whole code step, and the next layers spread it (on the CPU alone,
    weights moved by 1e-6 relative move one reduced layer's logits by 1-3%
    in relative L2, `examples/torch_pim_lm_jitter.py`). So it is held in
    three parts:
    1. the planes prepacked on the card equal the CPU's bit for bit (codes,
       planes, column sums, scale, zero point);
    2. every quantized product of the card's run (each projection and the
       head, each prefill chunk and decode step) recomputed on the CPU from
       the same input: the same activation codes and the same integer P, so
       the output agrees within 1e-5 of its largest; and every expert-bank
       product (kernel 2's batched entry) recomputed on the CPU from the
       same codes: the same P, bit for bit;
    3. the logits against the CPU's own run: each row within 0.1 in
       relative L2, where a wiring fault gives O(1); the error is printed
       beside the card's own spread (``jitter_rel_l2``: its logits with the
       float weights moved by 1e-6 relative); with cross layers (their
       gates set, ``set_cross_gates``), the card's logits at gate 0 must
       be more than 0.1 from the CPU's.
    The CPU runs ``int-direct``, whose P equals Eq. 1's bit for bit
    (``backends_agree``) and which is far faster there than the plain
    version of kernel 2."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import PIMQuantConfig, bitserial, pim_layers
    from repro_torch.core.packed import PackedWeight
    from repro_torch.models.lm import model as M
    from repro_torch.serving.engine import _pow2_chunks

    kind = {} if block_pattern is None else {"block_pattern": block_pattern}
    model = dataclasses.replace(get_config(arch).model, **{
        "n_layers": 1, "dtype": "float32", **kind, **cfg_kw})
    stub = not model.embed_inputs or bool(model.cross_attn_every)
    params = M.init(model, torch.Generator(device="cuda").manual_seed(3),
                    device="cpu")
    if model.cross_attn_every:
        set_cross_gates(torch, params)
    if shared is not None:
        if "embed" in shared:
            params.update(embed=shared["embed"], head=shared["head"])
        else:
            shared.update(embed=params["embed"], head=params["head"])
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, model.vocab, n).astype(np.int64)
               for n in (48, 20)]
    toks = []      # the CPU run's greedy tokens, which both runs decode
    if stub:
        x0, frames, img = stub_host_inputs(np, model, 2, 16, 2, seed=4)
        prompts = list(x0)
    real, calls, logits, packed = pim_layers.quantized_matmul, [], {}, {}
    real_bank, bank_calls = bitserial.int_matmul_prepacked_bank, []

    def spy(a, w, **kw):
        y = real(a, w, **kw)
        calls.append((a.cpu(), w, kw, y.cpu()))
        return y

    def bank_spy(qa, w, a_bits, backend):
        p = real_bank(qa, w, a_bits, backend)
        bank_calls.append((qa.cpu(), w, a_bits, p.cpu()))
        return p

    def run_slots(p, cfg, device):
        st = M.init_state(cfg, LM_MAX_BATCH, 64, device)
        out = []
        for slot, prompt in enumerate(prompts):
            pos = 0
            for c in _pow2_chunks(len(prompt)):
                lo, st = M.prefill_into_slot(
                    p, cfg, torch.from_numpy(
                        prompt[pos:pos + c])[None].to(device), st, slot, pos)
                pos += c
            out.append(lo[:, 0].cpu().numpy())
        if device == "cpu":
            toks.append(np.array([int(o.argmax()) for o in out] + [0] * (
                LM_MAX_BATCH - len(out))))
        for step in range(2):
            lo, st = M.decode_step(p, cfg, torch.from_numpy(
                toks[step])[:, None].to(device), st)
            out.append(lo[:, 0].cpu().numpy())
            if device == "cpu" and step == 0:
                toks.append(out[-1].argmax(-1))
        return out

    def run_batch(p, cfg, device):
        def conv(a):
            return None if a is None else torch.from_numpy(a).to(device)

        st = M.init_state(cfg, 2, 64, device)
        image = conv(img)
        lo, st = M.prefill(p, cfg, conv(x0), st, image_embeds=image)
        out = [lo[:, 0].cpu().numpy()]
        for step in range(2):
            if frames is not None:
                x = conv(frames[:, step:step + 1])
            else:
                if device == "cpu":
                    toks.append(out[-1].argmax(-1).astype(np.int32))
                x = conv(toks[step][:, None])
            lo, st = M.decode_step(p, cfg, x, st, image_embeds=image)
            out.append(lo[:, 0].cpu().numpy())
        return out

    for device, backend in (("cpu", "int-direct"), ("cuda", "cuda")):
        cfg = dataclasses.replace(model, pim=PIMQuantConfig(
            8, 8, backend=backend))
        ops.reset_launch_counts()
        with torch.no_grad():
            tree = M.to_device(params, device)
            if device == "cpu" and shared and "head_cpu" in shared:
                tree["head"] = shared["head_cpu"]
            p = packed[device] = M.prepack_params(tree, cfg.pim)
            if device == "cpu" and shared is not None:
                shared["head_cpu"] = p["head"]
            if device == "cuda":
                card_tree = tree   # the card's float tree, jittered below
                pim_layers.quantized_matmul = spy
                bitserial.int_matmul_prepacked_bank = bank_spy
            del tree
            try:
                out = (run_batch if stub else run_slots)(p, cfg, device)
            finally:
                pim_layers.quantized_matmul = real
                bitserial.int_matmul_prepacked_bank = real_bank
        logits[device] = out
        launches = ops.launch_counts()
    leaves = dict(_packed_leaves(packed["cpu"]))
    gpu_leaves = dict(_packed_leaves(packed["cuda"]))
    if sorted(leaves) != sorted(gpu_leaves) or not leaves:
        raise AssertionError(f"prepacked leaves differ: {sorted(leaves)} vs "
                             f"{sorted(gpu_leaves)}")
    for path, w in leaves.items():
        g = gpu_leaves[path].to("cpu")
        for name in ("codes", "planes", "col_sums"):
            if not torch.equal(getattr(w, name), getattr(g, name)):
                raise AssertionError(f"prepacked {path}.{name}: card != CPU")
        if not (torch.equal(w.wq.scale, g.wq.scale)
                and torch.equal(w.wq.qmin, g.wq.qmin)):
            raise AssertionError(f"prepacked {path} scale/qmin: card != CPU")
    # A card leaf, held equal to the CPU's prepack just above, is recomputed
    # against the CPU's own leaf; any other weight is copied to the CPU.
    on_cpu = {id(gpu_leaves[path]): w for path, w in leaves.items()}
    call_err = 0.0
    for a, w, kw, y in calls:
        # A PackedWeight, or a tied head's float weight (a new view of the
        # embedding at every call).
        key = id(w) if isinstance(w, PackedWeight) else (
            w.data_ptr(), tuple(w.shape), w.stride())
        if key not in on_cpu:
            on_cpu[key] = w.to("cpu")
        want = real(a, on_cpu[key], **dict(kw, backend="int-direct"))
        err = float((y - want).abs().max() / want.abs().max())
        call_err = max(call_err, err)
        if y.shape != want.shape or err > 1e-5:
            raise AssertionError(f"<8:8> product on the card vs the CPU: "
                                 f"{tuple(a.shape)} x {w.shape}, max |dy| "
                                 f"{err} of max |y|")
    for qa, w, a_bits, p in bank_calls:
        if id(w) not in on_cpu:
            on_cpu[id(w)] = w.to("cpu")
        want = real_bank(qa, on_cpu[id(w)], a_bits, "int-direct")
        if not torch.equal(p, want):
            raise AssertionError(f"<8:8> bank product on the card vs the "
                                 f"CPU: {tuple(qa.shape)} x {w.shape}")
    rel_l2 = [row_rel_l2(g, c)
              for g, c in zip(logits["cuda"], logits["cpu"])]
    scale = max(float(np.abs(c).max()) for c in logits["cpu"])
    err = max(float(np.abs(g - c).max())
              for g, c in zip(logits["cuda"], logits["cpu"]))
    missing = [k for k in LM_PATH_KERNELS[(arch, "<8:8> cuda")]
               if not launches[k]]
    # The card's own spread, printed beside the reading: its logits again
    # with every float weight moved by 1e-6 relative (one draw); the path
    # sits as far from the CPU as from itself under such a jitter. With
    # cross layers, the card at gate 0 must be further from the CPU than
    # the 0.1 the logits are held to.
    run = run_batch if stub else run_slots
    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(5)
        tree = M._map(lambda x: x * (1 + 1e-6 * torch.randn(
            x.shape, generator=gen, device="cuda"))
            if x.dtype == torch.float32 and x.dim() >= 2 else x, card_tree)
        del card_tree
        p = M.prepack_params(tree, cfg.pim)
        del tree
        jitter = max(row_rel_l2(g, c) for g, c in zip(
            run(p, cfg, "cuda"), logits["cuda"]))
        del p
        gate_moves = None
        if "cross_attn" in model.blocks:
            p = set_cross_gates(torch, packed["cuda"], None)
            gate_moves = min(float(np.min(
                np.linalg.norm(g - c, axis=-1) / np.linalg.norm(c, axis=-1)))
                for g, c in zip(run(p, cfg, "cuda"), logits["cpu"]))
            del p
    label = arch if block_pattern is None else f"{arch} {block_pattern[0]}"
    extra = dict(blocks=model.blocks, image_tokens=model.n_image_tokens,
                 gate_0_rel_l2=gate_moves) if model.cross_attn_every else {}
    print(json.dumps(dict(gpu_vs_cpu=f"{label} <8:8> cuda",
                          layers=model.n_layers, **extra,
                          prompts=[len(x) for x in prompts], decode_steps=2,
                          max_batch=2 if stub else LM_MAX_BATCH,
                          packed_leaves=len(leaves),
                          products=len(calls), product_max_rel_err=call_err,
                          bank_products_equal=len(bank_calls),
                          logits_rel_l2=rel_l2, jitter_rel_l2=jitter,
                          max_abs_diff=err,
                          max_abs_cpu=scale, launches=launches)), flush=True)
    if max(rel_l2) > 0.1 or len(calls) != launches["bitserial_matmul_fused"] \
            or len(bank_calls) != launches["bitserial_matmul_fused_batched"] \
            or missing or (gate_moves is not None and gate_moves <= 0.1):
        raise AssertionError(
            f"{arch} <8:8> GPU vs CPU: logits relative L2 {rel_l2}, at "
            f"gate 0 {gate_moves}, {len(calls)} products, launches "
            f"{launches}")


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


# The autotuner's backend grid: benchmarks/autotune_bench.py's SHAPES (M,
# K, N) at <2:2>, <4:4> and <8:8>, 15 GEMMs (a copy: the script imports
# nothing of benchmarks/). Each candidate is timed by measure_gemm over
# three rounds of AUTOTUNE_ITERS calls (the median round).
AUTOTUNE_SHAPES = [(4, 2048, 2048), (8, 4096, 1024), (64, 8192, 512),
                   (256, 2048, 256), (1024, 512, 1024)]
AUTOTUNE_BITS = (2, 4, 8)
AUTOTUNE_ITERS = 20
# Rates searched for the "cuda" row of autotune._RATES: 10^(i/4), 1e-3..1e3.
RATE_GRID = [10 ** (i / 4) for i in range(-12, 13)]


def autotune_grid(torch, clock_hz):
    """The backend grid on the card: at each GEMM every candidate of
    ``gemm_candidates`` (the four backends, each legalized kernel-2 tile
    request among them) gives the same P, held with ``torch.equal`` to
    int-direct's and to kernel 2's plain version; each candidate is timed
    by ``measure_gemm`` (CUDA events around AUTOTUNE_ITERS calls, the
    median of three rounds); the cost-mode pick (the committed "cuda"
    rates, no tie-break) and the measure-mode pick
    (``decide_gemm(mode="measure")`` as an engine runs it, at
    ``measure_gemm``'s own default) are scored against the fastest backend
    (the reference's ``autotune_regret`` row: a backend's time is its
    best analytic candidate's, the one measure mode times). Each kernel-2
    tile candidate is also timed on the device alone (``device_ms``),
    where its launch plan, not the host, sets the time. Prints one JSON
    line a GEMM and returns the rows, for :func:`fit_cuda_rates`."""
    from repro_torch.core.bitserial import int_matmul_prepacked
    from repro_torch.core.packed import prepack
    from repro_torch.kernels import bitserial_matmul as km
    from repro_torch.pim import autotune as at

    rows = []
    for m, k, n in AUTOTUNE_SHAPES:
        for b in AUTOTUNE_BITS:
            gen = torch.Generator(device="cuda").manual_seed(0)
            qa = torch.randint(0, 2 ** b, (m, k), generator=gen,
                               dtype=torch.int32, device="cuda")
            pk = prepack(torch.randn((k, n), generator=gen, device="cuda"), b)
            want = int_matmul_prepacked(qa, pk, b, "int-direct")
            plain = km.bitserial_matmul_fused_plain(qa, pk.planes, b, b)
            if not torch.equal(plain, want):
                raise AssertionError(f"plain kernel 2 != int-direct at "
                                     f"{(m, k, n)} <{b}:{b}>")
            cands = at.gemm_candidates(m, k, n, b, b, at.ALL_BACKENDS)
            tile_device_ms = {}
            for d in cands:
                tuned = at.attach(pk, d)
                if not torch.equal(int_matmul_prepacked(qa, tuned, b), want):
                    raise AssertionError(f"{d} differs at {(m, k, n)} "
                                         f"<{b}:{b}>")
                if d.backend == "cuda":
                    tile_device_ms[d] = device_ms(
                        lambda: int_matmul_prepacked(qa, tuned, b), 20,
                        clock_hz)
            del qa, pk, want, plain
            cost = {d: at.analytic_gemm_cost(m, k, n, b, b, d, "cuda")
                    for d in cands}
            ms = {d: at.measure_gemm(d, m, k, n, b, b, iters=AUTOTUNE_ITERS,
                                     device="cuda") * 1e3 for d in cands}
            heads = {}
            for d in sorted(cands, key=lambda d: (cost[d], cands.index(d))):
                heads.setdefault(d.backend, d)
            backend_ms = {be: ms[d] for be, d in heads.items()}
            fastest = min(backend_ms, key=backend_ms.get)
            pick = at.decide_gemm(m, k, n, b, b, backends=at.ALL_BACKENDS,
                                  hlo_tiebreak=False, device="cuda")
            lib = {be: backend_ms[be] for be in at.LIBRARY_BACKENDS}
            lib_fastest = min(lib, key=lib.get)
            lib_pick = at.decide_gemm(m, k, n, b, b, hlo_tiebreak=False,
                                      device="cuda")
            live = at.decide_gemm(m, k, n, b, b, backends=at.ALL_BACKENDS,
                                  mode="measure", hlo_tiebreak=False,
                                  device="cuda")
            tiles = [dict(bm=d.bm, bkw=d.bkw, ms=ms[d],
                          device_ms=tile_device_ms[d],
                          tile_factor=at._tile_factor(m, k, n, b, b, d))
                     for d in cands if d.backend == "cuda"]
            top = min(tiles, key=lambda t: t["tile_factor"])
            row = dict(
                autotune_grid=f"{m}x{k}x{n}", bits=f"<{b}:{b}>",
                backend_ms=backend_ms, fastest=fastest,
                cost_pick=pick.backend,
                cost_regret=ms[pick] / backend_ms[fastest] - 1,
                measure_pick=live.backend,
                measure_regret=backend_ms[live.backend]
                / backend_ms[fastest] - 1,
                library_fastest=lib_fastest,
                library_cost_pick=lib_pick.backend,
                library_cost_regret=lib[lib_pick.backend] / lib[lib_fastest]
                - 1,
                cuda_tiles=tiles,
                fastest_tile_is_analytic_top=min(
                    tiles, key=lambda t: t["ms"]) is top,
                fastest_device_tile_is_analytic_top=min(
                    tiles, key=lambda t: t["device_ms"]) is top,
                analytic_top_device_regret=top["device_ms"] / min(
                    t["device_ms"] for t in tiles) - 1,
                candidates_equal=len(cands))
            print(json.dumps(row), flush=True)
            # Each backend's cost at rate 1 (the committed rate multiplied
            # back), for the fit.
            row["base"] = {be: cost[d] * at._rates("cuda")[be]
                           for be, d in heads.items()}
            rows.append(row)
    return rows


def autotune_conv_grid(torch):
    """The conv GEMMs the tuned engines decide: ``tune_tree`` ranks each
    conv weight's im2col product among the library backends at
    ``conv_m_hint`` = bucket x 224 x 224 rows, the reference's bound. At
    each distinct (M, K, N) of ResNet-50's and AlexNet's convs (1 x 1
    included; ``model_specs`` at 224 px) at the buckets served, every
    library backend's P is held equal to int-direct's, each backend is
    timed by ``measure_gemm`` at the rows the engine serves, and the
    cost-mode pick (the committed "cuda" rates) is made at the hint, as
    the engine makes it. Prints one JSON line a GEMM and returns the rows,
    for :func:`fit_cuda_rates`."""
    from repro_torch.core.bitserial import int_matmul_prepacked
    from repro_torch.core.packed import TuneDecision, prepack
    from repro_torch.models.cnn.specs import model_specs
    from repro_torch.pim import autotune as at

    rows, seen = [], set()
    for bucket in SERVED_BUCKETS:
        hint = bucket * 224 * 224
        for model in ("resnet50", "alexnet"):
            for s in model_specs(model, bucket, 224):
                if s.kind != "conv" or (s.m, s.k, s.n) in seen:
                    continue
                seen.add((s.m, s.k, s.n))
                gen = torch.Generator(device="cuda").manual_seed(0)
                qa = torch.randint(0, 256, (s.m, s.k), generator=gen,
                                   dtype=torch.int32, device="cuda")
                pk = prepack(torch.randn((s.k, s.n), generator=gen,
                                         device="cuda"), 8)
                want = int_matmul_prepacked(qa, pk, 8, "int-direct")
                for be in at.LIBRARY_BACKENDS:
                    if not torch.equal(int_matmul_prepacked(qa, pk, 8, be),
                                       want):
                        raise AssertionError(f"{be} differs at conv GEMM "
                                             f"{(s.m, s.k, s.n)} <8:8>")
                del qa, pk, want
                ms = {}
                for be in at.LIBRARY_BACKENDS:
                    t = at.measure_gemm(TuneDecision(backend=be), s.m, s.k,
                                        s.n, 8, 8, iters=5, device="cuda")
                    if t is not None:
                        ms[be] = t * 1e3
                cost = {be: at.analytic_gemm_cost(
                    hint, s.k, s.n, 8, 8, TuneDecision(backend=be), "cuda")
                    for be in at.LIBRARY_BACKENDS}
                pick = min(at.LIBRARY_BACKENDS, key=cost.get)
                if pick != at.decide_gemm(hint, s.k, s.n, 8, 8,
                                          hlo_tiebreak=False,
                                          device="cuda").backend:
                    raise AssertionError("the conv grid's cost pick is not "
                                         "decide_gemm's")
                fastest = min(ms, key=ms.get)
                row = dict(
                    autotune_conv_grid=f"{s.m}x{s.k}x{s.n}", model=model,
                    layer=s.name, bucket=bucket, hint_m=hint, bits="<8:8>",
                    backend_ms=ms, library_fastest=fastest,
                    library_cost_pick=pick,
                    library_cost_regret=ms[pick] / ms[fastest] - 1
                    if pick in ms else None)
                print(json.dumps(row), flush=True)
                row["base"] = {be: cost[be] * at._rates("cuda")[be]
                               for be in cost}
                rows.append(row)
    torch.cuda.empty_cache()
    return rows


def fit_cuda_rates(rows, conv_rows) -> dict:
    """The "cuda" rates (popcount = 1) from RATE_GRID whose cost-mode pick
    is the fastest backend on the most GEMMs, counted three times: the
    grid's among the four backends (what an FC or projection weight ranks
    on the card), the grid's among the three library backends (what MoE
    banks rank), and the served convs' among the library three (what conv
    weights rank, priced at the engine's hint rows, timed at the rows
    served). Ties go to the least summed regret, then to the rates whose
    predicted time ratios (each backend's cost over popcount's) are
    nearest the measured ratios, in log over every row: the measured
    backend times settle what the counts leave open. Prints the fit beside
    the committed rates' match counts."""
    import math

    from repro_torch.pim import autotune as at

    def hits_of(rates, rows, backends):
        hits, regret = 0, 0.0
        for r in rows:
            ms = {be: r["backend_ms"][be] for be in backends
                  if be in r["backend_ms"]}
            pick = min(backends, key=lambda be: r["base"][be] / rates[be])
            fastest = min(ms, key=ms.get)
            hits += pick == fastest
            regret += (ms[pick] / ms[fastest] - 1 if pick in ms
                       else float("inf"))
        return hits, regret

    def score(rates):
        counts = (hits_of(rates, rows, at.ALL_BACKENDS),
                  hits_of(rates, rows, at.LIBRARY_BACKENDS),
                  hits_of(rates, conv_rows, at.LIBRARY_BACKENDS))
        return [c[0] for c in counts], sum(c[1] for c in counts)

    measured = [(r["base"], r["backend_ms"]) for r in rows + conv_rows
                if "popcount" in r["backend_ms"]]

    def misfit(rates):
        err = 0.0
        for base, ms in measured:
            for be, t in ms.items():
                if be != "popcount":
                    err += (math.log(base[be] / rates[be] / base["popcount"])
                            - math.log(t / ms["popcount"])) ** 2
        return err

    best = None
    for mxu in RATE_GRID:
        for direct in RATE_GRID:
            for cuda in RATE_GRID:
                rates = {"popcount": 1.0, "mxu-plane": mxu,
                         "int-direct": direct, "cuda": cuda}
                hits, regret = score(rates)
                key = (-sum(hits), round(regret, 9))
                if best is not None and key > best[0][:2]:
                    continue
                key += (misfit(rates),)
                if best is None or key < best[0]:
                    best = (key, rates, hits)
    committed, committed_regret = score(at._rates("cuda"))
    out = dict(autotune_grid_summary=dict(
        gemms=len(rows), conv_gemms=len(conv_rows),
        committed_rates=at._rates("cuda"),
        cost_matches_fastest=committed[0],
        library_cost_matches_fastest=committed[1],
        conv_cost_matches_fastest=committed[2],
        cost_regret_sum=committed_regret,
        measure_matches_fastest=sum(r["measure_pick"] == r["fastest"]
                                    for r in rows),
        fitted_rates=best[1], fitted_matches=best[2][0],
        fitted_library_matches=best[2][1], fitted_conv_matches=best[2][2],
        fitted_regret_sum=best[0][1], fitted_log_misfit=best[0][2],
        fastest_tile_is_analytic_top=sum(r["fastest_tile_is_analytic_top"]
                                         for r in rows),
        fastest_device_tile_is_analytic_top=sum(
            r["fastest_device_tile_is_analytic_top"] for r in rows)))
    print(json.dumps(out), flush=True)
    return out


def _decision_name(d) -> str:
    """A decision as a backend, with its tile requests where it has any."""
    if d.bm is None and d.bkw is None:
        return d.backend
    return f"{d.backend} bm={d.bm} bkw={d.bkw}"


def _picks(tree) -> dict:
    """Decisions of a tuned tree by kind of leaf ("fc" and "conv_mat" of a
    CNN, "proj" and "bank" of an LM): {decision name: count}."""
    from repro_torch.core.packed import PackedConvWeight

    out = {}
    lm = isinstance(tree, dict) and "scan" in tree
    for _, leaf in _packed_leaves(tree):
        if isinstance(leaf, PackedConvWeight):
            kind, d = "conv_mat", leaf.mat.tune
        else:
            kind = ("bank" if leaf.is_bank else "proj") if lm else "fc"
            d = leaf.tune
        by = out.setdefault(kind, {})
        by[_decision_name(d)] = by.get(_decision_name(d), 0) + 1
    return out


def _picked_backends(picks) -> set:
    return {name.split()[0] for by in picks.values() for name in by}


def check_picked_kernels(label, picked, launches):
    """Each kernel backend a tuned path dispatched to (``picked``) must
    have launched its kernel in the timed run: "cuda" kernel 2,
    "popcount" kernel 4."""
    want = {"cuda": "bitserial_matmul_fused",
            "popcount": "bitserial_matmul_packed"}
    missing = [k for be, k in want.items() if be in picked
               and not launches[k]]
    if missing:
        raise AssertionError(f"{label}: picked {sorted(picked)}, and "
                             f"{missing} never launched: {launches}")


class counted_im2col:
    """While open, counts ``pim_conv2d``'s im2col products by the backend
    each dispatches to (its weight's decision, else the layer's backend):
    a conv weight's decision runs only where its conv takes the im2col
    route, not on kernel 3."""

    def __enter__(self):
        from repro_torch.core import pim_layers

        self.module, self.real, self.by = (
            pim_layers, pim_layers.int_matmul_prepacked, {})

        def counted(qa, w, a_bits, backend="cuda"):
            be = w.tune.backend if w.tune is not None else backend
            self.by[be] = self.by.get(be, 0) + 1
            return self.real(qa, w, a_bits, backend)

        pim_layers.int_matmul_prepacked = counted
        return self

    def __exit__(self, *exc):
        self.module.int_matmul_prepacked = self.real


class counted_measures:
    """While open, counts the calls of ``autotune.measure_gemm``."""

    def __enter__(self):
        from repro_torch.pim import autotune as at

        self.module, self.real, self.n = at, at.measure_gemm, 0

        def counted(*a, **k):
            self.n += 1
            return self.real(*a, **k)

        at.measure_gemm = counted
        return self

    def __exit__(self, *exc):
        self.module.measure_gemm = self.real


def autotune_vision(torch, np, ops, model, module, imgs, cache_path):
    """``model`` at 224 px, 1000 classes, <8:8>, 12 requests (buckets 8 +
    4) through ``VisionEngine(backend="cuda")`` untuned and with
    ``autotune="measure"`` on a tuning cache file: a warm run, then a timed
    run of each with the launch counts set to 0 just before it and read
    just after; the tuned logits must equal the untuned ones bit for bit
    (and so top-1). Prints the picks by backend and the conv routes (kernel
    3's launches, and the im2col products by the backend each dispatched
    to), the img/s of both, and a profiled bucket of 8 of both.
    A second tuned engine on the same file must make the same decisions
    with no call of ``measure_gemm``."""
    from repro_torch.core.packed import PackedConvWeight
    from repro_torch.serving import VisionEngine, VisionRequest

    params = module.init(torch.Generator().manual_seed(0), num_classes=1000,
                         image=224)

    def serve(eng):
        for rid in range(len(imgs)):
            eng.submit(VisionRequest(rid=rid, image=imgs[rid], model=model))
        t = time.perf_counter()
        done = eng.run(strict=True)
        torch.cuda.synchronize()
        return sorted(done, key=lambda c: c.rid), time.perf_counter() - t

    out, engines = {}, {}
    with counted_measures() as first:
        for label, kw in (("untuned", {}),
                          ("tuned", dict(autotune="measure",
                                         tuning_cache=cache_path))):
            eng = VisionEngine({model: params}, backend="cuda", max_batch=8,
                               device="cuda", **kw)
            t = time.perf_counter()
            serve(eng)                                  # warm (and tune)
            warm_s = time.perf_counter() - t
            with counted_im2col() as im2col:
                ops.reset_launch_counts()
                done, dt = serve(eng)
                launches = ops.launch_counts()
            out[label] = dict(done=done, img_per_s=len(done) / dt,
                              warm_s=warm_s, launches=launches,
                              im2col=im2col.by)
            engines[label] = eng
    base, tuned = out["untuned"]["done"], out["tuned"]["done"]
    if [c.batch for c in tuned] != [c.batch for c in base] or not all(
            np.array_equal(a.logits, b.logits) and a.top1 == b.top1
            for a, b in zip(base, tuned)):
        raise AssertionError(f"{model}: tuned logits differ from untuned")
    eng = engines["tuned"]
    trees = {k: v for k, v in eng._tuned.items()}
    if sorted(k[-1] for k in trees) != [4, 8]:
        raise AssertionError(f"{model}: tuned views {sorted(trees)}")
    lt = out["tuned"]["launches"]
    if not lt["conv2d_bitserial_fused"] or not lt["bitplane_pack"]:
        raise AssertionError(f"{model}: the tuned path never launched "
                             f"kernel 3 or kernel 1: {lt}")
    picks = {f"bucket_{k[-1]}": _picks(v) for k, v in trees.items()}
    # FC weights dispatch their decision in every bucket; a conv weight's
    # only where its conv takes the im2col route.
    fc = {leaf.tune.backend for tree in trees.values()
          for _, leaf in _packed_leaves(tree)
          if not isinstance(leaf, PackedConvWeight)}
    check_picked_kernels(f"{model} tuned", fc | set(out["tuned"]["im2col"]),
                         lt)
    with counted_measures() as second:
        again = VisionEngine({model: params}, backend="cuda", max_batch=8,
                             autotune="measure", tuning_cache=cache_path,
                             device="cuda")
        done2, _ = serve(again)
    def decisions(tree):
        return [(leaf.tune, getattr(leaf, "mat", leaf).tune)
                for _, leaf in _packed_leaves(tree)]

    same = all(decisions(again._tuned[k]) == decisions(trees[k])
               for k in trees)
    if second.n or not same or not all(
            np.array_equal(a.logits, b.logits) for a, b in zip(done2, base)):
        raise AssertionError(f"{model}: a second engine on the cache made "
                             f"{second.n} measurements (same decisions: "
                             f"{same})")
    profiles = {label: profile_bucket(torch, engines[label], imgs[:8],
                                      VisionRequest, model)
                for label in ("untuned", "tuned")}
    over = profiles["tuned"]["device_ms"] / profiles["untuned"]["device_ms"]
    if over > 1:
        print(json.dumps(dict(autotune_slower_than_untuned=model,
                              tuned_device_ms_over_untuned=over)),
              flush=True)
    print(json.dumps(dict(
        autotune_serving=model, backend="cuda", image=224, precision="<8:8>",
        requests=len(imgs), buckets=[8, 4], logits_equal=True,
        top1_equal=True,
        untuned_img_per_s=out["untuned"]["img_per_s"],
        tuned_img_per_s=out["tuned"]["img_per_s"],
        tune_warm_s=out["tuned"]["warm_s"],
        untuned_warm_s=out["untuned"]["warm_s"],
        measure_calls=first.n, second_engine_measure_calls=second.n,
        cache_entries=len(eng.tune_cache), picks=picks,
        untuned_launches=out["untuned"]["launches"], tuned_launches=lt,
        im2col_products_by_backend={label: out[label]["im2col"]
                                    for label in ("untuned", "tuned")},
        tuned_device_ms_over_untuned=over,
        tuned_device_ms_exceeds_untuned=over > 1,
        profile_bucket_of_8={
            label: {k: p[k] for k in ("wall_ms", "device_ms", "idle_share",
                                      "bitserial_kernels_ms",
                                      "launches_on_device")}
            for label, p in profiles.items()})), flush=True)
    for e in (*engines.values(), again):
        e.close()


def autotune_lm(torch, np, ops, cfg, params, cache_path, max_new=16):
    """``cfg`` (llama3.2-3b, <8:8> on "cuda", ``LLAMA_LAYERS``) through
    ``ServeEngine`` untuned and with ``autotune="measure"``: the eight
    prompts of ``serve_lm``, a warm run and a timed run each (launch
    counts set to 0 just before it, read just after), prefill and decode
    tok/s on the host's clock around admissions and dispatches. The tuned
    tokens must equal the untuned ones, and one 256-token prefill's logits
    must be ``torch.equal`` to the untuned ones (two untuned prefills are
    held equal first: the card's own spread)."""
    from repro_torch.models.lm import model as M
    from repro_torch.serving import Request, SamplerConfig, ServeEngine

    prompts = lm_prompts(np, cfg.vocab)
    probe = torch.from_numpy(prompts[0][:256]).cuda()[None]

    def prefill(eng):
        with torch.no_grad():
            st = M.init_state(cfg, 1, LM_MAX_LEN, device="cuda")
            return M.prefill(eng.params, cfg, probe, st)[0]

    def serve(eng):
        stats = dict(prefill_s=0.0, prefill_tokens=0, decode_s=0.0,
                     decode_tokens=0)
        admit, decode_n = eng._admit, eng._decode_n

        def timed_admit():
            before = sum(len(r.prompt) for r in eng.queue)
            t = time.perf_counter()
            admit()
            torch.cuda.synchronize()
            stats["prefill_s"] += time.perf_counter() - t
            stats["prefill_tokens"] += before - sum(len(r.prompt)
                                                    for r in eng.queue)

        def timed_decode(n):
            t = time.perf_counter()
            res = decode_n(n)
            stats["decode_s"] += time.perf_counter() - t
            return res

        eng._admit, eng._decode_n = timed_admit, timed_decode
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new))
        done = sorted(eng.run(strict=True), key=lambda c: c.rid)
        del eng._admit, eng._decode_n
        stats["decode_tokens"] = sum(len(c.tokens) - 1 for c in done)
        return [c.tokens for c in done], stats

    out = {}
    with counted_measures() as measures:
        for label, kw in (("untuned", {}),
                          ("tuned", dict(autotune="measure",
                                         tuning_cache=cache_path))):
            t = time.perf_counter()
            eng = ServeEngine(cfg, params, max_batch=LM_MAX_BATCH,
                              max_len=LM_MAX_LEN,
                              sampler=SamplerConfig(temperature=0.0),
                              device="cuda", **kw)
            torch.cuda.synchronize()
            deploy_s = time.perf_counter() - t
            serve(eng)                                   # warm
            ops.reset_launch_counts()
            tokens, stats = serve(eng)
            launches = ops.launch_counts()
            logits = prefill(eng)
            out[label] = dict(
                tokens=tokens, deploy_s=deploy_s, launches=launches,
                prefill_tok_per_s=stats["prefill_tokens"]
                / stats["prefill_s"],
                decode_tok_per_s=stats["decode_tokens"] / stats["decode_s"],
                logits=logits)
            if label == "untuned":
                spread = float((prefill(eng) - logits).abs().max())
                if spread:
                    print(json.dumps(dict(autotune_lm_untuned_spread=spread)),
                          flush=True)
            else:
                picks = _picks(eng.params)
                entries = len(eng.tune_cache)
            eng.close()
            del eng
            torch.cuda.empty_cache()
    base, tuned = out["untuned"], out["tuned"]
    diff = float((tuned["logits"] - base["logits"]).abs().max())
    if tuned["tokens"] != base["tokens"] or diff > spread:
        raise AssertionError(f"{cfg.name}: tuned tokens or prefill logits "
                             f"differ from untuned (max |diff| {diff}, the "
                             f"untuned spread {spread})")
    lt = tuned["launches"]
    check_picked_kernels(f"{cfg.name} tuned", _picked_backends(picks), lt)
    print(json.dumps(dict(
        autotune_serving=cfg.name, layers=cfg.n_layers, precision="<8:8>",
        backend="cuda", requests=len(prompts), max_batch=LM_MAX_BATCH,
        max_new=max_new, tokens_equal=True,
        prefill_logits_equal=diff == 0.0, prefill_logits_max_abs_diff=diff,
        untuned_spread=spread,
        untuned_prefill_tok_per_s=base["prefill_tok_per_s"],
        tuned_prefill_tok_per_s=tuned["prefill_tok_per_s"],
        untuned_decode_tok_per_s=base["decode_tok_per_s"],
        tuned_decode_tok_per_s=tuned["decode_tok_per_s"],
        untuned_deploy_s=base["deploy_s"], tuned_deploy_s=tuned["deploy_s"],
        measure_calls=measures.n, cache_entries=entries, picks=picks,
        untuned_launches=base["launches"],
        tuned_launches=lt)), flush=True)


def autotune_phase(torch, np, ops, imgs):
    """The autotuner on the card: the backend grid and the "cuda" rates'
    fit, then tuned vision serving (AlexNet, ResNet-50) and tuned LM
    serving (llama3.2-3b <8:8>), each against its untuned engine."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core import PIMQuantConfig
    from repro_torch.models.cnn import alexnet, resnet
    from repro_torch.models.lm import model as lm

    with phase("autotune backend grid"):
        clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
        rows = autotune_grid(torch, clock_hz)
        torch.cuda.empty_cache()
        fit_cuda_rates(rows, autotune_conv_grid(torch))
    with tempfile.TemporaryDirectory() as tmp:
        for model, module in (("alexnet", alexnet), ("resnet50", resnet)):
            with phase(f"autotune serve {model}"), no_plain_pack():
                autotune_vision(torch, np, ops, model, module, imgs,
                                f"{tmp}/{model}.json")
                torch.cuda.empty_cache()
        with phase("autotune serve llama3.2-3b <8:8>"), no_plain_pack():
            cfg = dataclasses.replace(
                get_config("llama3.2-3b").model, n_layers=LLAMA_LAYERS,
                dtype="float32", pim=PIMQuantConfig(8, 8, backend="cuda"))
            params = lm.init(cfg, torch.Generator(
                device="cuda").manual_seed(0), device="cuda")
            autotune_lm(torch, np, ops, cfg, params, f"{tmp}/llama.json")
            del params
            torch.cuda.empty_cache()


# -- 10. the fault model, the watchdog and snapshot / restore ----------------

# Phase 10's fault rates; "persistent only" drops the read disturb.
FAULT_KW = dict(write_ber=1e-4, retention_ber=1e-5, stuck0_rate=1e-5,
                stuck1_rate=1e-5, subarray_fail_rate=1e-3,
                read_disturb_ber=1e-6, protect_msb=2, vote_copies=3,
                checksum=True, spare_cols=8, seed=0)
FAULT_MAX_NEW = 8          # new tokens a request on phase 10's LM engines


def fault_configs():
    """(full, persistent only) FaultConfigs of phase 10."""
    from repro_torch.pim.faults import FaultConfig

    full = FaultConfig(**FAULT_KW)
    return full, FaultConfig(**dict(FAULT_KW, read_disturb_ber=0.0))


def raise_at(plan):
    """A fault injector raising at dispatch d as many times as ``plan[d]``
    says (a test hook of both engines)."""
    left = dict(plan)

    def inj(d):
        if left.get(d, 0) > 0:
            left[d] -= 1
            raise RuntimeError(f"injected fault at dispatch {d}")
    return inj


class recorded_packed:
    """While open, keeps the operands of kernel 4's calls (on the card, as
    given) in ``calls``; every call runs the kernel as before."""

    def __enter__(self):
        from repro_torch.kernels import bitserial_matmul as km

        self.module, self.kernel, self.calls = km, km.bitserial_matmul_packed, []

        def spy(pa, pw, a_bits, w_bits, **tiles):
            self.calls.append((pa.clone(), pw.clone(), a_bits, w_bits))
            return self.kernel(pa, pw, a_bits, w_bits, **tiles)

        km.bitserial_matmul_packed = spy
        return self

    def __exit__(self, *exc):
        self.module.bitserial_matmul_packed = self.kernel


def check_fault_tree(torch, tree, golden, label) -> dict:
    """A corrupted packed tree is self-consistent: every leaf's planes are
    the plain pack of its corrupted codes (a conv's ``fused_planes`` the
    plain fused pack too), its ``col_sums`` the golden tree's, and
    ``verify_columns`` flags exactly the columns whose code sums moved,
    each of them a column whose codes differ from golden. Columns whose
    codes differ with the sum kept (flips that cancel) escape the
    checksum; they are counted, not failed."""
    from repro_torch.core.packed import PackedConvWeight, PackedWeight
    from repro_torch.kernels.bitplane_pack import bitplane_pack_plain
    from repro_torch.pim.faults import verify_columns

    out = dict(leaves=0, columns=0, differing=0, flagged=0, escaped=0)

    def check(pw, gw, conv=None):
        codes, bits = pw.codes32, pw.bits
        if not torch.equal(pw.planes, bitplane_pack_plain(
                codes.T.contiguous(), bits)):
            raise AssertionError(f"{label}: planes != plain pack of codes")
        if conv is not None:
            kh, kw, c, o = conv.kernel_shape
            fused = bitplane_pack_plain(codes.reshape(kh, kw, c, o).permute(
                0, 3, 1, 2).contiguous(), bits).permute(1, 0, 2, 3, 4)
            if not torch.equal(conv.fused_planes, fused):
                raise AssertionError(f"{label}: fused planes != plain")
        if not torch.equal(pw.col_sums, gw.col_sums):
            raise AssertionError(f"{label}: col_sums left golden")
        flags = verify_columns(pw)
        moved = codes.to(torch.int64).sum(0) != gw.col_sums.to(torch.int64)
        differ = (codes != gw.codes32).any(0)
        if not torch.equal(flags, moved) or bool((flags & ~differ).any()):
            raise AssertionError(f"{label}: verify_columns flags the wrong "
                                 "columns")
        out["leaves"] += 1
        out["columns"] += int(flags.numel())
        out["differing"] += int(differ.sum())
        out["flagged"] += int(flags.sum())
        out["escaped"] += int((differ & ~flags).sum())

    def walk(p, g):
        if isinstance(p, PackedConvWeight):
            check(p.mat, g.mat, p)
        elif isinstance(p, PackedWeight):
            check(p, g)
        elif isinstance(p, dict):
            for k in p:
                walk(p[k], g[k])

    walk(tree, golden)
    return out


def faults_vision(torch, np, ops, kc, imgs):
    """ResNet-50 (224 px, <8:8>, "cuda") through ``VisionEngine``: a
    fault-free engine, one with phase 10's faults, a watchdog and an
    injector raising once at dispatch 1, one with the persistent half
    alone, and one whose injector raises until its cohort is degraded."""
    from repro_torch.models.cnn import resnet
    from repro_torch.serving import VisionEngine, VisionRequest
    from repro_torch.training.fault_tolerance import WatchdogConfig

    full, persistent = fault_configs()
    params = resnet.init(torch.Generator().manual_seed(0), num_classes=1000,
                         image=224)
    mkey = ("resnet50", "<8:8>")

    def engine(**kw):
        return VisionEngine({"resnet50": params}, backend="cuda",
                            max_batch=8, **kw)

    def serve(eng, n):
        for rid in range(n):
            eng.submit(VisionRequest(rid=rid, image=imgs[rid],
                                     model="resnet50"))
        t = time.perf_counter()
        done = eng.run(strict=True)
        torch.cuda.synchronize()
        return sorted(done, key=lambda c: c.rid), time.perf_counter() - t

    def deploy_ms(eng):
        t = time.perf_counter()
        eng._packed_params(*mkey)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    def bucket_launches(eng):
        ops.reset_launch_counts()
        serve(eng, 8)
        return ops.launch_counts()

    def finite(done, label):
        if not all(np.isfinite(c.logits).all() and c.logits.shape == (1000,)
                   for c in done):
            raise AssertionError(f"{label}: non-finite or misshapen logits")

    rows = {}
    with phase("faults resnet50 fault-free"), no_plain_pack():
        deploy_ms(engine())                  # first use's costs, unmeasured
        eng = engine()
        prepack_ms = deploy_ms(eng)
        serve(eng, 12)
        _, dt = serve(eng, 12)
        clean_bucket = bucket_launches(eng)
        prof = profile_call(torch, lambda: serve(eng, 8))
        rows["fault-free"] = dict(img_per_s=12 / dt, prepack_ms=prepack_ms,
                                  bucket_of_8_device_ms=prof["device_ms"],
                                  bucket_of_8_wall_ms=prof["wall_ms"],
                                  idle_share=prof["idle_share"],
                                  launches_per_bucket_of_8=clean_bucket)
        del eng
    with phase("faults resnet50 faults + watchdog"):
        eng = engine(faults=full, fault_injector=raise_at({1: 1}),
                     watchdog=WatchdogConfig(max_failures=3, backoff_s=0.0))
        with no_plain_pack():
            with prepack_packs() as packs:
                inject_ms = deploy_ms(eng)
            packed = packs.check("resnet50 faults prepack + inject")
            serve(eng, 12)                       # the injector fires here
            ops.reset_launch_counts()
            done, dt = serve(eng, 12)
            launches = ops.launch_counts()
            finite(done, "resnet50 faults")
            missing = [k for k in PATH_KERNELS["cuda"] if not launches[k]]
            if missing:
                raise AssertionError(f"resnet50 faults: {missing} never "
                                     f"launched: {launches}")
            with recorded_convs() as convs, recorded_matmuls() as mms:
                serve(eng, 8)                    # one disturbed dispatch
            fault_bucket = bucket_launches(eng)
            prof = profile_call(torch, lambda: serve(eng, 8))
        h = eng.health
        if h["rollbacks"] < 1 or h["repairs"] < 1 or h["repaired_cols"] < 1:
            raise AssertionError(f"resnet50 faults: health {h}")
        tree = check_fault_tree(torch, eng._packed[mkey], eng._golden[mkey],
                                "resnet50")
        rows["faults"] = dict(img_per_s=12 / dt,
                              prepack_inject_ms=inject_ms,
                              bucket_of_8_device_ms=prof["device_ms"],
                              bucket_of_8_wall_ms=prof["wall_ms"],
                              idle_share=prof["idle_share"],
                              launches=launches,
                              launches_per_bucket_of_8=fault_bucket,
                              health=h, tree=tree, **packed)
        del eng
    with phase("faults resnet50 disturbed operands"):
        n8 = [c for c in served_conv_calls("resnet50") if c[0] == 8]
        got = sorted((geo["n"], geo["hp"], geo["c"], pw.shape[2],
                      pw.shape[0], geo["stride"], geo["oh"])
                     for _, pw, geo in convs.calls.values())
        if got != n8:
            raise AssertionError(f"resnet50 faults: kernel 3 ran at {got}, "
                                 f"the bucket of 8 serves {n8}")
        for pa, pw, geo in convs.calls.values():
            kc.served_conv("resnet50 disturbed", pa, pw, geo)
        for qa, pw, a_bits in mms.calls.values():
            kc.served_matmul("resnet50 disturbed", qa.cuda(), pw.cuda(),
                             a_bits)
        rows["disturbed_dispatch"] = dict(kernel3_calls=len(convs.calls),
                                          kernel2_calls=len(mms.calls))
        del convs, mms
    with phase("faults resnet50 persistent only"), no_plain_pack():
        eng = engine(faults=persistent)
        serve(eng, 8)
        bucket = bucket_launches(eng)
        if bucket != clean_bucket:
            raise AssertionError("resnet50 persistent faults: a bucket "
                                 f"launched {bucket}, fault-free "
                                 f"{clean_bucket}")
        rows["persistent_only"] = dict(launches_per_bucket_of_8=bucket)
        del eng
    with phase("faults resnet50 degraded cohort"), no_plain_pack():
        box = {}

        def until_degraded(d):
            if mkey not in box["eng"].health["degraded"]:
                raise RuntimeError("sustained fault")

        eng = box["eng"] = engine(faults=full, fault_injector=until_degraded,
                                  watchdog=WatchdogConfig(max_failures=1,
                                                          backoff_s=0.0))
        done, _ = serve(eng, 8)
        finite(done, "resnet50 degraded")
        ops.reset_launch_counts()
        done, _ = serve(eng, 8)
        finite(done, "resnet50 degraded")
        launches = ops.launch_counts()
        stray = [k for k in BITSERIAL_KERNELS if launches[k]]
        if eng.health["degraded"] != [mkey] or stray:
            raise AssertionError(f"resnet50 degraded: health {eng.health}, "
                                 f"bit-serial launches {launches}")
        rows["degraded"] = dict(health=eng.health, launches=launches)
        del eng
    print(json.dumps(dict(faults_serving="resnet50", precision="<8:8>",
                          backend="cuda", fault_config=FAULT_KW, **rows)),
          flush=True)
    return rows


def faults_lm(torch, np, ops):
    """llama3.2-3b (``LLAMA_LAYERS``, full width, <8:8> "cuda") through
    ``ServeEngine``: the eight requests on 4 slots, greedy, fault-free,
    with the persistent half alone, with phase 10's faults and a watchdog
    (without and with an injector raising once at dispatch 1), a snapshot
    restored into an engine of another seed at temperature 0.7, and
    sustained failures degrading the engine to the float path."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core import PIMQuantConfig
    from repro_torch.models.lm import model as lm
    from repro_torch.serving import Request, SamplerConfig, ServeEngine
    from repro_torch.training.fault_tolerance import WatchdogConfig

    full, persistent = fault_configs()
    cfg = dataclasses.replace(get_config("llama3.2-3b").model,
                              n_layers=LLAMA_LAYERS, dtype="float32",
                              pim=PIMQuantConfig(8, 8, backend="cuda"))
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    prompts = lm_prompts(np, cfg.vocab)

    def engine(temperature=0.0, **kw):
        t = time.perf_counter()
        eng = ServeEngine(cfg, params, max_batch=LM_MAX_BATCH,
                          max_len=LM_MAX_LEN,
                          sampler=SamplerConfig(temperature=temperature),
                          device="cuda", **kw)
        torch.cuda.synchronize()
        eng.deploy_ms = (time.perf_counter() - t) * 1e3
        return eng

    def submit(eng):
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p,
                               max_new_tokens=FAULT_MAX_NEW))

    def serve(eng, dispatches=None, stats=None):
        """Run the eight requests. Each decode dispatch is timed on the
        host (it ends in the host read); with ``dispatches``, the first
        dispatch of each step count keeps its launches; with ``stats``,
        generated tok/s (prefill included) and decode tok/s."""
        real = eng._decode_n
        dec = {"s": 0.0, "steps": 0}

        def counted(n):
            before = ops.launch_counts()
            t = time.perf_counter()
            out = real(n)
            dec["s"] += time.perf_counter() - t
            dec["steps"] += n
            after = ops.launch_counts()
            if dispatches is not None:
                dispatches.setdefault(n, {k: after[k] - before[k]
                                          for k in after})
            return out

        eng._decode_n = counted
        submit(eng)
        t = time.perf_counter()
        done = eng.run(strict=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        del eng._decode_n
        toks = {c.rid: c.tokens for c in done}
        if sorted(len(v) for v in toks.values()) != [FAULT_MAX_NEW] * 8:
            raise AssertionError(f"llama faults: wrong completions {toks}")
        if stats is not None:
            n_tok = sum(len(v) for v in toks.values())
            stats.update(tok_per_s=n_tok / wall,
                         decode_tok_per_s=(n_tok - len(toks)) / dec["s"],
                         decode_step_ms=dec["s"] * 1e3 / dec["steps"],
                         deploy_ms=eng.deploy_ms)
        return toks

    rows = {"fault_free": {}, "persistent_only": {}, "faults": {}}
    with phase("faults llama3.2-3b fault-free and persistent"), \
            no_plain_pack():
        clean, persist = {}, {}
        eng = engine()
        serve(eng)                           # first use's costs, unmeasured
        serve(eng, clean, rows["fault_free"])
        eng.close()
        eng = engine(faults=persistent)
        serve(eng, persist, rows["persistent_only"])
        eng.close()
        if persist != clean:
            raise AssertionError("llama persistent faults: decode "
                                 f"dispatches launched {persist}, fault-free "
                                 f"{clean}")
        rows["decode_dispatch_launches"] = clean
    with phase("faults llama3.2-3b transient + watchdog"), no_plain_pack():
        wd = WatchdogConfig(max_failures=3, backoff_s=0.0)
        eng = engine(faults=full, watchdog=wd)
        transient = {}
        want = serve(eng, transient, rows["faults"])
        rows["faults"]["decode_dispatch_launches"] = transient
        eng.close()
        eng = engine(faults=full, watchdog=wd,
                     fault_injector=raise_at({1: 1}))
        got = serve(eng)
        if got != want or eng.health["rollbacks"] < 1:
            raise AssertionError(f"llama rollback: tokens {got} vs {want}, "
                                 f"health {eng.health}")
        rows["rollback_health"] = dict(eng.health)
        eng.close()
    with phase("faults llama3.2-3b snapshot / restore"), no_plain_pack():
        tmp = tempfile.mkdtemp()
        try:
            eng = engine(temperature=0.7, faults=full, seed=0)
            submit(eng)
            for _ in range(3):
                eng.step()
            eng.snapshot(tmp, step=3)
            want = {c.rid: c.tokens for c in eng.run(strict=True)}
            eng.close()
            eng = engine(temperature=0.7, faults=full, seed=1)
            manifest = eng.restore(tmp)
            got = {c.rid: c.tokens for c in eng.run(strict=True)}
            eng.close()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if got != want or not want:
            raise AssertionError(f"llama snapshot / restore: {got} vs {want}")
        rows["snapshot"] = dict(completions=len(got),
                                extra_keys=sorted(manifest["extra"]))
    with phase("faults llama3.2-3b degrade to float"), no_plain_pack():
        eng = engine(faults=full, fault_injector=raise_at({0: 3}),
                     watchdog=WatchdogConfig(max_failures=2, backoff_s=0.0))
        serve(eng)
        ops.reset_launch_counts()
        serve(eng)
        launches = ops.launch_counts()
        if not eng.health["degraded"] or eng.cfg.pim.enabled or \
                launches["bitserial_matmul_fused"]:
            raise AssertionError(f"llama degrade: health {eng.health}, pim "
                                 f"{eng.cfg.pim}, launches {launches}")
        rows["degraded"] = dict(health=dict(eng.health), launches=launches)
        eng.close()
    print(json.dumps(dict(faults_serving="llama3.2-3b", layers=cfg.n_layers,
                          precision="<8:8>", backend="cuda",
                          requests=len(prompts), max_new=FAULT_MAX_NEW,
                          fault_config=FAULT_KW, **rows)), flush=True)
    del params
    torch.cuda.empty_cache()
    return rows


def faults_kernels(torch, kc):
    """Kernel 2's batched entry on one disturbed phi3.5-moe bank (E = 16,
    M = 8, 4096 x 6400) and kernel 4 at AlexNet conv2's im2col shape on
    corrupted and disturbed planes, each held against its plain version;
    the disturbed planes are the plain pack of the codes XOR the site's
    field, and kernel 4's P equals int-direct's on that state."""
    from repro_torch.core import bitserial, packed
    from repro_torch.kernels.bitplane_pack import bitplane_pack_plain
    from repro_torch.pim import faults as F

    full, persistent = fault_configs()
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    with phase("faults kernel 2 batched, disturbed bank"):
        with no_plain_pack():
            bank = packed.prepack(torch.randn((16, 4096, 6400), generator=gen,
                                              device="cuda"), 8)
        qa = torch.randint(0, 256, (16, 8, 4096), generator=gen,
                           device="cuda", dtype=torch.int32)
        with recorded_matmuls() as rec, no_plain_pack(), \
                F.read_disturb_scope(full, F.Key.root(0).fold_in(23)):
            p = bitserial.int_matmul_prepacked_bank(qa, bank, 8, "cuda")
            field = F._READ_FIELDS[0]["field"]
        (qa_h, pw_h, a_bits), = rec.bank_calls.values()
        pw_d = pw_h.cuda()
        for e in (0, 15):
            want = bitplane_pack_plain(
                (bank.codes[e] ^ field).to(torch.int32).T.contiguous(), 8)
            if not torch.equal(pw_d[e], want):
                raise AssertionError(f"disturbed bank expert {e}: planes != "
                                     "plain pack of codes ^ field")
        kc.served_bank("phi3.5-moe disturbed", qa, pw_d, a_bits)
        out["bank_flipped_bits"] = int(sum(
            ((field >> b) & 1).sum().item() for b in range(8)))
        del bank, qa, pw_d, p, field, rec
        torch.cuda.empty_cache()
    with phase("faults kernel 4, corrupted and disturbed planes"):
        m, k, n = 8 * 27 * 27, 2400, 256          # AlexNet conv2's im2col
        with no_plain_pack():
            clean = packed.prepack(torch.randn((k, n), generator=gen,
                                               device="cuda"), 8)
            bad = F.inject_packed(clean, persistent, F.Key.root(0).fold_in(5))
        if not torch.equal(bad.planes, bitplane_pack_plain(
                bad.codes32.T.contiguous(), 8)):
            raise AssertionError("corrupted planes != plain pack of codes")
        qa = torch.randint(0, 256, (m, k), generator=gen, device="cuda",
                           dtype=torch.int32)
        with recorded_packed() as rec, no_plain_pack(), \
                F.read_disturb_scope(full, F.Key.root(0).fold_in(6)):
            p4 = bitserial.int_matmul_prepacked(qa, bad, 8, "popcount")
            field = F._READ_FIELDS[0]["field"]
        (pa, pw, a_bits, w_bits), = rec.calls
        kc.served_packed("alexnet conv2 corrupted+disturbed", pa, pw,
                         a_bits, w_bits)
        direct = bitserial.int_matmul_direct(qa, bad.codes ^ field)
        if not torch.equal(p4, direct):
            raise AssertionError("kernel 4 on disturbed planes != int-direct "
                                 "on the disturbed codes")
        out["kernel4_corrupted_codes"] = int(
            (bad.codes != clean.codes).sum().item())
        out["kernel4_disturbed_bits"] = int(sum(
            ((field >> b) & 1).sum().item() for b in range(8)))
    print(json.dumps(dict(faults_kernels=out)), flush=True)
    return out


def fault_phase(torch, np, ops, kc, imgs):
    """Phase 10: the fault model, the watchdog and snapshot / restore on
    both engines, and kernels 2 (batched) and 4 on faulty planes."""
    t = time.perf_counter()
    vision = faults_vision(torch, np, ops, kc, imgs)
    torch.cuda.empty_cache()
    lmrows = faults_lm(torch, np, ops)
    kernels = faults_kernels(torch, kc)
    print(json.dumps(dict(fault_phase_s=time.perf_counter() - t)),
          flush=True)
    return vision, lmrows, kernels


# Phase 11: training (examples/train_lm.py's settings) at llama3.2-3b's
# published width and depth.
TRAIN_ARCH = "llama3.2-3b"
TRAIN_STEPS = 12            # a run; losses printed, the first two warm
TRAIN_WARM = 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 16, 256, 6e-4
TRAIN_VS_CPU_SHAPE = dict(batch=2, seq=64)     # one full-width layer


def train_card(torch, np, ops, pim: bool) -> dict:
    """Phase 11a: ``TRAIN_STEPS`` steps of llama3.2-3b (full width,
    all 28 layers, bf16 params with float32 masters,
    ``remat="block"``) built by the launcher's ``build`` and stepped by
    its ``make_train_step``, in bf16 or (``pim``) with <8:8> QAT; one more
    step profiled on the card.
    Fails unless every loss is finite, the last is below the first and no
    bit-serial kernel launched during the steps."""
    from repro_torch.launch import train as tlaunch

    label = "<8:8> qat" if pim else "bf16"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, opt_state, step, source, put = tlaunch.build(
        TRAIN_ARCH, False, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR, 1,
        False, pim=pim, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, norms, lrs, secs = [], [], [], []
    ops.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        batch = put(source.batch(i))
        t = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))          # the step's host read
        secs.append(time.perf_counter() - t)
        norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
    launches = ops.launch_counts()
    batch = put(source.batch(TRAIN_STEPS))
    prof = profile_call(torch, lambda: step(params, opt_state, batch))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in tlaunch.leaves(params))
    steady = secs[TRAIN_WARM:]
    row = dict(
        training=TRAIN_ARCH, path=label, layers=cfg.n_layers,
        d_model=cfg.d_model, vocab=cfg.vocab, params=n_params,
        dtype=cfg.dtype, masters="float32", remat=cfg.remat,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS, lr=TRAIN_LR,
        setup_s=setup_s, step_ms=float(np.median(steady)) * 1e3,
        step_ms_each=[x * 1e3 for x in secs],
        tok_per_s=TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / sum(secs),
        tok_per_s_steady=TRAIN_BATCH * TRAIN_SEQ / float(np.median(steady)),
        peak_memory_gb=peak_gb, idle_share=prof["idle_share"],
        profiled_step=dict(wall_ms=prof["wall_ms"],
                           device_ms=prof["device_ms"],
                           launches_on_device=prof["launches_on_device"],
                           top=prof["top"]),
        losses=losses, grad_norms=norms, lrs=lrs,
        bitserial_launches=launches)
    print(json.dumps(row), flush=True)
    del params, opt_state, step, batch
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training {label}: a loss is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training {label}: the loss did not fall "
                             f"({losses[0]} -> {losses[-1]})")
    if any(launches.values()):
        raise AssertionError(f"training {label} launched bit-serial "
                             f"kernels: {launches}")
    return row


def _clone_to(torch, tree, device):
    from repro_torch.models.lm import model as lm

    return lm._map(lambda x: x.to(device, copy=True), tree)


def train_gpu_vs_cpu(torch, np, ops) -> dict:
    """Phase 11b: one ``make_train_step`` step of one full-width
    llama3.2-3b layer in float32 (TF32 off), batch 2 x seq 64, on the card
    and on the CPU from the same params: the loss within rtol 1e-4, every
    gradient leaf within 1e-3 relative L2, the grad norm within 1e-3.
    With <8:8> QAT: every fake-quantized weight (the layer's projections
    and the tied head) equal bit for bit, the training loss (no step)
    within 1e-3."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import PIMQuantConfig
    from repro_torch.core.quantize import fake_quant
    from repro_torch.models.lm import model as lm
    from repro_torch.training import (DataConfig, OptimizerConfig,
                                      SyntheticLM, init_opt_state,
                                      make_train_step)
    from repro_torch.training.optimizer import leaves

    cfg = dataclasses.replace(get_config(TRAIN_ARCH).model, n_layers=1,
                              dtype="float32")
    base = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                   device="cuda")
    batch = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_VS_CPU_SHAPE["seq"],
        global_batch=TRAIN_VS_CPU_SHAPE["batch"])).batch(0)
    # float32 params: no float32 masters (the reference's keep_master
    # False), so the CPU holds one copy of the layer fewer.
    ocfg = OptimizerConfig(lr=TRAIN_LR, warmup_steps=2,
                           total_steps=TRAIN_STEPS, keep_master=False)

    cpu_base = _clone_to(torch, base, "cpu")

    def one_step(c, params):
        kept = {}

        def keep(grads):
            kept["grads"] = grads
            return grads

        ops.reset_launch_counts()
        _, _, m = make_train_step(c, ocfg, compress_grads=keep)(
            params, init_opt_state(ocfg, params), batch)
        if any(ops.launch_counts().values()):
            raise AssertionError(f"a training step launched bit-serial "
                                 f"kernels: {ops.launch_counts()}")
        return float(m["loss"]), float(m["grad_norm"]), kept["grads"]

    def qat_loss(params, device):
        with torch.no_grad():
            return float(lm.loss_fn(params, qcfg, {
                k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                train=True))

    def rel(a, b):   # on the card
        a, b = a.to("cuda"), b.to("cuda")
        return float((a - b).norm() / (b.norm() + 1e-30))

    # QAT first: the float step below updates its params in place.
    t = time.perf_counter()
    parts = {}
    qcfg = dataclasses.replace(cfg, pim=PIMQuantConfig(8, 8,
                                                       backend="int-direct"))

    def weights(tree):
        return [("embed.T", tree["embed"].T)] + [
            (f"scan/0/{blk}/{k}", leaf[0])
            for blk in ("attn", "ffn")
            for k, leaf in tree["scan"][0][blk].items() if leaf.dim() == 3]

    pairs = list(zip(weights(base), weights(cpu_base)))
    unequal = [name for (name, w), (_, wc) in pairs
               if not torch.equal(fake_quant(w, 8),
                                  fake_quant(wc, 8).to("cuda"))]
    parts["fake_quant_s"] = time.perf_counter() - t
    lqg, lqc = qat_loss(base, "cuda"), qat_loss(cpu_base, "cpu")
    parts["qat_loss_s"] = time.perf_counter() - t - parts["fake_quant_s"]
    t1 = time.perf_counter()
    lg, ng, gg = one_step(cfg, base)
    parts["step_gpu_s"] = time.perf_counter() - t1
    lc, nc, gc = one_step(cfg, cpu_base)
    parts["step_cpu_s"] = time.perf_counter() - t1 - parts["step_gpu_s"]
    grad_rel = max(rel(a, b) for a, b in zip(leaves(gg), leaves(gc)))
    del gg, gc, cpu_base
    row = dict(train_gpu_vs_cpu=TRAIN_ARCH, layers=1, d_model=cfg.d_model,
               vocab=cfg.vocab, dtype="float32", **TRAIN_VS_CPU_SHAPE,
               loss_gpu=lg, loss_cpu=lc, loss_rel=abs(lg - lc) / abs(lc),
               grad_max_rel_l2=grad_rel, grad_norm_gpu=ng, grad_norm_cpu=nc,
               grad_norm_rel=abs(ng - nc) / abs(nc),
               qat_weights_compared=len(pairs),
               qat_weights_unequal=unequal, qat_loss_gpu=lqg,
               qat_loss_cpu=lqc, qat_loss_rel=abs(lqg - lqc) / abs(lqc),
               seconds=time.perf_counter() - t, parts=parts)
    ok = (row["loss_rel"] <= 1e-4 and grad_rel <= 1e-3
          and row["grad_norm_rel"] <= 1e-3 and not unequal
          and row["qat_loss_rel"] <= 1e-3)
    row["passed"] = ok
    print(json.dumps(row), flush=True)
    del base
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"train_gpu_vs_cpu failed: {row}")
    return row


def train_launcher_on_card(np) -> dict:
    """Phase 11c: the launcher's entry point with the argv of ``python -m
    repro_torch.launch.train --arch llama3.2-3b --reduced --steps 20``
    (every step logged, a checkpoint directory of its own) on the card;
    its loss must fall. It runs in this process (a process of its own
    would spend ~8 s reaching the card)."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.launch import train as tlaunch

    ckpt = tempfile.mkdtemp(prefix="train_launcher_")
    argv = ["--arch", TRAIN_ARCH, "--reduced", "--steps", "20",
            "--log-every", "1", "--ckpt-dir", ckpt]
    out = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            history = tlaunch.main(argv)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = [loss for _, loss in history]
    tail = [line for line in out.getvalue().splitlines()
            if line.startswith(("arch=", "done:", "loss:"))]
    row = dict(train_launcher=" ".join(argv[:-2]), losses=losses, tail=tail,
               seconds=time.perf_counter() - t)
    print(json.dumps(row), flush=True)
    if not (len(losses) == 20 and np.all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"the launcher's loss did not fall: {losses}")
    return row


def train_phase(torch, np, ops):
    """Phase 11: training. Each part is a phase of its own."""
    rows = []
    for pim in (False, True):
        with phase(f"train {TRAIN_ARCH} {'<8:8> qat' if pim else 'bf16'}"):
            rows.append(train_card(torch, np, ops, pim))
    with phase(f"train gpu vs cpu {TRAIN_ARCH}"):
        rows.append(train_gpu_vs_cpu(torch, np, ops))
    with phase("train launcher"):
        rows.append(train_launcher_on_card(np))
    return rows


def main(argv) -> int:
    kernel_rows = "--kernel-rows" in argv
    autotune_only = "--autotune" in argv
    faults_only = "--faults" in argv
    train_only = "--train" in argv
    unknown = [a for a in argv if a not in ("--kernel-rows", "--autotune",
                                            "--faults", "--train")]
    if unknown:
        print(f"chip_smoke.py: unknown arguments {unknown}", file=sys.stderr)
        return 2
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
            log = _build.log_path(name)
            if log.exists():
                print(f"--- nvcc {name} ---\n{log.read_text().strip()}",
                      flush=True)
        for name in ("bitserial_matmul", "conv2d_fused"):
            if not kernel_rows:
                check_imma_build(_build, name)
    imgs = np.random.default_rng(0).standard_normal(
        (12, 224, 224, 3)).astype(np.float32)
    if autotune_only:
        autotune_phase(torch, np, ops, imgs)
        return 0
    if train_only:
        train_phase(torch, np, ops)
        return 0

    # -- 3. kernels against their plain versions -----------------------------
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(f"bounds: memory {HBM_BYTES_PER_S:.3g} B/s, int8 "
          f"{INT8_OPS_PER_S:.4g} op/s; {props.multi_processor_count} SMs at "
          f"{clock_mhz:.0f} MHz", flush=True)
    kc = KernelChecks(torch, clock_mhz * 1e6)
    if faults_only:
        fault_phase(torch, np, ops, kc, imgs)
        return 0
    if kernel_rows:
        with phase("kernels 1 and 5, timed rows"):
            for row in PACK_ROWS:
                kc.pack(*row)
            for row in WKV_ROWS:
                kc.wkv(*row)
        return 0
    with phase("kernels"):
        # Kernel 1: the served input maps at 224 px, bucket of 8, <8:8>;
        # ragged rows at 1-16 bits.
        for row in PACK_ROWS:
            kc.pack(*row)
        for row in PACK_EDGES:
            kc.pack(*row, timing=False)
        prepack_layouts(torch)
        # Kernel 3: the served convs, the ragged rows, the wrap.
        for row in CONV_ROWS:
            kc.conv(*row, 8, 8)
        for bits in (2, 4, 8):
            for row in RAGGED_CONV_ROWS:
                kc.conv(*row, bits, bits, timing=False)
        kc.conv_wrap(*CONV_WRAP_ROW)
        backends_agree(torch, 8 * 55 * 55, 363, 96, 8)   # AlexNet conv1
        # rwkv6-3b: kernel 5 at the prefills' shapes (40 heads of 64), on
        # the batch-1 layout's strided views, and the reference test's
        # sweep.
        for row in WKV_ROWS:
            kc.wkv(*row)
        kc.wkv(40, 256, 64, 16, timing=False, strided=True)
        kc.wkv(8, 48, 32, 16, timing=False, strided=True)
        for row in WKV_EDGES:
            kc.wkv(*row, timing=False)
        # Kernels 2 and 4: the served shapes, the plan's edges, the wrap.
        for m, k, n, wb, ab, timing in FUSED_ROWS:
            kc.matmul(m, k, n, wb, ab, timing=timing)
        for m, k, n, wb, ab, timing in PACKED_ROWS:
            kc.packed(m, k, n, wb, ab, timing=timing)
        kc.wrap(*WRAP_ROW)
        # Kernel 2's batched entry: the expert banks, ragged rows, the wrap.
        for e, m, k, n, wb, ab, timing in BATCHED_ROWS:
            kc.batched(e, m, k, n, wb, ab, timing=timing)
        kc.batched_wrap(*BATCHED_WRAP_ROW)
        torch.cuda.empty_cache()

    # -- 4. serving ResNet-50 -------------------------------------------------
    with phase("serve resnet50 cuda"), no_plain_pack():
        params = resnet.init(torch.Generator().manual_seed(0),
                             num_classes=1000, image=224)
        eng = VisionEngine({"resnet50": params}, backend="cuda", max_batch=8)
        done, launches, convs = serve_path(torch, np, ops, eng, "resnet50",
                                           "cuda", imgs, VisionRequest)
    with phase("serve resnet50 float"), no_plain_pack():
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
    with phase("kernel 3 at resnet50's served convs"):
        check_served_convs(kc, "resnet50", convs)
    del convs

    # -- 5. serving AlexNet and VGG19 -----------------------------------------
    paths = {}
    for model, module, backend in (("alexnet", alexnet, "cuda"),
                                   ("alexnet", alexnet, "popcount"),
                                   ("vgg19", vgg, "cuda")):
        with phase(f"serve {model} {backend}"), no_plain_pack():
            params = module.init(torch.Generator().manual_seed(0),
                                 num_classes=1000, image=224)
            eng = VisionEngine({model: params}, backend=backend, max_batch=8)
            _, paths[(model, backend)], convs = serve_path(
                torch, np, ops, eng, model, backend, imgs, VisionRequest)
            del eng, params
        if backend == "cuda":
            with phase(f"kernel 3 at {model}'s served convs"):
                check_served_convs(kc, model, convs)
        del convs
        torch.cuda.empty_cache()

    # -- 6. end to end against the CPU's plain versions ----------------------
    for module, model, backend, image in (
            (resnet, "resnet50", "cuda", 32), (alexnet, "alexnet", "cuda", 64),
            (alexnet, "alexnet", "popcount", 64), (vgg, "vgg19", "cuda", 32)):
        with phase(f"gpu vs cpu {model} {backend}"):
            gpu_vs_cpu(torch, np, module, model, backend, image)

    # -- 7. serving rwkv6-3b --------------------------------------------------
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import PIMQuantConfig
    from repro_torch.models.lm import model as lm

    arch = dataclasses.replace(get_config("rwkv6-3b").model,
                               n_layers=RWKV_LAYERS)
    with phase("serve rwkv6-3b bf16"), no_plain_pack():
        params = lm.cast_params(
            lm.init(arch, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda"), torch.bfloat16)
        lm_launches, _ = serve_lm(torch, np, ops, arch, params, "bf16",
                                  max_new=32)
        del params
        torch.cuda.empty_cache()
    with phase("serve rwkv6-3b <8:8> cuda"), no_plain_pack():
        cfg = dataclasses.replace(arch, dtype="float32",
                                  pim=PIMQuantConfig(8, 8, backend="cuda"))
        params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
        _, calls = serve_lm(torch, np, ops, cfg, params, "<8:8> cuda",
                            max_new=16)
        del params
        torch.cuda.empty_cache()
    with phase("kernel 2 at rwkv6-3b's served matmuls"):
        check_served_matmuls(np, kc, "rwkv6-3b", calls)
    del calls

    # -- 7b. serving llama3.2-3b (dense GQA, tied embeddings) -----------------
    arch = dataclasses.replace(get_config("llama3.2-3b").model,
                               n_layers=LLAMA_LAYERS)
    with phase("serve llama3.2-3b bf16"), no_plain_pack():
        params = lm.cast_params(
            lm.init(arch, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda"), torch.bfloat16)
        serve_lm(torch, np, ops, arch, params, "bf16", max_new=32)
        lm_part_costs(torch, arch, params, "bf16", kc.clock_hz)
        del params
        torch.cuda.empty_cache()
    with phase("serve llama3.2-3b <8:8> cuda"), no_plain_pack():
        cfg = dataclasses.replace(arch, dtype="float32",
                                  pim=PIMQuantConfig(8, 8, backend="cuda"))
        params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
        _, calls = serve_lm(torch, np, ops, cfg, params, "<8:8> cuda",
                            max_new=16)
        lm_part_costs(torch, cfg, params, "<8:8> cuda", kc.clock_hz)
        del params
        torch.cuda.empty_cache()
    with phase("kernel 2 at llama3.2-3b's served matmuls"):
        check_served_matmuls(np, kc, "llama3.2-3b", calls)
    del calls

    # -- 7c. serving recurrentgemma-9b (RG-LRU + local attention) -------------
    arch = dataclasses.replace(get_config("recurrentgemma-9b").model,
                               n_layers=RG_LAYERS)
    with phase("serve recurrentgemma-9b bf16"), no_plain_pack():
        params = lm.init(arch, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
        cast_in_place(torch, params, torch.bfloat16)
        serve_lm(torch, np, ops, arch, params, "bf16", max_new=32)
        lm_part_costs(torch, arch, params, "bf16", kc.clock_hz)
        del params
        torch.cuda.empty_cache()
    with phase("serve recurrentgemma-9b <8:8> cuda"), no_plain_pack():
        cfg = dataclasses.replace(arch, dtype="float32",
                                  pim=PIMQuantConfig(8, 8, backend="cuda"))
        params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
        _, calls = serve_lm(torch, np, ops, cfg, params, "<8:8> cuda",
                            max_new=16)
        lm_part_costs(torch, cfg, params, "<8:8> cuda", kc.clock_hz)
        del params
        torch.cuda.empty_cache()
    with phase("kernel 2 at recurrentgemma-9b's served matmuls"):
        check_served_matmuls(np, kc, "recurrentgemma-9b", calls)
    del calls

    # -- 7d. serving phi3.5-moe (16 experts, top-2) at 4 of its 32 layers -----
    arch = dataclasses.replace(get_config(PHI).model, n_layers=PHI_LAYERS)
    with phase("serve phi3.5-moe bf16"), no_plain_pack():
        params = lm.init(arch, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
        cast_in_place(torch, params, torch.bfloat16)
        serve_lm(torch, np, ops, arch, params, "bf16", max_new=32)
        lm_part_costs(torch, arch, params, "bf16", kc.clock_hz)
        del params
        torch.cuda.empty_cache()
    with phase("serve phi3.5-moe <8:8> cuda"), no_plain_pack():
        cfg = dataclasses.replace(arch, dtype="float32",
                                  pim=PIMQuantConfig(8, 8, backend="cuda"))
        params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
        moe_launches, calls = serve_lm(torch, np, ops, cfg, params,
                                       "<8:8> cuda", max_new=16)
        lm_part_costs(torch, cfg, params, "<8:8> cuda", kc.clock_hz)
        del params
        torch.cuda.empty_cache()
    with phase("kernel 2 at phi3.5-moe's served matmuls"):
        check_served_matmuls(np, kc, PHI, calls)
    del calls

    # -- 7e. the stub frontends: musicgen-large (12 layers) and one unit of
    # llama-3.2-vision-90b (4 attn + 1 cross_attn) at full width ---------------
    for name, bf16_steps in ((MUSICGEN, 32), (VISION, 16)):
        arch = dataclasses.replace(get_config(name).model,
                                   n_layers=STUB_PATHS[name]["layers"])
        with phase(f"serve {name} bf16"), no_plain_pack():
            params = set_cross_gates(torch, lm.init(
                arch, torch.Generator(device="cuda").manual_seed(0),
                device="cuda"))
            cast_in_place(torch, params, torch.bfloat16)
            deployed, _ = serve_stub(torch, np, ops, arch, params, "bf16",
                                     bf16_steps)
            if arch.cross_attn_every:
                cross_layer_costs(torch, arch, deployed, "bf16", kc.clock_hz)
            del params, deployed
            torch.cuda.empty_cache()
        with phase(f"serve {name} <8:8> cuda"), no_plain_pack():
            cfg = dataclasses.replace(arch, dtype="float32",
                                      pim=PIMQuantConfig(8, 8, backend="cuda"))
            params = set_cross_gates(torch, lm.init(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                device="cuda"))
            deployed, calls = serve_stub(torch, np, ops, cfg, params,
                                         "<8:8> cuda", 16)
            if cfg.cross_attn_every:
                cross_layer_costs(torch, cfg, deployed, "<8:8> cuda",
                                  kc.clock_hz)
            del params, deployed
            torch.cuda.empty_cache()
        with phase(f"kernel 2 at {name}'s served matmuls"):
            check_stub_matmuls(kc, name, calls)
        del calls

    # -- 8. the LMs against the CPU's plain versions --------------------------
    with phase("gpu vs cpu rwkv6-3b"):
        lm_gpu_vs_cpu(torch, np, ops, "rwkv6-3b")
        lm_pim_gpu_vs_cpu(torch, np, ops, "rwkv6-3b")
    with phase("gpu vs cpu llama3.2-3b"):
        lm_gpu_vs_cpu(torch, np, ops, "llama3.2-3b")
        lm_gpu_vs_cpu(torch, np, ops, "llama3.2-3b", kv_quant=True)
        lm_pim_gpu_vs_cpu(torch, np, ops, "llama3.2-3b")
    with phase("gpu vs cpu recurrentgemma-9b"):
        # One unit (rglru, rglru, local_attn); 2,100 tokens in chunks of
        # 2048 + 32 + 16 + 4 wrap the 2,048-row ring.
        lm_gpu_vs_cpu(torch, np, ops, "recurrentgemma-9b", n_layers=3,
                      prompt_len=2100)
        shared = {}
        for kind in ("rglru", "local_attn"):
            lm_pim_gpu_vs_cpu(torch, np, ops, "recurrentgemma-9b",
                              block_pattern=(kind,), shared=shared)
        del shared
    with phase("gpu vs cpu phi3.5-moe"):
        lm_gpu_vs_cpu(torch, np, ops, PHI, n_layers=1)
        lm_pim_gpu_vs_cpu(torch, np, ops, PHI)
    with phase("gpu vs cpu musicgen-large"):
        stub_gpu_vs_cpu(torch, np, ops, MUSICGEN, n_layers=2)
        lm_pim_gpu_vs_cpu(torch, np, ops, MUSICGEN)
    with phase("gpu vs cpu llama-3.2-vision-90b"):
        # attn then cross_attn at full width: all 6,400 image tokens in
        # float32; 64 of them at <8:8> (the CPU's plain products at 6,400
        # would take minutes), the cross layer alone and the two.
        stub_gpu_vs_cpu(torch, np, ops, VISION, n_layers=2,
                        cross_attn_every=1)
        shared = {}
        for kind, layers in ((("cross_attn",), 1), (None, 2)):
            lm_pim_gpu_vs_cpu(torch, np, ops, VISION, block_pattern=kind,
                              shared=shared, n_layers=layers,
                              cross_attn_every=1, n_image_tokens=64)
        del shared

    # -- 9. the autotuner -----------------------------------------------------
    autotune_phase(torch, np, ops, imgs)

    # -- 10. the fault model, the watchdog and snapshot / restore -------------
    fault_phase(torch, np, ops, kc, imgs)

    # -- 11. training ---------------------------------------------------------
    train_phase(torch, np, ops)

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
        summary(kc.rows, "wkv_chunked", lm_launches["wkv_chunked"],
                dict(BH=40, S=256, D=64, chunk=16)),
        summary(kc.rows, "bitserial_matmul_fused_batched",
                moe_launches["bitserial_matmul_fused_batched"],
                dict(E=16, M=8, K=4096, N=6400)),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
