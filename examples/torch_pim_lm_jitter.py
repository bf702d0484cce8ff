"""How far one float ulp of jitter moves the <8:8> rwkv6-3b logits.

Builds the reduced rwkv6-3b (float32, ``--layers`` layers), prefills two
prompts (48 and 20 tokens) into a 4-slot grid and runs two decode steps at
M = 4, then does the same with every float weight moved by ``--eps``
relative (Gaussian, a fresh seed per trial) on the same tokens. Prints the
worst row's relative L2 change of the logits, for the float model and for
<8:8> on ``--backend``. The float model moves by about ``--eps``; the
quantized one by a code step wherever the jitter flips an activation code
at a quantization boundary, spread by the layers after it. This is why
the card's <8:8> path is held against the CPU per quantized product and
only loosely end to end (``chip_smoke.py``, ``lm_pim_gpu_vs_cpu``).

  PYTHONPATH=src python examples/torch_pim_lm_jitter.py --device cpu
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import disable_tf32
from repro_torch.configs import get_config
from repro_torch.core import PIMQuantConfig
from repro_torch.models.lm import model as M
from repro_torch.serving.engine import _pow2_chunks


def logits_of(params, cfg, prompts, toks, device):
    """Prefill ``prompts`` into slots 0.. of a 4-slot grid, then two decode
    steps on ``toks`` (filled from this run's argmax where None)."""
    p = M.prepack_params(M.to_device(params, device), cfg.pim)
    st = M.init_state(cfg, 4, 64, device)
    out = []
    for slot, prompt in enumerate(prompts):
        pos = 0
        for c in _pow2_chunks(len(prompt)):
            lo, st = M.prefill_into_slot(
                p, cfg, torch.from_numpy(prompt[pos:pos + c])[None].to(
                    device), st, slot, pos)
            pos += c
        out.append(lo[:, 0].cpu().numpy())
    if not toks:
        toks.append(np.array([int(o.argmax()) for o in out] + [0, 0]))
    for step in range(2):
        lo, st = M.decode_step(p, cfg, torch.from_numpy(
            toks[step])[:, None].to(device), st)
        out.append(lo[:, 0].cpu().numpy())
        if len(toks) == step + 1:
            toks.append(out[-1].argmax(-1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--backend", default="int-direct")
    args = ap.parse_args(argv)
    disable_tf32()
    base = dataclasses.replace(get_config("rwkv6-3b").model.reduced(),
                               n_layers=args.layers, dtype="float32")
    params = M.init(base, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, base.vocab, n) for n in (48, 20)]
    worst = {}
    with torch.no_grad():
        for label, pim in (("float", None),
                           ("<8:8>", PIMQuantConfig(8, 8,
                                                    backend=args.backend))):
            cfg = dataclasses.replace(base, pim=pim)
            toks = []
            want = logits_of(params, cfg, prompts, toks, args.device)
            worst[label] = []
            for trial in range(args.trials):
                gen = torch.Generator().manual_seed(100 + trial)
                moved = M._map(lambda x: x * (1 + args.eps * torch.randn(
                    x.shape, generator=gen)) if x.is_floating_point()
                    else x, params)
                got = logits_of(moved, cfg, prompts, toks, args.device)
                worst[label].append(max(float(np.max(
                    np.linalg.norm(g - w, axis=-1)
                    / np.linalg.norm(w, axis=-1))) for g, w in zip(got, want)))
            print(f"{label:6s} eps {args.eps:g}: worst row relative L2 of the "
                  f"logits over {args.trials} trials: "
                  f"{', '.join(f'{w:.3g}' for w in worst[label])}")
    return worst


if __name__ == "__main__":
    main()
