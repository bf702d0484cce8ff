"""LM assembly: embed -> block schedule -> head.

The parameter tree is the JAX package's: nested dicts, the arch's
repeating unit of blocks stacked on a leading (n_reps,) axis under
``"scan"`` and the remainder layers under ``"rest"``. A Python loop over the
reps takes the place of ``jax.lax.scan``.

Entry points:

  ``forward(params, cfg, tokens)``             -> (logits, aux loss)
  ``loss_fn(params, cfg, batch)``              -> scalar cross entropy
                                                  (+ MoE aux)
  ``prefill(params, cfg, tokens, state)``      -> (last logits, state)
  ``decode_step(params, cfg, tokens, state)``  -> (logits, state)
                                                  (+ stats with
                                                  ``return_stats``)
  ``prefill_into_slot(params, cfg, tokens, state, slot, start_pos)``

``tokens`` are (B, S) ids, or (B, S, d_model) frame embeddings where
``cfg.embed_inputs`` is False (musicgen, from the stub frontend). The first
three take ``image_embeds`` (B, n_image_tokens, d_model), the stub
frontend's patch embeddings that every ``cross_attn`` block attends to
(llama-3.2-vision); a model with cross blocks raises ``ValueError``
without them.

State updates are in place: ``prefill`` and ``decode_step`` write each
layer's new carries into the stacked state tensors they were given (and
return the same dict), and an ``attn`` or ``local_attn`` layer writes only
its new KV rows (into the ring buffer for ``local_attn``), so a decode
step allocates no second copy of the (max_batch, ...) state. The block
kinds are the JAX package's: ``attn`` (dense decoder), ``local_attn`` and
``rglru`` (the recurrentgemma hybrid), ``cross_attn`` (llama-3.2-vision)
and ``rwkv``, each but ``rwkv`` with a dense or an MoE FFN (``cfg.moe``:
grok-1, phi3.5-moe).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core.packed import PackedWeight, prepack
from repro_torch.core.pim_layers import pim_linear
from repro_torch.pim import faults as _faults

from . import attention as A
from . import cache as C
from . import mlp as MLP
from . import moe as MOE
from . import rglru as RG
from . import rwkv6 as RW
from .config import ModelConfig
from .norms import apply_norm, init_norm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[str(name)]


# ---------------------------------------------------------------------------
# Repeating-unit detection
# ---------------------------------------------------------------------------

def layer_plan(cfg: ModelConfig) -> tuple[tuple, int, tuple]:
    """blocks -> (unit, n_reps, remainder) maximizing scanned coverage."""
    blocks = cfg.blocks
    best = (blocks[:1], 1, blocks[1:])
    best_cov = 1
    for ln in range(1, min(len(blocks), 8) + 1):
        unit = blocks[:ln]
        reps = 0
        while blocks[reps * ln:(reps + 1) * ln] == unit:
            reps += 1
        cov = reps * ln
        if cov > best_cov or (cov == best_cov and ln < len(best[0])):
            best, best_cov = (unit, reps, blocks[reps * ln:]), cov
    return best


# ---------------------------------------------------------------------------
# Per-block init / apply
# ---------------------------------------------------------------------------

_ATTN_KINDS = ("attn", "local_attn", "cross_attn")
_FFN_KINDS = _ATTN_KINDS + ("rglru",)
_KINDS = _FFN_KINDS + ("rwkv",)


def init_block(kind: str, cfg: ModelConfig, generator, device=None):
    if kind not in _KINDS:
        raise ValueError(kind)
    d = cfg.d_model
    p = {"norm1": init_norm(cfg.norm, d, device)}
    if kind in _ATTN_KINDS:
        p["attn"] = A.init_attention(cfg, generator, device,
                                     cross=kind == "cross_attn")
        if cfg.post_attn_norm:
            p["norm_post"] = init_norm(cfg.norm, d, device)
    elif kind == "rglru":
        p["rglru"] = RG.init_rglru_block(cfg, generator, device)
    if kind in _FFN_KINDS:
        p["norm2"] = init_norm(cfg.norm, d, device)
        p["ffn"] = (MOE.init_moe(cfg, generator, device) if cfg.moe
                    else MLP.init_mlp(cfg, generator, device))
        return p
    p["time_mix"] = RW.init_rwkv_block(cfg, generator, device)
    p["norm2"] = init_norm(cfg.norm, d, device)
    p["channel_mix"] = RW.init_rwkv_channel_mix(cfg, generator, device)
    return p


def _zero_aux(device) -> dict:
    """The MoE aux accumulator (the JAX package's ``_zero_aux``): the
    balance + z loss, and the dropped-assignment fraction summed over the
    MoE layers with a layer count, so the engine can report a mean."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"loss": z, "drop": z, "layers": z}


def apply_block(kind: str, p, cfg: ModelConfig, x, q_pos=None, state=None,
                cache_index=None, image_embeds=None, train=False):
    """Pre-norm residual block. Returns (x, new_state, aux): ``aux`` is the
    MoE FFN's aux dict (``_zero_aux``'s keys), or None without MoE.

    ``q_pos`` (B, S) int32 and ``cache_index`` (B,) are the positions an
    attention block needs (the recurrent blocks ignore them); a ``local_attn``
    block attends within ``cfg.local_window`` and keeps its ring buffer in
    ``state``; a ``cross_attn`` block attends to ``image_embeds`` and keeps
    their keys and values in ``state``. A cache comes back as ``state``
    itself, written in place. ``train`` runs the projections as
    quantization-aware training where ``cfg.pim`` is set.

    A ``cross_attn`` block without ``image_embeds`` raises ``ValueError``:
    the JAX package then runs it as self-attention over its image cache."""
    if kind not in _KINDS:
        raise ValueError(kind)
    if kind == "cross_attn" and image_embeds is None:
        raise ValueError("a cross_attn block needs image_embeds (the stub "
                         "frontend's patch embeddings) at every call")
    h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
    if kind in _FFN_KINDS:
        if kind == "rglru":
            y, new_inner = RG.rglru_block(p["rglru"], cfg, h, state,
                                          train=train)
        else:
            local = kind == "local_attn"
            y, new_inner = A.attention(
                p["attn"], cfg, h, q_pos,
                kv_src=image_embeds if kind == "cross_attn" else None,
                cache=state, cache_index=cache_index,
                window=cfg.local_window if local else 0,
                ring=local and state is not None, train=train)
            if cfg.post_attn_norm:
                y = apply_norm(cfg.norm, p["norm_post"], y, cfg.norm_eps)
        x = x + y
        h2 = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
        if not cfg.moe:
            return x + MLP.mlp(p["ffn"], cfg, h2, train=train), new_inner, None
        y2, aux = MOE.moe_ffn(p["ffn"], cfg, h2, train=train)
        return x + y2, new_inner, aux
    y, new_inner = RW.rwkv_time_mix(p["time_mix"], cfg, h, state, train=train)
    x = x + y
    h2 = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
    y2, new_inner = RW.rwkv_channel_mix(p["channel_mix"], cfg, h2, new_inner,
                                        train=train)
    return x + y2, new_inner, None


def _add_aux(total, aux):
    """Aux dicts summed key by key (None is no MoE layer)."""
    if aux is None:
        return total
    if total is None:
        return dict(aux)
    return {k: total[k] + v for k, v in aux.items()}


# ---------------------------------------------------------------------------
# Whole-model init, casts and prepack
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters from ``generator``, float32 on ``device``.

    The draws are made on the generator's device (a CUDA generator makes a
    full-width model on the card without a host round trip)."""
    unit, reps, rest = layer_plan(cfg)
    params: dict = {}
    if cfg.embed_inputs:
        params["embed"] = RW.randn(generator, (cfg.vocab, cfg.d_model),
                                   cfg.d_model**-0.5, device)
    stacked = [[init_block(kind, cfg, generator, device) for kind in unit]
               for _ in range(reps)]
    params["scan"] = []
    for i in range(len(unit)):
        params["scan"].append(_stack([s[i] for s in stacked]))
        for s in stacked:   # free each rep's copy once it is stacked
            s[i] = None
    params["rest"] = [init_block(kind, cfg, generator, device)
                      for kind in rest]
    params["final_norm"] = init_norm(cfg.norm, cfg.d_model, device)
    if not cfg.tie_embeddings:
        params["head"] = RW.randn(generator, (cfg.d_model, cfg.vocab),
                                  cfg.d_model**-0.5, device)
    return params


def _stack(trees):
    """The reps' trees stacked leaf by leaf; each rep's leaf is dropped from
    its tree once stacked, so at most one leaf is held twice (a layer of
    phi3.5-moe holds 5.2 GB of float32 experts)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(trees[0])}
    out = torch.stack(trees)
    trees.clear()
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def cast_params(params, dtype):
    """Cast float32 leaves of two or more dimensions to ``dtype``, as the
    JAX package does (stacked leaves count their rep axis, so a stacked
    norm scale is cast too; the final norm stays float32). A packed
    weight, whose tensors are integer codes and planes, is kept whole, its
    ``tune`` with it."""
    def _cast(x):
        if isinstance(x, PackedWeight):
            return x
        if x.dtype == torch.float32 and x.dim() >= 2:
            return x.to(dtype)
        return x
    return _map(_cast, params)


def to_device(params, device):
    """The tree (float or prepacked) moved to ``device``."""
    return _map(lambda x: x.to(device), params)


# Projection leaves that route through pim_linear — the prepack targets.
# (Tied embeddings stay float: the embedding gather is not a GEMM, and the
# tied head quantizes ``embed.T`` per call, as the JAX package does. The
# RG-LRU gate weights ``w_a``/``w_i`` stay float: their products are
# float32 ``torch.matmul``.)
_PIM_PROJ_KEYS = frozenset({
    "wq", "wk", "wv", "wo",                      # attention
    "w_in", "w_out", "w_gate",                   # mlp / rglru
    "w_x",                                       # rglru input proj
    "w_r", "w_k", "w_v", "w_g", "w_o",           # rwkv6
    "head",                                      # untied lm head
})

# Expert-bank leaves inside a router-bearing dict: (E, d, f), or (R, E, d,
# f) scan-stacked, packed as banks (the router stays float).
_MOE_EXPERT_KEYS = frozenset({"w_in", "w_out", "w_gate"})


def prepack_params(params, cfg, faults=None):
    """Quantize + pack every pim_linear projection weight exactly once.

    ``cfg`` is the model's ``PIMQuantConfig`` (None or disabled: the tree
    comes back as it is). A (K, N) leaf becomes a :class:`PackedWeight`; a
    stacked (R, K, N) leaf a list of R of them, one per rep, each
    calibrated on its own rep as the JAX package's ``vmap`` calibrates.
    MoE expert banks pack one level deeper: ``w_in``/``w_out``/``w_gate``
    of a router-bearing dict are (E, d, f) (or (R, E, d, f) scan-stacked)
    and each becomes one bank PackedWeight (or a list of R), every expert
    calibrated on itself; the ``router`` stays float, so the packed path
    routes exactly as the float one.

    ``faults``: an optional :class:`repro_torch.pim.faults.FaultConfig`.
    After packing, persistent device faults (stochastic writes, retention,
    stuck-at cells, dead subarrays) corrupt the packed codes, re-packed
    through kernel 1, as a real subarray-programming pass would; with
    ``faults.checksum`` armed, flagged columns repair from spares before
    the tree ships. A rep list is one leaf of the injection, as the
    reference's stacked leaf is. Single device only: no mesh.
    """
    if cfg is None or not getattr(cfg, "enabled", False):
        return params

    def pack_leaf(leaf, ndim):
        """A leaf of ``ndim`` dimensions per weight (2, or 3 for a bank),
        with a leading rep axis or without."""
        leaf = leaf.to(torch.float32)
        if leaf.dim() == ndim:
            return prepack(leaf, cfg.w_bits)
        return [prepack(w, cfg.w_bits) for w in leaf]

    def packs(k, v, keys, ndim):
        return (k in keys and isinstance(v, torch.Tensor)
                and v.dim() in (ndim, ndim + 1) and v.is_floating_point())

    def walk(p):
        if isinstance(p, dict):
            if "router" in p:            # MoE: pack experts, router stays
                return {k: (pack_leaf(v, 3)
                            if packs(k, v, _MOE_EXPERT_KEYS, 3) else v)
                        for k, v in p.items()}
            return {k: (pack_leaf(v, 2) if packs(k, v, _PIM_PROJ_KEYS, 2)
                        else walk(v))
                    for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v) for v in p)
        return p

    packed = walk(params)
    if faults is not None:
        packed, _ = _faults.inject_tree(packed, faults)
    return packed


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _reps(tree, reps: int) -> list:
    """A stacked block tree as one tree per rep: a stacked tensor is
    unbound once (one backward node that stacks the reps' gradients, where
    indexing each rep would add a full-size gradient per rep), a list of
    PackedWeight (one per rep) is indexed."""
    if isinstance(tree, dict):
        per_key = {k: _reps(v, reps) for k, v in tree.items()}
        return [{k: v[r] for k, v in per_key.items()} for r in range(reps)]
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    return [tree[r] for r in range(reps)]


def _rep(tree, r: int):
    """Rep ``r`` of a stacked state tree."""
    if isinstance(tree, dict):
        return {k: _rep(v, r) for k, v in tree.items()}
    return tree[r]


def _write(dst: dict, src: dict):
    """Copy a layer's new state into its slice of the stacked state (a KV
    cache comes back as ``dst`` itself, already written in place)."""
    if src is not dst:
        for k, v in src.items():
            dst[k].copy_(v)


def _run_blocks(params, cfg: ModelConfig, x, q_pos, states=None,
                cache_index=None, image_embeds=None, train=False):
    """Apply the full block schedule; ``states`` (prefill/decode) is
    updated in place. Returns (x, aux): the MoE aux values summed over the
    layers (``_zero_aux``), or None for a model without MoE.

    In training (``train`` and ``cfg.remat`` not ``"none"``) each rep of
    the unit runs under ``torch.utils.checkpoint`` and is recomputed in
    the backward ("block" and "full" alike: training keeps no decode cache
    for "block" to save). The unit returns its aux sum, which is added
    outside the checkpoint, so a recompute cannot count it twice."""
    unit, reps, rest = layer_plan(cfg)
    aux = None

    def unit_fn(x, p_list, s_list):
        unit_aux = None
        for j, kind in enumerate(unit):
            s = s_list[j] if s_list is not None else None
            x, ns, a = apply_block(kind, p_list[j], cfg, x, q_pos, s,
                                   cache_index, image_embeds, train)
            if s is not None:
                _write(s, ns)
            unit_aux = _add_aux(unit_aux, a)
        return x, unit_aux

    remat = train and cfg.remat != "none"
    per_rep = [_reps(t, reps) for t in params["scan"]]
    # Under a read-disturb scope every rep reads at the scan body's sites,
    # as the reference's one traced scan body numbers them.
    mark = _faults.site_mark()
    for r in range(reps):
        _faults.site_rewind(mark)
        p_list = [t[r] for t in per_rep]
        s_list = ([_rep(t, r) for t in states["scan"]]
                  if states is not None else None)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                unit_fn, x, p_list, s_list, use_reentrant=False)
        else:
            x, a = unit_fn(x, p_list, s_list)
        aux = _add_aux(aux, a)
    for i, kind in enumerate(rest):
        s = states["rest"][i] if states is not None else None
        x, ns, a = apply_block(kind, params["rest"][i], cfg, x, q_pos, s,
                               cache_index, image_embeds, train)
        if states is not None:
            _write(s, ns)
        aux = _add_aux(aux, a)
    return x, aux


def embed_inputs(params, cfg: ModelConfig, tokens):
    if cfg.embed_inputs:
        return params["embed"][tokens].to(torch_dtype(cfg.dtype))
    return tokens.to(torch_dtype(cfg.dtype))  # precomputed frame embeds


def lm_head(params, cfg: ModelConfig, x):
    """Logits (float32). Where ``cfg.pim`` is set the head runs
    ``pim_linear``'s inference pipeline, also under quantization-aware
    training, as the JAX package's head does: its rounding passes no
    gradient, so the loss reaches the head's input and weight only through
    their min and max (the calibration's scale and offset)."""
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = pim_linear(x, w, cfg=cfg.pim).to(torch.float32)
    if cfg.logits_softcap:
        logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
    return logits


def _seq_positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(
        b, s)


def forward(params, cfg: ModelConfig, tokens, image_embeds=None,
            train=False):
    """Full-sequence forward. Returns (logits (B, S, V) float32, aux loss):
    the MoE balance + z loss summed over the layers, 0 without MoE."""
    x = embed_inputs(params, cfg, tokens)
    x, aux = _run_blocks(params, cfg, x, _seq_positions(x),
                         image_embeds=image_embeds, train=train)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    loss = aux["loss"] if aux is not None else torch.zeros((),
                                                           device=x.device)
    return lm_head(params, cfg, x), loss


def _xent(logits, labels):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    return lse - gold


def loss_fn(params, cfg: ModelConfig, batch, train=True):
    """Mean next-token cross entropy (+ the MoE aux loss). ``batch``:
    ``tokens`` and ``labels`` (B, S), and ``image_embeds`` for a model with
    cross blocks.

    ``cfg.loss_chunk`` > 0 (dividing S, and below it) evaluates the head
    and the cross entropy a chunk of positions at a time, each chunk
    recomputed in the backward, so the (B, S, V) logits are never held
    whole."""
    labels = batch["labels"]
    x = embed_inputs(params, cfg, batch["tokens"])
    b, s = x.shape[:2]
    x, aux = _run_blocks(params, cfg, x, _seq_positions(x),
                         image_embeds=batch.get("image_embeds"), train=train)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)

    chunk = cfg.loss_chunk
    if chunk and s % chunk == 0 and s > chunk:
        def chunk_loss(xi, li):
            return _xent(lm_head(params, cfg, xi), li).sum()

        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s, chunk):
            xi, li = x[:, i:i + chunk], labels[:, i:i + chunk]
            total = total + (torch.utils.checkpoint.checkpoint(
                chunk_loss, xi, li, use_reentrant=False)
                if torch.is_grad_enabled() else chunk_loss(xi, li))
        # A tensor divisor (a CUDA division by a Python number multiplies
        # by its reciprocal).
        loss = total / torch.full_like(total, float(b * s))
    else:
        loss = _xent(lm_head(params, cfg, x), labels).mean()
    return loss + aux["loss"] if aux is not None else loss


def _positions(state, b: int, s: int):
    """(cache_index (B,), q_pos (B, S)) of a step that starts at each
    sequence's ``state["length"]``."""
    idx = state["length"].expand(b).clone()
    q_pos = idx[:, None] + torch.arange(s, dtype=torch.int32,
                                        device=idx.device)[None]
    return idx, q_pos


def decode_step(params, cfg: ModelConfig, tokens, state, image_embeds=None,
                return_stats: bool = False):
    """One decode step. tokens (B, 1) (or (B, 1, d) embeddings) ->
    (logits (B, 1, V), state), the state updated in place.
    ``state["length"]`` is (B,): every slot of a continuous-batching grid
    decodes at its own position. A model with ``cross_attn`` blocks takes
    the same ``image_embeds`` at every step (its image cache was written at
    the first prefill).

    ``return_stats`` appends the step's telemetry, ``{"moe_drop_frac": the
    fraction of this step's top-k assignments dropped at capacity,
    averaged over the MoE layers}`` (0 for a dense model), a 0-d tensor on
    the device."""
    x = embed_inputs(params, cfg, tokens)
    idx, q_pos = _positions(state, x.shape[0], 1)
    x, aux = _run_blocks(params, cfg, x, q_pos, state, idx, image_embeds)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = lm_head(params, cfg, x)
    state["length"] += 1
    if not return_stats:
        return logits, state
    aux = aux or _zero_aux(x.device)
    return logits, state, {"moe_drop_frac": aux["drop"]
                           / aux["layers"].clamp_min(1.0)}


def prefill(params, cfg: ModelConfig, tokens, state, image_embeds=None):
    """Run a whole prompt through the model, filling the decode state in
    place (a sequence at length 0 also writes its image keys and values).
    Returns the last token's logits (B, 1, V)."""
    x = embed_inputs(params, cfg, tokens)
    idx, q_pos = _positions(state, *x.shape[:2])
    x, _ = _run_blocks(params, cfg, x, q_pos, state, idx, image_embeds)
    x = apply_norm(cfg.norm, params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = lm_head(params, cfg, x)
    state["length"] += tokens.shape[1]
    return logits, state


def init_state(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               dtype=None):
    """Decode state on ``device``; KV caches default to the model's compute
    dtype."""
    dtype = torch_dtype(cfg.dtype) if dtype is None else dtype
    return C.init_model_state(cfg, batch, max_len, device, dtype)


# ---------------------------------------------------------------------------
# Slot-addressed prefill (continuous-batching admission path)
# ---------------------------------------------------------------------------
# The decode-state grid puts the batch axis at position 1 for scan-stacked
# leaves ((n_reps, B, ...)) and position 0 for remainder-layer leaves and
# ``length``.

def _slot_view(state, slot: int):
    """Slot ``slot`` of a (max_batch, ...) grid as a batch-1 state of
    views: what is written to it lands in the grid."""
    def take(ax):
        return lambda t: t.narrow(ax, slot, 1)
    return {
        "scan": [_map(take(1), t) for t in state["scan"]],
        "rest": [_map(take(0), t) for t in state["rest"]],
        "length": take(0)(state["length"]),
    }


def prefill_into_slot(params, cfg: ModelConfig, tokens, state, slot: int,
                      start_pos: int):
    """Prefill ``tokens`` (1, S) into slot ``slot`` of a decode-state grid.

    :func:`prefill` runs on views of the slot, so the grid changes only in
    that slot, in place, and no copy of the slot's state is made. Returns
    (last-token logits (1, 1, V), the grid). Chunked admission calls this
    once per power-of-two chunk of a prompt, threading ``start_pos``
    forward; a chunk at ``start_pos`` > 0 attends over the rows the earlier
    chunks cached.

    Slot reuse must not leak the previous occupant's state into the new
    request: KV rows are position-masked, but recurrent carries (RWKV wkv
    and token shifts, RG-LRU h and conv inputs) and ring buffers are
    position-less, so every leaf of the slot is zeroed on a request's first
    chunk (``start_pos == 0``); later chunks continue the carried state.
    """
    s1 = _slot_view(state, slot)
    if start_pos == 0:
        for t in s1["scan"] + s1["rest"]:
            _map(torch.Tensor.zero_, t)
    s1["length"].fill_(start_pos)
    logits, _ = prefill(params, cfg, tokens, s1)
    return logits, state


__all__ = ["apply_block", "cast_params", "decode_step",
           "embed_inputs", "forward", "init", "init_block", "init_state",
           "layer_plan", "lm_head", "loss_fn", "prefill",
           "prefill_into_slot", "prepack_params", "to_device"]
