"""Deterministic, restartable data pipeline.

Two sources behind one iterator interface:

  * ``SyntheticLM`` — endless stream of structured pseudo-text (a mixture
    of Zipfian unigrams and repeated n-gram motifs, so a model can actually
    reduce loss on it; pure-noise tokens would leave nothing to learn).
  * ``MemmapTokens`` — a flat binary token file (np.memmap), the standard
    packed-corpus format.

Determinism/restart contract: batch content is a pure function of
``(seed, step)`` — resuming from a checkpoint at step K reproduces exactly
the batches a non-preempted run would have seen. That is the property the
fault-tolerance layer relies on (no data-state checkpointing needed beyond
the step counter).

Sharded loading: each data-parallel host materializes only its slice
(``host_slice``); single-process runs take the whole batch.

This is numpy only, the JAX package's module as it is, so its batches are
the reference's bit for bit; the train step moves them to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"       # synthetic | memmap
    path: str = ""                  # for memmap
    motif_len: int = 16
    n_motifs: int = 256


class SyntheticLM:
    """Zipf unigrams + recurring motifs; ~55% of positions are motif tokens."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.motifs = rng.integers(
            0, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len), dtype=np.int32)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.unigram = p / p.sum()

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len + 1
        toks = rng.choice(cfg.vocab, size=(b, s), p=self.unigram).astype(np.int32)
        # Overwrite random spans with motifs (predictable structure).
        n_spans = max(1, s // (2 * cfg.motif_len))
        for i in range(b):
            starts = rng.integers(0, s - cfg.motif_len, size=n_spans)
            ids = rng.integers(0, cfg.n_motifs, size=n_spans)
            for st, mid in zip(starts, ids):
                toks[i, st:st + cfg.motif_len] = self.motifs[mid]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def host_slice(self, step: int, host_index: int, n_hosts: int) -> dict:
        full = self.batch(step)
        per = self.cfg.global_batch // n_hosts
        sl = slice(host_index * per, (host_index + 1) * per)
        return {k: v[sl] for k, v in full.items()}


class MemmapTokens:
    """Packed token file; batch (seed, step) -> deterministic offsets."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self.n = len(self.data) - cfg.seq_len - 1
        if self.n <= 0:
            raise ValueError(f"{cfg.path} shorter than one sequence")

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        offs = rng.integers(0, self.n, size=cfg.global_batch)
        rows = np.stack([self.data[o:o + cfg.seq_len + 1] for o in offs])
        rows = np.asarray(rows, dtype=np.int32) % cfg.vocab
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def host_slice(self, step: int, host_index: int, n_hosts: int) -> dict:
        full = self.batch(step)
        per = self.cfg.global_batch // n_hosts
        sl = slice(host_index * per, (host_index + 1) * per)
        return {k: v[sl] for k, v in full.items()}


def make_source(cfg: DataConfig):
    if cfg.source == "synthetic":
        return SyntheticLM(cfg)
    if cfg.source == "memmap":
        return MemmapTokens(cfg)
    raise ValueError(cfg.source)
