"""Deterministic synthetic LM data (``repro.data.pipeline`` without the
device prefetch thread): batches are seeded per (seed, step, first row),
so a run can start at any step without replay.  numpy only; bit-identical
to the JAX package's ``make_batch`` and its prefetcher's stub context."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 1234
    microbatch: int = 0          # reshape to [n, B/n, ...] when > 1
    pack: bool = True            # synth docs packed to seq_len with EOS
    eos_id: int = 2


def _host_tokens(cfg: DataConfig, step: int, start: int, count: int):
    """Deterministic tokens for rows [start, start+count) of global batch."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, start]))
    toks = rng.integers(3, cfg.vocab_size, size=(count, cfg.seq_len + 1),
                        dtype=np.int32)
    if cfg.pack:
        # synthetic doc boundaries every ~512 tokens
        doc_len = rng.integers(256, 1024)
        toks[:, ::max(int(doc_len), 1)] = cfg.eos_id
    return toks


def stub_context(cfg: DataConfig, step: int,
                 shape: Tuple[int, int, int]) -> np.ndarray:
    """The stub frontend's embeddings of ``step`` (the JAX package's
    ``Prefetcher``, ``data/pipeline.py:80-89``): f32 ``shape`` = [B,
    context_len, context_dim or d_model] from numpy seed ``[seed, step,
    7]``, times 0.02, [n, B/n, ...] with ``microbatch`` n > 1."""
    rng = np.random.default_rng([cfg.seed, step, 7])
    ctx = rng.standard_normal(shape).astype(np.float32)
    if cfg.microbatch > 1:
        n = cfg.microbatch
        ctx = ctx.reshape((n, ctx.shape[0] // n) + ctx.shape[1:])
    return ctx * 0.02


def make_batch(cfg: DataConfig, step: int,
               ctx_shape: Optional[Tuple[int, int, int]] = None
               ) -> Dict[str, np.ndarray]:
    """The whole global batch of ``step``: {"tokens", "labels"} int32
    [B, s], or [n, B/n, s] with ``microbatch`` n > 1; with ``ctx_shape``
    also the stub context "ctx" (:func:`stub_context`)."""
    toks = _host_tokens(cfg, step, 0, cfg.global_batch)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.microbatch > 1:
        n = cfg.microbatch
        batch = {k: v.reshape(n, cfg.global_batch // n, cfg.seq_len)
                 for k, v in batch.items()}
    if ctx_shape is not None:
        batch["ctx"] = stub_context(cfg, step, ctx_shape)
    return batch
