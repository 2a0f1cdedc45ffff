"""Tensor-model-parallel primitives of ``repro.core.tmp`` at tp=1 (the
port runs one device): the norm, the embedding, the chunked cross
entropy and greedy sampling."""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.rmsnorm import rmsnorm


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """``repro.core.tmp.rms_norm``: f32 math, ``(1 + scale)``, output in
    x's dtype.  Runs the CUDA kernels (forward and backward) on a CUDA
    tensor."""
    return rmsnorm(x, scale, eps=eps)


def vocab_parallel_embed(tokens: torch.Tensor,
                         embed: torch.Tensor) -> torch.Tensor:
    """tokens [...] -> [..., D].  At tp=1 the vocab shard is the whole
    table and the completing AllReduce is the identity."""
    return embed[tokens.long()]


def _xent_chunk(x: torch.Tensor, head32: torch.Tensor,
                labels: torch.Tensor, softcap: float) -> torch.Tensor:
    """x [t, D]; head32 [D, V] f32; labels [t] -> summed nll (f32 scalar).
    ``_xent_chunk`` of ``repro.core.tmp`` with the whole vocab local."""
    logits = torch.matmul(x.float(), head32)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    m = logits.amax(dim=-1).detach()      # stability only, no gradient
    z = torch.exp(logits - m[:, None]).sum(dim=-1)
    lab = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return (torch.log(z) + m - lab).sum()


def vocab_parallel_xent(x: torch.Tensor, head: torch.Tensor,
                        labels: torch.Tensor, *, chunk: int = 512,
                        softcap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked cross entropy (``repro.core.tmp.vocab_parallel_xent`` at
    tp=1, no mask): x [b, s, D]; head [D, V]; labels [b, s] ->
    (loss_sum, count), both f32 scalars.

    Logits are f32, ``chunk`` tokens at a time plus the remainder; each
    full chunk runs under ``checkpoint`` (the ``@jax.checkpoint`` of the
    JAX scan step), so only one chunk's [chunk, V] logits are live in the
    backward.  The head is cast to f32 once per call rather than once per
    chunk, so its gradient sums over the chunks in f32."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    lf = labels.reshape(t)
    head32 = head.float()
    chunk = min(chunk, t)
    n = t // chunk
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        loss = loss + checkpoint(_xent_chunk, xf[sl], head32, lf[sl],
                                 softcap, use_reentrant=False)
    if n * chunk < t:
        loss = loss + _xent_chunk(xf[n * chunk:], head32, lf[n * chunk:],
                                  softcap)
    return loss, torch.tensor(float(t), device=x.device)


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """[b, V] -> [b] int32; the first maximum wins, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
