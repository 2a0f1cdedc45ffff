"""AdamW (``repro.optim.adamw`` at dp=1) on each rank's shards: f32
master weights, m and v; global-norm clipping, the norm spanning every
rank and counting each distinct shard once; linear warmup and cosine
decay to 10%; weight decay on leaves with more than one dimension.

Unlike the JAX version, which returns new trees, :func:`apply_updates`
updates the master weights, m, v and the model parameters IN PLACE, and
walks each leaf in slices so that its f32 temporaries stay small.
ZeRO-1 sharding of the optimizer state over data-parallel ranks and int8
gradient compression are not ported (ROADMAP.md A4).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core.comm import Comm
from repro_torch.models.params import flat_leaves

# elements per slice of a leaf in apply_updates (f32 temporaries of
# 4 x 64 MB at most)
_SLICE = 1 << 24


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup + cosine decay to 10%."""
    step = float(step)
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.55 + 0.45 * math.cos(math.pi * prog)
    return cfg.learning_rate * warm * cos


def init_opt_state(params: Dict[str, Any]) -> Dict[str, Any]:
    """{"master", "m", "v"}: f32 lists in :func:`flat_leaves` order, and
    ``step`` (the number of updates applied)."""
    leaves = flat_leaves(params)
    return {"master": [w.detach().float().clone() for w in leaves],
            "m": [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                  for w in leaves],
            "v": [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                  for w in leaves],
            "step": 0}


def _sq(g: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(g.float()))


def global_norm(grads: List[torch.Tensor], comm: Optional[Comm] = None,
                counted: Optional[Sequence[Optional[bool]]] = None
                ) -> torch.Tensor:
    """The norm of the whole model's gradient, counting each distinct
    shard once, so every rank clips by the same factor.  Over several
    ranks (``comm`` of size > 1, the whole mesh), ``counted`` says per
    leaf: None, every rank holds the whole gradient (added once, here);
    True, this rank counts its shard in the sum all-reduced over the
    ranks; False, another holder of the same shard counts it (a leaf
    sharded over some axes and replicated over others)."""
    if comm is None or comm.size == 1:
        return torch.sqrt(sum(_sq(g) for g in grads))
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    local = sum((_sq(g) for g, c in zip(grads, counted) if c), zero)
    rep = sum((_sq(g) for g, c in zip(grads, counted) if c is None), zero)
    return torch.sqrt(comm.all_reduce(local.reshape(1))[0] + rep)


def apply_updates(params: Dict[str, Any], grads: List[torch.Tensor],
                  opt_state: Dict[str, Any], cfg: AdamWConfig, *,
                  compress: bool = False, comm: Optional[Comm] = None,
                  counted: Optional[Sequence[Optional[bool]]] = None
                  ) -> torch.Tensor:
    """One AdamW step, in place; ``grads`` in :func:`flat_leaves` order
    (any float dtype).  Returns the global norm of the unclipped grads.
    Over several ranks, ``counted`` says which shards this rank counts
    in the norm (:func:`global_norm`; ``ModelLayout.holders`` and
    ``holds_first``)."""
    if compress:
        raise NotImplementedError(
            "int8 gradient compression is not ported yet (ROADMAP.md A4)")
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads, comm, counted)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-6), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    with torch.no_grad():
        for w, w32, m, v, g in zip(flat_leaves(params), opt_state["master"],
                                   opt_state["m"], opt_state["v"], grads):
            decay = cfg.weight_decay if w32.dim() > 1 else 0.0
            for sl in zip(*(t.view(-1).split(_SLICE)
                            for t in (w, w32, m, v, g))):
                ws, w32s, ms, vs, gs = sl
                gs = gs.float() * clip
                ms.mul_(b1).add_((1 - b1) * gs)
                vs.mul_(b2).add_((1 - b2) * gs * gs)
                upd = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps)
                if decay:
                    upd.add_(decay * w32s)
                w32s.sub_(lr * upd)
                ws.copy_(w32s)
    opt_state["step"] = step
    return gnorm
