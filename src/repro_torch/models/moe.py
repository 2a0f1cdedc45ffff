"""Mixture-of-Experts FFN with capacity-based routing
(``repro.models.moe``), at tp=1: every expert is local, so JAX's ``tmp``
and ``ep`` shardings compute the same thing and the combine's all-reduce
is the identity.  The three expert products run the grouped-matmul kernel
(:func:`repro_torch.kernels.moe_gmm.grouped_matmul`).  The dispatch
(JAX's ``.at[le, pos].add(mode="drop")``) and the combine
(``.at[tok_idx].add``) are ``index_add`` over rows (the dispatch's over
the flattened [E * C] buffer), and the two gathers are an expand (each
token's k copies) and an ``index_select``: on the card their gradients
are a sum and an ``index_add``, where advanced indexing and
``index_put(accumulate=True)`` run CUDA's sort-based indexing kernel.
Tensor parallelism and expert parallelism are ROADMAP.md A10."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm import grouped_matmul


def capacity(tokens: int, top_k: int, num_experts: int,
             factor: float) -> int:
    """Rows of each expert's buffer."""
    return max(8, math.ceil(tokens * top_k / num_experts * factor))


def route(x2d: torch.Tensor, router_w: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d [t, D]; router_w [D, E] -> (weights [t, k] f32, experts [t, k]
    int64, Switch-style load-balance aux loss, f32 scalar).  Routing
    softmax in f32; the top-k weights are renormalised."""
    logits = torch.matmul(x2d.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    w, e = torch.topk(probs, top_k, dim=-1)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    num_experts = router_w.shape[1]
    frac_prob = probs.mean(dim=0)
    frac_tok = F.one_hot(e[:, 0], num_experts).float().mean(dim=0)
    aux = num_experts * (frac_prob * frac_tok).sum()
    return w, e, aux


def dispatch_positions(experts_flat: torch.Tensor, num_experts: int,
                       cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position of each (token, choice) within its expert's buffer (its
    rank among earlier choices of the same expert), and whether it fits
    the capacity.  The running count runs along the inner dim of the
    [E, t * k] one-hot (an outer-dim scan is slow on the card)."""
    oh = F.one_hot(experts_flat, num_experts).t().contiguous()
    pos = torch.cumsum(oh, dim=1) - oh
    posf = pos.gather(0, experts_flat[None, :])[0]
    return posf, posf < cap


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], *,
            num_experts: int, top_k: int, cap_factor: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, s, D] -> (delta [b, s, D] in x's dtype, aux).  ``p`` holds
    ``router`` [D, E] f32 and the SwiGLU expert stacks ``w1``, ``w3``
    [E, D, F] and ``w2`` [E, F, D].  The capacity is per call: each
    sub-batch of a split schedule routes alone, as in JAX."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    w, e, aux = route(x2d, p["router"], top_k)
    cap = capacity(t, top_k, num_experts, cap_factor)

    ef = e.reshape(-1)                                    # [t * k]
    wf = w.reshape(-1)
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)
    posf, keep = dispatch_positions(ef, num_experts, cap)
    # row of each kept choice in the flattened [E * C] buffer; dropped
    # choices point at row 0 and carry zeros
    slot = torch.where(keep, ef * cap + posf, 0)

    # gather the kept choices into [E, C, D] (x2d[tok_idx] is each token
    # repeated k times)
    vals = torch.where(keep[:, None],
                       x2d[:, None].expand(t, top_k, d).reshape(t * top_k, d),
                       0.0)
    buf = x.new_zeros(num_experts * cap, d).index_add(0, slot, vals)
    buf = buf.view(num_experts, cap, d)

    h = grouped_matmul(buf, p["w1"])
    g = grouped_matmul(buf, p["w3"])
    out_buf = grouped_matmul(F.silu(g) * h, p["w2"])      # [E, C, D]

    # combine back to tokens, weighted
    gathered = torch.where(
        keep[:, None],
        out_buf.reshape(num_experts * cap, d).index_select(0, slot), 0.0)
    contrib = gathered * wf[:, None].to(gathered.dtype)
    out = contrib.new_zeros(t, d).index_add(0, tok_idx, contrib)
    return out.reshape(b, s, d).to(x.dtype), aux
