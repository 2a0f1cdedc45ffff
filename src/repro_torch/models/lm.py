"""The model on one device: the training loss of
``repro.models.lm.build_train_loss`` and the paged decode step of
``build_decode`` (embed, copy-on-write, the layer loop, final norm, head,
greedy token)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, TrainHParams
from repro_torch.core.tmp import (greedy_token, rms_norm,
                                  vocab_parallel_embed, vocab_parallel_xent)
from repro_torch.models import blocks
from repro_torch.models.params import check_supported


def train_loss(cfg: ArchConfig, params: Dict[str, Any],
               batch: Dict[str, torch.Tensor], hp: TrainHParams
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch {"tokens", "labels"} [b, s] int -> (loss, aux), f32 scalars:
    the body of ``build_train_loss`` on one device.  Each layer adds its
    attention part, then its MLP part, to the residual stream; the
    sub-batch split of the ``oases`` schedule only cuts the batch at tp=1
    and is not taken.  Dense models have no auxiliary loss (aux = 0)."""
    check_supported(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    x = vocab_parallel_embed(tokens, params["embed"])
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    attn = blocks.make_attn_part(cfg)
    per_layer = {name: t.unbind(0)
                 for name, t in params["blocks"][0].items()}
    for i in range(cfg.num_layers):
        p = {name: ts[i] for name, ts in per_layer.items()}
        x = x + attn(p, x, positions)
        x = x + blocks.mlp_part(cfg, p, x)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    loss_sum, count = vocab_parallel_xent(
        x, params["lm_head"], labels, chunk=hp.loss_chunk,
        softcap=cfg.final_softcap)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return loss_sum / count + aux, aux


def apply_cow(state: Dict[str, Any], cow_src: torch.Tensor,
              cow_dst: torch.Tensor):
    """Copy page ``cow_src[i]`` over page ``cow_dst[i]`` in every layer's k
    and v pool, IN PLACE.  All sources are gathered before any page is
    written, as ``lm._apply_cow`` does; ``(0, 0)`` pairs copy the null page
    onto itself and change nothing."""
    for entry in state["blocks"]:
        for key in ("k", "v"):
            pool = entry[key]                     # [n, pages, page, kvh, hd]
            taken = pool.index_select(1, cow_src.long())
            pool.index_copy_(1, cow_dst.long(), taken)


def last_logits(cfg: ArchConfig, params: Dict[str, Any],
                x_last: torch.Tensor) -> torch.Tensor:
    """x_last [b, d] -> f32 logits over the padded vocab.  Like
    ``lm._last_logits`` this casts the whole head to f32 each call (a
    transient copy of the [d, V] head)."""
    logits = torch.matmul(x_last.float(), params["lm_head"].float())
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Dict[str, Any],
                state: Dict[str, Any], tokens: torch.Tensor,
                pos: torch.Tensor, tables: torch.Tensor,
                cow_src: Optional[torch.Tensor] = None,
                cow_dst: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [b] int32, pos [b] int32, tables [b, nb] int32 -> next token
    [b] int32.  ``state`` (the page pools of :func:`params.zeros_state`) is
    updated in place: copy-on-write pages first, then each layer's k/v."""
    check_supported(cfg)
    if cow_src is not None and cow_src.numel():
        apply_cow(state, cow_src, cow_dst)
    x = vocab_parallel_embed(tokens[:, None], params["embed"])
    blk = params["blocks"][0]
    per_layer = {name: t.unbind(0) for name, t in blk.items()}
    k_pools = state["blocks"][0]["k"].unbind(0)
    v_pools = state["blocks"][0]["v"].unbind(0)
    for i in range(cfg.num_layers):
        p = {name: ts[i] for name, ts in per_layer.items()}
        x = blocks.decode_fn(cfg, p, x, k_pools[i], v_pools[i], pos, tables)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return greedy_token(last_logits(cfg, params, x[:, 0]))
