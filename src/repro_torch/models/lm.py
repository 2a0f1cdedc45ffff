"""The model: the training loss of ``repro.models.lm.build_train_loss``
on a 1-D tensor-parallel group (with sequence parallelism and ring
attention), and the paged decode step of
``build_decode`` on one device (embed, copy-on-write, the layer loop,
final norm, head, greedy token)."""
from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, TrainHParams
from repro_torch.core import remat
from repro_torch.core.comm import Comm, SoloComm
from repro_torch.core.schedule import (TmpCtx, apply_layer, effective_split,
                                       merge_tree, split_tree)
from repro_torch.core.tmp import (greedy_token, rms_norm,
                                  vocab_parallel_embed, vocab_parallel_xent)
from repro_torch.models import blocks
from repro_torch.models.params import (check_servable, check_supported,
                                       check_tp, head_weight, layer_units,
                                       stack_layout)


def train_layout(cfg: ArchConfig, hp: TrainHParams, tp: int,
                 seq_len: int) -> Tuple[bool, int, List[str]]:
    """(seq_parallel, seq_shard, blockers) of a run, as JAX's
    ``build_train_loss`` decides them (``lm.py:330-375``): ring attention
    (``hp.seq_shard`` > 1) that cannot run raises (``check_tp``) and
    implies SP; ``hp.seq_parallel`` with a blocker (a group of one, a
    sequence the group does not divide) runs without SP, and ``blockers``
    names why."""
    check_tp(cfg, tp, seq_shard=hp.seq_shard, seq_len=seq_len)
    blockers = []
    if tp <= 1:
        blockers.append("the mesh has no model axes (tp=1)")
    if seq_len % max(tp, 1):
        blockers.append(f"seq_len {seq_len} is not divisible by the model "
                        f"group size {tp}")
    sp = bool((hp.seq_parallel or hp.seq_shard > 1) and not blockers)
    return sp, hp.seq_shard, blockers


def train_ctx(cfg: ArchConfig, hp: TrainHParams, comm: Comm,
              seq_len: int) -> TmpCtx:
    """The :class:`~repro_torch.core.schedule.TmpCtx` of a run: ``hp``'s
    schedule and sequence layout (:func:`train_layout`) over ``comm``.
    SP that a blocker turns off warns, as JAX's ``_sp_degraded`` does."""
    sp, shard, blockers = train_layout(cfg, hp, comm.size, seq_len)
    if hp.seq_parallel and not sp:
        warnings.warn(f"seq_parallel degraded: {'; '.join(blockers)}",
                      RuntimeWarning, stacklevel=2)
    return TmpCtx(comm, schedule=hp.schedule, seq_parallel=sp,
                  seq_shard=shard)


def train_loss(cfg: ArchConfig, params: Dict[str, Any],
               batch: Dict[str, torch.Tensor], hp: TrainHParams,
               ctx: Optional[TmpCtx] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch {"tokens", "labels"} [b, s] int -> (loss, aux), f32 scalars,
    the same on every rank: the body of ``build_train_loss`` on a 1-D
    model group (``ctx``, as :func:`train_ctx` makes it; None: tp=1).
    ``params`` are this rank's shards
    (:func:`~repro_torch.models.params.shard_params`).

    The vocab-parallel embedding (under SP completed by a reduce-scatter
    along the sequence, so the residual stream is this rank's chunk), the
    batch cut into :func:`~repro_torch.core.schedule.effective_split`
    sub-batches, the layer loop through
    :func:`~repro_torch.core.schedule.apply_layer` under the recomputation
    policy of ``hp`` (``repro_torch.core.remat``), the merge, the SP
    all-gather of the sequence, the final norm and the vocab-parallel
    cross entropy over the head (``embed.T`` when tied).  ``aux`` is the
    parts' auxiliary loss (the MoE router's) summed over layers and
    sub-batches and divided by the layer count, and is added to the
    loss, as in JAX (``lm.py:438-440``); 0 for dense and SSD models."""
    check_supported(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    if ctx is None:
        ctx = train_ctx(cfg, hp, SoloComm(), s)
    if ctx.schedule != hp.schedule:
        raise ValueError(f"TmpCtx schedule {ctx.schedule!r} != hp.schedule "
                         f"{hp.schedule!r}")
    sp, shard, _ = train_layout(cfg, hp, ctx.tp, s)
    if (ctx.sp, ctx.seq_shard) != (sp, shard):
        raise ValueError(
            f"TmpCtx (seq_parallel={ctx.sp}, seq_shard={ctx.seq_shard}) "
            f"does not match hp's layout (seq_parallel={sp}, "
            f"seq_shard={shard}) at seq {s}: build it with train_ctx")
    x = vocab_parallel_embed(tokens, params["embed"], ctx.comm,
                             sp_seq_dim=1 if ctx.sp else None)
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    split = effective_split(hp.schedule, hp.split, b)
    xs = split_tree(x, split)
    pos = torch.arange(s, device=tokens.device)
    if ctx.seq_shard > 1:         # the ring part's chunk of the sequence
        pos = pos.chunk(ctx.tp)[ctx.comm.rank]
    positions = [pos[None, :].expand(t.shape[0], -1) for t in xs]
    n, pat, tail = stack_layout(cfg)
    parts = {k: blocks.train_parts(cfg, ctx, k) for k in set(pat) | set(tail)}
    pol = remat.policy(hp.schedule, remat=hp.remat, fine=hp.fine_remat)

    def unit_fn(unit, *xs_in):
        xs_u, aux_u = list(xs_in), 0.0
        for kind, p in unit:
            xs_u, aux_l = apply_layer(parts[kind], p, xs_u, positions, ctx,
                                      fine=pol == "fine")
            aux_u = aux_u + aux_l
        return (*xs_u, aux_u)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit in layer_units(cfg, params):
        if pol == "coarse":
            *xs, aux_u = remat.checkpoint_layer(unit_fn, unit, *xs)
        else:
            *xs, aux_u = unit_fn(unit, *xs)
        aux = aux + aux_u
    x = ctx.gather_seq(merge_tree(xs))
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    loss_sum, count = vocab_parallel_xent(
        x, head_weight(params), labels, chunk=hp.loss_chunk,
        softcap=cfg.final_softcap, comm=ctx.comm, sp=ctx.sp)
    aux = aux / max(cfg.num_layers, 1)
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
    logits = torch.matmul(x_last.float(), head_weight(params).float())
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
    check_servable(cfg)
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
