"""The model: the training loss of ``repro.models.lm.build_train_loss``
over a rank mesh (1-D TMP with sequence parallelism and ring attention,
the 2-D layout, and per-layer plans whose groups mix degrees and
schedules); on one device the batched prefill of ``build_prefill``; and
over a rank mesh the decode step of ``build_decode`` and the speculative
verify of ``build_verify`` on a dense or paged state (embed,
copy-on-write, the layer loop, final norm, head, greedy token), under
the training schedules at decode shapes."""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import GLOBAL_ATTN, ArchConfig, TrainHParams
from repro_torch.core import remat
from repro_torch.core import tmp as tmpc
from repro_torch.core.comm import Comm, MeshComm, SoloComm
from repro_torch.core.schedule import (TmpCtx, apply_layer, effective_split,
                                       merge_tree, split_tree)
from repro_torch.core.tmp import (greedy_token, rms_norm,
                                  vocab_parallel_embed, vocab_parallel_xent)
from repro_torch.models import blocks
from repro_torch.models.params import (PlanGroup, check_families,
                                       check_supported, check_tp,
                                       encoder_layers, head_weight,
                                       layer_units, plan_groups,
                                       stack_layout)


def normalize_strategy(cfg: ArchConfig, hp: TrainHParams,
                       degrees: Optional[Sequence] = None,
                       schedules: Optional[Sequence[str]] = None,
                       seqs: Optional[Sequence[int]] = None):
    """One normalization of the per-layer strategy inputs
    (``lm._normalize_strategy``) -> ``(degrees, schedules, seqs, hp)``:

    * uniform per-layer schedules collapse into ``hp.schedule`` (the
      stacked path) when no degrees are pinned;
    * mixed schedules with no pinned degrees promote to the grouped path
      with mesh-following ``degree=None`` groups;
    * per-layer ring-attention ``seqs`` collapse into ``hp.seq_shard``
      when uniform over the whole stack (else they ride the grouped
      path); a uniform ``hp.seq_shard`` over a grouped plan re-expands
      into per-layer seqs;
    * the grouped path always carries an explicit schedule list, so the
      spec grouping (:func:`~repro_torch.models.params.model_specs`) and
      the execution grouping agree by construction."""
    if seqs is not None:
        seqs = list(seqs)
        if len(seqs) != cfg.num_layers:
            raise ValueError(
                f"per-layer seqs have {len(seqs)} entries for a "
                f"{cfg.num_layers}-layer model")
        if len(set(seqs)) == 1:
            hp = dataclasses.replace(hp, seq_shard=seqs[0])
            seqs = None
    if schedules is not None:
        schedules = list(schedules)
        if len(schedules) != cfg.num_layers:
            raise ValueError(
                f"per-layer schedules have {len(schedules)} entries for "
                f"a {cfg.num_layers}-layer model")
        if len(set(schedules)) == 1:
            hp = dataclasses.replace(hp, schedule=schedules[0])
            schedules = None
        elif degrees is None:
            degrees = [None] * cfg.num_layers
    if seqs is not None and degrees is None:
        degrees = [None] * cfg.num_layers
    if degrees is not None:
        degrees = list(degrees)
        if schedules is None:
            schedules = [hp.schedule] * cfg.num_layers
    if degrees is not None and seqs is None and hp.seq_shard > 1:
        seqs = [hp.seq_shard] * cfg.num_layers
        hp = dataclasses.replace(hp, seq_shard=1)
    return degrees, schedules, seqs, hp


def train_layout(cfg: ArchConfig, hp: TrainHParams, tp: int,
                 seq_len: int, *, grouped: bool = False,
                 twod: bool = False,
                 width: Optional[int] = None) -> Tuple[bool, int, List[str]]:
    """(seq_parallel, seq_shard, blockers) of a run, as JAX's
    ``build_train_loss`` decides them (``lm.py:325-375``): ring attention
    (``hp.seq_shard`` > 1) that cannot run raises (``check_tp``) and
    implies SP; ``hp.seq_parallel`` with a blocker (a group of one, a
    sequence the group does not divide, a per-layer plan, the 2-D
    layout) runs without SP, and ``blockers`` names why.  ``tp``: the
    model group's size; ``width``: the degree heads and d_ff divide by
    (dx in 2-D; default tp)."""
    check_families(cfg, tp)
    blockers = []
    if tp <= 1:
        blockers.append("the mesh has no model axes (tp=1)")
    if grouped:
        blockers.append("per-layer strategies run the grouped path "
                        "(groups shard their own sequences)")
    if seq_len % max(tp, 1):
        blockers.append(f"seq_len {seq_len} is not divisible by the model "
                        f"group size {tp}")
    if twod:
        blockers.append("the 2D layout's block entries/exits are "
                        "per-axis collectives, not the SP AG/RS pair")
    if hp.seq_shard > 1 and (grouped or twod):
        raise ValueError("seq_shard (ring attention) cannot run here: "
                         + "; ".join(blockers))
    if not grouped:
        check_tp(cfg, tp if width is None else width,
                 seq_shard=hp.seq_shard, seq_len=seq_len)
    sp = bool((hp.seq_parallel or hp.seq_shard > 1) and not blockers)
    return sp, hp.seq_shard, blockers


def train_ctx(cfg: ArchConfig, hp: TrainHParams, comm: Comm,
              seq_len: int, *, grouped: bool = False) -> TmpCtx:
    """The :class:`~repro_torch.core.schedule.TmpCtx` of a run over the
    whole model group: ``hp``'s schedule, layout (``hp.tmp_layout``) and
    sequence layout (:func:`train_layout`) over ``comm`` (a MeshComm, or
    one 1-D group's Comm).  Under a per-layer plan (``grouped``) it is
    the context of the embedding and the loss.  SP that a blocker turns
    off warns, as JAX's ``_sp_degraded`` does."""
    base = TmpCtx(comm, layout=hp.tmp_layout)
    sp, shard, blockers = train_layout(cfg, hp, base.tp_total, seq_len,
                                       grouped=grouped, twod=base.is_2d,
                                       width=base.tp)
    if hp.seq_parallel and not sp:
        warnings.warn(f"seq_parallel degraded: {'; '.join(blockers)}",
                      RuntimeWarning, stacklevel=2)
    return TmpCtx(comm, schedule=hp.schedule, seq_parallel=sp,
                  seq_shard=shard, layout=hp.tmp_layout)


def group_ctxs(cfg: ArchConfig, hp: TrainHParams, comm: MeshComm,
               degrees: Sequence, schedules: Sequence[str]
               ) -> List[Tuple[PlanGroup, TmpCtx]]:
    """The plan groups of a per-layer plan (:func:`~repro_torch.models.
    params.plan_groups`), each with its own ``TmpCtx``: the group's
    degree and schedule over ``comm``, ``hp.tmp_layout``, no SP.  Each
    group's layers must run at their width degree (``check_tp``)."""
    out = []
    for g in plan_groups(cfg, degrees, schedules):
        ctx = TmpCtx(comm, schedule=g.schedule, degree=g.degree,
                     layout=hp.tmp_layout)
        check_tp(cfg, ctx.tp)
        out.append((g, ctx))
    return out


def _layer_loop(cfg, hp, layers, xs, auxs, ctx):
    """Run ``layers`` (a list of units, each a list of (kind, leaves))
    over the sub-batches ``xs`` (each with its aux: positions and
    context) under ``ctx`` and ``hp``'s recomputation policy -> (xs,
    aux)."""
    parts = {kind: blocks.train_parts(cfg, ctx, kind)
             for unit in layers for kind, _ in unit}
    pol = remat.policy(ctx.schedule, remat=hp.remat, fine=hp.fine_remat)

    def unit_fn(unit, *xs_in):
        xs_u, aux_u = list(xs_in), 0.0
        for kind, p in unit:
            xs_u, aux_l = apply_layer(parts[kind], p, xs_u, auxs, ctx,
                                      fine=pol == "fine")
            aux_u = aux_u + aux_l
        return (*xs_u, aux_u)

    aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    for unit in layers:
        if pol == "coarse":
            *xs, aux_u = remat.checkpoint_layer(unit_fn, unit, *xs)
        else:
            *xs, aux_u = unit_fn(unit, *xs)
        aux = aux + aux_u
    return list(xs), aux


def _auxs(xs, s, device, pos=None, cross=None):
    """Each sub-batch's aux (``apply_layer``): its positions ``pos``
    (default ``arange(s)``) and its rows of the context ``cross`` [b, L,
    d] (None: no cross attention), split as the stream is (JAX's
    ``split_tree`` of ``enc_out``)."""
    pos = torch.arange(s, device=device) if pos is None else pos
    ctxs = (split_tree(cross, len(xs)) if cross is not None
            else [None] * len(xs))
    return [{"positions": pos[None, :].expand(t.shape[0], -1), "ctx": c}
            for t, c in zip(xs, ctxs)]


def run_encoder(cfg: ArchConfig, params: Dict[str, Any],
                ctx_embed: torch.Tensor) -> torch.Tensor:
    """whisper's encoder over the stub frames (``lm.py:51-73``
    ``_run_encoder`` at tp=1): ``ctx_embed`` [b, L, d] plus the encoder's
    ``pos_embed``, its layers (:func:`~repro_torch.models.blocks.
    encoder_layer`), its final norm -> [b, L, d]."""
    enc = params["encoder"]
    x = ctx_embed + enc["pos_embed"][None, :ctx_embed.shape[1]].to(
        ctx_embed.dtype)
    for p in encoder_layers(params):
        x = blocks.encoder_layer(cfg, p, x)
    return rms_norm(x, enc["final_ln"], cfg.norm_eps)


def _grouped_layers(cfg, hp, params, x, mesh: MeshComm, groups,
                    cross=None):
    """The layer loop of a per-layer plan (``lm._grouped_scan``): each
    plan group runs its layers under its own ``TmpCtx`` and sub-batch
    split of the *local* batch.  The batch is cut over the extra
    data-parallel axes of a group's degree (the model axes a lower-degree
    group does not shard over), so a group change reshards it: the
    chunks are gathered over the old axes, then cut over the new ones
    (a chunk's place is the linearized index over the whole ordered
    tuple, so gathering or cutting only the changed axes would permute
    the batch against the labels).  Ends gathered, for the loss.
    ``cross``: the context of cross attention (one rank: no reshard).
    -> (x, aux)."""
    cur = mesh.sub(())

    def reshard(x, axes):
        nonlocal cur
        new = mesh.sub(axes)
        if new is not cur:
            x = tmpc.batch_gather(x, cur, 0)
            if x.shape[0] % new.size:
                raise ValueError(
                    f"a batch of {x.shape[0]} rows does not split over the "
                    f"{new.size} extra data-parallel ranks {tuple(axes)} "
                    f"of a lower-degree group")
            x = tmpc.batch_split(x, new, 0)
            cur = new
        return x

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (g, ctx) in enumerate(groups):
        x = reshard(x, mesh.info.extra_dp_axes(g.degree))
        xs = split_tree(x, effective_split(ctx.schedule, hp.split,
                                           x.shape[0]))
        # unbound, as ``layer_units`` does: the backward stacks the layers'
        # gradients once (a slice's would be a whole-stack tensor a layer)
        per = {k: t.unbind(0) for k, t in params["groups"][gi].items()}
        layers = [[(g.kind, {k: ts[i] for k, ts in per.items()})]
                  for i in range(g.count)]
        xs, aux_g = _layer_loop(cfg, hp, layers, xs,
                                _auxs(xs, x.shape[1], x.device,
                                      cross=cross), ctx)
        aux = aux + aux_g
        x = merge_tree(xs)
    return reshard(x, ()), aux


def train_loss(cfg: ArchConfig, params: Dict[str, Any],
               batch: Dict[str, torch.Tensor], hp: TrainHParams,
               ctx: Optional[TmpCtx] = None,
               groups: Optional[List[Tuple[PlanGroup, TmpCtx]]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch {"tokens", "labels"} [b, s] int (and, for cross attention,
    "ctx" [b, L, d]: the stub frontend's embeddings) -> (loss, aux), f32
    scalars, the same on every rank: the body of ``build_train_loss`` over
    the model group (``ctx``, as :func:`train_ctx` makes it; None: tp=1).
    ``params`` are this rank's shards (:class:`~repro_torch.models.
    params.ModelLayout`); under a per-layer plan they hold ``groups``
    and ``groups`` gives each plan group's context (:func:`group_ctxs`).

    The vocab-parallel embedding (under SP completed by a reduce-scatter
    along the sequence, so the residual stream is this rank's chunk; times
    sqrt(d_model) for gemma models; plus whisper's ``pos_embed``), the
    context (the encoder's output for encoder-decoder configs,
    :func:`run_encoder`; else the stub as it is; cast to the model dtype,
    where JAX promotes the f32 stub through the bf16 products, because
    the flash kernels take one dtype), the
    batch cut into :func:`~repro_torch.core.schedule.effective_split`
    sub-batches, the layer loop through
    :func:`~repro_torch.core.schedule.apply_layer` under the recomputation
    policy of ``hp`` (``repro_torch.core.remat``), the merge, the SP
    all-gather of the sequence, the final norm and the vocab-parallel
    cross entropy over the head (``embed.T`` when tied).  A per-layer
    plan runs its groups in turn (:func:`_grouped_layers`), each with its
    own split of its share of the batch.  ``aux`` is the parts'
    auxiliary loss (the MoE router's) summed over layers and sub-batches
    and divided by the layer count, and is added to the loss, as in JAX
    (``lm.py:438-440``); 0 for dense and SSD models."""
    check_supported(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    grouped = "groups" in params
    if grouped != (groups is not None):
        raise ValueError("grouped weights and plan groups go together")
    if ctx is None:
        ctx = train_ctx(cfg, hp, SoloComm(), s)
    if ctx.schedule != hp.schedule:
        raise ValueError(f"TmpCtx schedule {ctx.schedule!r} != hp.schedule "
                         f"{hp.schedule!r}")
    sp, shard, _ = train_layout(cfg, hp, ctx.tp_total, s, grouped=grouped,
                                twod=ctx.is_2d, width=ctx.tp)
    if (ctx.sp, ctx.seq_shard) != (sp, shard):
        raise ValueError(
            f"TmpCtx (seq_parallel={ctx.sp}, seq_shard={ctx.seq_shard}) "
            f"does not match hp's layout (seq_parallel={sp}, "
            f"seq_shard={shard}) at seq {s}: build it with train_ctx")
    x = vocab_parallel_embed(tokens, params["embed"], ctx.group,
                             sp_seq_dim=1 if ctx.sp else None)
    x = _family_scale(cfg, x)
    if "pos_embed" in params:
        x = x + params["pos_embed"][None, :s].to(x.dtype)
    cross = None
    if cfg.context_len:
        if "ctx" not in batch:
            raise ValueError(f"{cfg.name} cross-attends to a context: the "
                             f"batch needs 'ctx' [b, {cfg.context_len}, d]")
        cross = batch["ctx"].to(x.dtype)
        if cfg.is_encdec:
            cross = run_encoder(cfg, params, cross)
    if grouped:
        x, aux = _grouped_layers(cfg, hp, params, x, ctx.comm, groups,
                                 cross)
    else:
        xs = split_tree(x, effective_split(hp.schedule, hp.split, b))
        pos = None
        if ctx.seq_shard > 1:         # the ring part's chunk of the sequence
            pos = torch.arange(s, device=tokens.device).chunk(
                ctx.tp_total)[ctx.group.rank]
        xs, aux = _layer_loop(cfg, hp, layer_units(cfg, params), xs,
                              _auxs(xs, s, x.device, pos, cross), ctx)
        x = ctx.gather_seq(merge_tree(xs))
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    loss_sum, count = vocab_parallel_xent(
        x, head_weight(params), labels, chunk=hp.loss_chunk,
        softcap=cfg.final_softcap, comm=ctx.group, sp=ctx.sp)
    aux = aux / max(cfg.num_layers, 1)
    return loss_sum / count + aux, aux


def apply_cow(cfg: ArchConfig, state: Dict[str, Any],
              cow_src: torch.Tensor, cow_dst: torch.Tensor):
    """Copy page ``cow_src[i]`` over page ``cow_dst[i]`` in the k and v
    pools of every GLOBAL_ATTN layer (``lm._apply_cow``), IN PLACE; the
    other layers' states are dense and stay.  All sources are gathered
    before any page is written; ``(0, 0)`` pairs copy the null page onto
    itself and change nothing."""
    _, pat, tail = stack_layout(cfg)
    entries = ([e for e, k in zip(state["blocks"], pat) if k == GLOBAL_ATTN]
               + [e for e, k in zip(state.get("tail", []), tail)
                  if k == GLOBAL_ATTN])
    for entry in entries:
        for key in ("k", "v"):
            pool = entry[key]                     # [n, pages, page, kvh, hd]
            taken = pool.index_select(1, cow_src.long())
            pool.index_copy_(1, cow_dst.long(), taken)


def last_logits(cfg: ArchConfig, params: Dict[str, Any],
                x_last: torch.Tensor) -> torch.Tensor:
    """x_last [b, d] -> f32 logits over this rank's columns of the padded
    vocab (its head shard [d, V/tp]; all of them at tp=1).  Like
    ``lm._last_logits`` this casts the head to f32 each call (a transient
    copy of the [d, V/tp] head)."""
    logits = torch.matmul(x_last.float(), head_weight(params).float())
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _family_scale(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """gemma's and recurrentgemma's ``sqrt(d_model)`` embedding scale."""
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _layers(cfg: ArchConfig, params: Dict[str, Any]):
    """(kind, position in ``blocks`` or None for the tail, repeat or tail
    index, the layer's leaves) in execution order."""
    n, pat, tail = stack_layout(cfg)
    per_pos = [{name: t.unbind(0) for name, t in blk.items()}
               for blk in params["blocks"]]
    for r in range(n):
        for j, kind in enumerate(pat):
            yield kind, j, r, {name: ts[r] for name, ts in per_pos[j].items()}
    for i, kind in enumerate(tail):
        yield kind, None, i, params["tail"][i]


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Dict[str, Any], tokens: torch.Tensor,
            ctx: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens [b, s] int32 (and, for cross attention, ``ctx`` [b,
    context_len, d]: the stub frontend's embeddings) -> (next token [b]
    int32, the decode state of the prompt): ``build_prefill`` on one
    device.  The embedding (times sqrt(d_model) for gemma models; plus
    ``pos_embed[:s]``), the context (whisper's encoder,
    :func:`run_encoder`; else the stub as it is, in the model dtype), each
    layer's :func:`~repro_torch.models.blocks.prefill_fn`, the final norm,
    the f32 head of the last position and the greedy token.  The state
    has :func:`~repro_torch.models.params.cache_specs`' tree at
    ``seq = s`` (the blocks' leaves stacked, the tail's [1, ...]), and
    its dtypes."""
    check_supported(cfg)
    b, s = tokens.shape
    x = _family_scale(cfg, vocab_parallel_embed(tokens, params["embed"]))
    if "pos_embed" in params:
        x = x + params["pos_embed"][None, :s].to(x.dtype)
    cross = None
    if cfg.context_len:
        if ctx is None:
            raise ValueError(f"{cfg.name} cross-attends to a context: "
                             f"prefill needs ctx [b, {cfg.context_len}, d]")
        cross = ctx.to(x.dtype)
        if cfg.is_encdec:
            cross = run_encoder(cfg, params, cross)
    aux = {"positions": torch.arange(s, device=x.device)[None, :]
           .expand(b, -1), "ctx": cross}
    n, pat, tail = stack_layout(cfg)
    fns = {k: blocks.prefill_fn(cfg, k) for k in set(pat) | set(tail)}
    per_pos: List[List[Dict[str, torch.Tensor]]] = [[] for _ in pat]
    state: Dict[str, Any] = {"blocks": [], "tail": []}
    for kind, j, _, p in _layers(cfg, params):
        x, st = fns[kind](p, x, aux)
        if j is None:
            state["tail"].append({k: t[None] for k, t in st.items()})
        else:
            per_pos[j].append(st)
    state["blocks"] = [{k: torch.stack([st[k] for st in sts])
                        for k in sts[0]} for sts in per_pos if sts]
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return greedy_token(last_logits(cfg, params, x[:, -1])), state


def _decode_embed(cfg: ArchConfig, params: Dict[str, Any],
                  tokens: torch.Tensor, pos: torch.Tensor,
                  ctx: TmpCtx) -> torch.Tensor:
    """The decode preamble (``lm._decode_embed``): tokens [b, qn] -> [b,
    qn, d], the vocab-parallel embedding over the model group (times
    sqrt(d_model) for gemma models; plus ``pos_embed`` at ``min(pos + j,
    rows - 1)``)."""
    x = _family_scale(cfg, vocab_parallel_embed(tokens, params["embed"],
                                                ctx.group))
    if "pos_embed" in params:
        pe = params["pos_embed"]
        qpos = pos.long()[:, None] + torch.arange(tokens.shape[1],
                                                  device=pos.device)
        x = x + pe[torch.clamp(qpos, max=pe.shape[0] - 1)].to(x.dtype)
    return x


def _stack_step(cfg: ArchConfig, params: Dict[str, Any],
                state: Dict[str, Any], x: torch.Tensor, aux: Dict[str, Any],
                fns) -> torch.Tensor:
    """Every layer's step (``fns[kind]``: a decode or verify step) on its
    views of the state, in execution order, then the final norm."""
    for kind, j, i, p in _layers(cfg, params):
        entry = state["blocks"][j] if j is not None else state["tail"][i]
        st = {k: t[i] if j is not None else t[0] for k, t in entry.items()}
        x = fns[kind](p, x, st, aux)
    return rms_norm(x, params["final_ln"], cfg.norm_eps)


def check_servable(cfg: ArchConfig, ctx: TmpCtx):
    """What serves over the model group of ``ctx``: every assigned arch at
    tp=1; the dense global-attention archs at the degrees training takes
    (:func:`~repro_torch.models.params.check_tp`, the families' A10c
    refusals first)."""
    check_supported(cfg)
    if ctx.tp_total > 1:
        check_families(cfg, ctx.tp_total)
        check_tp(cfg, ctx.tp)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Dict[str, Any],
                state: Dict[str, Any], tokens: torch.Tensor,
                pos: torch.Tensor, tables: Optional[torch.Tensor] = None,
                cow_src: Optional[torch.Tensor] = None,
                cow_dst: Optional[torch.Tensor] = None, *,
                ctx: Optional[TmpCtx] = None) -> torch.Tensor:
    """tokens [b] int32, pos [b] int32 -> next token [b] int32, the same
    on every rank: dense and paged ``build_decode`` under ``ctx`` (the
    schedule over the model group, as training's; None: one device).
    ``params`` and ``state`` (the tree of :func:`~repro_torch.models.
    params.cache_specs`, from :func:`~repro_torch.models.params.
    zeros_state` or :func:`prefill`) are this rank's shards; the state is
    updated in place.  Paged (``tables`` [b, nb] int32, the GLOBAL_ATTN
    layers' page pools): copy-on-write pages first (:func:`apply_cow`).
    The embedding (:func:`_decode_embed`), each layer's
    :func:`~repro_torch.models.blocks.decode_fn`, the final norm, this
    rank's head columns in f32 and the greedy token gathered over the
    vocab shards (:func:`~repro_torch.core.tmp.greedy_token`)."""
    ctx = ctx or TmpCtx()
    check_servable(cfg, ctx)
    if tables is not None and cow_src is not None and cow_src.numel():
        apply_cow(cfg, state, cow_src, cow_dst)
    _, pat, tail = stack_layout(cfg)
    fns = {k: blocks.decode_fn(cfg, ctx, k) for k in set(pat) | set(tail)}
    x = _stack_step(cfg, params, state, _decode_embed(
        cfg, params, tokens[:, None], pos, ctx), {"pos": pos,
                                                  "tables": tables}, fns)
    return greedy_token(last_logits(cfg, params, x[:, 0]), ctx.group)


def check_verifiable(cfg: ArchConfig):
    """The verify takes all-global-attention patterns only (JAX's
    ``build_verify`` message)."""
    _, pat, tail = stack_layout(cfg)
    other = sorted((set(pat) | set(tail)) - {GLOBAL_ATTN})
    if other:
        raise ValueError(
            f"speculative decoding requires an all-global-attention "
            f"layer pattern; {cfg.name} mixes in {other} (ring-buffer "
            f"and recurrent states cannot absorb multi-token jumps)")


@torch.no_grad()
def verify_step(cfg: ArchConfig, params: Dict[str, Any],
                state: Dict[str, Any], tokens: torch.Tensor,
                pos: torch.Tensor, tables: Optional[torch.Tensor] = None,
                cow_src: Optional[torch.Tensor] = None,
                cow_dst: Optional[torch.Tensor] = None, *,
                ctx: Optional[TmpCtx] = None) -> torch.Tensor:
    """The speculative-decoding target forward (``build_verify``): tokens
    [b, qn] int32 at positions ``pos + j`` (pos [b] int32) -> choices [b,
    qn] int32, ``choices[:, j]`` the greedy token after ``tokens[:, :j +
    1]``, what undrafted decode emits there.  One pass writes the k/v of
    all ``qn`` tokens and attends causally within the block
    (:func:`~repro_torch.models.blocks.verify_fn`), under ``ctx`` as
    :func:`decode_step` (its exits ring over the block under ``fused``),
    dense or paged (copy-on-write first), then the final norm, the f32
    head over all ``b * qn`` rows and the greedy tokens.  All-global
    patterns only."""
    ctx = ctx or TmpCtx()
    check_servable(cfg, ctx)
    check_verifiable(cfg)
    b, qn = tokens.shape
    if tables is not None and cow_src is not None and cow_src.numel():
        apply_cow(cfg, state, cow_src, cow_dst)
    x = _stack_step(cfg, params, state, _decode_embed(
        cfg, params, tokens, pos, ctx), {"pos": pos, "tables": tables},
        {GLOBAL_ATTN: blocks.verify_fn(cfg, ctx, GLOBAL_ATTN)})
    logits = last_logits(cfg, params, x.reshape(b * qn, -1))
    return greedy_token(logits, ctx.group).reshape(b, qn)
