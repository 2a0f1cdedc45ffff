"""The training step of ``repro.launch.steps.build_train_step`` on one
rank of a 1-D model group: forward and backward of
:func:`repro_torch.models.lm.train_loss` (with gradient accumulation over
microbatches), the all-reduce of the gradients that are partial per rank
under sequence parallelism and ring attention, then AdamW with the
gradient norm spanning the group."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig, TrainHParams
from repro_torch.core.comm import Comm, SoloComm
from repro_torch.models import lm
from repro_torch.models.params import (flat_leaves, flatten,
                                       partial_grad_leaves, shard_dims)
from repro_torch.optim import adamw


def auto_microbatch(global_batch: int, seq_len: int, d_model: int,
                    num_layers: int, act_shard: int = 1) -> int:
    """Gradient-accumulation count sized so one microbatch's rematerialized
    activations (~3 [t,d] bf16 tensors per layer with the fine policy) fit
    a 5e9-byte activation budget, stretched ``act_shard``-fold where the
    residuals are sharded, floored at 1 sequence (the JAX package's rule
    at one data-parallel rank, kept so both packages pick the same
    count)."""
    token_budget = 5e9 * act_shard / (3.0 * d_model * 2.0
                                      * max(num_layers, 1))
    seqs = max(1, min(global_batch, int(token_budget // max(seq_len, 1))))
    n = max(1, global_batch // seqs)
    while n > 1 and global_batch % n:
        n -= 1
    return n    # 1 = no accumulation (resolved; 0 means "auto")


def resolve_hp(hp: TrainHParams, global_batch: int, *, seq_len: int,
               d_model: int, num_layers: int, tp: int = 1) -> TrainHParams:
    """Fill the auto field of a training run (microbatch=0 -> auto).
    Sequence parallelism and ring attention (``seq_shard`` > 1) shard the
    remat residuals over the model group of ``tp`` ranks, so the
    activation budget stretches by tp (JAX's ``resolve_hp``)."""
    if hp.microbatch == 0:
        shard = tp if (hp.seq_parallel or hp.seq_shard > 1) else 1
        return dataclasses.replace(
            hp, microbatch=auto_microbatch(global_batch, seq_len, d_model,
                                           num_layers, act_shard=shard))
    return hp


def check_plan(cfg: ArchConfig, plan, tp: int = 1):
    """-> ``plan``, once it is checked to be one the port runs on a 1-D
    group of ``tp`` ranks: every layer one (degree, schedule, seq)
    strategy, the degree ``tp`` (None: the group), no pipeline and a
    recorded mesh, if any, of one data rank and ``tp`` model ranks
    (ValueError otherwise).  Raises NotImplementedError with the plan's
    summary otherwise, naming the ROADMAP.md item: A7 (mixed plans, other
    or 2-D degrees), A8 (pipelines), A4 (data parallelism); and, without
    it, for the knobs :class:`TrainHParams` refuses (the 2-D layout A7,
    gradient compression A4, virtual stages A8)."""
    plan.validate_for(cfg)

    def refuse(what: str, item: str):
        raise NotImplementedError(
            f"{plan.summary()}: the PyTorch port runs plans whose layers "
            f"share one (degree, schedule, seq) strategy of degree --tp "
            f"{tp}, not {what} (ROADMAP.md {item})")

    if plan.is_mixed:
        refuse("per-layer mixed strategies", "A7")
    layer = plan.layers[0]
    if layer.degree not in (None, tp):
        refuse(f"degree {layer.degree!r}", "A7")
    if plan.pp > 1:
        refuse(f"pp={plan.pp} pipeline stages", "A8")
    if plan.mesh_shape:
        model = math.prod(n for a, n in zip(plan.mesh_axes, plan.mesh_shape)
                          if a.startswith("model"))
        rest = math.prod(plan.mesh_shape) // model
        if rest != 1:
            refuse(f"a mesh of {rest} data ranks", "A4")
        if model != tp:
            raise ValueError(f"{plan.summary()} was made for a model group "
                             f"of {model} ranks: run it with --tp {model}")
    plan.apply(TrainHParams())      # the knobs' refusals: 2-D A7, A4, A8
    return plan


def unpack_plan(cfg: ArchConfig, hp: TrainHParams, plan,
                tp: int = 1) -> TrainHParams:
    """Project an executable :class:`~repro_torch.core.plan.ParallelPlan`
    onto the hyper-parameters the step builder consumes (JAX's
    ``unpack_plan``: ``plan.apply``) after :func:`check_plan`.  A uniform
    ring-attention ``seq`` q becomes ``seq_shard`` q."""
    hp = check_plan(cfg, plan, tp).apply(hp)
    if plan.layers[0].seq > 1:
        hp = dataclasses.replace(hp, seq_shard=plan.layers[0].seq)
    return hp


def build_train_step(cfg: ArchConfig, hp: TrainHParams, *,
                     global_batch: int, seq_len: int,
                     comm: Optional[Comm] = None
                     ) -> Callable[..., Dict[str, torch.Tensor]]:
    """-> ``train_step(params, opt_state, batch) -> {"loss", "grad_norm"}``
    (0-d f32 tensors), updating ``params`` and ``opt_state`` in place.

    With ``hp.microbatch`` n > 1 the batch arrives as [n, B/n, s]: each
    microbatch's gradients (in the parameters' dtype, as in JAX) are
    summed into f32 buffers allocated at the first step and zeroed at
    each, then divided by n, and the loss is the mean of the microbatch
    losses; the last microbatch's gradients stay on the parameters'
    ``.grad``.  Without accumulation the ``.grad`` tensors, in the
    parameters' dtype, go to the update as they are: it casts each slice
    to f32 (as JAX's ``apply_updates`` casts each leaf), so no f32 copy of
    the gradients is made.  The resolved hyper-parameters are the step's
    ``hp`` attribute and its TMP context (:func:`~repro_torch.models.lm.
    train_ctx`) its ``ctx``.  ``comm``: the model group (None: tp=1);
    ``params`` are then this rank's shards, and every rank runs the step
    on the whole batch.  The leaves whose gradient is partial per rank
    (:func:`~repro_torch.models.params.partial_grad_leaves`: the norm
    scales under SP, also the attention weights under ring attention) are
    all-reduced over the group after the microbatch loop, in one bucket,
    where JAX's ``shard_map`` boundary psums them; the norm then counts
    them once, as every replicated leaf."""
    tp = comm.size if comm is not None else 1
    hp = resolve_hp(hp, global_batch, seq_len=seq_len, d_model=cfg.d_model,
                    num_layers=cfg.num_layers, tp=tp)
    n = hp.microbatch if hp.microbatch > 1 else 1
    ocfg = adamw.AdamWConfig(
        learning_rate=hp.learning_rate, weight_decay=hp.weight_decay,
        warmup_steps=hp.warmup_steps, total_steps=hp.total_steps,
        grad_clip=hp.grad_clip)
    ctx = lm.train_ctx(cfg, hp, comm or SoloComm(), seq_len)
    sharded = [d is not None
               for d in shard_dims(cfg, ctx.tp, ctx.seq_shard).values()]
    partial = set(partial_grad_leaves(cfg, seq_parallel=ctx.sp,
                                      seq_shard=ctx.seq_shard))
    acc: List[torch.Tensor] = []       # f32 sums of the microbatches

    def train_step(params: Dict[str, Any], opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        leaves = flat_leaves(params)
        micro = ([{k: t[i] for k, t in batch.items()} for i in range(n)]
                 if n > 1 else [batch])
        if n > 1 and not acc:
            acc.extend(torch.zeros(w.shape, dtype=torch.float32,
                                   device=w.device) for w in leaves)
        for a in acc:
            a.zero_()
        loss_sum = 0.0
        for mb in micro:
            for w in leaves:
                w.grad = None
            loss, _ = lm.train_loss(cfg, params, mb, hp, ctx)
            loss.backward()
            for a, w in zip(acc, leaves):
                a.add_(w.grad)
            loss_sum = loss_sum + loss.detach()
        if n > 1:
            for a in acc:
                a.div_(n)
            grads = list(acc)
        else:
            grads = [w.grad for w in leaves]
        reduce_partial_grads(grads, [k in partial for k in flatten(params)],
                             ctx.comm)
        gnorm = adamw.apply_updates(params, grads, opt_state, ocfg,
                                    comm=ctx.comm, sharded=sharded)
        return {"loss": loss_sum / n, "grad_norm": gnorm}

    train_step.hp = hp
    train_step.ctx = ctx
    return train_step


def reduce_partial_grads(grads, partial, comm: Comm):
    """Sum the gradients marked in ``partial`` over the group, replacing
    their entries of the list (the tensors themselves are not written): one
    all-reduce of their f32 concatenation (one bucket)."""
    idx = [i for i, p in enumerate(partial) if p]
    if not idx or comm.size == 1:
        return
    total = comm.all_reduce(torch.cat([grads[i].float().reshape(-1)
                                       for i in idx]))
    for i, part in zip(idx, total.split([grads[i].numel() for i in idx])):
        grads[i] = part.view(grads[i].shape)
