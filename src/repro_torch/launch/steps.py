"""The training step of ``repro.launch.steps.build_train_step`` on one
rank of a rank mesh: forward and backward of
:func:`repro_torch.models.lm.train_loss` (with gradient accumulation over
microbatches; a per-layer plan runs grouped), the sums of the gradients
that are partial per rank (under sequence parallelism and ring
attention, and over the extra data-parallel ranks of a lower-degree plan
group), then AdamW with the gradient norm spanning the ranks, each
distinct shard counted once."""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig, TrainHParams
from repro_torch.core.axes import T_AXES, RankMesh, deg_total, mesh_info
from repro_torch.core.comm import Comm, MeshComm, SoloComm, solo_mesh
from repro_torch.core.schedule import TmpCtx
from repro_torch.models import lm
from repro_torch.models.params import (ModelLayout, PlanGroup,
                                       check_families, flat_leaves,
                                       model_specs, partial_grad_leaves)
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


def plan_mesh(comm: Optional[Comm]) -> RankMesh:
    """The rank mesh a communicator spans: a MeshComm's, else the 1-D
    ``(1, size)`` mesh of ``("data", "model")``."""
    if isinstance(comm, MeshComm):
        return comm.mesh
    return RankMesh((1, comm.size if comm is not None else 1),
                    ("data", "model"))


def _refusal(plan, mesh: RankMesh):
    def refuse(what: str, item: str):
        raise NotImplementedError(
            f"{plan.summary()}: the PyTorch port runs per-layer (degree, "
            f"schedule) plans on one data rank of a {mesh.shape} "
            f"{mesh.axis_names} mesh, not {what} (ROADMAP.md {item})")
    return refuse


def check_plan(cfg: ArchConfig, plan, mesh=1):
    """-> ``plan``, once it is checked to be one the port runs on the rank
    ``mesh`` (a RankMesh, or a model group size: the 1-D mesh): per-layer
    degrees up to the mesh's model group, mixed ones and 2-D ones on the
    factored mesh, 2-D ones on a ``model_x`` / ``model_y`` mesh of that
    layout (ValueError with JAX's messages otherwise), and a recorded
    mesh, if any, equal to ``mesh`` (ValueError).  Raises
    NotImplementedError with the plan's summary, naming the ROADMAP.md
    item, for what the port does not run yet: a ``data`` axis above 1
    (A4), pipelines (A8), per-layer ring-attention seqs (A9) and the MoE,
    SSD and RG-LRU families at more than one rank (A10c); and,
    without it, for the knobs :class:`TrainHParams` refuses (gradient
    compression A4, virtual stages A8)."""
    plan.validate_for(cfg)
    if not isinstance(mesh, RankMesh):
        mesh = RankMesh((1, mesh), ("data", "model"))
    info = mesh_info(mesh)
    refuse = _refusal(plan, mesh)
    if plan.pp > 1 or info.pp > 1:
        refuse(f"pp={max(plan.pp, info.pp)} pipeline stages", "A8")
    if info.dp > 1:
        refuse(f"a mesh of {info.dp} data ranks", "A4")
    check_families(cfg, info.tp)
    if plan.mesh_shape and (tuple(plan.mesh_shape), tuple(plan.mesh_axes)) \
            != (mesh.shape, mesh.axis_names):
        model = math.prod(n for a, n in zip(plan.mesh_axes, plan.mesh_shape)
                          if a.startswith("model") or a in T_AXES)
        raise ValueError(f"{plan.summary()} was made for the mesh "
                         f"{plan.mesh_shape} {plan.mesh_axes}, a model "
                         f"group of {model} ranks: run it with --tp "
                         f"{model} and its mesh")
    degrees, _, seqs, _ = plan_layers(cfg, TrainHParams(), plan)
    if seqs is not None:
        refuse("per-layer ring-attention seqs", "A9")
    if degrees is not None:
        model_specs(cfg, info, degrees=degrees)   # JAX's degree errors
        for d in set(degrees):
            if plan.tmp_layout == "1d":
                info.tp_axes(deg_total(d))
            else:
                info.xy_axes(d)
    plan.apply(TrainHParams())      # the knobs' refusals: A4, A8
    return plan


def plan_layers(cfg: ArchConfig, hp: TrainHParams, plan):
    """A plan's per-layer strategy normalized (JAX's ``unpack_plan`` then
    ``_normalize_strategy``) -> ``(degrees, schedules, seqs, hp)``:
    degrees None for the stacked layout."""
    scheds = (None if plan.uniform_schedule is not None
              else list(plan.schedules))
    return lm.normalize_strategy(cfg, plan.apply(hp), plan.planned_degrees,
                                 scheds, plan.planned_seqs)


def unpack_plan(cfg: ArchConfig, hp: TrainHParams, plan,
                mesh=1) -> TrainHParams:
    """Project an executable :class:`~repro_torch.core.plan.ParallelPlan`
    onto the hyper-parameters the step builder consumes (JAX's
    ``unpack_plan``: ``plan.apply``) after :func:`check_plan`.  A uniform
    ring-attention ``seq`` q becomes ``seq_shard`` q; the per-layer
    degrees and schedules come from :func:`plan_layers`."""
    check_plan(cfg, plan, mesh)
    return plan_layers(cfg, hp, plan)[3]


def build_train_step(cfg: ArchConfig, hp: TrainHParams, *,
                     global_batch: int, seq_len: int,
                     comm: Optional[Comm] = None,
                     degrees: Optional[Sequence] = None,
                     schedules: Optional[Sequence[str]] = None
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
    the gradients is made.

    ``comm``: the ranks (a MeshComm, or one 1-D group's Comm; None: one
    rank); ``params`` are then this rank's shards in the step's
    ``layout`` (a :class:`~repro_torch.models.params.ModelLayout`), and
    every rank runs the step on the whole batch.  ``degrees`` /
    ``schedules``: a per-layer plan (:func:`plan_layers`; normalized as
    JAX's ``_normalize_strategy``), which runs grouped on a MeshComm.
    After the microbatch loop the step sums, in one bucket each: the
    leaves whose gradient is partial per rank under SP and ring
    attention (:func:`~repro_torch.models.params.partial_grad_leaves`,
    over the group), and the leaves of each plan group with extra data
    parallelism, over those axes (``ModelLayout.grad_replicas``), where
    JAX's ``shard_map`` boundary psums them; the norm then counts each
    distinct shard once.  The resolved hyper-parameters are the step's
    ``hp`` attribute, its TMP context (:func:`~repro_torch.models.lm.
    train_ctx`) its ``ctx``, the plan groups' contexts its ``groups``."""
    hp = resolve_hp(hp, global_batch, seq_len=seq_len, d_model=cfg.d_model,
                    num_layers=cfg.num_layers,
                    tp=plan_mesh(comm).size if comm is not None else 1)
    setup = train_setup(cfg, hp, seq_len=seq_len, comm=comm,
                        degrees=degrees, schedules=schedules)
    hp, comm, ctx, groups, layout = (setup.hp, setup.comm, setup.ctx,
                                     setup.groups, setup.layout)
    info = layout.info
    n = hp.microbatch if hp.microbatch > 1 else 1
    ocfg = adamw.AdamWConfig(
        learning_rate=hp.learning_rate, weight_decay=hp.weight_decay,
        warmup_steps=hp.warmup_steps, total_steps=hp.total_steps,
        grad_clip=hp.grad_clip)
    names = list(layout.specs)
    for g, _ in groups or ():
        extra = info.extra_dp_axes(g.degree)
        if (global_batch // n) % info._size(extra):
            raise ValueError(
                f"a microbatch of {global_batch // n} rows does not split "
                f"over the {info._size(extra)} extra data-parallel ranks "
                f"{extra} of a degree-{g.degree} group")
    # one gradient bucket per communicator: the SP partial leaves over the
    # group, each plan group's leaves over its extra data-parallel axes
    partial = set(partial_grad_leaves(cfg, seq_parallel=ctx.sp,
                                      seq_shard=ctx.seq_shard))
    buckets: Dict[Comm, List[int]] = {}
    for i, k in enumerate(names):
        c = (ctx.group if k in partial
             else comm.sub(layout.grad_replicas(k)) if layout.grouped
             else None)
        if c is not None and c.size > 1:
            buckets.setdefault(c, []).append(i)
    world = comm.size
    counted = [None if layout.holders(k) == world
               else layout.holds_first(k, comm.rank) for k in names]
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
            loss, _ = lm.train_loss(cfg, params, mb, hp, ctx, groups)
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
        for c, idx in buckets.items():
            reduce_grads(grads, idx, c)
        gnorm = adamw.apply_updates(params, grads, opt_state, ocfg,
                                    comm=comm, counted=counted)
        return {"loss": loss_sum / n, "grad_norm": gnorm}

    train_step.hp = hp
    train_step.ctx = ctx
    train_step.groups = groups
    train_step.layout = layout
    return train_step


@dataclass(frozen=True)
class TrainSetup:
    """What a rank trains with: the normalized hyper-parameters, its
    communicators, the whole model group's ``TmpCtx``, a per-layer plan's
    groups with their contexts (None: the stacked layout) and the
    model's layout on the mesh."""
    hp: TrainHParams
    comm: Comm
    ctx: TmpCtx
    groups: Optional[List[Tuple[PlanGroup, TmpCtx]]]
    layout: ModelLayout


def train_setup(cfg: ArchConfig, hp: TrainHParams, *, seq_len: int,
                comm: Optional[Comm] = None,
                degrees: Optional[Sequence] = None,
                schedules: Optional[Sequence[str]] = None) -> TrainSetup:
    """Normalize a per-layer strategy (JAX's ``_normalize_strategy``;
    per-layer seqs raise, ROADMAP.md A9) and build the contexts and the
    layout of :func:`build_train_step` for ``comm`` (None: one rank).
    Every rank builds the same communicators in the same order: the
    whole group's, each plan group's x, y and both, and each group's
    extra data-parallel axes."""
    comm = comm or SoloComm()
    degrees, schedules, seqs, hp = lm.normalize_strategy(cfg, hp, degrees,
                                                         schedules)
    if seqs is not None:
        raise NotImplementedError(
            "per-layer ring-attention seqs run the grouped path with ring "
            "groups, not ported yet (ROADMAP.md A9)")
    grouped = degrees is not None
    if grouped and not isinstance(comm, MeshComm):
        comm = plan_comm(comm)
    info = (comm.info if isinstance(comm, MeshComm)
            else mesh_info(plan_mesh(comm)))
    ctx = lm.train_ctx(cfg, hp, comm, seq_len, grouped=grouped)
    groups = None
    if grouped:
        groups = lm.group_ctxs(cfg, hp, comm, degrees, schedules)
        comm.build([info.extra_dp_axes(g.degree) for g, _ in groups])
    return TrainSetup(hp, comm, ctx, groups,
                      ModelLayout(cfg, info, degrees, schedules,
                                  hp.tmp_layout, ctx.seq_shard,
                                  max_pos=seq_len))


def plan_comm(comm: Comm) -> MeshComm:
    """A per-layer plan needs a MeshComm; a one-rank run gets the
    ``(1, 1)`` mesh."""
    if comm.size == 1:
        return solo_mesh()
    raise ValueError("a per-layer plan runs over a MeshComm "
                     "(launch/ranks.py hands one to each rank)")


# elements a gradient bucket sends at once (256 MB of f32)
BUCKET_PIECE = 1 << 26


def reduce_grads(grads: List[torch.Tensor], idx: Sequence[int], comm: Comm):
    """Sum the gradients at ``idx`` over ``comm`` in place, as one bucket
    sent in pieces of at most ``BUCKET_PIECE`` elements: consecutive leaves of
    one dtype share a piece (their concatenation), a larger leaf goes in
    slices, so the transient is two pieces.  Each sum is the collective's:
    f32 in rank order, cast once to the gradient's dtype (JAX's boundary
    psum keeps the leaf's dtype too)."""
    if not idx or comm.size == 1:
        return
    for i in idx:
        if not grads[i].is_contiguous():
            grads[i] = grads[i].contiguous()
    piece = BUCKET_PIECE
    segs = [grads[i].view(-1)[lo:lo + piece] for i in idx
            for lo in range(0, grads[i].numel(), piece)]
    chunks: List[List[torch.Tensor]] = [[]]
    for seg in segs:
        if chunks[-1] and (chunks[-1][0].dtype != seg.dtype or sum(
                t.numel() for t in chunks[-1]) + seg.numel() > piece):
            chunks.append([])
        chunks[-1].append(seg)
    for chunk in chunks:
        total = comm.all_reduce(chunk[0] if len(chunk) == 1
                                else torch.cat(chunk))
        for seg, part in zip(chunk, total.split([t.numel() for t in chunk])):
            seg.copy_(part)
