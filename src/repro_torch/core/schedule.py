"""The five TMP training schedules of ``repro.core.schedule`` (paper §3,
Fig. 3, Alg. 1-2), 1-D, as eager program order.

* ``megatron`` — one batch, each row-parallel exit a blocking all-reduce.
* ``wang``     — each exit product cut into ``wang_chunks`` chunks along
  the sequence; chunk i's all-reduce is started before chunk i+1's
  product (intra-op overlap).
* ``merak``    — two sub-batches, pass barriers kept, coarse recomputation
  (the whole layer, collectives included).
* ``oases``    — two sub-batches in Alg. 1's order: sub-batch j's exit
  all-reduce is started asynchronously and waited for only at its
  residual add, so it runs under sub-batch j+1's compute; with
  ``fine_remat`` the recomputation holds no collective.
* ``fused``    — each exit is one fused matmul -> all-reduce
  (:mod:`repro_torch.kernels.collective_matmul`).  On a CUDA device it
  always launches the ring kernel (``csrc/ring_matmul_rs.cu``) and the
  peer all-gather; the ``ring_shift`` decomposition of the same ring is
  the CPU path.

Sequence parallelism (``seq_parallel``, Megatron-SP): the residual stream
stays cut along the sequence; each block entry all-gathers it (``fused``:
one all-gather feeding every entry product) and each exit reduce-scatters
(``fused``: the ring kernel's scatter alone, no all-gather after it;
``wang`` does not chunk).  Ring attention (``seq_shard`` = the group
size) keeps the attention part sequence-local with replicated weights and
the KV shards circulating (:mod:`repro_torch.kernels.ring_attention`);
the MLP part runs SP.

The 2-D layout (``layout`` auto or 2d on a mesh with y axes: a
``model_x`` / ``model_y`` mesh, or a 2-D ``(dx, dy)`` degree on the
factored mesh): weight *width* (heads, d_ff) shards over the x axes and
the *contraction* dim (d_model) over the y axes.  A block entry slices
this rank's d_model chunk of the replicated input (free; its backward
all-gathers over y), passes it through f over x alone, and each entry
product is a ``proj``: the partial product summed over y (``fused``: the
ring kernel over the y communicator).  An exit sums its partial product
over x (``fused``: the ring kernel over the x communicator) and
all-gathers the y-sharded output columns; its backward slices the
output's cotangent to those columns and sums the input's cotangent over
y (the input is replicated over y but fed only this rank's columns).
Under fine recomputation the outputs of the y sums are kept, so the
replay runs no collective.  The SP pair and ``wang``'s chunking are 1-D
forms; in 2-D every schedule's exit waits for its collectives.

What overlaps: on a box of several cards the structure above lets a
collective run beside the next compute (the communication stream of
``PeerComm``, gloo's background thread).  On one card shared by the rank
processes, the processes are time-sliced and nothing overlaps; the
structure is there all the same.  Not taken yet: the Pallas switch
(ROADMAP.md A2).

Phase ranges (:mod:`repro_torch.obs.tracing`, JAX's names):
``tmp.<schedule>.row_matmul`` around each exit, ``gather_matmul`` around
each column-parallel entry, ``proj`` around each 2-D entry product (in
its entry's range) and ``sub<j>`` around sub-batch j's part in
:func:`apply_layer`, each over its backward too, while a profiler
records.  Under ``oases`` an exit's collective is waited for at the
residual add, outside its ``row_matmul`` range.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import remat
from repro_torch.core import tmp as tmpc
from repro_torch.core.axes import Degree, deg_total, deg_xy
from repro_torch.core.comm import Comm, MeshComm, Pending, SoloComm
from repro_torch.obs.tracing import phase_scope, scoped
# one schedule set for the schedules, the plans and the planner
from repro_torch.core.plan import SCHEDULES, validate_schedule  # noqa: F401


@dataclass(frozen=True)
class TmpCtx:
    """Per-layer TMP context: the communicator, the layer's ``degree``
    and ``layout``, the schedule, and the sequence layout
    (``seq_parallel``; ``seq_shard`` > 1: ring attention over the group).

    ``comm`` is a :class:`~repro_torch.core.comm.MeshComm`, whose axes
    the degree and layout pick (JAX's ``TmpCtx`` over ``MeshInfo``:
    ``layout="1d"`` flattens the degree's axes into x), or one group's
    Comm, the 1-D group of the whole model (degree None or its size).
    ``x_comm`` shards the width (heads, d_ff), ``y_comm`` the contraction
    dim and ``group`` is both."""
    comm: Comm = field(default_factory=SoloComm)
    schedule: str = "oases"
    wang_chunks: int = 4
    seq_parallel: bool = False
    seq_shard: int = 1
    degree: Degree = None
    layout: str = "auto"

    def __post_init__(self):
        validate_schedule(self.schedule)
        if isinstance(self.comm, MeshComm):
            info = self.comm.info
            if self.layout == "1d":
                ax, ay = info.tp_axes(deg_total(self.degree)), ()
            else:
                ax, ay = info.xy_axes(self.degree)
            x, y, group = (self.comm.sub(ax), self.comm.sub(ay),
                           self.comm.sub(ax + ay))
        else:
            if deg_total(self.degree) not in (None, self.comm.size) \
                    or (self.layout != "1d" and deg_xy(self.degree)[1] > 1):
                raise ValueError(
                    f"degree {self.degree!r} over a group of "
                    f"{self.comm.size}: other and 2-D degrees need a "
                    f"MeshComm")
            x = group = self.comm
            y = SoloComm()
        object.__setattr__(self, "x_comm", x)
        object.__setattr__(self, "y_comm", y)
        object.__setattr__(self, "group", group)

    @property
    def tp(self) -> int:
        """The *width*-sharding degree (heads and d_ff divide by it): dx
        in 2-D, the whole group in 1-D."""
        return self.x_comm.size

    @property
    def tp_y(self) -> int:
        return self.y_comm.size

    @property
    def tp_total(self) -> int:
        return self.group.size

    @property
    def is_2d(self) -> bool:
        return self.y_comm.size > 1

    @property
    def sp(self) -> bool:
        """Sequence parallelism is on (1-D, a group of more than one
        rank)."""
        return self.seq_parallel and self.tp_total > 1 and not self.is_2d

    def reduce(self, x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
        """The exit collective alone: a reduce-scatter along the sequence
        under SP, else the all-reduce."""
        if self.sp:
            return tmpc.sp_reduce_scatter(x, self.group, seq_dim)
        return tmpc.tmp_reduce(x, self.group)

    def gather_seq(self, x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
        """Block entry under SP: reassemble the whole sequence."""
        if self.sp:
            return tmpc.sp_all_gather(x, self.group, seq_dim)
        return x

    def shard_seq(self, x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
        """Under SP, this rank's sequence chunk of a replicated tensor."""
        if self.sp:
            return tmpc.batch_split(x, self.group, seq_dim)
        return x

    def _ring_dim(self, x: torch.Tensor, preferred: int,
                  comm: Optional[Comm] = None) -> int:
        """Chunking dim of a fused all-reduce ring over ``comm`` (default
        the group): the sequence, or at decode shapes (sequence 1)
        another dim the ring's size divides (``TmpCtx._ring_dim`` of
        JAX)."""
        if x.shape[preferred] != 1:
            return preferred
        n = (comm or self.group).size
        for dim in range(x.dim() - 1):
            if dim != preferred and n > 1 and x.shape[dim] % n == 0:
                return dim
        return preferred

    def row_matmul(self, x: torch.Tensor, w: torch.Tensor,
                   seq_dim: int = 1, *, full_out: Optional[int] = None,
                   replay: bool = False) -> Pending:
        """x [..., K_local] @ w [K_local, D] followed by the all-reduce (a
        reduce-scatter along ``seq_dim`` under SP), as a handle whose
        ``wait()`` gives the result.  Only ``oases`` without SP, in 1-D,
        leaves the collective running past the return.  One
        differentiable op (:func:`~repro_torch.core.tmp.row_exit`) that
        saves x and w; under ``replay`` (fine recomputation replaying the
        part) it computes and communicates nothing, and the handle's
        tensor is left unset: the replay needs only what is saved.

        2-D: the sum over x, then, where w's output columns are y-sharded
        (``full_out`` set and wider than w), the all-gather of the
        columns over y back to ``full_out``."""
        phase = f"tmp.{self.schedule}.row_matmul"
        with phase_scope(phase):
            if self.is_2d:
                cols = full_out is not None and w.shape[-1] != full_out
                return tmpc.row_exit(
                    x, w, lambda x, w: self._exit_2d(
                        x, w, seq_dim, full_out if cols else None, replay),
                    cols_comm=self.y_comm if cols else None, phase=phase)
            if self.sp:
                return tmpc.row_exit(
                    x, w, lambda x, w: self._sp_exit(x, w, seq_dim, replay),
                    comm=self.group, gather_dim=seq_dim, phase=phase)
            return tmpc.row_exit(
                x, w, lambda x, w: self._exit(x, w, seq_dim, replay),
                phase=phase)

    def local_matmul(self, x: torch.Tensor, w: torch.Tensor, *,
                     replay: bool = False) -> Pending:
        """The exit of the ring-attention part: ``x @ w`` with replicated
        weights and no collective, as one op that saves x and w (so fine
        recomputation's replay skips it, as :meth:`row_matmul`'s)."""
        return tmpc.row_exit(x, w, lambda x, w: Pending(
            self._placeholder(x, w, None) if replay else torch.matmul(x, w),
            None))

    def _placeholder(self, x, w, scatter_dim,
                     width: Optional[int] = None) -> torch.Tensor:
        """The unset output of a replayed exit, of the exit's shape."""
        shape = list(x.shape[:-1]) + [width or w.shape[1]]
        if scatter_dim is not None:
            shape[scatter_dim] //= self.tp_total
        return x.new_empty(shape)

    def _exit_2d(self, x, w, seq_dim, full_out, replay) -> Pending:
        """The 2-D exit's forward: the sum of the partial products over x
        (``fused``: the ring kernel over the x communicator), then the
        all-gather of the output columns over y when ``full_out``."""
        if replay:
            return Pending(self._placeholder(x, w, None, full_out), None)
        if self.schedule == "fused" and self.tp > 1 and x.dim() >= 2:
            from repro_torch.kernels import collective_matmul as cm
            y = cm.matmul_allreduce(
                x, w, self.x_comm, scatter_dim=self._ring_dim(
                    x, min(seq_dim, x.dim() - 2), self.x_comm))
        else:
            y = self.x_comm.all_reduce(torch.matmul(x, w))
        if full_out is not None:
            y = self.y_comm.all_gather(y, y.dim() - 1)
        return Pending(y, None)

    def _exit(self, x, w, seq_dim, replay) -> Pending:
        if replay:
            return Pending(self._placeholder(x, w, None), None)
        if self.schedule == "fused" and self.tp > 1 and x.dim() >= 2:
            from repro_torch.kernels import collective_matmul as cm
            return Pending(cm.matmul_allreduce(
                x, w, self.group,
                scatter_dim=self._ring_dim(x, min(seq_dim, x.dim() - 2))),
                None)
        if self.schedule == "wang" and x.dim() >= 2:
            n, dim = self.wang_chunks, x.dim() - 2
            if x.shape[dim] % n == 0 and x.shape[dim] >= n:
                pend = [self.group.all_reduce_async(torch.matmul(c, w))
                        for c in x.chunk(n, dim=dim)]
                return Pending(torch.cat([p.wait() for p in pend], dim=dim),
                               None)
        pend = self.group.all_reduce_async(torch.matmul(x, w))
        return pend if self.schedule == "oases" else Pending(pend.wait(),
                                                             None)

    def _sp_exit(self, x, w, seq_dim, replay) -> Pending:
        """The SP exit's forward: ``fused`` runs the matmul ->
        reduce-scatter ring (the ring kernel on the card), every other
        schedule the product and the reduce-scatter."""
        if replay:
            return Pending(self._placeholder(x, w, seq_dim), None)
        if self.schedule == "fused":
            from repro_torch.kernels import collective_matmul as cm
            return Pending(cm.matmul_reducescatter_fwd(x, w, self.group,
                                                       seq_dim), None)
        return Pending(self.group.reduce_scatter(torch.matmul(x, w),
                                                 seq_dim), None)

    def gather_matmul(self, x: torch.Tensor, ws: Sequence[torch.Tensor],
                      seq_dim: int = 1, *, keep=None) -> tuple:
        """Column-parallel block entry: one product per weight.  ``x``
        passes through f; under SP its sequence is gathered first
        (``fused``: one all-gather feeds every product).  2-D: x's
        d_model chunk (:meth:`contract_slice`, once) passes through f
        over x and each product is a :meth:`proj`.  ``keep``: fine
        recomputation's state of the enclosing part (the 2-D sums' outputs
        are kept)."""
        return scoped(f"tmp.{self.schedule}.gather_matmul",
                      self._gather_matmul, x, tuple(ws), seq_dim, keep)

    def _gather_matmul(self, x, ws, seq_dim, keep) -> tuple:
        if self.is_2d:
            rows = {w.shape[0] for w in ws}
            if len(rows) != 1:
                raise ValueError(f"entry weights with rows {sorted(rows)}")
            xy, partial = self.contract_slice(x, rows.pop())
            h = tmpc.copy_to_tmp(xy, self.x_comm)
            if not partial:
                return tuple(torch.matmul(h, w) for w in ws)
            return tuple(self.proj(h, w, keep=keep) for w in ws)
        if self.sp:
            if self.schedule == "fused":
                from repro_torch.kernels import collective_matmul as cm
                return cm.fused_allgather_matmul(x, ws, self.group, seq_dim)
            h = self.gather_seq(x, seq_dim)
        else:
            h = tmpc.copy_to_tmp(x, self.group)
        return tuple(torch.matmul(h, w) for w in ws)

    def contract_slice(self, x: torch.Tensor,
                       w_rows: int) -> Tuple[torch.Tensor, bool]:
        """(x's chunk of a y-sharded contraction dim, True), or (x, False)
        when the weight has full rows (``w_rows``: its leading dim).  The
        slice is free; its backward all-gathers over y."""
        if self.is_2d and w_rows != x.shape[-1]:
            return tmpc.batch_split(x, self.y_comm, x.dim() - 1), True
        return x, False

    def proj(self, xy: torch.Tensor, w: torch.Tensor, *,
             keep=None) -> torch.Tensor:
        """A 2-D entry product: ``xy`` (this rank's d_model chunk, from
        :meth:`contract_slice`) @ w (its rows), summed over y: the
        all-reduce, or under ``fused`` the ring kernel over the y
        communicator.  One op that saves xy and w, whose backward is the
        product's alone (the output's cotangent is whole on every rank).
        Under fine recomputation (``keep``) the sum's output is kept in
        the first run and handed back in the replay, which communicates
        nothing."""
        phase = f"tmp.{self.schedule}.proj"

        def run(x, w):
            if self.schedule == "fused" and x.dim() >= 2:
                from repro_torch.kernels import collective_matmul as cm
                return cm.matmul_allreduce(
                    x, w, self.y_comm, scatter_dim=self._ring_dim(
                        x, min(1, x.dim() - 2), self.y_comm))
            return self.y_comm.all_reduce(torch.matmul(x, w))

        with phase_scope(phase):
            return tmpc.row_exit(
                xy, w, lambda x, w: Pending(remat.kept(
                    keep, lambda: run(x, w)), None), phase=phase).wait()


def split_tree(x: torch.Tensor, split: int) -> List[torch.Tensor]:
    """Split the leading (batch) dim into ``split`` sub-batches."""
    return list(x.chunk(split, dim=0)) if split > 1 else [x]


def merge_tree(subs: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat(subs, dim=0) if len(subs) > 1 else subs[0]


def effective_split(schedule: str, split: int, local_batch: int) -> int:
    """Sub-batch split factor: oases/merak split (paper: 2) when
    divisible; megatron, wang and fused run the whole batch in one pass."""
    validate_schedule(schedule)
    if schedule in ("megatron", "wang", "fused"):
        return 1
    s = min(split, local_batch)
    while s > 1 and local_batch % s:
        s -= 1
    return max(s, 1)


@dataclass(frozen=True)
class Part:
    """One residual part of a layer: ``body(p, x, aux, keep) -> a``, the
    compute from the part's input up to the exit product's input, and
    ``exit``, the name of the exit weight (``a @ p[exit]``, followed by the
    schedule's collective unless ``collective`` is False).  ``aux`` is the
    sub-batch's ``{"positions": [b, s], "ctx": [b, L, d] or None}`` (JAX's
    per-sub-batch aux: the cross part reads the context).  ``keep`` is the
    fine-recomputation state of the call
    (:class:`~repro_torch.core.remat.Keep`, None outside it): a body that
    holds an op whose replay must not run again (ring attention) passes it
    to that op.  ``post(p, delta) -> delta``: a step after the exit and
    its collective, before the residual add (gemma2's post-norm, the cross
    part's ``tanh`` gate); it runs outside fine recomputation's replay.

    An exit-less part (``exit`` None) has a body that returns the residual
    delta itself and its auxiliary loss, ``(delta, aux)``: the MoE FFN,
    whose combine is its exit and whose reduce is the identity at tp=1.
    ``full_out``: the exit's whole output width, whose columns a 2-D
    exit gathers over y (None in 1-D)."""
    body: Callable
    exit: Optional[str] = None
    collective: bool = True
    full_out: Optional[int] = None
    post: Optional[Callable] = None


def apply_layer(parts: Sequence[Part], p, xs: List[torch.Tensor],
                auxs: List[dict], ctx: TmpCtx, *,
                fine: bool = False
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Run one layer's residual parts over the sub-batches (``auxs``:
    each sub-batch's aux, see :class:`Part`) in Alg. 1's program order:
    for each part, (compute_j, collective_j) for every sub-batch j, then
    the residual adds (each after the part's ``post`` step).  Under
    ``oases`` collective_j is started and waited for only at sub-batch
    j's residual add, so it is independent of compute_{j+1}.  ``fine``
    runs each part's body and exit under a checkpoint whose replay skips
    the exit (:func:`repro_torch.core.remat.checkpoint_part`); an
    exit-less part's replay is its whole body (:func:`repro_torch.core.
    remat.checkpoint_body`).  -> (xs, aux): the parts' auxiliary losses
    summed over parts and sub-batches (f32 scalar, JAX's ``aux_total``)."""
    def part_exit(part, keep, p, x, sub):
        replay = keep is not None and keep.replay
        a = part.body(p, x, sub, keep)
        if not part.collective:
            return ctx.local_matmul(a, p[part.exit], replay=replay)
        kw = {} if part.full_out is None else {"full_out": part.full_out}
        return ctx.row_matmul(a, p[part.exit], replay=replay, **kw)

    def body(part, x, sub):
        if fine:
            return remat.checkpoint_body(part.body, p, x, sub)
        return part.body(p, x, sub, None)

    def exit_part(part, x, sub):
        run = functools.partial(part_exit, part)
        if fine:
            return remat.checkpoint_part(run, p, x, sub)
        return run(None, p, x, sub)

    aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    for part in parts:
        # sub-batch ranges: Alg. 1's (compute_j, collective_j) chunks are
        # attributable per sub-batch in a profile
        run = functools.partial(exit_part if part.exit else body, part)
        outs = [scoped(f"tmp.{ctx.schedule}.sub{j}", run, x, a)
                for j, (x, a) in enumerate(zip(xs, auxs))]
        if part.exit is None:
            xs = [x + d for x, (d, _) in zip(xs, outs)]
            for _, a in outs:
                aux = aux + a
            continue
        post = part.post or (lambda p, d: d)
        xs = [x + post(p, d.wait()) for x, d in zip(xs, outs)]
    if ctx.schedule == "merak":
        xs = [tmpc.pass_barrier(x) for x in xs]
    return xs, aux
