"""Tensor-model-parallel primitives of ``repro.core.tmp`` over a
:class:`~repro_torch.core.comm.Comm`: the TMP all-reduce, the norm, the
vocab-parallel embedding and cross entropy, and greedy sampling.  At
tp=1 the communicator is a :class:`~repro_torch.core.comm.SoloComm` and
every collective is the identity, on the same code path.

Gradient convention: Megatron's f/g pair.  :func:`copy_to_tmp` (f) is the
identity forward and an all-reduce backward, at every column-parallel
entry; :func:`reduce_from_tmp` (g) is an all-reduce forward and the
identity backward, at every row-parallel exit.  A layer issues 2
collectives forward and 2 backward, as in JAX, whose ``shard_map``
transpose instead uses partial cotangents (``psum`` transposes to
``psum``).  Under f/g the activation cotangents of replicated tensors are
whole on every rank, so replicated leaves (the norm scales) get the same
whole gradient on every rank and sharded leaves their shard's: gathered,
they equal JAX's.  The outputs of g are the residuals that fine
recomputation keeps (``repro_torch.core.remat``): Eq. (1) of the paper
makes their gradient the identity, so g saves nothing and its backward
runs no collective.  A row-parallel exit is the product and g in one
op (:func:`row_exit`), whose backward is the product's alone.

Sequence parallelism (Megatron-SP) keeps the residual stream cut along
the sequence, each rank holding its chunk, and replaces the pair: the
column-parallel entry gathers the sequence (:func:`sp_all_gather`:
all-gather forward, reduce-scatter backward, in place of f) and the
row-parallel exit scatters it (:func:`sp_reduce_scatter`: reduce-scatter
forward, all-gather backward, in place of g; the exit op's SP form).  The
rule that makes this consistent with f/g: the cotangent of a tensor cut
along the sequence is whole for this rank's chunk, and the cotangent of
a gathered tensor that feeds per-rank partial products is partial (the
reduce-scatter sums it).  :func:`batch_split` (a slice of a replicated
tensor) therefore all-gathers its cotangent, so the replicated input's
cotangent is whole on every rank, as f/g wants.  A leaf whose forward sees
only this rank's chunk of the sequence (the norm scales under SP; the
replicated attention weights under ring attention) gets a gradient that
is partial per rank: the training step all-reduces those
(``repro_torch.launch.steps``), where JAX's ``shard_map`` boundary psums.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.comm import Comm, Pending, SoloComm
from repro_torch.kernels.ref import wide
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.obs.tracing import phase_scope


def axes_index(comm: Comm) -> int:
    """This shard's index in the group (``repro.core.tmp.axes_index`` of
    the group's ordered axes: a sub-communicator's rank is that index)."""
    return comm.rank


def axes_size(comm: Comm) -> int:
    return comm.size


class _CopyToTmp(torch.autograd.Function):
    """f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous()), None


class _ReduceFromTmp(torch.autograd.Function):
    """g: all-reduce forward, identity backward.  ``box`` (a list) receives
    the :class:`Pending` of the all-reduce: the output holds the sum once
    it has been waited for."""

    @staticmethod
    def forward(ctx, x, comm, box):
        p = comm.all_reduce_async(x.contiguous())
        box.append(p)
        return p.result

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _RowExit(torch.autograd.Function):
    """A row-parallel exit: ``x @ w`` and its collective, computed by
    ``run(x, w) -> Pending``.  Under f/g the output's cotangent is whole on
    every rank, so the backward is local (``dx = dy @ w.T``,
    ``dw = x.T @ dy``) whatever ``run`` did.  The SP form (``gather_dim``
    set: ``run`` reduce-scatters along it) first all-gathers ``dy`` along
    that dim over ``comm`` (JAX's ``_rs_bwd``).  The 2-D form
    (``cols_comm`` set: ``run`` all-gathers w's output columns over it)
    keeps this rank's columns of ``dy`` and sums ``dx`` over
    ``cols_comm``: x is replicated there but met only this rank's
    columns.  ``box`` receives the handle, as for
    :class:`_ReduceFromTmp`.  ``phase``: the profiler range the backward
    runs under (the forward's), or None."""

    @staticmethod
    def forward(ctx, x, w, run, box, comm, gather_dim, cols_comm, phase):
        ctx.save_for_backward(x, w)
        ctx.comm, ctx.gather_dim, ctx.phase = comm, gather_dim, phase
        ctx.cols_comm = cols_comm
        p = run(x, w)
        box.append(p)
        return p.result

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        cols = ctx.cols_comm
        with (phase_scope(ctx.phase) if ctx.phase
              else contextlib.nullcontext()):
            if ctx.gather_dim is not None:
                dy = ctx.comm.all_gather(dy.contiguous(), ctx.gather_dim)
            if cols is not None:
                dy = dy.chunk(cols.size, -1)[cols.rank]
            dx = torch.matmul(dy, w.t())
            if cols is not None:
                dx = cols.all_reduce(dx)
            dw = torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                              dy.reshape(-1, dy.shape[-1]))
        return dx, dw, None, None, None, None, None, None


def row_exit(x: torch.Tensor, w: torch.Tensor, run, *,
             comm: Optional[Comm] = None,
             gather_dim: Optional[int] = None,
             cols_comm: Optional[Comm] = None,
             phase: Optional[str] = None) -> Pending:
    """The exit product ``x @ w`` and its collective as one differentiable
    op: ``run(x, w)`` computes them (a schedule's way) and returns a
    :class:`Pending`; the gradient is that of g after ``x @ w``, under
    SP (``gather_dim``: ``run`` reduce-scatters along it over ``comm``)
    that of the reduce-scatter, and in 2-D (``cols_comm``: ``run``
    all-gathers the output columns over it) that of the gather, with
    ``dx`` summed over ``cols_comm``.  Only x and w are saved, so fine
    recomputation can replay an exit without its product or collective
    (``repro_torch.core.remat``).  The backward runs under the profiler
    range ``phase`` (None: none)."""
    box: List[Pending] = []
    y = _RowExit.apply(x, w, run, box, comm, gather_dim, cols_comm, phase)
    return Pending(y, box[0].wait)


def copy_to_tmp(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Megatron f at a column-parallel entry."""
    if comm.size == 1:
        return x
    return _CopyToTmp.apply(x, comm)


def reduce_from_tmp_async(x: torch.Tensor, comm: Comm) -> Pending:
    """Megatron g, started: the returned handle's ``wait()`` gives the
    all-reduced tensor (differentiable, identity backward)."""
    if comm.size == 1:
        return Pending(x, None)
    box: List[Pending] = []
    y = _ReduceFromTmp.apply(x, comm, box)
    return Pending(y, box[0].wait)


def reduce_from_tmp(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Megatron g: the TMP all-reduce of a row-parallel exit."""
    return reduce_from_tmp_async(x, comm).wait()


def tmp_reduce(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``repro.core.tmp.tmp_reduce``: the all-reduce whose output fine
    recomputation keeps.  JAX tags it with ``checkpoint_name``; here the
    recomputed segments end before it (``repro_torch.core.remat``)."""
    return reduce_from_tmp(x, comm)


class _SpAllGather(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g.contiguous(), ctx.dim), None, None


class _SpReduceScatter(torch.autograd.Function):
    """Reduce-scatter forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.reduce_scatter(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g.contiguous(), ctx.dim), None, None


class _BatchSplit(torch.autograd.Function):
    """This rank's chunk of a replicated tensor forward, the all-gather of
    the chunks' cotangents backward."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return x.chunk(comm.size, dim)[comm.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g.contiguous(), ctx.dim), None, None


def sp_all_gather(x: torch.Tensor, comm: Comm, dim: int) -> torch.Tensor:
    """``repro.core.tmp.sp_all_gather``: every rank's chunk of x along
    ``dim``, concatenated in rank order (the SP block entry)."""
    if comm.size == 1:
        return x
    return _SpAllGather.apply(x, comm, dim)


def sp_reduce_scatter(x: torch.Tensor, comm: Comm, dim: int) -> torch.Tensor:
    """``repro.core.tmp.sp_reduce_scatter``: the sum over ranks of x, cut
    along ``dim``; this rank's chunk (the SP block exit)."""
    if comm.size == 1:
        return x
    return _SpReduceScatter.apply(x, comm, dim)


def batch_split(x: torch.Tensor, comm: Comm, dim: int) -> torch.Tensor:
    """``repro.core.tmp.batch_split``: this rank's chunk of the x
    replicated over ``comm`` (a sub-group's communicator: the chunk at
    ``axes_index`` of its ordered axes) along ``dim`` (a free slice; the
    backward all-gathers, see the module docstring for why not JAX's
    zero-padded chunk)."""
    if comm.size == 1:
        return x
    if x.shape[dim] % comm.size:
        raise ValueError(f"batch_split: dim {dim} of size {x.shape[dim]} "
                         f"is not divisible by the group size {comm.size}")
    return _BatchSplit.apply(x, comm, dim)


class _BatchGather(torch.autograd.Function):
    """Every rank's chunk concatenated forward, this rank's chunk of the
    cotangent backward."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.comm.size, ctx.dim)[ctx.comm.rank].contiguous(),
                None, None)


def batch_gather(x: torch.Tensor, comm: Comm, dim: int) -> torch.Tensor:
    """The inverse of :func:`batch_split`: every rank's chunk of ``dim``
    concatenated in rank order, replicated over the group.  The backward
    is a free slice: the gathered tensor's cotangent is whole on every
    rank (f/g), so each rank keeps its chunk's.  (JAX reshards with
    ``sp_all_gather``, whose reduce-scatter backward suits its partial
    cotangents; under f/g it would count each chunk ``size`` times.)"""
    if comm.size == 1:
        return x
    return _BatchGather.apply(x, comm, dim)


def pass_barrier(x: torch.Tensor) -> torch.Tensor:
    """The identity.  JAX puts an optimization_barrier on the gradient to
    emulate Merak's inter-pass barriers in the compiled program; eager
    PyTorch runs the program in the order it is written and reorders
    nothing, so there is nothing to hold back."""
    return x


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """``repro.core.tmp.rms_norm``: f32 math, ``(1 + scale)``, output in
    x's dtype.  Runs the CUDA kernels (forward and backward) on a CUDA
    tensor."""
    return rmsnorm(x, scale, eps=eps)


def vocab_parallel_embed(tokens: torch.Tensor, embed_local: torch.Tensor,
                         comm: Optional[Comm] = None, *,
                         sp_seq_dim: Optional[int] = None) -> torch.Tensor:
    """tokens [...] (replicated); embed_local [V/tp, D] -> [..., D]: look up
    the tokens of this rank's vocab shard, zeros elsewhere, and all-reduce
    (``comm`` None: tp=1).  ``sp_seq_dim``: sequence parallelism, the
    completing collective is a reduce-scatter along that dim."""
    v_local = embed_local.shape[0]
    if comm is None or comm.size == 1:
        return embed_local[tokens.long()]
    local = tokens.long() - axes_index(comm) * v_local
    in_shard = (local >= 0) & (local < v_local)
    out = embed_local[local.clamp(0, v_local - 1)]
    out = out * in_shard[..., None].to(out.dtype)
    if sp_seq_dim is not None:
        return sp_reduce_scatter(out, comm, sp_seq_dim)
    return tmp_reduce(out, comm)


def _xent_chunk(x: torch.Tensor, head32: torch.Tensor,
                labels: torch.Tensor, softcap: float,
                comm: Comm) -> torch.Tensor:
    """x [t, D]; head32 [D, V/tp] f32 (f64 for an f64 model: ``wide``);
    labels [t] -> summed nll (f32 scalar), ``_xent_chunk`` of
    ``repro.core.tmp``: the max, the sum of exponentials and the label
    logit all-reduced over the vocab shards."""
    logits = torch.matmul(wide(x), head32)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    v_local = logits.shape[-1]
    m = logits.amax(dim=-1).detach()      # stability only, no gradient
    if comm.size > 1:
        m = comm.all_reduce(m, op="max")
    z = reduce_from_tmp(torch.exp(logits - m[:, None]).sum(dim=-1), comm)
    local = labels.long() - axes_index(comm) * v_local
    in_shard = (local >= 0) & (local < v_local)
    lab = torch.gather(logits, 1, local.clamp(0, v_local - 1)[:, None])[:, 0]
    lab = reduce_from_tmp(lab * in_shard.to(lab.dtype), comm)
    return (torch.log(z) + m - lab).sum()


def vocab_parallel_xent(x: torch.Tensor, head_local: torch.Tensor,
                        labels: torch.Tensor, *, chunk: int = 512,
                        softcap: float = 0.0, comm: Optional[Comm] = None,
                        sp: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked vocab-parallel cross entropy
    (``repro.core.tmp.vocab_parallel_xent``, no mask): x [b, s, D]
    (replicated); head_local [D, V/tp]; labels [b, s] -> (loss_sum, count),
    f32 scalars, the same on every rank.

    Logits are f32, ``chunk`` tokens at a time plus the remainder; each
    full chunk runs under ``checkpoint`` (the ``@jax.checkpoint`` of the
    JAX scan step, which recomputes the chunk's collectives too), so only
    one chunk's [chunk, V/tp] logits are live in the backward.  x enters
    through f (its cotangent sums the shards' contributions), except under
    sequence parallelism (``sp``): x then comes from the sequence
    all-gather, whose backward reduce-scatters the partial cotangent, so it
    takes the place of f (as at every SP block entry).  The head is
    cast to f32 once per call rather than once per chunk, so its gradient
    sums over the chunks in f32.  ``comm`` None: tp=1."""
    comm = comm or SoloComm()
    b, s, d = x.shape
    t = b * s
    xf = (x if sp else copy_to_tmp(x, comm)).reshape(t, d)
    lf = labels.reshape(t)
    head32 = wide(head_local)
    chunk = min(chunk, t)
    n = t // chunk
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        loss = loss + checkpoint(_xent_chunk, xf[sl], head32, lf[sl],
                                 softcap, comm, use_reentrant=False)
    if n * chunk < t:
        loss = loss + _xent_chunk(xf[n * chunk:], head32, lf[n * chunk:],
                                  softcap, comm)
    return loss, torch.tensor(float(t), device=x.device)


def greedy_token(logits_local: torch.Tensor,
                 comm: Optional[Comm] = None) -> torch.Tensor:
    """Vocab-parallel greedy sampling (``repro.models.lm.greedy_token``):
    logits_local [b, V/tp] (this rank's vocab shard over ``comm``; None:
    tp=1) -> [b] int32 global ids, the same on every rank.  Each rank
    takes its shard's max and first argmax plus the shard's offset; one
    all-gather brings every rank's pair (the ids as f32, exact below
    2^24), and the first rank that holds the max wins, so ties resolve as
    a global ``jnp.argmax``."""
    v_local = logits_local.shape[-1]
    idx = torch.argmax(logits_local, dim=-1)
    if comm is None or comm.size == 1:
        return idx.to(torch.int32)
    val = logits_local.gather(-1, idx[:, None])[:, 0]
    idx = idx + axes_index(comm) * v_local
    pairs = comm.all_gather(
        torch.stack([val.float(), idx.float()])[None], 0)   # [tp, 2, b]
    win = torch.argmax(pairs[:, 0], dim=0)                  # first max
    return pairs[:, 1].gather(0, win[None])[0].to(torch.int32)
