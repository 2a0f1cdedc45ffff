"""Fused collective-matmul: the TMP all-reduce of a row-parallel exit
streamed through its matmul (``repro.kernels.collective_matmul``, the
paper's §3 at kernel granularity), 1-D, over a
:class:`~repro_torch.core.comm.Comm`.

``fused_matmul_allreduce`` = a matmul -> reduce-scatter ring whose
products all hide in the scatter phase, then a ring all-gather of the
reduced chunk (the same link bytes as an all-reduce).  Backends, chosen
by :func:`backend` as in JAX:

* ``ref``  — the product, then the communicator's all-reduce
  (reduce-scatter): the numerics reference, and JAX's semantics for an
  indivisible chunk dim or a group of one;
* ``ring`` — on CPU tensors, the ring decomposition over
  ``comm.ring_shift`` (the plain version of the kernel: f32 partials,
  one cast at the end); on CUDA tensors, always the hand-written ring
  kernel :func:`matmul_reducescatter` (``csrc/ring_matmul_rs.cu``, the
  port of ``_rs_ring_kernel``) and the peer all-gather.  No CUDA tensor
  ever takes the decomposition.

:func:`tile_matmul` is the port of ``pallas_tile_matmul``
(``csrc/tile_matmul.cu``): the ring kernel's per-step product, callable
alone, as in JAX for the autotuner and the checks; no model path launches
it by itself.

Gradient: ``fused_matmul_allreduce`` is differentiable under Megatron's
f/g convention (``repro_torch.core.tmp.row_exit``): the output is
replicated and its cotangent whole on every rank, so the backward is local
(``dx = dy @ w.T``, ``dw = x.T @ dy``, plain products), the same as
``megatron``'s exit and JAX's (XLA dots).  :func:`matmul_allreduce` is its
forward alone, which the schedules call inside their exit op.

The sequence-parallel pair (JAX ``collective_matmul.py:459-546``):

* :func:`fused_matmul_reducescatter` — the SP exit: the matmul ->
  reduce-scatter ring scattering along the sequence with no all-gather
  after it (the ring kernel on CUDA tensors, as JAX's ``pallas`` backend
  runs ``_rs_ring_kernel``; :func:`ring_matmul_reducescatter` on the CPU).
  Backward: all-gather the cotangent, then plain products.
* :func:`fused_allgather_matmul` — the SP entry: the sequence all-gather
  feeding every weight's product (on CUDA tensors the peer all-gather and
  ``torch.matmul``; JAX has no Pallas AG-matmul either,
  ``collective_matmul.py:453``; on the CPU the ring over ``ring_shift``,
  :func:`ring_allgather_matmul`).  Backward: a reduce-scatter of
  ``sum_k g_k @ w_k.T`` and each ``dw_k`` against the re-gathered x, so
  only the 1/tp input is saved.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.comm import Comm, Pending
from repro_torch.core.tmp import row_exit
from repro_torch.kernels import _build
from repro_torch.kernels.ref import tile_matmul_ref

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def backend(comm: Comm, size_along_dim: int) -> str:
    """``ref`` for a group of one or a chunk dim the group does not divide,
    else ``ring``."""
    n = comm.size
    if n <= 1 or size_along_dim % n:
        return "ref"
    return "ring"


# --------------------------------------------------------------------------
# reference path
# --------------------------------------------------------------------------
def matmul_allreduce_ref(x, w, comm: Comm):
    return comm.all_reduce(torch.matmul(x, w))


def matmul_reducescatter_ref(x, w, comm: Comm, scatter_dim: int):
    return comm.reduce_scatter(torch.matmul(x, w), scatter_dim)


# --------------------------------------------------------------------------
# ring decomposition (CPU path; the plain version of the ring kernel)
# --------------------------------------------------------------------------
def ring_matmul_reducescatter(x, w, comm: Comm, scatter_dim: int):
    """Row-parallel ``x @ w`` fused with a ring reduce-scatter along
    ``scatter_dim``: at step s rank i adds its product for output chunk
    ``(i - 1 - s) mod n`` to the f32 partial arriving from the left; after
    n steps (n - 1 hops) it holds chunk i, cast once to x's dtype."""
    n, idx = comm.size, comm.rank
    chunk = x.shape[scatter_dim] // n

    def contrib(s):
        c = (idx - 1 - s) % n
        xc = x.narrow(scatter_dim, c * chunk, chunk)
        return torch.matmul(xc.float(), w.float())

    accum = contrib(0)
    for s in range(1, n):
        accum = comm.ring_shift(accum) + contrib(s)
    return accum.to(x.dtype)


def ring_allgather(y_chunk, comm: Comm, dim: int):
    """Ring all-gather of a local chunk along ``dim``: after s hops rank i
    holds chunk ``(i - s) mod n``."""
    n, idx = comm.size, comm.rank
    parts = [None] * n
    cur = y_chunk
    for s in range(n):
        parts[(idx - s) % n] = cur
        if s < n - 1:
            cur = comm.ring_shift(cur)
    return torch.cat(parts, dim=dim)


def ring_allgather_matmul(x, ws, comm: Comm, gather_dim: int):
    """Column-parallel SP entry over the ring: the shards of x arrive one
    hop at a time (after s hops rank i holds shard ``(i - s) mod n``) and
    each is multiplied by every weight as it arrives -> one output per
    weight, the whole sequence along ``gather_dim``."""
    n, idx = comm.size, comm.rank
    parts = [[None] * n for _ in ws]
    cur = x
    for s in range(n):
        src = (idx - s) % n
        for k, w in enumerate(ws):
            parts[k][src] = torch.matmul(cur, w)
        if s < n - 1:
            cur = comm.ring_shift(cur)
    return tuple(torch.cat(p, dim=gather_dim) for p in parts)


def ring_matmul_allreduce(x, w, comm: Comm, scatter_dim: int):
    return ring_allgather(ring_matmul_reducescatter(x, w, comm, scatter_dim),
                          comm, scatter_dim)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------
def _check_pair(what: str, x: torch.Tensor, w: torch.Tensor):
    """What the kernels take (both tiles, any device): f32 or bf16 x and w
    of one dtype, [m, k] @ [k, n] with no extent 0, both contiguous (the
    tiles read x K-major and w MN-major as stored)."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{what} takes f32 or bf16 x and w of one dtype, "
                        f"got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{what}: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if 0 in x.shape or 0 in w.shape:
        raise ValueError(f"{what}: empty operand {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what} takes contiguous x [m, k] and w [k, n] "
                         f"(strides {x.stride()} and {w.stride()})")


def tile_matmul(x: torch.Tensor, w: torch.Tensor, *,
                block_m: Optional[int] = None, block_n: Optional[int] = None,
                block_k: Optional[int] = None, count: bool = True,
                path: Optional[str] = None) -> torch.Tensor:
    """``[m, k] @ [k, n]`` with f32 accumulation, output in x's dtype
    (``pallas_tile_matmul``), on the tile that
    :func:`~repro_torch.kernels.autotune.gemm_path` picks (``path``
    overrides it: the autotuner's timing runs).  Block sizes left as None
    come from :func:`repro_torch.kernels.autotune.tuned_blocks`; explicit
    ones win.  A CPU tensor takes
    :func:`~repro_torch.kernels.ref.tile_matmul_ref`.  ``count=False``
    (the autotuner's timing runs) leaves ``LAUNCHES``."""
    if _build.on_cpu("tile_matmul", x, w):
        return tile_matmul_ref(x, w)
    _check_pair("tile_matmul", x, w)
    m, k = x.shape
    n = w.shape[1]
    from repro_torch.kernels import autotune
    path = path or autotune.gemm_path(x, w)
    blocks = autotune.tuned_blocks(m, k, n, x.dtype, x.device, path=path) \
        if None in (block_m, block_n, block_k) else (0, 0, 0)
    bm = block_m if block_m is not None else blocks[0]
    bn = block_n if block_n is not None else blocks[1]
    bk = block_k if block_k is not None else blocks[2]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    rc = _build.library().repro_tile_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, bm, bn, bk,
        _DTYPES[x.dtype], int(path == autotune.WGMMA), _build.stream_ptr(x))
    _build.check(rc, f"tile_matmul kernel launch ({path}, blocks "
                     f"{bm}x{bn}x{bk})")
    if count:
        _build.LAUNCHES["tile_matmul"] += 1
    return out


def matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, comm: Comm,
                         scatter_dim: int = 0) -> torch.Tensor:
    """One rank's fused matmul -> reduce-scatter (``pallas_matmul_
    reducescatter``): x [..., K_local] with ``x.shape[scatter_dim]``
    divisible by the group, w [K_local, D] -> this rank's chunk of
    ``sum over ranks of x @ w`` along ``scatter_dim``.  CUDA tensors launch
    the ring kernel over the communicator's peer workspaces (a
    :class:`~repro_torch.core.comm.PeerComm`); CPU tensors take the ring
    decomposition, which computes the same function."""
    if _build.on_cpu("matmul_reducescatter", x, w):
        return ring_matmul_reducescatter(x, w, comm, scatter_dim)
    from repro_torch.core.comm import peer_comm
    comm = peer_comm(comm)
    n = comm.size
    if n < 2 or x.shape[scatter_dim] % n:
        raise ValueError(
            f"matmul_reducescatter: dim {scatter_dim} of size "
            f"{x.shape[scatter_dim]} over a group of {n}")
    xm = x.movedim(scatter_dim, 0)
    lead = xm.shape[:-1]
    x2 = xm.reshape(-1, x.shape[-1]).contiguous()
    w = w.contiguous()
    _check_pair("matmul_reducescatter", x2, w)
    rows, k = x2.shape
    d = w.shape[1]
    chunk = rows // n
    if chunk * d * 4 > comm.ws.slot_bytes:
        raise ValueError(
            f"matmul_reducescatter: an f32 chunk of {chunk} x {d} does not "
            f"fit a landing slot of {comm.ws.slot_bytes} bytes")
    from repro_torch.kernels import autotune
    # every rank must tile alike: the path follows the shapes alone, and
    # an operand at an address TMA cannot take is copied to one it can
    path = autotune.shape_path(k, d, x.dtype)
    if path == autotune.WGMMA:
        x2, w = autotune.aligned16(x2), autotune.aligned16(w)
        # the ring's tile is 128 x 128 only: its epilogue is staged through
        # 68 KB of shared memory beside the stages
        bm, bn, bk = autotune.TC_DEFAULT_BLOCKS
    else:
        bm, bn, bk = comm.agree(
            f"tile/{path}/{chunk}/{k}/{d}/{x.dtype}",
            lambda: autotune.tuned_blocks(chunk, k, d, x.dtype, x.device,
                                          path=path))
    out = torch.empty(chunk, d, dtype=x.dtype, device=x.device)
    comm.ws.check()
    with torch.cuda.stream(comm.begin()):
        rc = _build.library().repro_ring_matmul_rs(
            comm.ws.ptrs.data_ptr(), comm.rank, n, comm.ws.slot_bytes,
            x2.data_ptr(), w.data_ptr(), out.data_ptr(), chunk, k, d, bm, bn,
            bk, comm.ring_base, _DTYPES[x.dtype], int(path == autotune.WGMMA),
            comm.ws.err_dev, comm.stream.cuda_stream)
    _build.check(rc, f"ring_matmul_rs kernel launch ({path}, blocks "
                     f"{bm}x{bn}x{bk})")
    comm.ring_base += n - 1
    _build.LAUNCHES["ring_matmul_rs"] += 1
    torch.cuda.current_stream(x.device).wait_event(comm.end(x2, w, out))
    return out.reshape((lead[0] // n,) + tuple(lead[1:]) + (d,)) \
        .movedim(0, scatter_dim)


def _dispatch_rs(x, w, comm: Comm, scatter_dim: int):
    """Matmul -> reduce-scatter on any backend (``_dispatch_rs`` of JAX):
    tiled reduce-scatter semantics need an even split, so an indivisible
    scatter dim raises."""
    n = comm.size
    if n > 1 and x.shape[scatter_dim] % n != 0:
        raise ValueError(
            f"matmul→reduce-scatter: scatter dim {scatter_dim} of size "
            f"{x.shape[scatter_dim]} is not divisible by the TMP group "
            f"size {n}")
    if backend(comm, x.shape[scatter_dim]) == "ref":
        return matmul_reducescatter_ref(x, w, comm, scatter_dim)
    return matmul_reducescatter(x, w, comm, scatter_dim)


def matmul_reducescatter_fwd(x: torch.Tensor, w: torch.Tensor, comm: Comm,
                             scatter_dim: int = 1) -> torch.Tensor:
    """The forward of :func:`fused_matmul_reducescatter` (no autograd):
    the product at tp=1; else the ring decomposition on CPU tensors or the
    ring kernel on CUDA tensors.  An indivisible scatter dim raises."""
    if comm.size <= 1:
        return torch.matmul(x, w)
    return _dispatch_rs(x, w, comm, scatter_dim)


def fused_matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, comm: Comm,
                               scatter_dim: int = 1) -> torch.Tensor:
    """Row-parallel ``x @ w`` + ring reduce-scatter along ``scatter_dim``
    (JAX's ``fused_matmul_reducescatter``, the SP exit), differentiable:
    the backward all-gathers the cotangent along ``scatter_dim`` and takes
    plain products (JAX's ``_rs_bwd``)."""
    return row_exit(x, w, lambda x, w: Pending(
        matmul_reducescatter_fwd(x, w, comm, scatter_dim), None),
        comm=comm, gather_dim=scatter_dim).wait()


class _AllGatherMatmul(torch.autograd.Function):
    """Forward: the sequence all-gather of x and one product per weight.
    Backward: the reduce-scatter of ``sum_k g_k @ w_k.T`` and
    ``dw_k = AG(x).T @ g_k`` against the re-gathered x (plain products;
    only x, the 1/tp shard, is saved)."""

    @staticmethod
    def forward(ctx, x, comm, gather_dim, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.comm, ctx.gather_dim = comm, gather_dim
        if comm.size <= 1:
            return tuple(torch.matmul(x, w) for w in ws)
        if x.device.type == "cpu":
            return ring_allgather_matmul(x, ws, comm, gather_dim)
        h = comm.all_gather(x.contiguous(), gather_dim)
        return tuple(torch.matmul(h, w) for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        comm, dim = ctx.comm, ctx.gather_dim
        dx = None
        for g, w in zip(gs, ws):
            t = torch.matmul(g, w.t())
            dx = t if dx is None else dx + t
        xf = x
        if comm.size > 1:
            dx = comm.reduce_scatter(dx.contiguous(), dim)
            xf = comm.all_gather(x.contiguous(), dim)
        x2 = xf.reshape(-1, xf.shape[-1]).t()
        dws = tuple(torch.matmul(x2, g.reshape(-1, g.shape[-1]))
                    for g in gs)
        return (dx, None, None, *dws)


def fused_allgather_matmul(x: torch.Tensor, ws, comm: Comm,
                           gather_dim: int = 1) -> tuple:
    """Column-parallel SP entry (JAX's ``fused_allgather_matmul``): the
    all-gather of x along ``gather_dim`` feeding every weight in ``ws``;
    one output per weight, differentiable."""
    return _AllGatherMatmul.apply(x, comm, gather_dim, *ws)


def matmul_allreduce(x: torch.Tensor, w: torch.Tensor, comm: Comm,
                     scatter_dim: int = 1) -> torch.Tensor:
    """The forward of :func:`fused_matmul_allreduce` (no autograd): the
    reference path, the ring decomposition on CPU tensors, or the ring
    kernel and the peer all-gather on CUDA tensors."""
    if comm.size <= 1:
        return torch.matmul(x, w)
    if backend(comm, x.shape[scatter_dim]) == "ref":
        return matmul_allreduce_ref(x, w, comm)
    if x.device.type == "cpu":
        return ring_matmul_allreduce(x, w, comm, scatter_dim)
    y_chunk = matmul_reducescatter(x, w, comm, scatter_dim)
    return comm.all_gather(y_chunk, scatter_dim)


def fused_matmul_allreduce(x: torch.Tensor, w: torch.Tensor, comm: Comm, *,
                           scatter_dim: int = 1) -> torch.Tensor:
    """Row-parallel ``x @ w`` + all-reduce as a reduce-scatter ring and an
    all-gather (JAX's ``fused_matmul_allreduce``), differentiable with the
    local backward of Megatron's g."""
    return row_exit(x, w, lambda x, w: Pending(
        matmul_allreduce(x, w, comm, scatter_dim), None)).wait()
