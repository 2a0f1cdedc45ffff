"""The tensor-parallel communicator: the port's counterpart of a mesh
axis plus ``lax.psum`` / ``psum_scatter`` / ``all_gather`` / ``ppermute``
as ``repro.core.tmp`` and ``repro.kernels.collective_matmul`` call them.

A :class:`Comm` has a ``rank`` and a ``size`` and offers ``all_reduce``
(sum or max; also asynchronously, returning a handle), ``reduce_scatter``,
``all_gather`` and ``ring_shift`` (send to ``rank + 1``, receive from
``rank - 1``).  Every call adds one to ``counts[kind]``; the remat tests
read them.  The ops carry no gradient: ``repro_torch.core.tmp`` wraps them
in autograd Functions.

Replicated activations must come out bitwise identical on every rank, or
the norm inputs of the replicas drift apart: every all-reduce therefore
sums in f32 in one fixed rank order (0, 1, ..., n-1) and casts once, on
every rank.

* :class:`SoloComm` — tp=1: every call is the identity.
* :class:`DistComm` — over ``torch.distributed`` (gloo on the CPU; the
  tests' transport): all-reduce and reduce-scatter are an all-gather then
  the rank-order sum (the reduce-scatter then slices this rank's chunk),
  ring_shift is an isend/irecv pair.
* :class:`PeerComm` — on CUDA: the port's own kernels over peer
  workspaces shared through CUDA IPC (``kernels/peer_comm.py``), all on
  one communication stream; its reduce-scatter sums and writes only this
  rank's chunk (the kernel's scatter mode).  On one card the ranks are processes sharing
  ``cuda:0``; NCCL refuses two ranks on one device.
* :class:`TraceComm` — one rank of a group that moves no data, for the
  dry run (``launch/hlo_cost.py``): each op returns a tensor of the real
  result's shape and hands (kind, payload bytes, group size) to a
  recorder.
* :class:`MeshComm` — the ranks of a run as a mesh
  (:class:`~repro_torch.core.axes.RankMesh`): ``sub(axes)`` is the
  communicator of the ranks that share every coordinate outside
  ``axes`` (a ``DistComm`` over a ``torch.distributed`` sub-group, or a
  ``PeerComm`` with its own workspace and store prefix), built once per
  axes tuple and cached.  Its own ops run over the whole mesh.  In every
  sub-communicator ``rank`` and ``size`` are the rank's index in the
  group (``axes_index`` over the ordered axes) and the group's size.
"""
from __future__ import annotations

import json
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

KINDS = ("all_reduce", "reduce_scatter", "all_gather", "ring_shift")


class Pending:
    """The handle of an asynchronous all-reduce: ``result`` is allocated at
    the start and holds the sum once :meth:`wait` has returned."""

    def __init__(self, result: torch.Tensor, finish: Callable[[], None]):
        self.result = result
        self._finish = finish

    def wait(self) -> torch.Tensor:
        if self._finish is not None:
            self._finish()
            self._finish = None
        return self.result


class Comm:
    """Base class: counting and the synchronous forms of the ops."""

    rank: int = 0
    size: int = 1

    def __init__(self):
        self.counts: Dict[str, int] = dict.fromkeys(KINDS, 0)

    def reset_counts(self):
        for k in self.counts:
            self.counts[k] = 0

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self.all_reduce_async(x, op).wait()

    def all_reduce_async(self, x: torch.Tensor, op: str = "sum") -> Pending:
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce op {op!r} (sum or max)")
        self.counts["all_reduce"] += 1
        return self._all_reduce_async(x, op)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over ranks of x, cut into ``size`` chunks along ``dim``;
        this rank's chunk.  ``x.shape[dim]`` must divide evenly."""
        if x.shape[dim] % self.size:
            raise ValueError(
                f"reduce_scatter: dim {dim} of size {x.shape[dim]} is not "
                f"divisible by the group size {self.size}")
        self.counts["reduce_scatter"] += 1
        return self._reduce_scatter(x, dim % x.dim())

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's x concatenated along ``dim`` in rank order."""
        self.counts["all_gather"] += 1
        return self._all_gather(x, dim)

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """Send x to rank + 1; return what rank - 1 sent."""
        self.counts["ring_shift"] += 1
        return self._ring_shift(x)

    def agree(self, key: str, choose: Callable[[], object]):
        """A value every rank uses alike (rank 0's ``choose()``), such as
        the ring kernel's block sizes, whose tiles must match across
        ranks."""
        return choose()

    def barrier(self):
        """Block the host until every rank has reached this call (no
        device work): a rank that will be busy on the host for long, such
        as one post-processing a profile, meets the others here first, so
        that no peer kernel of theirs waits on it past its timeout."""

    def check(self):
        """Raise if the transport recorded a failure (PeerComm)."""

    def close(self):
        """Release the transport's resources."""

    # implementations
    def _all_reduce_async(self, x, op) -> Pending:
        raise NotImplementedError

    def _reduce_scatter(self, x, dim) -> torch.Tensor:
        """The all-reduce, then this rank's chunk (the plain version)."""
        full = self._all_reduce_async(x, "sum").wait()
        return full.chunk(self.size, dim)[self.rank].contiguous()

    def _all_gather(self, x, dim) -> torch.Tensor:
        raise NotImplementedError

    def _ring_shift(self, x) -> torch.Tensor:
        raise NotImplementedError


class SoloComm(Comm):
    """tp=1: one rank, every op is the identity (returns x itself)."""

    def _all_reduce_async(self, x, op):
        return Pending(x, None)

    def _all_gather(self, x, dim):
        return x

    def _ring_shift(self, x):
        return x


def _rank_order(parts: List[torch.Tensor], op: str) -> torch.Tensor:
    acc = parts[0].float()
    for p in parts[1:]:
        acc = torch.maximum(acc, p.float()) if op == "max" else acc + p.float()
    return acc.to(parts[0].dtype)


class DistComm(Comm):
    """Over a ``torch.distributed`` process group (gloo for CPU tensors):
    the default group, or ``group`` whose members are the global ranks
    ``members`` in group-rank order."""

    def __init__(self, group=None, members: Optional[Sequence[int]] = None):
        super().__init__()
        import torch.distributed as dist
        self._dist = dist
        self._group = group
        if members is None:
            members = range(dist.get_world_size())
        self._members = list(members)
        self.rank = self._members.index(dist.get_rank())
        self.size = len(self._members)

    def _gather_list(self, x, async_op):
        parts = [torch.empty_like(x) for _ in range(self.size)]
        work = self._dist.all_gather(parts, x.contiguous(),
                                     group=self._group, async_op=async_op)
        return parts, work

    def _all_reduce_async(self, x, op):
        if self.size == 1:
            return Pending(x, None)
        parts, work = self._gather_list(x, True)
        out = torch.empty_like(x)

        def finish():
            work.wait()
            with torch.no_grad():
                out.copy_(_rank_order(parts, op))
        return Pending(out, finish)

    def _all_gather(self, x, dim):
        if self.size == 1:
            return x
        parts, _ = self._gather_list(x, False)
        return torch.cat(parts, dim=dim)

    def barrier(self):
        self._dist.barrier(group=self._group)

    def _ring_shift(self, x):
        if self.size == 1:
            return x
        out = torch.empty_like(x)
        nxt = self._members[(self.rank + 1) % self.size]
        prv = self._members[(self.rank - 1) % self.size]
        reqs = [self._dist.isend(x.contiguous(), nxt, group=self._group),
                self._dist.irecv(out, prv, group=self._group)]
        for r in reqs:
            r.wait()
        return out


class PeerComm(Comm):
    """On CUDA: the port's collective kernels over peer workspaces.

    ``store`` is a ``torch.distributed`` store shared by the ranks (the
    IPC handles travel through it); ``prefix`` keeps the keys of one group
    apart from another's.  ``slot_bytes`` sizes each landing, collective
    and attention slot: a collective larger than a slot runs in pieces,
    the ring matmul's f32 output chunk must fit one, and so must a ring
    attention call's K/V shard.

    Every op runs on the communicator's own stream, after the work already
    queued on the caller's stream; a synchronous op makes the caller's
    stream wait for it, an asynchronous one at :meth:`Pending.wait`.  So
    the peer kernels of a rank run one at a time in program order, which
    the workspace protocol relies on."""

    def __init__(self, rank: int, size: int, store, *, prefix: str = "peer",
                 slot_bytes: int = 64 << 20,
                 device: Optional[torch.device] = None):
        super().__init__()
        from repro_torch.kernels import peer_comm
        self._pc = peer_comm
        self.rank, self.size = rank, size
        self.device = torch.device(device or "cuda")
        self.ws = peer_comm.Workspace(rank, size, store, prefix, slot_bytes,
                                      self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.epoch = 0                # collective calls so far
        self.ring_base = 0            # ring matmul tags so far
        self.attn_epoch = 0           # ring attention calls so far
        self._store, self._prefix = store, prefix
        self._agreed: Dict[str, object] = {}
        self._barriers = 0

    def agree(self, key, choose):
        if key not in self._agreed:
            skey = f"{self._prefix}/agree/{key}"
            if self.rank == 0:
                self._store.set(skey, json.dumps(choose()))
            self._agreed[key] = json.loads(self._store.get(skey))
        return self._agreed[key]

    def begin(self) -> torch.cuda.Stream:
        """Order the comm stream after the caller's queued work."""
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return self.stream

    def end(self, *tensors: torch.Tensor) -> torch.cuda.Event:
        """Keep ``tensors`` alive for the comm stream; the done event."""
        for t in tensors:
            t.record_stream(self.stream)
        return self.stream.record_event()

    def _launch(self, x: torch.Tensor, out: torch.Tensor, mode: str,
                inner: int = 1):
        """x [count] -> out [count] (sum, max), [size, count] (gather) or
        this rank's chunk (scatter, x seen as [outer, size, ``inner``]),
        in pieces of at most a slot.  Runs on the comm stream."""
        self.ws.check()
        piece = self._pc.piece_elems(self.ws, x.dtype)
        for lo in range(0, x.numel(), piece):
            hi = min(lo + piece, x.numel())
            self.epoch += 1
            if mode == "scatter":          # out: this rank's whole chunk
                self._pc.collective(self.ws, x[lo:hi], out, mode,
                                    self.epoch, self.stream,
                                    inner=inner, offset=lo)
                continue
            dst = out[..., lo:hi]
            if not dst.is_contiguous():          # a gather in pieces
                dst = torch.empty_like(dst)
            self._pc.collective(self.ws, x[lo:hi], dst, mode, self.epoch,
                                self.stream)
            if dst.data_ptr() != out[..., lo:hi].data_ptr():
                out[..., lo:hi].copy_(dst)

    def _all_reduce_async(self, x, op):
        if self.size == 1:
            return Pending(x, None)
        xf = x.contiguous().view(-1)
        out = torch.empty_like(xf)
        with torch.cuda.stream(self.begin()):
            self._launch(xf, out, op)
        done = self.end(xf, out)
        result = out.view(x.shape)

        def finish():
            torch.cuda.current_stream(self.device).wait_event(done)
        return Pending(result, finish)

    def _reduce_scatter(self, x, dim):
        """The scatter mode of the collective kernel: x seen as [outer,
        size, inner] along ``dim``; this rank sums and writes only its
        chunk."""
        if self.size == 1:
            return x
        xf = x.contiguous().view(-1)
        shape = list(x.shape)
        shape[dim] //= self.size
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        with torch.cuda.stream(self.begin()):
            self._launch(xf, out, "scatter", math.prod(shape[dim:]))
        torch.cuda.current_stream(self.device).wait_event(self.end(xf, out))
        return out

    def _all_gather(self, x, dim):
        if self.size == 1:
            return x
        xf = x.contiguous().view(-1)
        out = torch.empty(self.size, xf.numel(), dtype=x.dtype,
                          device=x.device)
        with torch.cuda.stream(self.begin()):
            self._launch(xf, out, "gather")
        torch.cuda.current_stream(self.device).wait_event(self.end(xf, out))
        parts = out.view(self.size, *x.shape).unbind(0)
        return torch.cat(parts, dim=dim)

    def _ring_shift(self, x):
        """Through the all-gather (the ring decomposition is the CPU path;
        on the card ``fused`` runs the ring kernel)."""
        if self.size == 1:
            return x
        return self._all_gather(x.unsqueeze(0), 0)[(self.rank - 1)
                                                   % self.size]

    def barrier(self):
        self._barriers += 1
        self._pc.store_barrier(self._store,
                               f"{self._prefix}/barrier/{self._barriers}",
                               self.size)

    def check(self):
        self.ws.check()

    def close(self):
        self.ws.close()


class TraceComm(Comm):
    """One rank of a group of ``size`` that moves no data: the counting
    communicator of the dry run.  Each op returns a new tensor of the real
    result's shape and dtype (``all_gather`` the concatenation, a
    ``reduce_scatter`` this rank's chunk, ``all_reduce`` and
    ``ring_shift`` x's shape; fake tensors under the tracer) and calls
    ``record(kind, payload_bytes, size)`` with the payload as JAX's HLO
    states it: the all-reduce's operand, the all-gather's gathered output,
    the reduce-scatter's scattered output, the shifted tensor.
    ``agree`` returns ``choose()``."""

    def __init__(self, rank: int, size: int,
                 record: Callable[[str, int, int], None]):
        super().__init__()
        self.rank, self.size = rank, size
        self._record = record

    def _out(self, kind: str, shape, x: torch.Tensor) -> torch.Tensor:
        out = x.new_empty(shape)
        self._record(kind, (out if kind != "all_reduce" else x).numel()
                     * x.element_size(), self.size)
        return out

    def _all_reduce_async(self, x, op):
        return Pending(self._out("all_reduce", x.shape, x), None)

    def _reduce_scatter(self, x, dim):
        shape = list(x.shape)
        shape[dim] //= self.size
        return self._out("reduce_scatter", shape, x)

    def _all_gather(self, x, dim):
        shape = list(x.shape)
        shape[dim] *= self.size
        return self._out("all_gather", shape, x)

    def _ring_shift(self, x):
        return self._out("ring_shift", x.shape, x)


def trace_mesh(mesh, rank: int,
               record: Callable[[str, int, int], None]) -> "MeshComm":
    """Rank ``rank`` of ``mesh`` as a :class:`MeshComm` of
    :class:`TraceComm` groups: no process is spawned."""
    def factory(axes, index, members):
        return TraceComm(members.index(rank) if rank in members else 0,
                         len(members), record)
    return MeshComm(mesh, rank, factory)


Factory = Callable[[Tuple[str, ...], int, List[int]], Optional[Comm]]


class MeshComm(Comm):
    """The communicators of a rank mesh, as seen from one rank.

    ``factory(axes, index, members)`` builds the communicator of one
    group over ``axes`` (``index``: the group's place in
    ``mesh.groups(axes)``; ``members``: its global ranks in group-rank
    order), or returns None where this rank is not a member.  Every rank
    calls it for every group of an axes tuple, in the same order, the
    first time any rank asks for that tuple (gloo's ``new_group`` wants
    every process in every call); :meth:`build` asks for a list of tuples
    in one pass.  Axes of size one are dropped from a tuple first, so
    ``("data", "model")`` on a ``(1, tp)`` mesh is ``("model",)``.

    The mesh's own ops (``all_reduce`` ... ``barrier``) run over the
    whole mesh, so a MeshComm stands wherever a 1-D group's Comm did.
    ``counts`` sums every sub-communicator's counts."""

    def __init__(self, mesh, rank: int, factory: Factory):
        from repro_torch.core.axes import mesh_info
        self.mesh, self.info = mesh, mesh_info(mesh)
        self.rank, self.size = rank, mesh.size
        self._factory = factory
        self._subs: Dict[Tuple[str, ...], Comm] = {}
        self.world = self.sub(mesh.axis_names)

    def _key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        s = self.mesh.sizes
        unknown = [a for a in axes if a not in s]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh "
                             f"{self.mesh.axis_names}")
        return tuple(a for a in axes if s[a] > 1)

    def sub(self, axes: Sequence[str]) -> Comm:
        """The communicator over ``axes`` that holds this rank."""
        key = self._key(axes)
        if key not in self._subs:
            if not key:
                self._subs[key] = SoloComm()
            else:
                mine = None
                for i, members in enumerate(self.mesh.groups(key)):
                    c = self._factory(key, i, members)
                    if self.rank in members:
                        mine = c
                self._subs[key] = mine
        return self._subs[key]

    def build(self, axes_list: Sequence[Sequence[str]]) -> "MeshComm":
        """Build the communicators of every axes tuple in ``axes_list``,
        in order (the plan's tuples; the same list on every rank)."""
        for axes in axes_list:
            self.sub(axes)
        return self

    def comms(self) -> List[Comm]:
        """The distinct communicators built so far."""
        out: List[Comm] = []
        for c in self._subs.values():
            if all(c is not o for o in out):
                out.append(c)
        return out

    @property
    def counts(self) -> Dict[str, int]:
        tot = dict.fromkeys(KINDS, 0)
        for c in self.comms():
            for k, v in c.counts.items():
                tot[k] += v
        return tot

    def reset_counts(self):
        for c in self.comms():
            c.reset_counts()

    # the whole mesh's ops
    def all_reduce_async(self, x, op="sum"):
        return self.world.all_reduce_async(x, op)

    def reduce_scatter(self, x, dim):
        return self.world.reduce_scatter(x, dim)

    def all_gather(self, x, dim):
        return self.world.all_gather(x, dim)

    def ring_shift(self, x):
        return self.world.ring_shift(x)

    def agree(self, key, choose):
        return self.world.agree(key, choose)

    def barrier(self):
        self.world.barrier()

    def check(self):
        for c in self.comms():
            c.check()

    def close(self):
        for c in self.comms():
            c.close()


def peer_comm(comm: Comm) -> "PeerComm":
    """The PeerComm a kernel runs over: ``comm`` itself, or a MeshComm's
    whole-mesh communicator; TypeError otherwise."""
    if isinstance(comm, MeshComm):
        comm = comm.world
    if not isinstance(comm, PeerComm):
        raise TypeError(f"the kernel needs a PeerComm, got "
                        f"{type(comm).__name__}")
    return comm


def solo_mesh() -> MeshComm:
    """The one-rank mesh ``(1, 1)`` of ``("data", "model")``."""
    from repro_torch.core.axes import RankMesh
    return MeshComm(RankMesh((1, 1), ("data", "model")), 0,
                    lambda axes, i, members: SoloComm())
