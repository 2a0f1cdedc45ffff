"""Run one function on every rank of a rank mesh, each rank its own
process (``torch.multiprocessing`` with ``spawn``: CUDA cannot fork).

``run_ranks(fn, tp, device=..., mesh=...)`` starts one process per rank
of ``mesh`` (shape, axis names; default the 1-D ``(1, tp)`` mesh of
``("data", "model")``); each joins a ``torch.distributed`` TCP store on
``localhost``, builds its :class:`~repro_torch.core.comm.MeshComm` and
calls ``fn(comm, device, *args)``; the results come back in rank order.
The MeshComm's own ops run over every rank, so a body written for one
1-D group runs unchanged; ``comm.sub(axes)`` is the communicator of a
sub-group.  On the CPU each communicator is a
:class:`~repro_torch.core.comm.DistComm` over a gloo group; on CUDA a
:class:`~repro_torch.core.comm.PeerComm` with its own workspace, on
``cuda:(rank % cards)``, so with one card visible every rank shares
``cuda:0``.  The kernel library is
built once in the calling process before the ranks start (its build lock
covers the threads of one process only).

A rank that raises, a rank that dies, and a group that outlives
``timeout`` all make :func:`run_ranks` terminate every rank and raise: a
hung collective fails instead of hanging its caller.
"""
from __future__ import annotations

import math
import os
import queue as queue_mod
import socket
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _leave(store, rank: int, tp: int, timeout_s: float = 300.0):
    """The store lives in rank 0's process: rank 0 returns only once every
    other rank has made its last store call, so that no rank finds the
    store gone in the middle of one (a barrier's last poll)."""
    if rank:
        store.add("left", 1)
        return
    t0 = time.monotonic()
    while store.add("left", 0) < tp - 1:
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"ranks did not leave within {timeout_s} s")
        time.sleep(0.001)


def _factory(device: str, rank: int, store, dev):
    """The MeshComm factory of a transport: a gloo sub-group (every rank
    calls ``new_group`` for every group) or, on CUDA, a PeerComm of the
    members with the store prefix ``tp/<axes>/<group>``."""
    import torch.distributed as dist

    from repro_torch.core.comm import DistComm, PeerComm

    def make(axes, index, members):
        if device == "cpu":
            group = (None if members == list(range(dist.get_world_size()))
                     else dist.new_group(members))
            return DistComm(group, members) if rank in members else None
        if rank not in members:
            return None
        return PeerComm(members.index(rank), len(members), store,
                        prefix=f"tp/{'.'.join(axes)}/{index}", device=dev)
    return make


def _rank_entry(rank: int, mesh, port: int, device: str, threads: int,
                fn: Callable, args: Sequence, out_q):
    import torch.distributed as dist

    from repro_torch.core.axes import RankMesh
    from repro_torch.core.comm import MeshComm
    comm = None
    tp = math.prod(mesh[0])
    try:
        store = dist.TCPStore("127.0.0.1", port, tp, rank == 0,
                              timeout=timedelta(seconds=300))
        if device == "cpu":
            torch.set_num_threads(threads)
            dist.init_process_group("gloo", store=store, rank=rank,
                                    world_size=tp)
            dev = torch.device("cpu")
        else:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        comm = MeshComm(RankMesh(*mesh), rank,
                        _factory(device, rank, store, dev))
        result = fn(comm, dev, *args)
        comm.check()
        comm.close()
        _leave(store, rank, tp)
        out_q.put((rank, True, result))
    except BaseException:
        msg = traceback.format_exc()
        if comm is not None:
            try:                  # a kernel's recorded flag timeout
                comm.check()
            except RuntimeError as e:
                msg += f"\n{e}"
        out_q.put((rank, False, msg))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, tp: int = 0, *, device: Optional[str] = None,
              args: Sequence = (), timeout: float = 600.0,
              threads: Optional[int] = None,
              mesh: Optional[Tuple[Sequence[int], Sequence[str]]] = None
              ) -> List[Any]:
    """``[fn(comm_r, device_r, *args) for r in range(n)]``, each in its own
    process, where n is the size of ``mesh`` (``(shape, axis_names)``;
    default ``((1, tp), ("data", "model"))``; ``tp``, when given with a
    mesh, must be its size).  ``device``: ``"cpu"`` or CUDA (None).
    ``fn`` and ``args`` must pickle (``fn`` by its import path).
    ``threads``: torch threads a CPU rank uses (default: the cores shared
    out)."""
    import torch.multiprocessing as mp
    if mesh is None:
        mesh = ((1, tp), ("data", "model"))
    mesh = (tuple(int(n) for n in mesh[0]), tuple(mesh[1]))
    if tp and tp != math.prod(mesh[0]):
        raise ValueError(f"run_ranks: tp={tp} but the mesh {mesh[0]} has "
                         f"{math.prod(mesh[0])} ranks")
    tp = math.prod(mesh[0])
    device = "cpu" if device == "cpu" else "cuda"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_ranks: no CUDA device available; pass "
                               "device='cpu' for gloo ranks on the CPU")
        from repro_torch.kernels import _build
        _build.build()
    threads = threads or max(1, (os.cpu_count() or 1) // tp)
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, mesh, port, device, threads, fn,
                               tuple(args), out_q), daemon=True)
             for r in range(tp)]
    for p in procs:
        p.start()
    results: List[Any] = [None] * tp
    got, deadline = 0, time.monotonic() + timeout
    try:
        while got < tp:
            try:
                rank, ok, payload = out_q.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"run_ranks: {tp - got} of {tp} ranks gave no result "
                        f"within {timeout} s")
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode not in (0, None)
                        and results[r] is None]
                if dead:
                    raise RuntimeError(f"run_ranks: rank(s) {dead} died "
                                       f"(exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n"
                                   f"{payload}")
            results[rank] = payload
            got += 1
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results
