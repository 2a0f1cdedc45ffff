"""Peer workspaces and the collective kernels of ``csrc/peer_comm.cu``.

Port-only infrastructure: XLA's collectives do this work in the JAX
package.  Each rank of a tensor-parallel group allocates one workspace
through the kernel library (not PyTorch's caching allocator: an IPC handle
covers a whole allocation), exports it with ``cudaIpcGetMemHandle``, and
opens every peer's through ``cudaIpcOpenMemHandle``; the handles travel
through a ``torch.distributed`` store.  This works between processes on
the same device (it cannot be done within one process), so the ranks on
one card are processes sharing it.

Every failure raises: an IPC open that fails, a kernel refused at launch,
or a flag wait that times out on the card (the kernel writes a host-mapped
error word and traps; :meth:`Workspace.check` names it).  Nothing falls
back to staging through the host.
"""
from __future__ import annotations

import ctypes
import time
from typing import List

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}
MODES = {"sum": 0, "max": 1, "gather": 2, "scatter": 3}
# the launch counter of each mode
COUNTERS = {"sum": "peer_all_reduce", "max": "peer_all_reduce",
            "gather": "peer_all_gather", "scatter": "peer_reduce_scatter"}
# csrc/peer.cuh: elements per collective tile and tiles per launch
COLL_TILE = 8192
MAX_COLL_TILES = 4096
MAX_RANKS = 8
ERRORS = {1: "a ring matmul flag wait timed out",
          2: "a collective flag wait timed out",
          3: "a ring attention flag wait timed out"}
# csrc/peer.cuh: slots of slot_bytes in a workspace (ring landing,
# collective, attention; two each)
SLOTS = 6


def store_barrier(store, key: str, size: int, timeout_s: float = 300.0):
    """Block until ``size`` processes have reached ``key`` on ``store``."""
    store.add(key, 1)
    t0 = time.monotonic()
    while store.add(key, 0) < size:
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"store barrier {key!r}: peers did not arrive "
                               f"within {timeout_s} s")
        time.sleep(0.001)


class Workspace:
    """This rank's workspace and the mapped workspaces of its peers.

    ``ptrs`` is the device table of every rank's workspace base pointer (own
    included), which the kernels take; ``host_ptrs`` the same table in
    host memory.  ``slot_bytes`` sizes each of the two ring landing slots,
    the two collective slots and the two ring-attention slots."""

    def __init__(self, rank: int, size: int, store, prefix: str,
                 slot_bytes: int, device: torch.device):
        if not 1 <= size <= MAX_RANKS:
            raise ValueError(f"peer group of {size} ranks (1..{MAX_RANKS})")
        self.rank, self.size = rank, size
        self.slot_bytes = (slot_bytes + 255) // 256 * 256
        self.device = device
        self._store, self._prefix = store, prefix
        lib = _build.library()
        with torch.cuda.device(device):
            own = ctypes.c_void_p()
            _build.check(lib.repro_peer_alloc(self.slot_bytes,
                                              ctypes.byref(own)),
                         "peer workspace cudaMalloc")
            self._own = own.value
            handle = ctypes.create_string_buffer(64)
            _build.check(lib.repro_peer_export(self._own, handle),
                         "cudaIpcGetMemHandle")
            store.set(f"{prefix}/ws/{rank}", handle.raw)
            host, dev = ctypes.c_void_p(), ctypes.c_void_p()
            _build.check(lib.repro_peer_error_word(ctypes.byref(host),
                                                   ctypes.byref(dev)),
                         "host-mapped error word")
            self._err_host, self.err_dev = host.value, dev.value
            self._opened: List[int] = []
            ptrs = []
            for r in range(size):
                if r == rank:
                    ptrs.append(self._own)
                    continue
                raw = store.get(f"{prefix}/ws/{r}")
                buf = ctypes.create_string_buffer(bytes(raw), 64)
                p = ctypes.c_void_p()
                _build.check(lib.repro_peer_open(buf, ctypes.byref(p)),
                             f"cudaIpcOpenMemHandle of rank {r}'s workspace")
                self._opened.append(p.value)
                ptrs.append(p.value)
            self.ptrs = torch.tensor(ptrs, dtype=torch.int64, device=device)
            # the same table in host memory (the ring-attention kernel's
            # tensor maps of the peers' slots are built on the host)
            self.host_ptrs = (ctypes.c_longlong * size)(*ptrs)
        store_barrier(store, f"{prefix}/opened", size)

    def check(self):
        """Raise if a kernel of this rank recorded a flag timeout."""
        code = ctypes.c_int.from_address(self._err_host).value
        if code:
            raise RuntimeError(f"PeerComm rank {self.rank}: "
                               f"{ERRORS.get(code, f'error {code}')}")

    def close(self):
        """Unmap the peers and free this rank's memory, after every rank
        has stopped using it."""
        if self._own is None:
            return
        torch.cuda.synchronize(self.device)
        store_barrier(self._store, f"{self._prefix}/closing", self.size)
        lib = _build.library()
        for p in self._opened:
            _build.check(lib.repro_peer_close(p), "cudaIpcCloseMemHandle")
        store_barrier(self._store, f"{self._prefix}/closed", self.size)
        _build.check(lib.repro_peer_free(self._own), "cudaFree")
        _build.check(lib.repro_peer_error_word_free(self._err_host),
                     "cudaFreeHost")
        self._own = None


def collective(ws: Workspace, x: torch.Tensor, out: torch.Tensor, mode: str,
               epoch: int, stream: torch.cuda.Stream, *, inner: int = 1,
               offset: int = 0):
    """One launch of the collective kernel on ``stream``: x [count]
    contiguous; out [count] (sum, max) or [size, count] (gather).  The
    caller cuts tensors into pieces of at most :func:`piece_elems`.
    ``scatter``: x is elements ``[offset, offset + count)`` of an input
    seen as [outer, size, inner]; out is this rank's whole chunk
    [outer, inner], of which the kernel writes the elements in x."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"peer collective takes f32 or bf16, got {x.dtype}")
    if not (x.is_contiguous() and out.is_contiguous()):
        raise ValueError("peer collective takes contiguous tensors")
    lib = _build.library()
    rc = lib.repro_peer_collective(
        ws.ptrs.data_ptr(), ws.rank, ws.size, ws.slot_bytes, x.data_ptr(),
        out.data_ptr(), x.numel(), inner, offset, _DTYPES[x.dtype],
        MODES[mode], epoch, ws.err_dev, stream.cuda_stream)
    _build.check(rc, f"peer collective ({mode}) launch")
    _build.LAUNCHES[COUNTERS[mode]] += 1


def piece_elems(ws: Workspace, dtype: torch.dtype) -> int:
    """Most elements one collective launch moves."""
    elt = torch.tensor([], dtype=dtype).element_size()
    return min(ws.slot_bytes // elt, COLL_TILE * MAX_COLL_TILES)
