"""Build and load the port's CUDA kernels (one shared library, C ABI).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), then linked into
``build/repro_torch_kernels/librepro_torch_kernels.so`` at the repository
root and loaded with :mod:`ctypes`.  The build runs at the first kernel
launch, never at import, and is redone when a source is newer than the
library.  Sources include no PyTorch headers, so a build takes seconds.
The lock covers the threads of one process only: a program that spawns
rank processes builds once in the parent first (:func:`build`).

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds one
where it launches its kernel, and nowhere else (a backward entry point
that runs two or three CUDA kernels counts as one call, as does the ring
attention's publish, attention and done launches, the SSD forward's
four launches and its backward's eight, and the RG-LRU backward's
two).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v", "-lineinfo"]

# dtype codes shared with the C entry points
DTYPE_F32 = 0
DTYPE_BF16 = 1

LAUNCHES: Dict[str, int] = {"paged_decode": 0, "rmsnorm": 0,
                            "rmsnorm_bwd": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "tile_matmul": 0,
                            "ring_matmul_rs": 0, "peer_all_reduce": 0,
                            "peer_all_gather": 0, "ring_attention": 0,
                            "ssd": 0, "ssd_bwd": 0, "moe_gmm": 0,
                            "rglru": 0, "rglru_bwd": 0,
                            "peer_reduce_scatter": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint
_SIGNATURES = {
    # x, scale, out, rows, d, warps_per_row, rows_per_block, nblocks, eps,
    # dtype, stream
    "repro_rmsnorm": [_P, _P, _P, _L, _I, _I, _I, _I, _F, _I, _P],
    # q, k_pages, v_pages, tables, pos, out, partial, counters, b, kvh, g,
    # hd, page, nb, pps, nsplit, scale, softcap, dtype, stream
    "repro_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _I, _F, _F, _I, _P],
    # x, scale, dy, dx, dscale, partial, rows, d, warps_per_row,
    # rows_per_block, nblocks, eps, dtype, stream
    "repro_rmsnorm_bwd": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _F, _I,
                          _P],
    # q, k, v, out, lse, b, sq, sk, h, kvh, hd, causal, window, scale,
    # softcap, dtype, stream
    "repro_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _F, _F, _I, _P],
    # q, k, v, out, lse, dout, delta, dq, dk, dv, b, sq, sk, h, kvh, hd,
    # causal, window, scale, softcap, dtype, stream
    "repro_flash_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _I, _F, _F, _I, _P],
    # x, w, out, m, k, n, bm, bn, bk, dtype, tc, stream
    "repro_tile_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # ws, rank, n, slot, x, w, out, chunk, k, d, bm, bn, bk, base, dtype,
    # tc, err, stream
    "repro_ring_matmul_rs": [_P, _I, _I, _L, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _U, _I, _I, _P, _P],
    # ws, host_ws, rank, n, slot, q, k, v, out, lse, b, sq, sk, h, kvh, hd,
    # causal, window, scale, softcap, epoch, dtype, err, stream
    "repro_ring_attention": [_P, _P, _I, _I, _L, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _I, _F, _F, _U, _I, _P, _P],
    # ws, rank, n, slot, x, out, count, inner, offset, dtype, mode, epoch,
    # err, stream
    "repro_peer_collective": [_P, _I, _I, _L, _P, _P, _L, _L, _L, _I, _I, _U,
                              _P, _P],
    # a, b, out, e, m, k, n, ta, tb, bm, bn, bk, dtype, tc, stream
    "repro_moe_gmm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _I, _P],
    # x, dt, A_log, B, C, D, y, cb, states, decay, final, b, s, h, p, n, q,
    # dtype, stream
    "repro_ssd_fwd": [_P] * 11 + [_I] * 7 + [_P],
    # x, dt, A_log, B, C, D, dy, dx, ddt, dA_log, dB, dC, dD, cb, states,
    # decay, gstates, dcb_part, dc_part, db_part, head_part, b, s, h, p, n,
    # q, dtype, stream
    "repro_ssd_bwd": [_P] * 21 + [_I] * 7 + [_P],
    # x, w_a, b_a, w_x, b_x, a_param, y, states, last, b, s, w, dtype,
    # stream
    "repro_rglru_fwd": [_P] * 9 + [_I] * 4 + [_P],
    # x, w_a, b_a, w_x, b_x, a_param, states, dy, dx, partial, dgates, b, s,
    # w, dtype, stream
    "repro_rglru_bwd": [_P] * 11 + [_I] * 4 + [_P],
    # slot, &ptr
    "repro_peer_alloc": [_L, _P],
    "repro_peer_free": [_P],
    # ptr, handle (64 bytes)
    "repro_peer_export": [_P, _P],
    # handle (64 bytes), &ptr
    "repro_peer_open": [_P, _P],
    "repro_peer_close": [_P],
    # &host, &dev
    "repro_peer_error_word": [_P, _P],
    "repro_peer_error_word_free": [_P],
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built on this machine")


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library; returns its path.
    Writes the compiler's messages (``-Xptxas -v`` register and shared
    memory report) to ``build.log`` beside the library."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib = BUILD_DIR / LIB_NAME
    newest = max(p.stat().st_mtime for p in sources + headers)
    if not force and lib.exists() and lib.stat().st_mtime >= newest:
        return lib
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(log[-1])
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(o) for _s, o, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def on_cpu(what: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then takes its
    plain version), False when all lie on one CUDA device (it launches its
    kernel); raises for any other mix, so no CUDA tensor ever reaches a
    plain version."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{what}: all tensors must be on the CPU or on the same CUDA "
            f"device, got {[str(t.device) for t in tensors]}")
    return False


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the C entry points take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
