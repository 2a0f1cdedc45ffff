"""The GEMM tiles' path rule and block sizes: which tile a product runs
(:func:`gemm_path`), and the blocks of the tile matmul
(``csrc/tile_matmul.cu``) and of the ring kernel's per-step product
(``csrc/ring_matmul_rs.cu``), per shape: ``repro.kernels.autotune`` for
the card.

* :func:`gemm_path`: bf16 operands that TMA can describe take the
  tensor-core tile (``csrc/gemm_tc.cuh``, ``wgmma`` fed by TMA, blocks
  ``TC_BLOCKS``); other bf16 the ``mma.sync`` tile and f32 the CUDA-core
  tile (``csrc/tile_mm.cuh``, blocks ``CAND_M x CAND_N x CAND_K``).  The
  rule runs before the launch; a launch that fails raises, and never
  falls back to another tile.
* :func:`tuned_blocks` returns ``(bm, bn, bk)`` for an ``[m, k] @ [k, n]``
  product on a path, cached per ``(device, tile version, path, shape,
  dtype)`` in memory and on disk (``REPRO_TORCH_TUNE_CACHE``, default
  ``build/autotune/tile_blocks.json`` at the repository root, beside the
  kernel library); ``TILE_VERSION`` keeps picks made for an older tile
  design from being read for this one.
* On the card the candidates are timed with CUDA events (a synchronised
  warm-up, then the least of ``repeats`` timed runs).
* Off the card the clipped default is returned without timing and cached,
  as JAX does off the TPU.
* Rank processes sharing a card time nothing of their own: the ring's
  blocks are rank 0's choice (``Comm.agree``), since the others' time
  slices would be in the timings and every rank must tile alike.

The structure is JAX's (a default, a candidate grid per axis, clipping to
the problem, a fast-memory budget); the values are the card's.  The TPU's
default (128, 128, 512) and grid (up to 512 x 512 x 1024) are sized for
~16 MB of VMEM; a Hopper block has 227 KB of shared memory and at most
255 registers a thread, so the CUDA-core and ``mma.sync`` tiles hold at
most 128 x 128 f32 sums in 256 threads and walk k in steps of 32 or 64,
and the tensor-core tile 128 x 128 or 128 x 256 (128 sums a consumer
thread) in steps of 64.  The kernels are compiled for exactly the sets
below, so clipping rounds a block down to the problem and then up to the
smallest compiled size that covers it (the ragged edge is masked).
Explicit ``block_*`` arguments to the wrappers always win.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

Blocks = Tuple[int, int, int]

# tile_mm.cuh (f32 on the CUDA cores, bf16 on mma.sync)
DEFAULT_BLOCKS: Blocks = (128, 128, 32)
CAND_M = (64, 128)
CAND_N = (64, 128)
CAND_K = (32, 64)
# gemm_tc.cuh: two warpgroups of 64 rows, one k step a 128-byte row, a
# 4-stage ring; 128 x 256 keeps 128 f32 sums a consumer thread
TC_BLOCKS: Tuple[Blocks, ...] = ((128, 128, 64), (128, 256, 64))
TC_DEFAULT_BLOCKS: Blocks = TC_BLOCKS[0]
TC_STAGES = 4
TILE_VERSION = "wgmma-v1"
SMEM_BUDGET_BYTES = 227 * 1024

WGMMA, MMA_SYNC, CUDA_CORE = "wgmma", "mma_sync", "cuda_core"

_MEM_CACHE: Dict[Tuple[str, str], Blocks] = {}


# resolved once: every wrapper call looks its blocks up through this path
_DEFAULT_CACHE = str(Path(__file__).resolve().parents[3] / "build"
                     / "autotune" / "tile_blocks.json")


def cache_path() -> str:
    return os.environ.get("REPRO_TORCH_TUNE_CACHE") or _DEFAULT_CACHE


def platform_of(device: torch.device) -> str:
    if device.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(device)
    return device.type


def gemm_path(*operands: torch.Tensor) -> str:
    """The tile a product of these stored operands runs: ``wgmma`` when
    all are bf16 at 16-byte-aligned addresses with their contiguous
    (last) extent a multiple of 8 (what a TMA tensor map needs), else
    ``mma_sync`` for bf16 and ``cuda_core`` for f32 (a tensor-core product
    of f32 inputs would be TF32)."""
    if operands[0].dtype != torch.bfloat16:
        return CUDA_CORE
    if all(t.data_ptr() % 16 == 0 and t.shape[-1] % 8 == 0
           for t in operands):
        return WGMMA
    return MMA_SYNC


def shape_path(k: int, n: int, dtype: torch.dtype) -> str:
    """:func:`gemm_path` of ``[m, k] @ [k, n]`` at aligned addresses."""
    if dtype != torch.bfloat16:
        return CUDA_CORE
    return WGMMA if k % 8 == 0 and n % 8 == 0 else MMA_SYNC


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy at a 16-byte-aligned address (a fresh allocation)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _cache_key(m: int, k: int, n: int, dtype: torch.dtype, platform: str,
               path: str) -> str:
    return (f"{platform}|{TILE_VERSION}|{path}|m{m}k{k}n{n}|"
            f"{str(dtype).replace('torch.', '')}")


def _load_disk() -> Dict[str, List[int]]:
    try:
        with open(cache_path()) as f:
            d = json.load(f)
        return d if isinstance(d, dict) else {}
    except (OSError, ValueError):
        return {}


def _store_disk(entries: Dict[str, List[int]]) -> None:
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(entries, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass                      # the cache is an optimisation, never fatal


def _fit(b: int, dim: int, cands: Tuple[int, ...]) -> int:
    want = min(b, dim)
    return next((c for c in cands if c >= want), cands[-1])


def clip(blocks: Blocks, m: int, k: int, n: int) -> Blocks:
    """Each block size cut to its dim, then rounded up to a compiled size."""
    bm, bn, bk = blocks
    return (_fit(bm, m, CAND_M), _fit(bn, n, CAND_N), _fit(bk, k, CAND_K))


def smem_bytes(bm: int, bn: int, bk: int, itemsize: int,
               path: str = CUDA_CORE) -> int:
    """Shared memory of one block (csrc/tile_mm.cuh; csrc/gemm_tc.cuh for
    ``wgmma``: the stages, their two barriers each, 1 KB to align)."""
    if path == WGMMA:
        return 1024 + TC_STAGES * (2 * (bm + bn) * bk + 16)
    if itemsize == 2:
        return 2 * (bm + bn) * (bk + 8)
    return 4 * bk * (bm + 4 + bn + 4)


def candidates(m: int, k: int, n: int, itemsize: int = 4,
               path: str = CUDA_CORE) -> List[Blocks]:
    """The clipped, shared-memory-feasible, deduplicated candidates."""
    if path == WGMMA:
        # 128 x 256 only where the product is wider than one 128 column
        return [b for b in TC_BLOCKS if b[1] == 128 or n > 128]
    seen, out = set(), []
    for bm in CAND_M:
        for bn in CAND_N:
            for bk in CAND_K:
                c = clip((bm, bn, bk), m, k, n)
                if c in seen:
                    continue
                seen.add(c)
                if smem_bytes(*c, itemsize=itemsize) <= SMEM_BUDGET_BYTES:
                    out.append(c)
    return out or [clip(DEFAULT_BLOCKS, m, k, n)]


def _time_candidate(m: int, k: int, n: int, dtype: torch.dtype,
                    device: torch.device, blocks: Blocks, repeats: int,
                    path: str) -> float:
    from repro_torch.kernels.collective_matmul import tile_matmul
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(m, k, generator=gen, device=device).to(dtype)
    w = torch.randn(k, n, generator=gen, device=device).to(dtype)
    bm, bn, bk = blocks

    def run():
        return tile_matmul(x, w, block_m=bm, block_n=bn, block_k=bk,
                           count=False, path=path)

    run()
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(max(repeats, 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def tuned_blocks(m: int, k: int, n: int, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 repeats: int = 3, path: Optional[str] = None) -> Blocks:
    """The ``(block_m, block_n, block_k)`` for ``[m, k] @ [k, n]`` on
    ``device`` (CPU by default) on ``path`` (default :func:`shape_path`):
    timed on a CUDA device, elsewhere the path's default
    (``TC_DEFAULT_BLOCKS``, or ``DEFAULT_BLOCKS`` clipped); cached either
    way."""
    device = torch.device(device or "cpu")
    path = path or shape_path(k, n, dtype)
    key = _cache_key(m, k, n, dtype, platform_of(device), path)
    mem_key = (cache_path(), key)
    hit = _MEM_CACHE.get(mem_key)
    if hit is not None:
        return hit
    disk = _load_disk()
    raw = disk.get(key)
    if isinstance(raw, list) and len(raw) == 3:
        blocks = tuple(int(v) for v in raw)
        if path != WGMMA:
            blocks = clip(blocks, m, k, n)
        elif blocks not in TC_BLOCKS:
            blocks = TC_DEFAULT_BLOCKS
        _MEM_CACHE[mem_key] = blocks
        return blocks
    if device.type != "cuda":
        blocks = (TC_DEFAULT_BLOCKS if path == WGMMA
                  else clip(DEFAULT_BLOCKS, m, k, n))
    else:
        itemsize = torch.tensor([], dtype=dtype).element_size()
        timed = [(_time_candidate(m, k, n, dtype, device, c, repeats,
                                  path), c)
                 for c in candidates(m, k, n, itemsize=itemsize, path=path)]
        blocks = min(timed)[1]
    _MEM_CACHE[mem_key] = blocks
    disk = _load_disk()           # what other processes stored meanwhile
    disk[key] = list(blocks)
    _store_disk(disk)
    return blocks
