"""The least time an H100 could take for a kernel's work: the larger of
the bytes it must move (each input read once, each output written once)
over the card's memory rate and its operations over the peak rate for
their type (NVIDIA's data sheet, H100 SXM, dense, at 700 W).

``python -m repro_torch.kernels.bounds`` prints the bounds of the ring
attention kernel (PERF.md row 6), of the grouped matmul and the SSD
forward and backward (rows 7, 8, 8b; each SSD row with its f32 and its
tensor-core bound), of the RG-LRU forward and backward (rows 9, 9b) and
of flash attention at recurrentgemma-9b's head dim 256 (row 3), each at
a named shape of a configuration that runs it.  ``chip_smoke.py``
computes its bounds from the same work functions at its own inputs.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Optional, Tuple

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# special-function (MUFU) results a clock an SM at compute capability 9.0
# (the CUDA programming guide's throughput table: exp2, reciprocal,
# reciprocal square root), the H100 SXM's SMs and its highest SM clock
MUFU_PER_CLOCK = 16
H100_SMS = 132
H100_SM_CLOCK_HZ = 1.98e9


def bound(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """-> (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ring_attention_work(b: int, sq: int, h: int, kvh: int, hd: int,
                        shards: int, pairs: int, elt: int
                        ) -> Tuple[int, int]:
    """(bytes, flops) of one rank's ring-attention forward: reads q and
    the ``shards`` KV shards of sq positions it needs, writes out and lse;
    q.k and p.v, 4 hd flops a visible pair (``pairs`` a head) and head."""
    return (b * (2 * sq * h * hd * elt + h * sq * 4
                 + shards * 2 * sq * kvh * hd * elt),
            4 * hd * pairs * h * b)


def _ring_row(label: str, b: int, s: int, n: int) -> Dict:
    """``ring_attention.py:218`` ``_ring_attn_kernel`` (forward) on the
    last device of n: internlm2-1.8b (16 q / 8 kv heads of 128), causal,
    q and each KV shard s / n positions.  The last device sees all n KV
    shards (n - 1 whole, the diagonal one half).  bf16
    (:func:`ring_attention_work`)."""
    h, kvh, hd = 16, 8, 128
    blk = s // n
    pairs = (n - 1) * blk * blk + blk * (blk + 1) // 2
    nbytes, flops = ring_attention_work(b, blk, h, kvh, hd, n, pairs, 2)
    return _row("ring_attention", label, nbytes, flops, "bfloat16")


def ring_attention() -> Dict:
    """The 32k prefill shape at batch 1, seq_shard 8 (one device of 8)."""
    return _ring_row("internlm2-1.8b, s 32768, seq_shard 8, last device",
                     1, 32768, 8)


def ring_attention_slice() -> Dict:
    """The training slice's shape: batch 2, seq 4096, tp = seq_shard 2,
    the last rank (``chip_smoke.py`` phases 11 and 13)."""
    return _ring_row("internlm2-1.8b, b 2, s 4096, seq_shard 2, last rank",
                     2, 4096, 2)


def rmsnorm_work(rows: int, d: int, elt: int) -> Tuple[int, int]:
    """(bytes, operations) of the RMSNorm forward on [rows, d]: reads x
    (``elt`` bytes a value) and the f32 scale once, writes y; 4 operations
    an element (the bound of ``chip_smoke.py``'s rmsnorm rows and the
    counter's unit)."""
    return 2 * rows * d * elt + d * 4, 4 * rows * d


def rmsnorm_bwd_work(rows: int, d: int, elt: int) -> Tuple[int, int]:
    """(bytes, operations) of the RMSNorm backward: reads x and dy and the
    scale, writes dx and dscale; 12 operations an element
    (the bound of ``chip_smoke.py``'s rmsnorm_bwd rows and the
    counter's unit)."""
    return 3 * rows * d * elt + 2 * d * 4, 12 * rows * d


def gemm_work(m: int, k: int, n: int, elt: int) -> Tuple[int, int]:
    """(bytes, flops) of [m, k] @ [k, n]: reads both operands once, writes
    the product; 2 m k n flops (the bound of ``chip_smoke.py``'s GEMM-tile
    rows and the counter's unit)."""
    return (m * k + k * n + m * n) * elt, 2 * m * k * n


def paged_decode_work(b: int, h: int, kvh: int, hd: int, rows: int,
                      positions: int, tables: int, elt: int
                      ) -> Tuple[int, int]:
    """(bytes, flops) of the paged decode: reads the ``rows`` distinct
    K/V rows its slots map, q, the ``tables`` int32 entries and the b
    positions, writes out; q.k and p.v over ``positions`` (every slot's
    positions up to its own) for each of the h heads."""
    return (2 * rows * kvh * hd * elt + 2 * b * h * hd * elt + tables * 4
            + b * 4, 4 * positions * h * hd)


def moe_gmm_work(e: int, c: int, d: int, f: int, elt: int
                 ) -> Tuple[int, int]:
    """(bytes, flops) of x [e, c, d] @ w [e, d, f] -> [e, c, f]: reads x
    and w once, writes the output; 2 c d f flops an expert."""
    return elt * (e * c * d + e * d * f + e * c * f), 2 * e * c * d * f


def moe_gmm() -> Dict:
    """``moe_gmm.py:19`` ``_kernel``: granite-moe-3b-a800m (40 experts,
    top 8, d 1536, expert d_ff 512), 4,096 tokens: capacity
    ceil(4096 * 8 / 40 * 1.25) = 1,024 rows an expert
    (``models/moe.py`` ``capacity``); x [40, 1024, 1536] @ w
    [40, 1536, 512], bf16."""
    e, d, f, t, k = 40, 1536, 512, 4096, 8
    c = max(8, math.ceil(t * k / e * 1.25))
    nbytes, flops = moe_gmm_work(e, c, d, f, 2)
    return _row("moe_gmm", f"granite-moe-3b-a800m, 4096 tokens, C {c}",
                nbytes, flops, "bfloat16")


def ssd_work(b: int, s: int, h: int, p: int, n: int, q: int, elt: int
             ) -> Tuple[int, int]:
    """(bytes, flops) of the chunked SSD's y: reads x (``elt`` bytes a
    value), dt (f32), B and C (``elt``) and A_log, D once, writes y.  The
    least arithmetic: per (batch, chunk) C B^T over the q (q + 1) / 2 causal
    pairs once (B and C are shared by the heads), and per head the masked
    product with dt x over the same pairs, C S^T and the chunk state (2 q
    n p each)."""
    nc = s // q
    pairs = q * (q + 1) // 2
    flops = b * nc * (2 * pairs * n + h * (2 * pairs * p + 4 * q * n * p))
    nbytes = (elt * (2 * b * s * h * p + 2 * b * s * n) + 4 * b * s * h
              + 8 * h)
    return nbytes, flops


def ssd_bwd_work(b: int, s: int, h: int, p: int, n: int, q: int, elt: int
                 ) -> Tuple[int, int]:
    """(bytes, flops) of the chunked SSD's backward (``ref.ssd_bwd_ref``):
    reads x, dy, B and C (``elt`` bytes a value), dt, A_log and D once,
    writes dx, dB, dC (``elt``), d(dt), dA_log and dD.  The least
    arithmetic from the inputs alone: per (batch, chunk) C B^T over the
    causal pairs and the heads' dCB times B and C (three products over the
    causal pairs); per head dy x^T and M^T dy over the causal pairs, and
    five products of 2 q n p: the chunk's state, its gradient, B G^T,
    dy S_prev and x G."""
    nc = s // q
    pairs = q * (q + 1) // 2
    flops = b * nc * (3 * 2 * pairs * n
                      + h * (2 * 2 * pairs * p + 5 * 2 * q * n * p))
    nbytes = (elt * (3 * b * s * h * p + 4 * b * s * n) + 2 * 4 * b * s * h
              + 4 * 4 * h)
    return nbytes, flops


def ssd_bounds(nbytes: float, flops: float, dtype: str) -> Dict:
    """Both bounds of an SSD kernel's work and the one it is held to: f32
    math on the CUDA cores (``float32``) for f32 inputs, the bf16 tensor
    cores (``bfloat16``: the products' operands are bf16 or bf16 halves)
    for bf16 inputs."""
    f32 = bound(nbytes, flops, "float32")
    tc = bound(nbytes, flops, "bfloat16")
    held = f32 if dtype == "float32" else tc
    return dict(bound_ms=held[0], bound_by=held[1], bound_f32_ms=f32[0],
                bound_f32_by=f32[1], bound_tc_ms=tc[0], bound_tc_by=tc[1])


def _ssd_row(name, work) -> Dict:
    """An SSD row at mamba2-130m's slice (d_inner 1536 = 24 heads of 64,
    state 128), batch 1, seq 4096, chunk 128, bf16 x, B, C, y and their
    gradients, with both bounds (:func:`ssd_bounds`)."""
    nbytes, flops = work(1, 4096, 24, 64, 128, 128, 2)
    return dict(_row(name, "mamba2-130m, batch 1, seq 4096, chunk 128",
                     nbytes, flops, "bfloat16"),
                **ssd_bounds(nbytes, flops, "bfloat16"))


def ssd() -> Dict:
    """``ssd.py:25`` ``_kernel`` (:func:`ssd_work`)."""
    return _ssd_row("ssd", ssd_work)


def ssd_bwd() -> Dict:
    """The SSD's backward (port-only: XLA differentiates ``ssd_chunked``
    in JAX; :func:`ssd_bwd_work`)."""
    return _ssd_row("ssd_bwd", ssd_bwd_work)


def rglru_work(b: int, s: int, w: int, elt: int) -> Tuple[int, int]:
    """(bytes, flops) of the RG-LRU forward: reads x [b, s, w] (``elt``
    bytes a value) and the five f32 [w] gate vectors once, writes y;
    about 24 f32 operations an element (two sigmoids, a softplus-scaled
    decay, two exps, the clamp and sqrt, the gated input, the
    recurrence's multiply-add)."""
    n = b * s * w
    return 2 * elt * n + 5 * 4 * w, 24 * n


def rglru_bwd_work(b: int, s: int, w: int, elt: int) -> Tuple[int, int]:
    """(bytes, flops) of the RG-LRU backward: reads x and dy (``elt``
    bytes a value) and the gates once, writes dx and the five gate
    gradients; about 50 f32 operations an element (the gates again, the
    reverse recurrence, the chain through q, i, r and x, five sums).  The
    f32 states that the port's forward keeps for it are a design's choice,
    not the work's (:func:`rglru_states_bytes`)."""
    n = b * s * w
    return 3 * elt * n + 10 * 4 * w, 50 * n


# steps in a time tile of the RG-LRU kernels (``kernels/rglru.py`` ``TILE``)
RGLRU_TILE = 64


def rglru_states_bytes(b: int, s: int, w: int) -> int:
    """Bytes the port's design adds to the RG-LRU's work: the forward
    writes the f32 state entering each time tile of ``RGLRU_TILE`` steps,
    [b, ceil(s / RGLRU_TILE), w], and the backward reads it."""
    return 2 * 4 * b * -(-s // RGLRU_TILE) * w


# special-function results an element: the gates' 4 exps, 2 reciprocals
# (the sigmoids) and 1 sqrt; the backward's chain rule adds one division
RGLRU_MUFU = {"forward": 7, "backward": 8}


def mufu_ms(results: float, clock_hz: float = H100_SM_CLOCK_HZ,
            sms: int = H100_SMS) -> float:
    """The least time for ``results`` special-function results at
    ``MUFU_PER_CLOCK`` a clock on each of ``sms`` SMs.  Reported beside a
    kernel's bound, not folded into it."""
    return 1e3 * results / (MUFU_PER_CLOCK * sms * clock_hz)


def rglru() -> Dict:
    """``rglru.py:23`` ``_kernel``: recurrentgemma-9b (RG-LRU width 4096),
    the slice's batch 2 x seq 4096, bf16 x and y (:func:`rglru_work`)."""
    nbytes, flops = rglru_work(2, 4096, 4096, 2)
    return dict(_row("rglru", "recurrentgemma-9b, batch 2, seq 4096",
                     nbytes, flops, "float32"),
                mufu_ms=mufu_ms(RGLRU_MUFU["forward"] * 2 * 4096 * 4096))


def rglru_bwd() -> Dict:
    """The RG-LRU's backward (port-only: XLA differentiates the scan in
    JAX) at the same shape (:func:`rglru_bwd_work`), with the bytes of the
    f32 tile-start states that the port's forward keeps for it and the
    special-function floor beside the bound."""
    nbytes, flops = rglru_bwd_work(2, 4096, 4096, 2)
    return dict(_row("rglru_bwd", "recurrentgemma-9b, batch 2, seq 4096",
                     nbytes, flops, "float32"),
                states_bytes=rglru_states_bytes(2, 4096, 4096),
                mufu_ms=mufu_ms(RGLRU_MUFU["backward"] * 2 * 4096 * 4096))


def visible_pairs(s: int, window=None, *, sk: Optional[int] = None,
                  causal: bool = True) -> int:
    """(query, key) pairs a head attends: queries at ``arange(s)``
    against keys at ``arange(sk)`` (default s) under a causal mask (with
    a window, if any), or every pair (``causal`` False, no window)."""
    sk = s if sk is None else sk
    if not causal and window is None:
        return s * sk
    if sk != s or not causal:
        total = 0
        for p in range(s):
            hi = min(p, sk - 1) if causal else sk - 1
            lo = 0 if window is None else max(0, p - window + 1)
            total += max(0, hi - lo + 1)
        return total
    if window is None:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_work(b: int, s: int, h: int, kvh: int, hd: int, pairs: int,
               elt: int, sk: Optional[int] = None
               ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((bytes, flops) forward, (bytes, flops) backward) of flash
    attention of s queries against sk keys (default s) with ``pairs``
    visible pairs a head: the forward reads q, k, v and writes out and
    lse, q.k and p.v over the pairs; the backward reads q, k, v, out,
    dout and lse, writes dq, dk, dv, four products over the pairs (the
    recomputation of the scores is a design's choice, not the work's)."""
    sk = s if sk is None else sk
    q, kv, lse = b * s * h * hd, b * sk * kvh * hd, b * h * s * 4
    return ((2 * q * elt + 2 * kv * elt + lse, 4 * hd * pairs * b * h),
            (4 * q * elt + 4 * kv * elt + lse, 8 * hd * pairs * b * h))


def flash_hd256() -> Dict:
    """``flash_attention.py:30`` ``_kernel`` at recurrentgemma-9b's local
    attention: 16 q heads and 1 kv head of 256, window 2048, batch 2, seq
    4096, bf16 (:func:`flash_work`): forward and backward."""
    (fb, ff), (bb, bf) = flash_work(2, 4096, 16, 1, 256,
                                    visible_pairs(4096, 2048), 2)
    shape = "recurrentgemma-9b local attention, b 2, s 4096, window 2048"
    return {"forward": _row("flash_attention", shape, fb, ff, "bfloat16"),
            "backward": _row("flash_attention_bwd", shape, bb, bf,
                             "bfloat16")}


def _row(name, shape, nbytes, flops, dtype) -> Dict:
    ms, by = bound(nbytes, flops, dtype)
    return dict(kernel=name, shape=shape, dtype=dtype, bytes=nbytes,
                flops=flops, bound_ms=ms, bound_by=by)


if __name__ == "__main__":
    for fn in (ring_attention, ring_attention_slice, moe_gmm, ssd, ssd_bwd,
               rglru, rglru_bwd, flash_hd256):
        print(json.dumps(fn()))
