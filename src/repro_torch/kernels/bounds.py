"""The least time an H100 could take for a kernel's work: the larger of
the bytes it must move (each input read once, each output written once)
over the card's memory rate and its operations over the peak rate for
their type (NVIDIA's data sheet, H100 SXM, dense, at 700 W).

``python -m repro_torch.kernels.bounds`` prints the bounds of the ring
attention kernel (PERF.md row 6) and of the TPU kernels not ported yet
(rows 7-9), each at a named shape of a configuration that runs or would
run it, worked out from the Pallas kernel's code.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Tuple

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def bound(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """-> (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _ring_row(label: str, b: int, s: int, n: int) -> Dict:
    """``ring_attention.py:218`` ``_ring_attn_kernel`` (forward) on the
    last device of n: internlm2-1.8b (16 q / 8 kv heads of 128), causal,
    q and each KV shard s / n positions.  The last device sees all n KV
    shards (n - 1 whole, the diagonal one half): q.k and p.v, 4 hd flops
    a visible pair and head; reads q and the n KV shards, writes out and
    lse.  bf16."""
    h, kvh, hd = 16, 8, 128
    blk = s // n
    pairs = (n - 1) * blk * blk + blk * (blk + 1) // 2
    flops = 4 * hd * pairs * h * b
    nbytes = b * (2 * blk * h * hd * 2 + h * blk * 4
                  + n * 2 * blk * kvh * hd * 2)
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


def moe_gmm() -> Dict:
    """``moe_gmm.py:19`` ``_kernel``: granite-moe-3b-a800m (40 experts,
    top 8, d 1536, expert d_ff 512), 4,096 tokens: capacity
    ceil(4096 * 8 / 40 * 1.25) = 1,024 rows an expert
    (``models/moe.py`` ``capacity``); x [40, 1024, 1536] @ w
    [40, 1536, 512], bf16."""
    e, d, f, t, k = 40, 1536, 512, 4096, 8
    c = max(8, math.ceil(t * k / e * 1.25))
    flops = 2 * e * c * d * f
    nbytes = 2 * (e * c * d + e * d * f + e * c * f)
    return _row("moe_gmm", f"granite-moe-3b-a800m, 4096 tokens, C {c}",
                nbytes, flops, "bfloat16")


def ssd() -> Dict:
    """``ssd.py:25`` ``_kernel``: mamba2-130m (d_inner 1536 = 24 heads of
    64, state 128), batch 1, seq 4096, chunk 128.  Per (head, chunk):
    C B^T (2 q^2 n), the masked product with dt*x (2 q^2 p), C S^T and the
    state update (2 q n p each); f32 math.  Reads dt*x and the log-decay
    (f32, [b, h, s, p] and [b, h, s]) and B, C (bf16 [b, s, n]); writes y
    (bf16 [b, h, s, p])."""
    h, p, n, s, q = 24, 64, 128, 4096, 128
    chunks = h * (s // q)
    flops = chunks * (2 * q * q * n + 2 * q * q * p + 4 * q * n * p)
    nbytes = 4 * (h * s * p + h * s) + 2 * 2 * s * n + 2 * h * s * p
    return _row("ssd", "mamba2-130m, batch 1, seq 4096, chunk 128",
                nbytes, flops, "float32")


def rglru() -> Dict:
    """``rglru.py:23`` ``_kernel``: recurrentgemma-9b (RG-LRU width 4096),
    batch 1, seq 4096: reads x (bf16 [s, w]) and the five f32 gate vectors,
    writes y (bf16); about 20 f32 operations an element (two sigmoids, a
    softplus, two exps, a sqrt, the recurrence)."""
    s, w = 4096, 4096
    flops = 20 * s * w
    nbytes = 2 * s * w * 2 + 5 * w * 4
    return _row("rglru", "recurrentgemma-9b, batch 1, seq 4096", nbytes,
                flops, "float32")


def _row(name, shape, nbytes, flops, dtype) -> Dict:
    ms, by = bound(nbytes, flops, dtype)
    return dict(kernel=name, shape=shape, dtype=dtype, bytes=nbytes,
                flops=flops, bound_ms=ms, bound_by=by)


if __name__ == "__main__":
    for fn in (ring_attention, ring_attention_slice, moe_gmm, ssd, rglru):
        print(json.dumps(fn()))
