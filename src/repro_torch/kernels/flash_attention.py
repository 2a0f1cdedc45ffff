"""Flash attention: wrappers of the CUDA kernels ``csrc/flash_attention.cu``
(training forward and backward) and ``csrc/paged_decode.cu`` (paged
decode, every dense decode read through a block-table view, and the
speculative verify's ``qn`` queries a slot folded into its batch).

Counterparts of ``repro.kernels.flash_attention.flash_attention`` and
``paged_flash_decode``, with the same layouts, and the decode reads of
``repro.models.attention.decode_attention`` (:func:`dense_flash_decode`).  A CPU tensor takes the
plain version (:mod:`repro_torch.kernels.ref`); a CUDA tensor launches
the kernel or raises.  :func:`flash_attention` is a
``torch.autograd.Function`` whose backward is the backward kernel (the
plain backward on the CPU).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (decode_attention_multi_ref,
                                    decode_attention_ref,
                                    flash_attention_bwd_ref,
                                    flash_attention_ref,
                                    paged_decode_attention_multi_ref,
                                    paged_decode_attention_ref, wide_dtype)

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}
# query heads per KV head and head dims that the paged decode kernel is
# compiled for; the training kernels take any group at run time, and
# their own head dims
GROUPS = (1, 2, 3, 4, 8, 16)
PAGED_HEAD_DIMS = (32, 64, 128, 256)
HEAD_DIMS = (32, 64, 128, 256)
# the paged decode's splits: at most this many positions a split (four
# chunks of a bf16 hd-128 block: short chains of dependent chunk loads),
# and enough (slot, kv head, split) blocks for a few on each of the H100's
# 132 SMs when every slot is full
SPLIT_POSITIONS = 128
SPLIT_BLOCKS = 4 * 132
# per (device, stream): the split merge's int32 counters (0 between calls:
# the last block of each (slot, kv head) resets its own) and f32 partials,
# grown to the largest call seen
_PAGED_SCRATCH = {}
# the largest page of a dense cache's block-table view
DENSE_PAGE = 16
# per (slots, blocks, device): the view's constant table
_DENSE_TABLES = {}
# per (slots, blocks, queries, device): that table with each slot's row
# repeated once a verified query (the verify's folded batch)
_FOLDED_TABLES = {}


def paged_splits(b: int, kvh: int, page: int, nb: int):
    """(pages a split covers, splits a slot has) of the paged decode
    kernel: a pure function of the shapes, never of ``pos``.  A split
    covers at most ``SPLIT_POSITIONS`` positions (rounded up to whole
    pages), and a full batch of ``b * kvh`` pairs gets at least
    ``SPLIT_BLOCKS`` blocks where ``nb`` allows."""
    want = max(-(-nb * page // SPLIT_POSITIONS), -(-SPLIT_BLOCKS // (b * kvh)))
    pps = -(-nb // min(want, nb))
    return pps, -(-nb // pps)


def _paged_scratch(device, stream: int, pairs: int, floats: int):
    counters, partial = _PAGED_SCRATCH.get((device, stream), (None, None))
    if counters is None or counters.numel() < pairs:
        counters = torch.zeros(pairs, dtype=torch.int32, device=device)
    if partial is None or partial.numel() < floats:
        partial = torch.empty(floats, dtype=torch.float32, device=device)
    _PAGED_SCRATCH[device, stream] = counters, partial
    return counters, partial


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, tables: torch.Tensor,
                       pos: torch.Tensor, *, softcap: float = 0.0,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention reading the KV cache through a block
    table.

    q [b, 1, h, hd]; k_pages/v_pages [P, page, kvh, hd] (q's dtype, f32 or
    bf16); tables [b, nb] int32 (physical page of logical block i; 0 is
    the null page); pos [b] int32 -> [b, 1, h, hd]."""
    tensors = (q, k_pages, v_pages, tables, pos)
    if _build.on_cpu("paged_flash_decode", *tensors):
        return paged_decode_attention_ref(q, k_pages, v_pages, tables, pos,
                                          softcap=softcap, scale=scale)
    b, one, h, hd = q.shape
    npages, page, kvh, hd_k = k_pages.shape
    if one != 1 or hd_k != hd or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"paged_flash_decode: q {tuple(q.shape)}, k_pages "
            f"{tuple(k_pages.shape)}, v_pages {tuple(v_pages.shape)} do not "
            f"match [b, 1, h, hd] and [P, page, kvh, hd]")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(
            f"paged_flash_decode kernel takes f32 or bf16 q/k/v of one "
            f"dtype, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if h % kvh or h // kvh not in GROUPS or hd not in PAGED_HEAD_DIMS:
        raise ValueError(
            f"paged_flash_decode kernel supports h/kvh in {GROUPS} and hd "
            f"in {PAGED_HEAD_DIMS}, got h={h} kvh={kvh} hd={hd}")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32 \
            or tables.dim() != 2 or tables.shape[0] != b \
            or pos.shape != (b,):
        raise TypeError(
            f"paged_flash_decode takes int32 tables [b, nb] and pos [b] "
            f"with b={b}, got {tables.dtype} {tuple(tables.shape)} and "
            f"{pos.dtype} {tuple(pos.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_flash_decode kernel takes contiguous tensors")
    scale = hd ** -0.5 if scale is None else scale
    nb = tables.shape[1]
    pps, nsplit = paged_splits(b, kvh, page, nb)
    stream = _build.stream_ptr(q)
    counters, partial = _paged_scratch(q.device, stream, b * kvh,
                                       b * nsplit * h * (hd + 2))
    out = torch.empty_like(q)
    lib = _build.library()
    rc = lib.repro_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        partial.data_ptr(), counters.data_ptr(), b, kvh, h // kvh, hd, page,
        nb, pps, nsplit, scale, softcap, _DTYPES[q.dtype], stream)
    _build.check(rc, "paged_decode kernel launch")
    _build.LAUNCHES["paged_decode"] += 1
    return out


def dense_page(S: int) -> int:
    """The page of the block-table view of a dense cache of S rows: the
    largest divisor of S up to ``DENSE_PAGE`` (16 at 2,048 and 4,096, 15
    at whisper's 1,500 context rows, 4 at llama's 6,404)."""
    return next(p for p in range(min(DENSE_PAGE, S), 0, -1) if S % p == 0)


def _dense_tables(b: int, nb: int, device) -> torch.Tensor:
    key = (b, nb, device)
    t = _DENSE_TABLES.get(key)
    if t is None:
        t = torch.arange(b * nb, dtype=torch.int32,
                         device=device).view(b, nb)
        _DENSE_TABLES[key] = t
    return t


def dense_flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, pos: torch.Tensor, *,
                       window: Optional[int] = None, softcap: float = 0.0,
                       scale: Optional[float] = None,
                       ring: bool = False) -> torch.Tensor:
    """Single-token decode attention over a dense per-slot cache
    (``repro.models.attention.decode_attention``): q [b, 1, h, hd];
    k_cache/v_cache [b, S, kvh, hd]; pos [b] int32 -> [b, 1, h, hd].

    On the card the paged decode kernel reads the cache through a view of
    pages: [b, S, kvh, hd] is [b * nb, page, kvh, hd] (``dense_page``)
    under the constant table ``tables[s, i] = s * nb + i``, whose gathered
    view is the cache itself.  A ring of S = window slots attends to the
    first ``min(pos + 1, S)``: the kernel's mask at ``min(pos, S - 1)``.
    A window that is not a ring raises on CUDA (no decode step reads one).
    On the CPU, the plain masked softmax (:func:`~repro_torch.kernels.ref.
    decode_attention_ref`)."""
    if _build.on_cpu("dense_flash_decode", q, k_cache, v_cache, pos):
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window,
                                    softcap=softcap, scale=scale, ring=ring)
    if window is not None and not ring:
        raise NotImplementedError(
            "dense_flash_decode: a window over a linear cache is not a mask "
            "the paged decode kernel takes (the decode step reads local "
            "layers as rings)")
    b, S, kvh, hd = k_cache.shape
    if v_cache.shape != k_cache.shape or not (k_cache.is_contiguous()
                                              and v_cache.is_contiguous()):
        raise ValueError(
            f"dense_flash_decode: k_cache {tuple(k_cache.shape)} and v_cache "
            f"{tuple(v_cache.shape)} must be one contiguous [b, S, kvh, hd]")
    page = dense_page(S)
    nb = S // page
    if ring:
        pos = torch.clamp(pos, max=S - 1)
    return paged_flash_decode(
        q, k_cache.view(b * nb, page, kvh, hd),
        v_cache.view(b * nb, page, kvh, hd), _dense_tables(b, nb, q.device),
        pos, softcap=softcap, scale=scale)


def _fold(q: torch.Tensor, pos: torch.Tensor, rows: int):
    """The verify's queries as a decode batch: q [b, qn, h, hd] -> [b * qn,
    1, h, hd], row ``(slot, j)`` at position ``min(pos + j, rows - 1)`` (a
    query past the last row sees every row, as JAX's mask does); its
    table row is the slot's, repeated once a query."""
    b, qn, h, hd = q.shape
    qpos = pos[:, None] + torch.arange(qn, dtype=pos.dtype,
                                       device=pos.device)[None]
    return (q.contiguous().view(b * qn, 1, h, hd),
            torch.clamp(qpos, max=rows - 1).view(b * qn))


def paged_flash_decode_multi(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, tables: torch.Tensor,
                             pos: torch.Tensor, *, softcap: float = 0.0,
                             scale: Optional[float] = None) -> torch.Tensor:
    """The speculative verify's attention through a block table
    (``repro.models.attention.paged_decode_attention_multi``): q [b, qn,
    h, hd], query j of a slot at position ``pos + j`` sees the slot's
    positions up to it; k_pages/v_pages [P, page, kvh, hd]; tables [b, nb]
    int32; pos [b] int32 -> [b, qn, h, hd].  On the card the paged decode
    kernel runs the ``b * qn`` queries as its batch (:func:`_fold`): what
    the TPU kernel computes for each query.  On the CPU, JAX's masked
    softmax in f32 (:func:`~repro_torch.kernels.ref.
    paged_decode_attention_multi_ref`)."""
    if _build.on_cpu("paged_flash_decode_multi", q, k_pages, v_pages,
                     tables, pos):
        return paged_decode_attention_multi_ref(q, k_pages, v_pages, tables,
                                                pos, softcap=softcap,
                                                scale=scale)
    qf, pf = _fold(q, pos, tables.shape[1] * k_pages.shape[1])
    return paged_flash_decode(
        qf, k_pages, v_pages, tables.repeat_interleave(q.shape[1], dim=0),
        pf, softcap=softcap, scale=scale).view(q.shape)


def _folded_tables(b: int, nb: int, qn: int, device) -> torch.Tensor:
    key = (b, nb, qn, device)
    t = _FOLDED_TABLES.get(key)
    if t is None:
        t = _dense_tables(b, nb, device).repeat_interleave(qn, dim=0)
        _FOLDED_TABLES[key] = t
    return t


def dense_flash_decode_multi(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, pos: torch.Tensor, *,
                             softcap: float = 0.0,
                             scale: Optional[float] = None) -> torch.Tensor:
    """The speculative verify's attention over a dense cache
    (``repro.models.attention.decode_attention_multi``): q [b, qn, h, hd];
    k_cache/v_cache [b, S, kvh, hd]; pos [b] int32 -> [b, qn, h, hd].  On
    the card the paged decode kernel reads the cache through its
    block-table view (:func:`dense_flash_decode`), the view's table row of
    each slot repeated once a query (cached per shape), the ``b * qn``
    queries as its batch.  On the CPU, JAX's masked softmax in f32."""
    if _build.on_cpu("dense_flash_decode_multi", q, k_cache, v_cache, pos):
        return decode_attention_multi_ref(q, k_cache, v_cache, pos,
                                          softcap=softcap, scale=scale)
    b, S, kvh, hd = k_cache.shape
    if v_cache.shape != k_cache.shape or not (k_cache.is_contiguous()
                                              and v_cache.is_contiguous()):
        raise ValueError(
            f"dense_flash_decode_multi: k_cache {tuple(k_cache.shape)} and "
            f"v_cache {tuple(v_cache.shape)} must be one contiguous "
            f"[b, S, kvh, hd]")
    page = dense_page(S)
    nb = S // page
    qf, pf = _fold(q, pos, S)
    return paged_flash_decode(
        qf, k_cache.view(b * nb, page, kvh, hd),
        v_cache.view(b * nb, page, kvh, hd),
        _folded_tables(b, nb, q.shape[1], q.device), pf, softcap=softcap,
        scale=scale).view(q.shape)


def _flash_check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int]):
    """Shapes the plain versions and the kernels share; raises otherwise."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2] or min(q.shape[1], k.shape[1]) < 1:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} do not match the shapes [b, sq, h, hd] and "
            f"[b, sk, kvh, hd] with kvh | h")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")


def _flash_on_cpu(what: str, tensors, lse: Optional[torch.Tensor] = None,
                  *, tma: int = 0) -> bool:
    """``_build.on_cpu`` (over ``tensors`` and ``lse``); on CUDA,
    :func:`_kernel_check` of them."""
    extra = () if lse is None else (lse,)
    if _build.on_cpu(what, *tensors, *extra):
        return True
    _kernel_check(tensors, extra, tma=tma)
    return False


def _kernel_check(tensors, extra=(), *, tma: int = 0):
    """What the kernels take: one f32 or bf16 dtype for ``tensors`` (an
    ``extra`` lse is f32, checked by the caller), hd among the compiled
    instances (any group h/kvh: ``_flash_check`` has checked that kvh
    divides h), contiguity; and the first ``tma`` of ``tensors``, which
    the bf16 tensor-core tiles read through tensor maps (the forward's
    q, k, v; the backward's q, k, v, dout), at 16-byte-aligned addresses
    when bf16."""
    if any(t.dtype != tensors[0].dtype for t in tensors) \
            or tensors[0].dtype not in _DTYPES:
        raise TypeError(
            "flash_attention kernels take f32 or bf16 tensors of one dtype, "
            f"got {[t.dtype for t in tensors]}")
    hd = tensors[0].shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernels support hd in {HEAD_DIMS}, got {hd}")
    if not all(t.is_contiguous() for t in (*tensors, *extra)):
        raise ValueError("flash_attention kernels take contiguous tensors")
    if tensors[0].dtype == torch.bfloat16 \
            and any(t.data_ptr() % 16 for t in tensors[:tma]):
        raise ValueError(
            "flash_attention kernels take bf16 tensors that their tensor "
            "maps read at 16-byte aligned addresses, got offsets "
            f"{[t.data_ptr() % 16 for t in tensors[:tma]]} mod 16")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: float = 0.0, scale: Optional[float] = None):
    """Queries at positions ``arange(sq)`` against keys at ``arange(sk)``
    (self-attention: sk = sq; cross attention: any sk, ``causal=False``):
    q [b, sq, h, hd]; k, v [b, sk, kvh, hd] -> (out [b, sq, h, hd], lse
    [b, h, sq] f32).  No autograd (see :func:`flash_attention`)."""
    _flash_check(q, k, v, window)
    if _flash_on_cpu("flash_attention", (q, k, v), tma=3):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    b, sq, h, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    lib = _build.library()
    rc = lib.repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, k.shape[1], h, k.shape[2], hd, int(causal),
        window or 0, scale, softcap, _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check(rc, "flash_attention kernel launch")
    _build.LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, softcap: float = 0.0,
                        scale: Optional[float] = None):
    """Gradient of :func:`flash_attention_fwd` given its ``out`` and
    ``lse``: -> (dq [b, sq, h, hd], dk, dv [b, sk, kvh, hd]) in the
    inputs' dtype."""
    _flash_check(q, k, v, window)
    b, sq, h, hd = q.shape
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (b, h, sq) or lse.dtype != wide_dtype(q):
        raise ValueError(
            f"flash_attention_bwd: out {tuple(out.shape)}, dout "
            f"{tuple(dout.shape)} must be {tuple(q.shape)} and lse "
            f"{tuple(lse.shape)} {lse.dtype} must be ({b}, {h}, {sq}) "
            f"{wide_dtype(q)}")
    if _flash_on_cpu("flash_attention_bwd", (q, k, v, dout, out), lse,
                     tma=4):
        return flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       softcap=softcap, scale=scale)
    scale = hd ** -0.5 if scale is None else scale
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    lib = _build.library()
    rc = lib.repro_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], h, k.shape[2], hd,
        int(causal), window or 0, scale, softcap, _DTYPES[q.dtype],
        _build.stream_ptr(q))
    _build.check(rc, "flash_attention_bwd kernel launch")
    _build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Forward: the flash kernel; backward: the backward kernels (plain
    versions on the CPU).  Saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable attention with the TPU kernel's arithmetic
    (``repro.kernels.flash_attention.flash_attention``): q [b, sq, h, hd];
    k, v [b, sk, kvh, hd] -> [b, sq, h, hd] in q's dtype; queries at
    positions ``arange(sq)``, keys at ``arange(sk)``."""
    return FlashAttentionFunction.apply(q, k, v, causal, window, softcap,
                                        scale)
