"""Plain PyTorch versions of the port's kernels.

The kernel wrappers route CPU tensors here; the tests hold these against
the JAX package, and ``chip_smoke.py`` holds each CUDA kernel against its
plain version on the card.  They run on any device.  Where the kernels
compute in f32, the norm, attention, RG-LRU and SSD versions do too, and in
f64 when given f64 (:func:`wide`): the f64 witness of ``chip_smoke.py``'s
recurrentgemma phase runs the whole model so.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the working precision: f64 stays f64, anything else is
    taken in f32."""
    return t if t.dtype == torch.float64 else t.float()


def wide_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype :func:`wide` gives ``t``."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in f32, cast back to
    x's dtype (``repro.kernels.ref.rmsnorm_ref``)."""
    xf = wide(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * (1.0 + wide(scale))).to(x.dtype)


def gather_pages(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Slot-contiguous KV view of a page pool.

    pages [P, page, kvh, hd]; tables [b, nb] -> [b, nb * page, kvh, hd]."""
    g = pages[tables.long()]                 # [b, nb, page, kvh, hd]
    b, nb, page, kvh, hd = g.shape
    return g.reshape(b, nb * page, kvh, hd)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, tables: torch.Tensor,
                               pos: torch.Tensor, *, softcap: float = 0.0,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention through a block table: gather the
    slot's pages, then :func:`decode_attention_ref` (positions after
    ``pos`` masked, softmax in f32).

    q [b, 1, h, hd]; k_pages/v_pages [P, page, kvh, hd]; tables [b, nb];
    pos [b] -> [b, 1, h, hd] in q's dtype."""
    return decode_attention_ref(q, gather_pages(k_pages, tables),
                                gather_pages(v_pages, tables), pos,
                                softcap=softcap, scale=scale)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: torch.Tensor, *,
                         window: Optional[int] = None, softcap: float = 0.0,
                         scale: Optional[float] = None,
                         ring: bool = False) -> torch.Tensor:
    """Single-token decode attention over a dense cache
    (``repro.models.attention.decode_attention``): the masked softmax over
    every slot, in f32.

    q [b, 1, h, hd]; k_cache/v_cache [b, S, kvh, hd]; pos [b] the new
    token's position -> [b, 1, h, hd] in q's dtype.  Slots up to ``pos``
    are valid (with ``window``, only the last ``window`` of them);
    ``ring``: a circular buffer of S = window slots, the first
    ``min(pos + 1, S)`` written.  ``q * scale`` is taken in f32, as the
    TPU kernel does (``flash_attention.py:160``)."""
    b, _, h, hd = q.shape
    S, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, kvh, g, hd) * scale
    s = torch.einsum("bkgh,bskh->bkgs", qf, k_cache.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    slots = torch.arange(S, device=q.device)[None, :]
    p_ = pos.long()[:, None]
    if ring:
        valid = slots < torch.clamp(p_ + 1, max=S)
    else:
        valid = slots <= p_                                 # [b, S]
        if window is not None:
            valid &= slots > p_ - window
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def decode_attention_multi_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, pos: torch.Tensor, *,
                               softcap: float = 0.0,
                               scale: Optional[float] = None) -> torch.Tensor:
    """The speculative verify's attention over a dense cache
    (``repro.models.attention.decode_attention_multi``): q [b, qn, h, hd]
    holds ``qn`` consecutive tokens at positions ``pos + j``; slot s is
    visible to query j iff ``s <= pos + j``; the masked softmax over
    every slot in f32 -> [b, qn, h, hd] in q's dtype.  ``q * scale`` is
    taken in f32, as in :func:`decode_attention_ref` (JAX scales in q's
    dtype first; the two agree exactly in f32)."""
    b, qn, h, hd = q.shape
    S, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, qn, kvh, g, hd) * scale
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k_cache.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    slots = torch.arange(S, device=q.device)[None, None, :]
    qpos = pos.long()[:, None] + torch.arange(qn, device=q.device)[None, :]
    valid = slots <= qpos[:, :, None]                        # [b, qn, S]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bkgqh", p, v_cache.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, qn, h, hd).to(q.dtype)


def paged_decode_attention_multi_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor,
                                     tables: torch.Tensor, pos: torch.Tensor,
                                     *, softcap: float = 0.0,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """:func:`decode_attention_multi_ref` through a block table
    (``paged_decode_attention_multi``): the slot's pages gathered first."""
    return decode_attention_multi_ref(q, gather_pages(k_pages, tables),
                                      gather_pages(v_pages, tables), pos,
                                      softcap=softcap, scale=scale)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5):
    """Gradient of :func:`rmsnorm_ref` (no Pallas counterpart: XLA
    differentiates ``core/tmp.py`` ``rms_norm`` in JAX).

    With ``w = 1 + scale`` and ``r = rsqrt(mean(x^2) + eps)``:
    ``dx = r * (w*dy - x * r^2 * mean(x*w*dy))`` and
    ``dscale = sum_rows(dy * x * r)``, all in f32; dx in x's dtype,
    dscale f32 [d]."""
    d = x.shape[-1]
    xf = wide(x).reshape(-1, d)
    dyf = wide(dy).reshape(-1, d)
    w = 1.0 + wide(scale)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    wdy = w * dyf
    dot = (xf * wdy).mean(dim=-1, keepdim=True)
    dx = r * (wdy - xf * (r * r) * dot)
    dscale = (dyf * xf * r).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dscale


def _attn_mask(q0: int, q1: int, s: int, causal: bool,
               window: Optional[int], device) -> torch.Tensor:
    """[q1 - q0, s] bool: key j of ``arange(s)`` visible from query i of
    ``arange(q0, q1)`` (absolute positions, as ``chunked_attention`` with
    default positions)."""
    qi = torch.arange(q0, q1, device=device)[:, None]
    kj = torch.arange(s, device=device)[None, :]
    valid = torch.ones(q1 - q0, s, dtype=torch.bool, device=device)
    if causal:
        valid &= kj <= qi
    if window is not None:
        valid &= kj > qi - window
    return valid


# query rows per chunk of the plain flash attention: bounds the f32 score
# block to [b, h, Q_CHUNK, s] instead of [b, h, s, s]
Q_CHUNK = 256


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: float = 0.0, scale: Optional[float] = None):
    """Queries at positions ``arange(sq)`` against keys at ``arange(sk)``
    with the arithmetic of the TPU kernel ``flash_attention.py:30``:
    ``q * scale`` in f32, capped f32 scores masked to NEG_INF, f32 softmax
    state, ``l`` floored at 1e-30.

    q [b, sq, h, hd]; k, v [b, sk, kvh, hd] -> (out [b, sq, h, hd] in q's
    dtype, lse [b, h, sq] f32 with ``lse = m + log(l)``)."""
    return _attention_ref(q, k, v, 0, causal=causal, window=window,
                          softcap=softcap, scale=scale)


def _attention_ref(q, k, v, q_off: int, *, causal, window, softcap, scale):
    """:func:`flash_attention_ref` for queries at positions ``q_off +
    arange(sq)`` against keys at ``arange(sk)``."""
    b, s, h, hd = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    kf = wide(k).permute(0, 2, 1, 3)[:, :, None]       # [b, kvh, 1, sk, hd]
    vf = wide(v).permute(0, 2, 1, 3)[:, :, None]
    out = torch.empty(b, s, h, hd, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, s, dtype=wide_dtype(q), device=q.device)
    for q0 in range(0, s, Q_CHUNK):
        q1 = min(q0 + Q_CHUNK, s)
        qc = (wide(q[:, q0:q1]) * scale).reshape(b, q1 - q0, kvh, g, hd)
        qc = qc.permute(0, 2, 3, 1, 4)                     # [b, kvh, g, c, hd]
        sc = torch.matmul(qc, kf.transpose(-1, -2))        # [b, kvh, g, c, sk]
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
        if causal or window is not None:
            valid = _attn_mask(q_off + q0, q_off + q1, sk, causal, window,
                               q.device)
            sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, vf) / torch.clamp(l, min=1e-30)
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(
            b, q1 - q0, h, hd).to(q.dtype)
        lse[:, :, q0:q1] = (m + torch.log(l)).reshape(b, h, q1 - q0)
    return out, lse


def ring_attention_all_ranks_ref(qs, ks, vs, rank: int, *,
                                 causal: bool = True,
                                 window: Optional[int] = None,
                                 softcap: float = 0.0,
                                 scale: Optional[float] = None):
    """One rank's (out [b, sq, h, hd], lse [b, h, sq] f32) of ring
    attention over contiguous shards, from every rank's inputs: q of
    ``rank`` (positions ``rank * sq + arange(sq)``) against every rank's
    K/V concatenated in rank order, in f32 with the kernel's arithmetic
    (:func:`flash_attention_ref`'s)."""
    k, v = torch.cat(list(ks), dim=1), torch.cat(list(vs), dim=1)
    q = qs[rank]
    return _attention_ref(q, k, v, rank * q.shape[1], causal=causal,
                          window=window, softcap=softcap, scale=scale)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            softcap: float = 0.0,
                            scale: Optional[float] = None):
    """Gradient of :func:`flash_attention_ref` (FlashAttention-2 form; the
    JAX package has no Pallas backward and lets XLA differentiate
    ``chunked_attention``).  P is recomputed from ``lse`` one query chunk
    at a time; ``delta = rowsum(dout * out)``; with a softcap, dS is
    multiplied by ``1 - tanh(s / c)^2``.  dk/dv sum over the g query heads
    of a kv head.  All in f32; -> (dq [b, sq, h, hd], dk, dv [b, sk, kvh,
    hd]) in the inputs' dtype."""
    b, s, h, hd = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    kf = wide(k).permute(0, 2, 1, 3)[:, :, None]       # [b, kvh, 1, sk, hd]
    vf = wide(v).permute(0, 2, 1, 3)[:, :, None]
    dq = torch.empty(b, s, h, hd, dtype=q.dtype, device=q.device)
    dk = torch.zeros(b, kvh, sk, hd, dtype=wide_dtype(q), device=q.device)
    dv = torch.zeros(b, kvh, sk, hd, dtype=wide_dtype(q), device=q.device)

    def heads(t, q0, q1):                          # -> [b, kvh, g, c, hd]
        return wide(t[:, q0:q1]).reshape(b, q1 - q0, kvh, g, hd) \
            .permute(0, 2, 3, 1, 4)

    for q0 in range(0, s, Q_CHUNK):
        q1 = min(q0 + Q_CHUNK, s)
        qc = heads(q, q0, q1) * scale
        doc = heads(dout, q0, q1)
        delta = (doc * heads(out, q0, q1)).sum(dim=-1, keepdim=True)
        lse_c = lse[:, :, q0:q1].reshape(b, kvh, g, q1 - q0, 1)
        raw = torch.matmul(qc, kf.transpose(-1, -2))      # [b, kvh, g, c, sk]
        sc = raw
        if softcap:
            t = torch.tanh(raw / softcap)
            sc = softcap * t
        p = torch.exp(sc - lse_c)
        if causal or window is not None:
            valid = _attn_mask(q0, q1, sk, causal, window, q.device)
            p = torch.where(valid, p, torch.zeros_like(sc))
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        ds = p * (dp - delta)
        if softcap:
            ds = ds * (1.0 - t * t)
        dq[:, q0:q1] = (torch.matmul(ds, kf) * scale).permute(
            0, 3, 1, 2, 4).reshape(b, q1 - q0, h, hd).to(q.dtype)
        dk += torch.matmul(ds.transpose(-1, -2), qc).sum(dim=2)
        dv += torch.matmul(p.transpose(-1, -2), doc).sum(dim=2)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def tile_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[m, k] @ [k, n]`` with f32 products and sums, cast once to x's
    dtype (``_mm_tile_kernel``'s f32 accumulator)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def matmul_reducescatter_all_ranks_ref(xs, ws, n: int, rank=None):
    """Every rank's chunk of the fused matmul -> reduce-scatter, from every
    rank's inputs: xs[r] [n * chunk, k_local], ws[r] [k_local, d] ->
    [chunk_0, ..., chunk_{n-1}], chunk_i = sum over r of (xs[r] @ ws[r])
    rows [i * chunk, (i + 1) * chunk); only chunk ``rank`` when given.
    f32 products, partials summed in f32 in the ring's order (rank i + 1
    first, rank i last) and cast once, as the ring kernel does."""
    rows = xs[0].shape[0]
    if rows % n:
        raise ValueError(f"rows {rows} not divisible by {n}")
    chunk = rows // n
    out = []
    for i in range(n) if rank is None else (rank,):
        acc = None
        for step in range(n):
            r = (i + 1 + step) % n
            p = torch.matmul(xs[r][i * chunk:(i + 1) * chunk].float(),
                             ws[r].float())
            acc = p if acc is None else acc + p
        out.append(acc.to(xs[0].dtype))
    return out if rank is None else out[0]


def all_reduce_ref(xs, op: str = "sum") -> torch.Tensor:
    """The all-reduce of every rank's tensor: f32, in rank order, cast once
    (the PeerComm kernel's order, so every rank gets the same bits)."""
    acc = xs[0].float()
    for x in xs[1:]:
        acc = torch.maximum(acc, x.float()) if op == "max" else acc + x.float()
    return acc.to(xs[0].dtype)


def all_gather_ref(xs, dim: int = 0) -> torch.Tensor:
    """The all-gather of every rank's tensor along ``dim``, in rank order."""
    return torch.cat(list(xs), dim=dim)


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert product x [E, C, D] @ w [E, D, F] -> [E, C, F] with f32
    products and sums, cast once to x's dtype
    (``repro.kernels.ref.moe_gmm_ref``)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
            chunk: int = 128) -> torch.Tensor:
    """y of the chunked SSD (:func:`ssd_chunked`, the arithmetic of the TPU
    kernel ``ssd.py:25`` with the D skip added in f32 before the one cast
    to x's dtype): x [b, s, h, p]; dt [b, s, h]; A_log, D [h]; B, C
    [b, s, n] -> [b, s, h, p].  The sequential oracle is
    :func:`ssd_sequential`."""
    return ssd_chunked(x, dt, A_log, B, C, D, chunk=chunk)[0]


# Mamba2 SSD (``repro.models.ssd``).  JAX writes the products as
# three-operand einsums (``ssd.py:52, 56, 73``).  ``torch.einsum``
# contracts pairwise and may build a [b, c, i, j, h, p] intermediate
# (6.4 GB f32 at b 4, s 2048, h 24, p 64), so each is spelled here as an
# elementwise product followed by one batched matrix product.
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                chunk: int = 128, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, s, h, p]; dt [b, s, h] (post-softplus step); A_log [h];
    B, C [b, s, n]; D [h] skip -> (y [b, s, h, p] in x's dtype, final
    state [b, h, p, n] f32, f64 for f64 inputs).  f32 math throughout
    (f64 for f64 inputs, :func:`wide`).

    Per head: ``S_t = exp(-exp(A_log) dt_t) S_{t-1} + dt_t x_t B_t^T`` and
    ``y_t = S_t C_t + D x_t``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} must divide by chunk {q}")
    nc = s // q

    xf = wide(x)
    a = -torch.exp(wide(A_log))                              # [h], a < 0
    dta = wide(dt) * a                                       # [b, s, h]
    x_c = (xf * wide(dt)[..., None]).reshape(b, nc, q, h, p)
    B_c = wide(B).reshape(b, nc, q, n)
    C_c = wide(C).reshape(b, nc, q, n)

    la = torch.cumsum(dta.reshape(b, nc, q, h), dim=2)       # [b,c,q,h]
    la_last = la[:, :, -1:, :]

    # intra-chunk: y_i = sum_{j<=i} (C_i . B_j) exp(la_i - la_j) dt_j x_j.
    # The exponent is masked before exp, so the masked entries are exact
    # zeros with zero gradient (JAX masks after exp; the same values)
    diff = la[:, :, :, None, :] - la[:, :, None, :, :]       # [b,c,i,j,h]
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    seg = torch.exp(diff.masked_fill(~mask[:, :, None], float("-inf")))
    cb = torch.matmul(C_c, B_c.transpose(-1, -2))            # [b,c,i,j]
    w = (cb[..., None] * seg).permute(0, 1, 4, 2, 3)         # [b,c,h,i,j]
    y_intra = torch.matmul(w, x_c.permute(0, 1, 3, 2, 4))    # [b,c,h,i,p]

    # chunk states: S_c = sum_j exp(la_last - la_j) dt_j x_j B_j^T
    decay_to_end = torch.exp(la_last - la)                   # [b,c,q,h]
    xw = (decay_to_end[..., None] * x_c).permute(0, 1, 3, 4, 2)  # [b,c,h,p,j]
    S = torch.matmul(xw, B_c[:, :, None])                    # [b,c,h,p,n]

    # inter-chunk recurrence over the chunk states (the state before each)
    chunk_decay = torch.exp(la_last[:, :, 0, :])             # [b,c,h]
    carry = (wide(h0) if h0 is not None
             else x.new_zeros(b, h, p, n, dtype=xf.dtype))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + S[:, c]
    prev_states = torch.stack(prev, dim=1)                   # [b,c,h,p,n]

    # inter-chunk: y_i += exp(la_i) C_i . S_prev
    y_inter = torch.matmul(C_c[:, :, None],
                           prev_states.transpose(-1, -2))    # [b,c,h,i,p]
    y_inter = y_inter * torch.exp(la).permute(0, 1, 3, 2)[..., None]

    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    y = y + wide(D)[:, None] * xf
    return y.to(x.dtype), carry


def _rev_cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """sum over k >= i along ``dim``."""
    return torch.flip(torch.cumsum(torch.flip(t, [dim]), dim), [dim])


def ssd_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                dy: torch.Tensor, *, chunk: int = 128):
    """The gradient of :func:`ssd_chunked`'s y for the cotangent ``dy`` (x's
    shape and dtype): -> (dx, d(dt), dA_log, dB, dC, dD), each in its
    input's dtype; dB and dC summed over the heads that share B and C.
    f32 math (f64 for f64 inputs).

    The chunked backward that the CUDA kernel ``csrc/ssd.cu`` runs, in
    torch ops (not autograd).  Per (batch, chunk c, head), with
    la_i = sum_{k<=i} a dt_k inside the chunk, L its last row,
    S_prev the state before the chunk, M_ij = (C_i . B_j) exp(la_i - la_j)
    for j <= i and w_j = exp(la_L - la_j) dt_j:

    - the state gradient after each chunk by a reverse scan,
      G_c = sum_i exp(la_i) dy_i^T C_i + exp(la_L) G_{c+1}, so that
      dS_c = G_{c+1} (zero after the last chunk);
    - dP_ij = dt_j (dy_i . x_j): d(dt x)_j = sum_i M_ij dy_i
      + exp(la_L - la_j) G_{c+1} B_j; dC and dB from the heads' sum of
      dP_ij exp(la_i - la_j) (times B_j, C_i), from exp(la_i) S_prev^T
      dy_i (dC) and from w_j G_{c+1}^T x_j (dB);
    - d la_i: the rows minus the columns of dP * M, exp(la_i) C_i .
      (S_prev^T dy_i), minus u_i = exp(la_L - la_i) (dt x)_i . (G B_i),
      and on the last row sum_j u_j + exp(la_L) <S_prev, G_{c+1}>; a
      reverse cumulative sum inside the chunk turns it into d(a dt)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} must divide by chunk {q}")
    nc = s // q
    xf, dtf, dyf = wide(x), wide(dt), wide(dy)
    a = -torch.exp(wide(A_log))                              # [h]
    x_c = xf.reshape(b, nc, q, h, p).permute(0, 1, 3, 2, 4)  # [b,c,h,q,p]
    dy_c = dyf.reshape(b, nc, q, h, p).permute(0, 1, 3, 2, 4)
    dt_c = dtf.reshape(b, nc, q, h).permute(0, 1, 3, 2)      # [b,c,h,q]
    B_c = wide(B).reshape(b, nc, q, n)[:, :, None]           # [b,c,1,q,n]
    C_c = wide(C).reshape(b, nc, q, n)[:, :, None]
    la = torch.cumsum(dt_c * a[:, None], dim=-1)             # [b,c,h,q]
    la_last = la[..., -1:]                                   # [b,c,h,1]
    el = torch.exp(la)
    to_end = torch.exp(la_last - la)                         # [b,c,h,q]
    xdt = x_c * dt_c[..., None]                              # [b,c,h,q,p]
    decay = torch.exp(la_last[..., 0])                       # [b,c,h]

    # the forward's chunk states and the state before each chunk
    S = torch.matmul((to_end[..., None] * xdt).transpose(-1, -2), B_c)
    carry = torch.zeros_like(S[:, 0])
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * decay[:, c, :, None, None] + S[:, c]
    prev = torch.stack(prev, dim=1)                          # [b,c,h,p,n]
    # the state gradient after each chunk (reverse scan)
    G_loc = torch.matmul((el[..., None] * dy_c).transpose(-1, -2), C_c)
    carry = torch.zeros_like(G_loc[:, 0])
    nxt = [None] * nc
    for c in reversed(range(nc)):
        nxt[c] = carry
        carry = carry * decay[:, c, :, None, None] + G_loc[:, c]
    G = torch.stack(nxt, dim=1)                              # [b,c,h,p,n]

    # intra-chunk
    diff = la[..., :, None] - la[..., None, :]               # [b,c,h,i,j]
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    seg = torch.exp(diff.masked_fill(~mask, float("-inf")))
    cb = torch.matmul(C_c, B_c.transpose(-1, -2))            # [b,c,1,i,j]
    M = cb * seg
    dP = torch.matmul(dy_c, x_c.transpose(-1, -2)) * dt_c[..., None, :]
    E = dP * M
    dla = E.sum(-1) - E.sum(-2)                              # [b,c,h,q]
    dCB = (dP * seg).sum(2)                                  # [b,c,i,j]
    dxdt = torch.matmul(M.transpose(-1, -2), dy_c)           # [b,c,h,q,p]
    # the chunk's state
    dxdt_state = to_end[..., None] * torch.matmul(B_c, G.transpose(-1, -2))
    u = (dxdt_state * xdt).sum(-1)                           # [b,c,h,q]
    dxdt = dxdt + dxdt_state
    dla = dla - u
    dla[..., -1] += u.sum(-1) + decay * (prev * G).sum((-1, -2))
    # inter-chunk
    v = torch.matmul(dy_c, prev)                             # [b,c,h,q,n]
    dla = dla + el * (v * C_c).sum(-1)
    dC = torch.matmul(dCB, B_c[:, :, 0]) + (el[..., None] * v).sum(2)
    xG = torch.matmul(x_c, G)                                # [b,c,h,q,n]
    dB = (torch.matmul(dCB.transpose(-1, -2), C_c[:, :, 0])
          + ((to_end * dt_c)[..., None] * xG).sum(2))

    ddta = _rev_cumsum(dla, -1)                              # [b,c,h,q]
    ddt = (dxdt * x_c).sum(-1) + a[:, None] * ddta
    dx = dxdt * dt_c[..., None] + wide(D)[:, None, None] * dy_c
    dA_log = a * (ddta * dt_c).sum((0, 1, 3))
    dD = (dy_c * x_c).sum((0, 1, 3, 4))

    def tokens(t):                                           # [b,c,h,q,...]
        return t.transpose(2, 3).reshape(b, s, h, *t.shape[4:])
    return (tokens(dx).to(x.dtype), tokens(ddt).to(dt.dtype),
            dA_log.to(A_log.dtype), dB.reshape(b, s, n).to(B.dtype),
            dC.reshape(b, s, n).to(C.dtype), dD.to(D.dtype))


def ssd_sequential(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(s) recurrence, step by step (the oracle): same inputs and
    outputs as :func:`ssd_chunked`."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    a = -torch.exp(A_log.float())
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    S = (h0.float() if h0 is not None
         else x.new_zeros(b, h, p, n, dtype=torch.float32))
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a)                     # [b, h]
        upd = (xf[:, t] * dtf[:, t, :, None])[..., None] \
            * Bf[:, t, None, None, :]                        # [b, h, p, n]
        S = S * decay[..., None, None] + upd
        ys.append(torch.matmul(S, Cf[:, t, None, :, None])[..., 0])
    y = torch.stack(ys, dim=1) + D.float()[:, None] * xf
    return y.to(x.dtype), S


# RG-LRU (``repro.models.rglru`` and the TPU kernel ``rglru.py:23``)
RGLRU_C = 8.0
RGLRU_GATES = ("w_a", "b_a", "w_x", "b_x", "a_param")


def _rglru_terms(xf: torch.Tensor, gates) -> dict:
    """The gates of every step, f32, as ``models/rglru.py`` ``_gates``
    writes them: r, i, softplus(a_param), log a, a, exp(2 log a), the
    clamp's input m = 1 - exp(2 log a), q = sqrt(max(m, 1e-6)) and the
    gated input g = q (i x)."""
    w_a, b_a, w_x, b_x, ap = (wide(gates[k]) for k in RGLRU_GATES)
    r = torch.sigmoid(xf * w_a + b_a)
    i = torch.sigmoid(xf * w_x + b_x)
    sp = torch.nn.functional.softplus(ap)
    log_a = -RGLRU_C * sp * r
    e2 = torch.exp(2.0 * log_a)
    m = 1.0 - e2
    q = torch.sqrt(torch.clamp_min(m, 1e-6))
    return dict(r=r, i=i, sp=sp, a=torch.exp(log_a), e2=e2, m=m, q=q,
                g=q * (i * xf))


def rglru_states_ref(x: torch.Tensor, gates) -> torch.Tensor:
    """The f32 states h [b, s, w] of the recurrence ``h_t = a_t h_{t-1} +
    g_t`` from h = 0, walked step by step in time as the TPU kernel walks
    it.  x [b, s, w]; ``gates`` maps ``RGLRU_GATES`` to [w] vectors."""
    t = _rglru_terms(wide(x), gates)
    a, g = t["a"], t["g"]
    h = torch.zeros_like(g[:, 0])
    hs = []
    for step in range(x.shape[1]):
        h = a[:, step] * h + g[:, step]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rglru_ref(x: torch.Tensor, gates) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function of ``repro.kernels.rglru.rglru``: x [b, s, w] ->
    (y [b, s, w] in x's dtype, h_last [b, w] f32).  As in the TPU kernel,
    ``h_last`` is ``y[:, -1]`` cast to f32, the rounded output (JAX's
    ``rglru_scan`` returns the f32 state instead), and there is no
    initial state."""
    y = rglru_states_ref(x, gates).to(x.dtype)
    return y, y[:, -1].float()


def rglru_bwd_ref(x: torch.Tensor, gates, h: torch.Tensor,
                  dy: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Gradient of the RG-LRU's y given the f32 states ``h``
    (:func:`rglru_states_ref`) and dy (x's dtype, taken in f32) ->
    (dx in x's dtype, then the f32 [w] gradients of ``RGLRU_GATES`` in
    order).  The reverse recurrence ``dh_t = dy_t + a_{t+1} dh_{t+1}`` is
    walked step by step; the chain through the gates is elementwise: the
    state's ``da_t = dh_t h_{t-1}`` and ``dg_t = dh_t``, through q (no
    gradient where the 1e-6 clamp binds), i, r and x, and the per-channel
    sums over batch and time."""
    xf = wide(x)
    t = _rglru_terms(xf, gates)
    a, r, i, q = t["a"], t["r"], t["i"], t["q"]
    dyf = wide(dy)
    dh = torch.empty_like(dyf)
    nxt = torch.zeros_like(dyf[:, 0])
    for step in reversed(range(x.shape[1])):
        d = dyf[:, step] + nxt
        dh[:, step] = d
        nxt = a[:, step] * d
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), wide(h[:, :-1])], 1)
    dq = dh * (i * xf)
    di = dh * q * xf
    dxf = dh * q * i
    dm = torch.where(t["m"] > 1e-6, dq * 0.5 / q, torch.zeros_like(dq))
    dlog_a = dh * h_prev * a - 2.0 * t["e2"] * dm
    dza = dlog_a * (-RGLRU_C * t["sp"]) * r * (1.0 - r)
    dzx = di * i * (1.0 - i)
    w_a, w_x, ap = (wide(gates[k]) for k in ("w_a", "w_x", "a_param"))
    dx = (dxf + dza * w_a + dzx * w_x).to(x.dtype)
    dsp = (dlog_a * (-RGLRU_C) * r).sum((0, 1))
    return (dx, (dza * xf).sum((0, 1)), dza.sum((0, 1)),
            (dzx * xf).sum((0, 1)), dzx.sum((0, 1)),
            dsp * torch.sigmoid(ap))
