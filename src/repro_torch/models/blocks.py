"""Layers: the training residual parts of ``repro.models.blocks`` over a
:class:`~repro_torch.core.schedule.TmpCtx`; at tp=1 the prefill
(``prefill_fn``: the full prompt, building a layer's decode state) of
every layer kind; over the context the decode step (``decode_fn``: one
token against that state, dense or paged; the families at tp=1) and the
speculative verify (``verify_fn``: a block of tokens, global attention).

A GLOBAL_ATTN layer is an attention part and an FFN part: each rank runs
its ``h_local`` heads and ``d_ff / dx`` columns (dx: the width-sharding
degree, the whole group in 1-D); the entries go through
``ctx.gather_matmul`` and the exits through ``ctx.row_matmul``, which
take the sequence-parallel forms under SP and the per-axis forms in 2-D
(the exits gather their output columns back to ``d_model``); with
``seq_shard`` > 1 the attention part is the ring part.  The FFN is
SwiGLU or, in the MoE family, the MoE FFN (tp=1: an exit-less part).  A
LOCAL_ATTN layer is a GLOBAL_ATTN layer whose attention sees only the
last ``cfg.window`` positions; an RGLRU layer is the RG-LRU part and the
FFN (tp=1).  An SSD layer is the Mamba2 mixer alone (tp=1).  A
CROSS_ATTN layer (tp=1) puts the cross part between the attention and
the FFN; with post-norms (tp=1) the attention's and the SwiGLU's deltas
are normalized after their exits.  whisper's encoder layers
(:func:`encoder_layer`) are non-causal attention and SwiGLU without rope
or recomputation.  Plain matrix products stay ``torch.matmul``, as the
JAX package left them to XLA."""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (CROSS_ATTN, GLOBAL_ATTN, LOCAL_ATTN,
                                      RGLRU, SSD, ArchConfig)
from repro_torch.core import tmp as tmpc
from repro_torch.core.schedule import Part, TmpCtx
from repro_torch.core.tmp import rms_norm
from repro_torch.kernels.ref import RGLRU_GATES
from repro_torch.kernels.ring_attention import ring_attention
from repro_torch.kernels.ssd import ssd, ssd_prefill
from repro_torch.models.attention import (chunked_attention,
                                         decode_attention,
                                         decode_attention_multi,
                                         paged_decode_attention,
                                         paged_decode_attention_multi, rope)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import attn_plan, ssd_dims
from repro_torch.models.rglru import (depthwise_conv1d, rglru_prefill,
                                     rglru_scan, rglru_step)
from repro_torch.models.ssd import ssd_step


def _row_exit(cfg: ArchConfig, ctx: TmpCtx, a: torch.Tensor,
              w: torch.Tensor, sharded: bool) -> torch.Tensor:
    """A part's exit ``a @ w``: the context's row-parallel exit
    (``ctx.row_matmul``: the schedule's collective; in 2-D the output
    columns gathered over y) where ``w``'s rows are ``sharded`` or its
    output columns are, else a plain product (tp=1)."""
    if sharded or w.shape[-1] != cfg.d_model:
        return ctx.row_matmul(a, w, full_out=cfg.d_model).wait()
    return torch.matmul(a, w)


def _attn_out(cfg: ArchConfig, ctx: TmpCtx, p: Dict[str, torch.Tensor],
              attn: torch.Tensor) -> torch.Tensor:
    """The attention's exit (``blocks.py`` ``_attn_out``): attn [b, s,
    h_local, hd] through ``wo`` (:func:`_row_exit`, sharded where the
    heads are)."""
    b, s = attn.shape[:2]
    return _row_exit(cfg, ctx, attn.reshape(b, s, -1), p["wo"],
                     attn_plan(cfg, ctx.tp).sharded)


def mlp_part(cfg: ArchConfig, ctx: TmpCtx, p: Dict[str, torch.Tensor],
             x: torch.Tensor) -> torch.Tensor:
    """Residual delta of the FFN (the prefill's, the decode step's and
    the verify's; JAX's ``make_mlp_part``): norm, then the MoE FFN routing
    all of x's tokens together (capacity from their count; tp=1) or
    SwiGLU, its entry ``ctx.gather_matmul`` and its exit
    :func:`_row_exit` (``wd``'s rows sharded over the group), then
    ``pn2`` with post-norms.  At tp=1 every product is plain."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        moe = cfg.moe
        return moe_ffn(h, {k: p[k] for k in ("router", "w1", "w3", "w2")},
                       num_experts=moe.num_experts, top_k=moe.top_k,
                       cap_factor=moe.capacity_factor)[0]
    g, u = ctx.gather_matmul(h, (p["wg"], p["wu"]))
    wd = p["wd"]
    d = _row_exit(cfg, ctx, F.silu(g) * u, wd, wd.shape[0] != cfg.d_ff)
    if cfg.post_norms:
        d = rms_norm(d, p["pn2"], cfg.norm_eps)
    return d


def _qkv(cfg: ArchConfig, ctx: TmpCtx, p: Dict[str, torch.Tensor],
         h: torch.Tensor, positions: torch.Tensor, keep=None):
    """h [b, s, d] (replicated; under SP this rank's sequence chunk, which
    the entry gathers) -> this rank's q [b, s, h_local, hd] and k, v
    [b, s, kv_local, hd] over the whole sequence, rope on q and k
    (``blocks.py`` ``_qkv``).  Heads shard over x (``ctx.tp`` = dx); in
    2-D the projections' rows shard over y and the entry slices h to
    match.  KV weights x does not divide are replicated over x: every
    rank projects the kv-head group its q heads need (all of them with
    one KV head; in 2-D from its y-sliced h, the products summed over y
    as every entry's), and the weights pass through f over x so that
    their gradient sums the ranks' shares.  ``keep``: fine
    recomputation's state of the part."""
    plan = attn_plan(cfg, ctx.tp)
    hd = cfg.resolved_head_dim
    b = h.shape[0]
    wk, wv = p["wk"], p["wv"]
    if plan.sharded and not plan.kv_sharded:
        if plan.kv_slice == cfg.num_kv_heads != cfg.num_heads \
                and plan.h_local % cfg.num_kv_heads:
            raise NotImplementedError(
                f"{cfg.name}: tp={ctx.tp} with {cfg.num_heads} q / "
                f"{cfg.num_kv_heads} kv heads needs the non-aligned GQA "
                f"fallback, not ported (ROADMAP.md A2)")
        group = cfg.num_heads // cfg.num_kv_heads
        start = (tmpc.axes_index(ctx.x_comm) * plan.h_local) // group
        cols = slice(start * hd, (start + plan.kv_slice) * hd)
        wk = tmpc.copy_to_tmp(wk, ctx.x_comm)[:, cols]
        wv = tmpc.copy_to_tmp(wv, ctx.x_comm)[:, cols]
    q, k, v = ctx.gather_matmul(h, (p["wq"], wk, wv), keep=keep)
    s = q.shape[1]
    q = q.reshape(b, s, plan.h_local, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def post_norm(cfg: ArchConfig, name: str):
    """The post step of a part with gemma2's post-norms: the exit's delta
    through RMSNorm with scale ``p[name]`` (``blocks.py:135-136, 151-152,
    209-210``); None without post-norms."""
    if not cfg.post_norms:
        return None
    return lambda p, delta: rms_norm(delta, p[name], cfg.norm_eps)


def train_parts(cfg: ArchConfig, ctx: TmpCtx, kind: str) -> List[Part]:
    """A layer's residual parts by its kind (``blocks.py`` ``train_parts``,
    1-D): GLOBAL_ATTN and LOCAL_ATTN give ``make_attn_part`` (windowed for
    LOCAL_ATTN) and ``make_mlp_part`` (:func:`moe_part` for MoE configs),
    CROSS_ATTN the attention part, :func:`cross_part` and the MLP part,
    RGLRU gives :func:`rglru_part` and the MLP part, SSD gives
    :func:`ssd_part` alone.  A part's body runs from its input to its exit
    product's input; the schedule runs the exit (``wo``, ``wd``) and its
    collectives (in 2-D gathering the output columns), then the part's
    post step: with post-norms the attention part's ``pn1`` and the
    SwiGLU part's ``pn2`` (:func:`post_norm`).  Under SP a part's input is
    this rank's sequence chunk: the entry gathers the sequence and the
    exit scatters it.  With ``seq_shard`` > 1 the attention part is
    :func:`ring_part`'s."""
    if kind == SSD:
        return [ssd_part(cfg)]
    if kind not in (GLOBAL_ATTN, LOCAL_ATTN, RGLRU, CROSS_ATTN):
        raise ValueError(kind)
    window = cfg.window if kind == LOCAL_ATTN else None

    def attn_body(p, x, aux, keep):
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        q, k, v = _qkv(cfg, ctx, p, h, aux["positions"], keep)
        o = chunked_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap)
        b, s = o.shape[:2]
        return o.reshape(b, s, -1)

    def mlp_body(p, x, aux, keep):
        g, u = ctx.gather_matmul(rms_norm(x, p["ln2"], cfg.norm_eps),
                                 (p["wg"], p["wu"]), keep=keep)
        return F.silu(g) * u

    # a 2-D exit gathers its output columns back to d_model
    full_out = cfg.d_model if ctx.is_2d else None
    if kind == RGLRU:
        first = rglru_part(cfg)
    elif ctx.seq_shard > 1:
        first = ring_part(cfg, ctx)
    else:
        first = Part(attn_body, "wo", full_out=full_out,
                     post=post_norm(cfg, "pn1"))
    mlp = (moe_part(cfg) if cfg.moe is not None
           else Part(mlp_body, "wd", full_out=full_out,
                     post=post_norm(cfg, "pn2")))
    if kind == CROSS_ATTN:
        return [first, cross_part(cfg), mlp]
    return [first, mlp]


def cross_part(cfg: ArchConfig) -> Part:
    """The cross-attention part (``blocks.py:158-176``) at tp=1: ``c_ln``,
    ``c_wq`` of the sub-batch's stream against ``c_wk`` / ``c_wv`` of its
    context (``aux["ctx"]`` [b, L, d]; no rope), non-causal attention of s
    queries against L keys (the flash kernels on the card), the ``c_wo``
    exit, then the post step ``delta * tanh(c_gate)`` (``c_gate`` cast to
    the delta's dtype first, as JAX)."""
    hd = cfg.resolved_head_dim

    def cross_body(p, x, aux, keep):
        h = rms_norm(x, p["c_ln"], cfg.norm_eps)
        c = aux["ctx"]
        b, s, _ = h.shape
        q = torch.matmul(h, p["c_wq"]).reshape(b, s, cfg.num_heads, hd)
        ck = torch.matmul(c, p["c_wk"]).reshape(b, c.shape[1],
                                                cfg.num_kv_heads, hd)
        cv = torch.matmul(c, p["c_wv"]).reshape(b, c.shape[1],
                                                cfg.num_kv_heads, hd)
        o = chunked_attention(q, ck, cv, causal=False)
        return o.reshape(b, s, -1)

    def gate(p, delta):
        return delta * torch.tanh(p["c_gate"].to(delta.dtype))

    return Part(cross_body, "c_wo", post=gate)


def encoder_layer(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
    """One layer of whisper's encoder (``blocks.py:540-551``
    ``encoder_layer_fn``) at tp=1: norm, q/k/v without rope, non-causal
    self-attention (the flash kernels on the card), ``wo``, then norm,
    SwiGLU and ``wd`` (``pn2`` after it with post-norms), both residual;
    no recomputation, as JAX's scan of it has none."""
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = torch.matmul(h, p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = torch.matmul(h, p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = torch.matmul(h, p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    o = chunked_attention(q, k, v, causal=False)
    x = x + torch.matmul(o.reshape(b, s, -1), p["wo"])
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    d = torch.matmul(F.silu(torch.matmul(h, p["wg"]))
                     * torch.matmul(h, p["wu"]), p["wd"])
    if cfg.post_norms:
        d = rms_norm(d, p["pn2"], cfg.norm_eps)
    return x + d


def rglru_part(cfg: ArchConfig) -> Part:
    """The RG-LRU part (``blocks.py:223-236``) at tp=1: norm, ``w_in_x``
    and ``w_in_g``, the causal depthwise conv on the x branch, the RG-LRU
    (the kernel on the card), ``gelu(g) * y`` with JAX's default tanh
    form of gelu, then a local ``w_out`` exit with no collective."""
    def rglru_body(p, x, aux, keep):
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        xb = torch.matmul(h, p["w_in_x"])
        gb = torch.matmul(h, p["w_in_g"])
        y = rglru_scan(depthwise_conv1d(xb, p["conv"])[0],
                       {k: p[k] for k in RGLRU_GATES})
        return F.gelu(gb, approximate="tanh") * y

    return Part(rglru_body, "w_out", collective=False)


def moe_part(cfg: ArchConfig) -> Part:
    """The MoE FFN part (``blocks.py:181-197``) at tp=1: norm, then
    :func:`~repro_torch.models.moe.moe_ffn`; an exit-less part whose
    aux is the router's load-balance loss times ``router_aux_weight``."""
    moe = cfg.moe

    def moe_body(p, x, aux, keep):
        delta, aux = moe_ffn(
            rms_norm(x, p["ln2"], cfg.norm_eps),
            {k: p[k] for k in ("router", "w1", "w3", "w2")},
            num_experts=moe.num_experts, top_k=moe.top_k,
            cap_factor=moe.capacity_factor)
        return delta, aux * moe.router_aux_weight

    return Part(moe_body)


def ssd_part(cfg: ArchConfig) -> Part:
    """The Mamba2 mixer (``blocks.py:244-272``) at tp=1: norm, ``in_proj``,
    split into z, xBC and dt, causal depthwise conv and SiLU on xBC,
    ``softplus(dt + dt_bias)``, the SSD kernel (chunk ``min(128, s)``),
    the gated RMSNorm (``norm_g``, times SiLU(z)), then a local
    ``out_proj`` exit with no collective, like :func:`ring_part`'s."""
    d_inner, nheads, n = ssd_dims(cfg)

    def ssd_body(p, x, aux, keep):
        z, xbc, dtp = _ssd_split(cfg, torch.matmul(
            rms_norm(x, p["ln"], cfg.norm_eps), p["in_proj"]))
        xbc = F.silu(depthwise_conv1d(xbc, p["conv"])[0])
        b, s, _ = x.shape
        xh = xbc[..., :d_inner].reshape(b, s, nheads, cfg.ssm_headdim)
        B = xbc[..., d_inner:d_inner + n]
        C = xbc[..., d_inner + n:]
        dt = F.softplus(dtp.float() + p["dt_bias"])
        y = ssd(xh, dt, p["A_log"], B, C, p["Dskip"], chunk=min(128, s))
        y = y.reshape(b, s, d_inner)
        return rms_norm(y, p["norm_g"], cfg.norm_eps) * F.silu(
            z.to(y.dtype))

    return Part(ssd_body, "out_proj", collective=False)


def ring_part(cfg: ArchConfig, ctx: TmpCtx) -> Part:
    """The ring-attention part (``blocks.py:107-137``): x stays this
    rank's sequence chunk through the mixer; the attention weights are
    replicated (whole heads on every rank; their gradients are partial per
    rank and summed by the training step); rope at the chunk's absolute
    positions ``rank * s_loc + arange(s_loc)`` (``aux["positions"]``), ring
    attention over the group, and a local ``wo`` exit with no collective.
    The ring op keeps its out and lse for fine recomputation's replay
    (``keep``)."""
    def ring_body(p, x, aux, keep):
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        b, s_loc, _ = h.shape
        hd = cfg.resolved_head_dim
        positions = aux["positions"]
        q = rope(torch.matmul(h, p["wq"]).reshape(b, s_loc, cfg.num_heads,
                                                  hd),
                 positions, cfg.rope_theta)
        k = rope(torch.matmul(h, p["wk"]).reshape(b, s_loc,
                                                  cfg.num_kv_heads, hd),
                 positions, cfg.rope_theta)
        v = torch.matmul(h, p["wv"]).reshape(b, s_loc, cfg.num_kv_heads, hd)
        o = ring_attention(q, k, v, comm=ctx.group, causal=True,
                           softcap=cfg.attn_softcap, keep=keep)
        return o.reshape(b, s_loc, -1)

    return Part(ring_body, "wo", collective=False)


def _ssd_split(cfg: ArchConfig, proj: torch.Tensor):
    """``in_proj``'s output -> (z, xBC, dt's pre-activation)."""
    d_inner, _, n = ssd_dims(cfg)
    return (proj[..., :d_inner], proj[..., d_inner:2 * d_inner + 2 * n],
            proj[..., 2 * d_inner + 2 * n:])


def _rglru_out(p, gb: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The RG-LRU part's exit: ``gelu(g) * y`` (tanh form) through
    ``w_out``."""
    return torch.matmul(F.gelu(gb, approximate="tanh") * y, p["w_out"])


def prefill_fn(cfg: ArchConfig, kind: str):
    """The prefill of one layer at tp=1 (``blocks.py:297-375``
    ``prefill_fn``): ``fn(p, x, aux) -> (x, st)`` over the whole prompt
    (``aux``: ``positions`` [b, s], ``ctx`` the context [b, L, d] or None),
    ``st`` the layer's decode state (:func:`~repro_torch.models.params.
    cache_specs`' keys, unstacked).  Attention kinds run the flash kernels
    (causal; LOCAL_ATTN windowed; softcapped), keep k and v (a LOCAL_ATTN
    layer past its window keeps the last ``window`` in ring order, slot =
    pos % window), and CROSS_ATTN adds the context's K/V (no rope) and
    non-causal attention of s queries to them; RGLRU and SSD run their
    kernels over the sequence and keep the last state and the conv's
    last inputs.  Then the FFN (:func:`mlp_part`) but in SSD layers."""
    window = cfg.window if kind == LOCAL_ATTN else None
    mlp = kind != SSD and bool(cfg.d_ff)
    hd = cfg.resolved_head_dim
    ctx = TmpCtx()

    def fn(p, x, aux):
        st: Dict[str, torch.Tensor] = {}
        b, s, _ = x.shape
        if kind in (GLOBAL_ATTN, LOCAL_ATTN, CROSS_ATTN):
            h = rms_norm(x, p["ln"], cfg.norm_eps)
            q, k, v = _qkv(cfg, ctx, p, h, aux["positions"])
            o = chunked_attention(q, k, v, causal=True, window=window,
                                  softcap=cfg.attn_softcap)
            delta = _attn_out(cfg, ctx, p, o)
            if cfg.post_norms:
                delta = rms_norm(delta, p["pn1"], cfg.norm_eps)
            x = x + delta
            if window is not None and s > window:
                roll = s % window
                k = torch.roll(k[:, s - window:], roll, dims=1)
                v = torch.roll(v[:, s - window:], roll, dims=1)
            st["k"], st["v"] = k, v
            if kind == CROSS_ATTN:
                c = aux["ctx"]
                L = c.shape[1]
                ck = torch.matmul(c, p["c_wk"]).reshape(
                    b, L, cfg.num_kv_heads, hd)
                cv = torch.matmul(c, p["c_wv"]).reshape(
                    b, L, cfg.num_kv_heads, hd)
                st["c_k"], st["c_v"] = ck, cv
                hc = rms_norm(x, p["c_ln"], cfg.norm_eps)
                qd = torch.matmul(hc, p["c_wq"]).reshape(
                    b, s, cfg.num_heads, hd)
                oc = chunked_attention(qd, ck, cv, causal=False)
                dc = torch.matmul(oc.reshape(b, s, -1), p["c_wo"])
                x = x + dc * torch.tanh(p["c_gate"].to(dc.dtype))
        elif kind == RGLRU:
            h = rms_norm(x, p["ln"], cfg.norm_eps)
            xb = torch.matmul(h, p["w_in_x"])
            gb = torch.matmul(h, p["w_in_g"])
            xc, conv_st = depthwise_conv1d(xb, p["conv"])
            y, h_last = rglru_prefill(xc, {k: p[k] for k in RGLRU_GATES})
            x = x + _rglru_out(p, gb, y)
            st["h"], st["conv"] = h_last, conv_st
        elif kind == SSD:
            d_inner, nheads, n = ssd_dims(cfg)
            z, xbc, dtp = _ssd_split(cfg, torch.matmul(
                rms_norm(x, p["ln"], cfg.norm_eps), p["in_proj"]))
            xbc_c, conv_st = depthwise_conv1d(xbc, p["conv"])
            xbc_c = F.silu(xbc_c)
            dt = F.softplus(dtp.float() + p["dt_bias"])
            y, S = ssd_prefill(
                xbc_c[..., :d_inner].reshape(b, s, nheads, cfg.ssm_headdim)
                .contiguous(), dt.contiguous(), p["A_log"],
                xbc_c[..., d_inner:d_inner + n].contiguous(),
                xbc_c[..., d_inner + n:].contiguous(), p["Dskip"],
                chunk=min(128, s))
            y = rms_norm(y.reshape(b, s, d_inner), p["norm_g"],
                         cfg.norm_eps) * F.silu(z.to(y.dtype))
            x = x + torch.matmul(y, p["out_proj"])
            st["S"], st["conv"] = S, conv_st
        else:
            raise ValueError(kind)
        if mlp:
            x = x + mlp_part(cfg, ctx, p, x)
        return x, st

    return fn


def decode_fn(cfg: ArchConfig, ctx: TmpCtx, kind: str):
    """The decode step of one layer (``blocks.py:378-475`` ``decode_fn``):
    ``fn(p, x, st, aux) -> x`` for x [b, 1, d] at positions
    ``aux["pos"]`` [b] int32, updating the layer's state ``st`` (views of
    :func:`~repro_torch.models.params.cache_specs`' leaves, this rank's
    shard) IN PLACE, where JAX returns a new state.

    Over the model group of ``ctx`` (a GLOBAL_ATTN layer of a dense
    model: the families run at tp=1) the layer runs under the schedule as
    in training, at decode shapes: q/k/v through ``ctx.gather_matmul``
    (this rank's heads and KV heads; in 2-D the d_model slice and the y
    sums), the exits through ``ctx.row_matmul`` (``fused``: the ring over
    the slot batch, ``TmpCtx._ring_dim``).  At tp=1 every product is
    plain.

    A GLOBAL_ATTN layer with ``aux["tables"]`` [b, nb] writes k/v into its
    page pools (inactive slots carry all-zero tables and write the null
    page 0, which every reader masks by position) and reads through the
    table; otherwise k/v go to slot ``pos`` (``pos % window`` in a
    LOCAL_ATTN ring) and :func:`~repro_torch.models.attention.
    decode_attention` reads the dense cache.  CROSS_ATTN then reads every
    context row of ``c_k``/``c_v`` (position ``L - 1``) and adds the
    ``tanh(c_gate)``-gated exit.  RGLRU and SSD run their steps from
    ``h``/``S`` and the conv history.  Then the FFN but in SSD layers."""
    is_local = kind == LOCAL_ATTN
    mlp = kind != SSD and bool(cfg.d_ff)
    hd = cfg.resolved_head_dim

    def fn(p, x, st, aux):
        pos = aux["pos"]
        b = x.shape[0]
        if kind in (GLOBAL_ATTN, LOCAL_ATTN, CROSS_ATTN):
            h = rms_norm(x, p["ln"], cfg.norm_eps)
            q, k, v = _qkv(cfg, ctx, p, h, pos[:, None])
            bidx = torch.arange(b, device=x.device)
            pos_l = pos.long()
            if kind == GLOBAL_ATTN and aux.get("tables") is not None:
                tables = aux["tables"]
                page = st["k"].shape[1]
                phys = tables.long()[bidx, pos_l // page]
                off = pos_l % page
                st["k"][phys, off] = k[:, 0].to(st["k"].dtype)
                st["v"][phys, off] = v[:, 0].to(st["v"].dtype)
                o = paged_decode_attention(q, st["k"], st["v"], tables, pos,
                                           softcap=cfg.attn_softcap)
            else:
                S = st["k"].shape[1]
                slot = pos_l % S if is_local else pos_l
                st["k"][bidx, slot] = k[:, 0].to(st["k"].dtype)
                st["v"][bidx, slot] = v[:, 0].to(st["v"].dtype)
                o = decode_attention(q, st["k"], st["v"], pos,
                                     window=cfg.window if is_local else None,
                                     softcap=cfg.attn_softcap, ring=is_local)
            delta = _attn_out(cfg, ctx, p, o)
            if cfg.post_norms:
                delta = rms_norm(delta, p["pn1"], cfg.norm_eps)
            x = x + delta
            if kind == CROSS_ATTN:
                hc = rms_norm(x, p["c_ln"], cfg.norm_eps)
                qd = torch.matmul(hc, p["c_wq"]).reshape(
                    b, 1, cfg.num_heads, hd)
                L = st["c_k"].shape[1]
                oc = decode_attention(
                    qd, st["c_k"], st["c_v"],
                    torch.full((b,), L - 1, dtype=torch.int32,
                               device=x.device))
                dc = _attn_out(cfg, ctx, {"wo": p["c_wo"]}, oc)
                x = x + dc * torch.tanh(p["c_gate"].to(dc.dtype))
        elif kind == RGLRU:
            h = rms_norm(x, p["ln"], cfg.norm_eps)
            xb = torch.matmul(h, p["w_in_x"])
            gb = torch.matmul(h, p["w_in_g"])
            hist = torch.cat([st["conv"], xb], dim=1)           # [b, k, W]
            xc = torch.einsum("bkw,kw->bw", hist, p["conv"])[:, None]
            y, h_new = rglru_step(xc, {k: p[k] for k in RGLRU_GATES},
                                  st["h"])
            x = x + _rglru_out(p, gb, y)
            st["h"].copy_(h_new)
            st["conv"].copy_(hist[:, 1:])
        elif kind == SSD:
            d_inner, nheads, n = ssd_dims(cfg)
            z, xbc, dtp = _ssd_split(cfg, torch.matmul(
                rms_norm(x, p["ln"], cfg.norm_eps), p["in_proj"]))
            hist = torch.cat([st["conv"], xbc], dim=1)          # [b, k, C]
            xbc_c = F.silu(torch.einsum("bkc,kc->bc", hist, p["conv"]))
            dt = F.softplus(dtp[:, 0].float() + p["dt_bias"])
            y, S = ssd_step(
                xbc_c[:, :d_inner].reshape(b, nheads, cfg.ssm_headdim), dt,
                p["A_log"], xbc_c[:, d_inner:d_inner + n],
                xbc_c[:, d_inner + n:], p["Dskip"], st["S"])
            y = rms_norm(y.reshape(b, 1, d_inner), p["norm_g"],
                         cfg.norm_eps) * F.silu(z.to(y.dtype))
            x = x + torch.matmul(y, p["out_proj"])
            st["S"].copy_(S)
            st["conv"].copy_(hist[:, 1:])
        else:
            raise ValueError(kind)
        if mlp:
            x = x + mlp_part(cfg, ctx, p, x)
        return x

    return fn


def verify_fn(cfg: ArchConfig, ctx: TmpCtx, kind: str):
    """The speculative verify's step of one layer (``blocks.py:478-534``
    ``verify_fn``): ``fn(p, x, st, aux) -> x`` for x [b, qn, d], ``qn``
    consecutive tokens at positions ``aux["pos"] + j``, under ``ctx`` as
    :func:`decode_fn`.  The layer writes all ``qn`` k/v rows first (dense
    at ``min(pos + j, S - 1)``; paged through the table at ``min(pos + j,
    nb * page - 1)``), then attends, query j to the positions up to
    ``pos + j`` (:func:`~repro_torch.models.attention.
    decode_attention_multi`: the paged decode kernel with the queries
    folded into its batch on the card), so a block of one is the decode
    step.  Rows clamped onto the last position all write the last
    query's k/v: JAX's scatter leaves that value there (its updates apply
    in order), and with every duplicate equal the write is the same in
    any order on the card.  No emitted token reads that row anyway: the
    engine stops a slot at ``max_seq - 1``.  GLOBAL_ATTN only."""
    if kind != GLOBAL_ATTN:
        raise NotImplementedError(
            f"speculative verification supports global-attention layers "
            f"only (got {kind}) — local-window ring buffers and recurrent "
            f"states cannot absorb multi-token jumps")
    mlp = bool(cfg.d_ff)

    def fn(p, x, st, aux):
        pos = aux["pos"]
        b, qn, _ = x.shape
        ar = torch.arange(qn, device=x.device)
        positions = pos.long()[:, None] + ar[None, :]          # [b, qn]
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        q, k, v = _qkv(cfg, ctx, p, h, positions)
        bidx = torch.arange(b, device=x.device)[:, None]
        tables = aux.get("tables")
        if tables is not None:
            page = st["k"].shape[1]
            last = tables.shape[1] * page - 1
        else:
            last = st["k"].shape[1] - 1
        rows = torch.clamp(positions, max=last)
        src = torch.where(positions >= last, qn - 1, ar[None, :])
        kw, vw = k[bidx, src], v[bidx, src]
        if tables is not None:
            phys = tables.long()[bidx, rows // page]
            st["k"][phys, rows % page] = kw.to(st["k"].dtype)
            st["v"][phys, rows % page] = vw.to(st["v"].dtype)
            o = paged_decode_attention_multi(q, st["k"], st["v"], tables,
                                             pos, softcap=cfg.attn_softcap)
        else:
            st["k"][bidx, rows] = kw.to(st["k"].dtype)
            st["v"][bidx, rows] = vw.to(st["v"].dtype)
            o = decode_attention_multi(q, st["k"], st["v"], pos,
                                       softcap=cfg.attn_softcap)
        delta = _attn_out(cfg, ctx, p, o)
        if cfg.post_norms:
            delta = rms_norm(delta, p["pn1"], cfg.norm_eps)
        x = x + delta
        if mlp:
            x = x + mlp_part(cfg, ctx, p, x)
        return x

    return fn
