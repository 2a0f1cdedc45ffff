"""Parameter and paged-cache shapes, init, and the bridge to the JAX
package's flat checkpoint view.

The port's weights are a plain dict with the JAX tree's structure (at
tp > 1 each rank holds its shard of every sharded leaf, see
:func:`shard_params`):
``{"blocks": [{...}, ...], "embed", "final_ln", "lm_head", "tail": [...]}``
as ``repro.models.params.model_specs`` lays them out: ``blocks`` holds one
dict per position of the layer pattern, each leaf with the stacked
``[n, ...]`` leading dim of the ``n`` whole pattern repeats, and ``tail``
one unstacked dict per layer left over (:func:`stack_layout`; a
single-kind pattern has one block dict and no tail).  There is no
``lm_head`` with tied embeddings: the head is ``embed.T``.  Flat names
are the JAX ``keystr`` paths (``"['blocks'][0]['wq']"``,
``"['tail'][1]['w_a']"``), so :func:`from_flat` reads
``repro.models.params.tree_to_flat`` output without remapping.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (GLOBAL_ATTN, LOCAL_ATTN, RGLRU, SSD,
                                      ArchConfig)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    f32: bool = False            # stored in f32 whatever the model dtype
    # init stddev; 0 -> zeros; -1 -> the constant -1 for f32 leaves and 1
    # otherwise (JAX ``init_params``' gate/decay init)
    scale: float = 0.02


# the ROADMAP.md items that name what the families of slices 5-6 lack
FAMILY_TP_ITEM = ("ROADMAP.md A10, MoE and SSD at tp > 1: MoE 'tmp' and "
                  "'ep', the replicated SSD mixer")
FAMILY_SERVE_ITEM = "ROADMAP.md A10, MoE and SSD serving"
HYBRID_TP_ITEM = ("ROADMAP.md A10c, RG-LRU and local attention at tp > 1: "
                  "the width-sharded RG-LRU")
HYBRID_SERVE_ITEM = ("ROADMAP.md A5/A10d, RG-LRU and local-attention "
                     "serving: rglru_step, the conv state and the window "
                     "ring cache")
SUPPORTED_KINDS = (GLOBAL_ATTN, LOCAL_ATTN, RGLRU, SSD)


def check_supported(cfg: ArchConfig):
    """The port trains dense global-attention models, the MoE family
    (global attention with an MoE FFN), the Mamba2 SSD family and
    patterns that mix global attention, local attention and the RG-LRU
    (the Griffin hybrid)."""
    other = sorted(set(cfg.layer_pattern) - set(SUPPORTED_KINDS))
    mixed = len(set(cfg.layer_pattern)) > 1
    unsupported = [what for what, on in (
        (f"layer kinds {other}", other),
        ("SSD in mixed layer patterns", mixed and SSD in cfg.layer_pattern),
        ("mixed layer patterns with an MoE FFN",
         mixed and cfg.moe is not None),
        ("post-norms", cfg.post_norms),
        ("MoE in SSD layers",
         cfg.moe is not None and SSD in cfg.layer_pattern),
        ("encoders", cfg.encoder_layers),
    ) if on]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port does not run {', '.join(unsupported)} "
            f"yet (ROADMAP.md queue A, other model families)")


def is_hybrid(cfg: ArchConfig) -> bool:
    """A config with RG-LRU or local-attention layers (slice 6: tp=1
    training only)."""
    return bool({RGLRU, LOCAL_ATTN} & set(cfg.layer_pattern))


def is_family(cfg: ArchConfig) -> bool:
    """An MoE or SSD config (slice 5: tp=1 training only)."""
    return cfg.moe is not None or SSD in cfg.layer_pattern


def check_servable(cfg: ArchConfig):
    """Serving runs the dense all-global-attention models only."""
    check_supported(cfg)
    if is_hybrid(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port does not serve RG-LRU or "
            f"local-attention models yet ({HYBRID_SERVE_ITEM})")
    if is_family(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port does not serve MoE or SSD models "
            f"yet ({FAMILY_SERVE_ITEM})")


@dataclass(frozen=True)
class AttnPlan:
    """``repro.models.params.AttnPlan`` of the 1-D layout."""
    sharded: bool          # q/o projections sharded over the model group
    h_local: int           # q heads per shard
    kv_sharded: bool       # kv projections sharded
    kv_slice: int          # kv heads each shard keeps after slicing


def attn_plan(cfg: ArchConfig, tp: int) -> AttnPlan:
    """KV heads shard when tp divides them; otherwise every shard holds
    all KV heads and slices the group its contiguous q heads need
    (``params.py`` ``attn_plan``)."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if tp <= 1 or H % tp != 0:
        return AttnPlan(False, H, False, KV)
    h_local = H // tp
    if KV % tp == 0:
        return AttnPlan(True, h_local, True, KV // tp)
    group = H // KV
    if group % h_local == 0:
        kv_slice = 1
    elif h_local % group == 0:
        kv_slice = h_local // group
    else:
        kv_slice = KV
    return AttnPlan(True, h_local, False, kv_slice)


def check_tp(cfg: ArchConfig, tp: int, *, seq_shard: int = 1,
             seq_len: Optional[int] = None):
    """The 1-D layout the port runs: heads (unless ring attention
    replicates the attention weights), d_ff and the padded vocab divide by
    tp (JAX falls back to replicated projections otherwise; the port does
    not take that path yet).  MoE and SSD configs run at tp=1 only.
    RG-LRU and local-attention configs run at tp=1 only too.  Ring
    attention (``seq_shard`` > 1) raises
    where JAX's ``build_train_loss`` raises (``models/lm.py:345-363``),
    with its messages; the sequence checks need ``seq_len``."""
    if tp > 1 and is_hybrid(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port trains RG-LRU and local-attention "
            f"models at tp=1 only, got tp={tp} ({HYBRID_TP_ITEM})")
    if tp > 1 and is_family(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port trains MoE and SSD models at tp=1 "
            f"only, got tp={tp} ({FAMILY_TP_ITEM})")
    bad = [what for what, n in (("num_heads",
                                 cfg.num_heads if seq_shard == 1 else tp),
                                ("d_ff", cfg.d_ff),
                                ("padded vocab", cfg.padded_vocab()))
           if n % tp]
    if tp < 1 or bad:
        raise NotImplementedError(
            f"{cfg.name}: tp={tp} does not divide {', '.join(bad) or 'it'}; "
            f"replicated fallbacks are not ported (ROADMAP.md A2)")
    if seq_shard == 1:
        return
    blockers = []
    if tp <= 1:
        blockers.append("the mesh has no model axes (tp=1)")
    if seq_len is not None and seq_len % tp:
        blockers.append(f"seq_len {seq_len} is not divisible by the model "
                        f"group size {tp}")
    if tp > 1 and seq_shard != tp:
        blockers.append(
            f"seq_shard {seq_shard} != model group size {tp} (the KV ring "
            f"spans exactly the group the heads would have sharded over)")
    if seq_len is not None and seq_len % seq_shard:
        blockers.append(f"seq_len {seq_len} is not divisible by seq_shard "
                        f"{seq_shard}")
    if blockers:
        raise ValueError("seq_shard (ring attention) cannot run here: "
                         + "; ".join(blockers))


RING_REPLICATED = ("wq", "wk", "wv", "wo")


def shard_dims(cfg: ArchConfig, tp: int,
               seq_shard: int = 1) -> Dict[str, Optional[int]]:
    """Flat name -> the dim each rank holds 1/tp of (None: replicated), in
    the 1-D layout of ``model_specs``: wq/wk/wv/wg/wu by output column,
    wo/wd by input row, embed and lm_head by vocabulary, norm scales
    replicated; wk/wv replicated when tp does not divide the KV heads;
    wq/wk/wv/wo replicated under ring attention (``seq_shard`` > 1, JAX
    ``params.py:98-113``)."""
    if tp == 1:
        return dict.fromkeys(model_specs(cfg))
    plan = attn_plan(cfg, tp)
    col, row = -1, -2
    layer = {"ln": None, "ln2": None, "wq": col, "wo": row, "wg": col,
             "wu": col, "wd": row,
             "wk": col if plan.kv_sharded else None,
             "wv": col if plan.kv_sharded else None}
    if seq_shard > 1:
        layer.update(dict.fromkeys(RING_REPLICATED))
    out: Dict[str, Optional[int]] = {}
    for key in model_specs(cfg):
        if key.startswith("['blocks'][0]"):
            d = layer[key[len("['blocks'][0]['"):-2]]
        else:
            d = {"['embed']": 0, "['final_ln']": None,
                 "['lm_head']": -1}[key]
        out[key] = d
    return out


def partial_grad_leaves(cfg: ArchConfig, *, seq_parallel: bool,
                        seq_shard: int = 1) -> List[str]:
    """Flat names of the leaves whose gradient each rank computes only in
    part (``repro_torch.core.tmp``'s SP rule): under sequence parallelism
    the norm scales (``ln`` and ``ln2`` see this rank's sequence chunk;
    ``final_ln``'s cotangent is the vocab shard's partial one), under ring
    attention also the replicated attention weights.  Their sum over the
    ranks is the whole gradient (JAX's ``shard_map`` boundary psum)."""
    if not seq_parallel and seq_shard == 1:
        return []
    names = ["ln", "ln2"] + (list(RING_REPLICATED) if seq_shard > 1 else [])
    return ([f"['blocks'][0]['{n}']" for n in names] + ["['final_ln']"])


def shard_params(cfg: ArchConfig, params: Dict[str, Any], rank: int,
                 tp: int, *, seq_shard: int = 1) -> Dict[str, Any]:
    """One rank's weights of the full ``params`` (for example JAX's,
    through :func:`from_flat`): each sharded leaf cut into tp equal parts
    along its :func:`shard_dims` dim, this rank's part copied; replicated
    leaves copied whole."""
    check_tp(cfg, tp, seq_shard=seq_shard)
    dims = shard_dims(cfg, tp, seq_shard)
    out = {}
    for key, t in flatten(params).items():
        d = dims[key]
        part = t if d is None else t.chunk(tp, dim=d)[rank]
        out[key] = part.detach().clone()
    return unflatten(out)


def gather_grads(cfg: ArchConfig, per_rank: List[Dict[str, Any]], *,
                 seq_shard: int = 1, partial: Sequence[str] = ()
                 ) -> Dict[str, Any]:
    """Flat name -> the whole gradient, from every rank's flat gradients
    (rank order): sharded leaves concatenated along their dim, replicated
    leaves taken from rank 0 (every rank holds the same whole gradient),
    the ``partial`` ones (:func:`partial_grad_leaves`, before the step's
    all-reduce) summed over the ranks in rank order."""
    tp = len(per_rank)
    dims = shard_dims(cfg, tp, seq_shard)
    out = {}
    for key, d in dims.items():
        parts = [g[key] for g in per_rank]
        if key in partial:
            acc = parts[0]
            for p in parts[1:]:
                acc = acc + p
            out[key] = acc
        elif d is None:
            out[key] = parts[0]
        elif isinstance(parts[0], np.ndarray):
            out[key] = np.concatenate(parts, axis=d)
        else:
            out[key] = torch.cat(parts, dim=d)
    return out


def ssd_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, state) of the SSD mixer (``params.py``
    ``ssd_dims``)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_headdim, cfg.ssm_state


def stack_layout(cfg: ArchConfig) -> Tuple[int, Tuple[str, ...], List[str]]:
    """(n whole pattern repeats, the pattern, the tail's kinds): the layer
    stack of ``params.py`` ``stack_layout``."""
    pat = cfg.layer_pattern
    n = cfg.num_layers // len(pat)
    tail = [pat[i % len(pat)] for i in range(n * len(pat), cfg.num_layers)]
    return n, pat, tail


def layer_specs(cfg: ArchConfig, kind: str) -> Dict[str, Spec]:
    """One layer of ``kind`` at tp=1 (``params.py`` ``layer_specs``):
    GLOBAL_ATTN and LOCAL_ATTN (``_attn_specs``) and RGLRU
    (``_rglru_specs``: the two entry projections, the [4, w] conv, the five
    f32 gate vectors, ``w_out``), each with a SwiGLU (``_mlp_specs``) or
    MoE (``_moe_specs``: an f32 router and three expert stacks) FFN, or
    the SSD mixer alone (``_ssd_specs``)."""
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    out = {"ln": Spec((d,), f32=True, scale=0.0)}
    if kind == SSD:
        d_inner, nheads, n = ssd_dims(cfg)
        out.update({
            "in_proj": Spec((d, 2 * d_inner + 2 * n + nheads)),
            "conv": Spec((cfg.ssm_conv, d_inner + 2 * n)),
            "A_log": Spec((nheads,), f32=True, scale=-1.0),
            "Dskip": Spec((nheads,), f32=True, scale=-1.0),
            "dt_bias": Spec((nheads,), f32=True, scale=0.0),
            "norm_g": Spec((d_inner,), f32=True, scale=0.0),
            "out_proj": Spec((d_inner, d), scale=out_scale),
        })
        return out
    if kind == RGLRU:
        w = cfg.rglru_width or d
        out.update({
            "w_in_x": Spec((d, w)),
            "w_in_g": Spec((d, w)),
            "conv": Spec((4, w)),
            "w_a": Spec((w,), f32=True),
            "b_a": Spec((w,), f32=True, scale=0.0),
            "w_x": Spec((w,), f32=True),
            "b_x": Spec((w,), f32=True, scale=0.0),
            "a_param": Spec((w,), f32=True, scale=-1.0),
            "w_out": Spec((w, d), scale=out_scale),
        })
    elif kind in (GLOBAL_ATTN, LOCAL_ATTN):
        out.update({
            "wq": Spec((d, cfg.num_heads * hd)),
            "wk": Spec((d, cfg.num_kv_heads * hd)),
            "wv": Spec((d, cfg.num_kv_heads * hd)),
            "wo": Spec((cfg.num_heads * hd, d), scale=out_scale),
        })
    else:
        raise ValueError(kind)
    out["ln2"] = Spec((d,), f32=True, scale=0.0)
    if cfg.moe is not None:
        e = cfg.moe.num_experts
        out.update({
            "router": Spec((d, e), f32=True),
            "w1": Spec((e, d, f)),
            "w3": Spec((e, d, f)),
            "w2": Spec((e, f, d), scale=out_scale),
        })
    else:
        out.update({
            "wg": Spec((d, f)),
            "wu": Spec((d, f)),
            "wd": Spec((f, d), scale=out_scale),
        })
    return out


def model_specs(cfg: ArchConfig) -> Dict[str, Spec]:
    """Flat name -> Spec, in the JAX tree's flatten order: the stacked
    blocks (one per pattern position), embed, final_ln, lm_head, then the
    tail's layers."""
    check_supported(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab()
    n, pat, tail = stack_layout(cfg)
    out = {}
    for j, kind in enumerate(pat if n else ()):
        for name, s in sorted(layer_specs(cfg, kind).items()):
            out[f"['blocks'][{j}]['{name}']"] = Spec((n,) + s.shape, s.f32,
                                                     s.scale)
    out["['embed']"] = Spec((vp, d))
    out["['final_ln']"] = Spec((d,), f32=True, scale=0.0)
    if not cfg.tie_embeddings:
        out["['lm_head']"] = Spec((d, vp))
    for i, kind in enumerate(tail):
        for name, s in sorted(layer_specs(cfg, kind).items()):
            out[f"['tail'][{i}]['{name}']"] = s
    return out


def head_weight(params: Dict[str, Any]) -> torch.Tensor:
    """The LM head [d, V]: ``lm_head``, or ``embed.T`` when tied."""
    return params["lm_head"] if "lm_head" in params else params["embed"].t()


def _parse(key: str) -> Tuple[str, Optional[int], str]:
    """``"['blocks'][1]['wq']"`` -> ("blocks", 1, "wq");
    ``"['embed']"`` -> ("embed", None, "")."""
    parts = [p.strip("'") for p in key[1:-1].split("][")]
    if len(parts) == 1:
        return parts[0], None, ""
    return parts[0], int(parts[1]), parts[2]


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat name -> leaf back into the weights dict (inverse of
    :func:`flatten`)."""
    params: Dict[str, Any] = {"blocks": [], "tail": []}
    for key, t in flat.items():
        top, i, name = _parse(key)
        if i is None:
            params[top] = t
            continue
        while len(params[top]) <= i:
            params[top].append({})
        params[top][i][name] = t
    return params


def flatten(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flat name -> leaf, in the JAX tree's flatten order."""
    flat = {}
    for j, blk in enumerate(params["blocks"]):
        for name in sorted(blk):
            flat[f"['blocks'][{j}]['{name}']"] = blk[name]
    for name in ("embed", "final_ln", "lm_head"):
        if name in params:
            flat[f"['{name}']"] = params[name]
    for i, layer in enumerate(params.get("tail", ())):
        for name in sorted(layer):
            flat[f"['tail'][{i}]['{name}']"] = layer[name]
    return flat


def flat_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The weights as a list in the JAX tree's flatten order (the order of
    ``jax.tree_util.tree_leaves`` and of :func:`model_specs`)."""
    return list(flatten(params).values())


def layer_units(cfg: ArchConfig, params: Dict[str, Any]
                ) -> List[List[Tuple[str, Dict[str, torch.Tensor]]]]:
    """The stack in execution order, grouped as JAX's ``_stack_scan``
    recomputes it: one unit per pattern repeat (its positions' layers)
    and one per tail layer; each layer as (kind, its leaves)."""
    n, pat, tail = stack_layout(cfg)
    per_pos = [{name: t.unbind(0) for name, t in blk.items()}
               for blk in params["blocks"]]
    units = [[(kind, {name: ts[r] for name, ts in per_pos[j].items()})
              for j, kind in enumerate(pat)] for r in range(n)]
    return units + [[(kind, p)] for kind, p in zip(tail, params["tail"])]


@dataclass(frozen=True)
class PlanGroup:
    """One scan group of the grouped (planner-mode) layout: ``count``
    consecutive layers sharing (kind, degree, schedule, seq)."""
    kind: str
    degree: Any              # None | int | (dx, dy)
    schedule: str
    count: int
    seq: int = 1             # ring-attention seq shards


def plan_groups(cfg: ArchConfig, degrees: Sequence,
                schedules: Optional[Sequence[str]] = None,
                seqs: Optional[Sequence[int]] = None) -> List[PlanGroup]:
    """Group consecutive layers sharing (kind, degree, schedule, seq) into
    scan groups: the executable unit of a per-layer plan
    (``repro.models.params.plan_groups``).  A schedule or seq-shard change
    breaks the group even at equal degree (each group runs under its own
    ``TmpCtx``/sub-batch split).  The overlap probe groups by it; the
    port's trainer runs one group until ROADMAP.md A7."""
    pat = cfg.layer_pattern
    scheds = list(schedules) if schedules is not None \
        else [None] * cfg.num_layers
    sq = list(seqs) if seqs is not None else [1] * cfg.num_layers
    groups = []
    i = 0
    while i < cfg.num_layers:
        j = i
        while (j < cfg.num_layers and degrees[j] == degrees[i]
               and scheds[j] == scheds[i] and sq[j] == sq[i]
               and pat[j % len(pat)] == pat[i % len(pat)]):
            j += 1
        groups.append(PlanGroup(pat[i % len(pat)], degrees[i],
                                scheds[i] or "oases", j - i, sq[i]))
        i = j
    return groups


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: torch.device = torch.device("cpu")) -> Dict[str, Any]:
    """Random weights from ``seed``, drawn in place on ``device`` in the
    storage dtype (no f32 staging copy of the large matrices).  The numbers
    differ from JAX's ``init_params``; tests move JAX weights over with
    :func:`from_flat`."""
    wdt = DTYPES[cfg.dtype]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = {}
    for key, s in model_specs(cfg).items():
        t = torch.zeros(s.shape, dtype=torch.float32 if s.f32 else wdt,
                        device=device)
        if s.scale == -1.0:
            t.fill_(-1.0 if s.f32 else 1.0)
        elif s.scale:
            t.normal_(0.0, s.scale, generator=gen)
        flat[key] = t
    return unflatten(flat)


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":          # ml_dtypes bf16 from JAX
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy() if not arr.flags.writeable else arr)


def from_flat(cfg: ArchConfig, flat: Dict[str, np.ndarray],
              device: torch.device = torch.device("cpu"),
              dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Build the port's weights from ``repro.models.params.tree_to_flat``
    output: same names, same shapes, no remapping."""
    specs = model_specs(cfg)
    missing = sorted(set(specs) - set(flat))
    extra = sorted(set(flat) - set(specs))
    if missing or extra:
        raise KeyError(f"{cfg.name}: flat weights missing {missing}, "
                       f"unexpected {extra}")
    wdt = dtype if dtype is not None else DTYPES[cfg.dtype]
    out = {}
    for key, s in specs.items():
        arr = flat[key]
        if tuple(arr.shape) != s.shape:
            raise ValueError(f"{key}: shape {tuple(arr.shape)}, expected "
                             f"{s.shape}")
        out[key] = _to_torch(arr).to(
            device=device, dtype=torch.float32 if s.f32 else wdt)
    return unflatten(out)


def to_flat(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`from_flat`: flat name -> host array (bf16 leaves
    come back as f32, which holds every bf16 value exactly)."""
    return {k: (t.float() if t.dtype == torch.bfloat16 else t)
            .detach().cpu().numpy() for k, t in flatten(params).items()}


def cache_shape(cfg: ArchConfig, pages: int,
                page_size: int) -> Tuple[int, ...]:
    """Page pool of one k (or v) stack: ``[n, pages, page, kvh, hd]``
    (``repro.models.params.cache_specs(paged=...)`` at tp=1)."""
    return (cfg.num_layers, pages, page_size, cfg.num_kv_heads,
            cfg.resolved_head_dim)


def zeros_state(cfg: ArchConfig, pages: int, page_size: int,
                device: torch.device = torch.device("cpu")) -> Dict[str, Any]:
    shape = cache_shape(cfg, pages, page_size)
    dt = DTYPES[cfg.dtype]
    return {"blocks": [{"k": torch.zeros(shape, dtype=dt, device=device),
                        "v": torch.zeros(shape, dtype=dt, device=device)}]}
