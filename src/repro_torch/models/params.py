"""Parameter and decode-state shapes, partition specs, init, and the
bridge to the JAX package's flat checkpoint view (weights and decode
states).

The port's weights are a plain dict with the JAX tree's structure (over
a rank mesh each rank holds its shard of every sharded leaf, see
:class:`ModelLayout`):
``{"blocks": [{...}, ...], "embed", "final_ln", "lm_head", "tail": [...]}``
as ``repro.models.params.model_specs`` lays them out: ``blocks`` holds one
dict per position of the layer pattern, each leaf with the stacked
``[n, ...]`` leading dim of the ``n`` whole pattern repeats, and ``tail``
one unstacked dict per layer left over (:func:`stack_layout`; a
single-kind pattern has one block dict and no tail).  A per-layer plan
(grouped layout) holds ``groups`` instead: one dict per plan group
(:func:`plan_groups`), each leaf stacked ``[count, ...]``.  There is no
``lm_head`` with tied embeddings: the head is ``embed.T``.  Flat names
are the JAX ``keystr`` paths (``"['blocks'][0]['wq']"``,
``"['groups'][1]['wd']"``, ``"['tail'][1]['w_a']"``), so
:func:`from_flat` reads ``repro.models.params.tree_to_flat`` output
without remapping, and :func:`relayout_flat` moves weights between the
stacked and any plan's grouped layout (JAX's weight carrier).

A leaf's partition spec (:attr:`Spec.pspec`) is JAX's ``PartitionSpec``
in the port's terms: per dim, the tuple of mesh axes it is sharded over
(``()``: whole).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (CROSS_ATTN, GLOBAL_ATTN, LOCAL_ATTN,
                                      RGLRU, SSD, ArchConfig)
from repro_torch.core.axes import (Axes, MeshInfo, RankMesh, deg_total,
                                   mesh_info)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


PSpec = Tuple[Axes, ...]


@dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    f32: bool = False            # stored in f32 whatever the model dtype
    # init stddev; 0 -> zeros; -1 -> the constant -1 for f32 leaves and 1
    # otherwise (JAX ``init_params``' gate/decay init)
    scale: float = 0.02
    # per dim, the mesh axes it shards over (() for every dim: whole)
    pspec: PSpec = ()

    def dims(self) -> PSpec:
        """The spec of every dim (``()`` where whole)."""
        return tuple(self.pspec) + ((),) * (len(self.shape)
                                            - len(self.pspec))

    def sharded_axes(self) -> Axes:
        return tuple(a for axes in self.dims() for a in axes)


# the ROADMAP.md items that name what the families lack at tp > 1
FAMILY_TP_ITEM = ("ROADMAP.md A10c, MoE and SSD at tp > 1: MoE 'tmp' and "
                  "'ep', the replicated SSD mixer")
HYBRID_TP_ITEM = ("ROADMAP.md A10c, RG-LRU and local attention at tp > 1: "
                  "the width-sharded RG-LRU")
CROSS_TP_ITEM = ("ROADMAP.md A10c, cross attention, encoders and "
                 "post-norms at tp > 1")
SUPPORTED_KINDS = (GLOBAL_ATTN, LOCAL_ATTN, RGLRU, SSD, CROSS_ATTN)


def check_supported(cfg: ArchConfig):
    """The port trains dense global-attention models (with gemma2's
    post-norms and softcaps), the MoE family (global attention with an
    MoE FFN), the Mamba2 SSD family, patterns that mix global attention,
    local attention and the RG-LRU (the Griffin hybrid), cross attention
    to a context and whisper's encoder."""
    other = sorted(set(cfg.layer_pattern) - set(SUPPORTED_KINDS))
    mixed = len(set(cfg.layer_pattern)) > 1
    unsupported = [what for what, on in (
        (f"layer kinds {other}", other),
        ("SSD in mixed layer patterns", mixed and SSD in cfg.layer_pattern),
        ("mixed layer patterns with an MoE FFN",
         mixed and cfg.moe is not None),
        ("MoE in SSD layers",
         cfg.moe is not None and SSD in cfg.layer_pattern),
    ) if on]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port does not run {', '.join(unsupported)} "
            f"yet (ROADMAP.md A10b, what is left of the other families)")


def is_hybrid(cfg: ArchConfig) -> bool:
    """A config with RG-LRU or local-attention layers (slice 6: tp=1
    training only)."""
    return bool({RGLRU, LOCAL_ATTN} & set(cfg.layer_pattern))


def is_family(cfg: ArchConfig) -> bool:
    """An MoE or SSD config (slice 5: tp=1 training only)."""
    return cfg.moe is not None or SSD in cfg.layer_pattern


def has_cross_or_post(cfg: ArchConfig) -> bool:
    """A config with cross attention, an encoder or post-norms: the port
    trains and serves it at tp=1 only."""
    return (CROSS_ATTN in cfg.layer_pattern or cfg.is_encdec
            or cfg.post_norms)


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


def check_families(cfg: ArchConfig, tp: int):
    """MoE and SSD configs, RG-LRU and local-attention configs, and
    configs with cross attention, an encoder or post-norms train on a
    model group of one rank only (ROADMAP.md A10c)."""
    if tp > 1 and is_hybrid(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port trains RG-LRU and local-attention "
            f"models at tp=1 only, got tp={tp} ({HYBRID_TP_ITEM})")
    if tp > 1 and is_family(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port trains MoE and SSD models at tp=1 "
            f"only, got tp={tp} ({FAMILY_TP_ITEM})")
    if tp > 1 and has_cross_or_post(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port trains models with cross "
            f"attention, encoders or post-norms at tp=1 only, got tp={tp} "
            f"({CROSS_TP_ITEM})")


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
    check_families(cfg, tp)
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


def _take(t, dim: int, n: int, i: int):
    """Block i of n along ``dim`` (numpy or torch)."""
    k = t.shape[dim] // n
    idx = [slice(None)] * t.ndim
    idx[dim] = slice(i * k, (i + 1) * k)
    return t[tuple(idx)]


@dataclass(frozen=True)
class ModelLayout:
    """Where the leaves of a model lie on a rank mesh: the partition spec
    of every leaf (:func:`model_specs`) for the mesh ``info`` (None: one
    rank), the per-layer ``degrees`` and ``schedules`` of a plan (None:
    the stacked layout), the ``layout`` (auto, 1d, 2d), ring
    attention's ``seq_shard`` and the longest sequence ``max_pos``
    (whisper's ``pos_embed``).  ``shard`` cuts whole weights into a
    rank's shards and ``gather`` puts every rank's pieces back together
    (JAX's ``shard_map`` in and out specs)."""
    cfg: ArchConfig
    info: Optional[MeshInfo] = None
    degrees: Optional[Tuple] = None
    schedules: Optional[Tuple[str, ...]] = None
    layout: str = "auto"
    seq_shard: int = 1
    max_pos: int = 0

    def __post_init__(self):
        for f in ("degrees", "schedules"):
            v = getattr(self, f)
            if v is not None:
                object.__setattr__(self, f, tuple(
                    tuple(d) if isinstance(d, list) else d for d in v))
        object.__setattr__(self, "specs", model_specs(
            self.cfg, self.info, degrees=self.degrees,
            schedules=self.schedules, layout=self.layout,
            seq_shard=self.seq_shard, max_pos=self.max_pos))

    @property
    def mesh(self) -> RankMesh:
        return (self.info.mesh if self.info is not None
                else RankMesh((1,), ("data",)))

    @property
    def grouped(self) -> bool:
        return self.degrees is not None

    def groups(self) -> List["PlanGroup"]:
        return plan_groups(self.cfg, list(self.degrees), self.schedules)

    def grad_replicas(self, name: str) -> Axes:
        """The mesh axes over which the gradient of leaf ``name`` is
        partial and must be summed: the extra data-parallel axes of its
        plan group (each rank there holds the same shard and saw other
        batch rows).  Every model axis the leaf is replicated over is not
        one: there every rank computes the whole gradient (f/g)."""
        top, g, _ = _parse(name)
        if top != "groups":
            return ()
        return self.info.extra_dp_axes(self.groups()[g].degree)

    def holders(self, name: str) -> int:
        """How many ranks hold the same shard of leaf ``name``."""
        return self.mesh.size // self.mesh.axes_size(
            self.specs[name].sharded_axes())

    def holds_first(self, name: str, rank: int) -> bool:
        """Whether ``rank`` is the first of the ranks that hold its shard
        of ``name`` (its coordinates on the leaf's replicated axes are
        0): the one that counts the shard in a norm."""
        used = set(self.specs[name].sharded_axes())
        c = self.mesh.coords(rank)
        return not any(c[a] for a in self.mesh.axis_names if a not in used)

    def shard_flat(self, flat: Dict[str, Any], rank: int) -> Dict[str, Any]:
        """Flat name -> ``rank``'s block of each whole leaf of ``flat``
        (in this layout's names: :func:`relayout_flat` moves stacked
        weights there first)."""
        return {key: self._cut(key, flat[key], rank) for key in self.specs}

    def _cut(self, key: str, t, rank: int):
        for dim, axes in enumerate(self.specs[key].dims()):
            if axes:
                t = _take(t, dim, self.mesh.axes_size(axes),
                          self.mesh.axes_index(rank, axes))
        return t

    def init_shard(self, rank: int, *, seed: int = 0,
                   device: torch.device = torch.device("cpu")
                   ) -> Dict[str, Any]:
        """``rank``'s shards of :func:`init_params` ``(cfg, seed=seed,
        max_pos=self.max_pos)``, the same numbers, each whole leaf drawn
        on ``device``, cut and dropped before the next: the peak is the
        rank's shards and one whole leaf, not the whole model (ranks that
        share a card draw side by side).  The stacked layout only."""
        if self.grouped:
            raise ValueError("init_shard draws the stacked layout; a plan's "
                             "groups take shard(init_params(...))")
        out = {}
        for key, t in _draw(self.cfg, seed, device, self.max_pos):
            out[key] = self._cut(key, t, rank).detach().clone()
            del t
        return unflatten(out)

    def shard(self, params: Dict[str, Any], rank: int) -> Dict[str, Any]:
        """``rank``'s weights of the whole stacked ``params`` (for example
        JAX's, through :func:`from_flat`): moved into this layout's groups
        (:func:`relayout_flat`), then cut (:meth:`shard_flat`), detached.
        Over more than one rank every leaf is a copy; at one rank a leaf
        the layout leaves whole is the caller's tensor."""
        flat = flatten(params)
        if self.grouped:
            flat = relayout_flat(self.cfg, flat, {}, {
                "degrees": self.degrees, "schedules": self.schedules})
        out = {}
        for k, t in self.shard_flat(flat, rank).items():
            t = t.detach()
            out[k] = (t.clone() if self.mesh.size > 1 or t._base is not None
                      else t)
        return unflatten(out)

    def gather(self, per_rank: Sequence[Dict[str, Any]], *,
               partial: bool = False) -> Dict[str, Any]:
        """Flat name -> the whole leaf in the *stacked* layout, from every
        rank's flat pieces in this layout (:meth:`gather_flat`, then back
        out of the groups): with ``partial``, gradients before the step's
        sums, summed over each leaf's :meth:`grad_replicas`."""
        summed = ({k: self.grad_replicas(k) for k in self.specs}
                  if partial else None)
        flat = self.gather_flat(per_rank, summed=summed)
        if self.grouped:
            flat = relayout_flat(self.cfg, flat, {
                "degrees": self.degrees, "schedules": self.schedules}, {})
        return flat

    def gather_flat(self, per_rank: Sequence[Dict[str, Any]], *,
                    summed: Optional[Dict[str, Axes]] = None
                    ) -> Dict[str, Any]:
        """Flat name -> the whole leaf, from every rank's flat pieces
        (rank order, numpy arrays or tensors): each block put back where
        its rank's coordinates place it, taken from the first of its
        holders, or summed over the axes ``summed[name]`` names (partial
        gradients before the step's sums), in rank order."""
        summed = summed or {}
        mesh = self.mesh
        out = {}
        for key, spec in self.specs.items():
            dims = spec.dims()
            used = {a for axes in dims for a in axes}
            add = set(summed.get(key, ()))
            skip = [a for a in mesh.axis_names if a not in used | add]
            acc = None
            for r, flat in enumerate(per_rank):
                c = mesh.coords(r)
                if any(c[a] for a in skip):
                    continue
                part = flat[key]
                if acc is None:
                    acc = (np.zeros(spec.shape, part.dtype)
                           if isinstance(part, np.ndarray)
                           else part.new_zeros(spec.shape))
                idx = tuple(
                    slice(mesh.axes_index(r, axes) * part.shape[d],
                          (mesh.axes_index(r, axes) + 1) * part.shape[d])
                    if axes else slice(None) for d, axes in enumerate(dims))
                acc[idx] += part
            out[key] = acc
        return out


def layout_1d(cfg: ArchConfig, tp: int, seq_shard: int = 1) -> ModelLayout:
    """The layout of a 1-D group of ``tp`` ranks (the ``(1, tp)`` mesh of
    ``("data", "model")``)."""
    return ModelLayout(cfg, mesh_info(RankMesh((1, tp), ("data", "model"))),
                       seq_shard=seq_shard)


def shard_params(cfg: ArchConfig, params: Dict[str, Any], rank: int,
                 tp: int, *, seq_shard: int = 1) -> Dict[str, Any]:
    """One rank's weights of the full ``params`` (for example JAX's,
    through :func:`from_flat`) on a 1-D group of ``tp`` ranks: each
    sharded leaf cut into tp equal parts along its sharded dim, this
    rank's part copied; replicated leaves copied whole."""
    check_tp(cfg, tp, seq_shard=seq_shard)
    flat = layout_1d(cfg, tp, seq_shard).shard_flat(flatten(params), rank)
    return unflatten({k: t.detach().clone() for k, t in flat.items()})


def gather_grads(cfg: ArchConfig, per_rank: List[Dict[str, Any]], *,
                 seq_shard: int = 1, partial: Sequence[str] = ()
                 ) -> Dict[str, Any]:
    """Flat name -> the whole gradient, from every rank's flat gradients
    on a 1-D group (rank order): sharded leaves concatenated along their
    dim, replicated leaves taken from rank 0 (every rank holds the same
    whole gradient), the ``partial`` ones (:func:`partial_grad_leaves`,
    before the step's all-reduce) summed over the ranks in rank order."""
    lay = layout_1d(cfg, len(per_rank), seq_shard)
    return lay.gather_flat(per_rank,
                           summed={k: ("model",) for k in partial})


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


def _layer_shapes(cfg: ArchConfig, kind: str) -> Dict[str, Spec]:
    """One layer of ``kind``, whole (``params.py`` ``layer_specs``):
    GLOBAL_ATTN and LOCAL_ATTN (``_attn_specs``), CROSS_ATTN (the
    self-attention's leaves, then ``c_ln``, the ``c_``-prefixed
    projections, which read d_model, and the f32 ``c_gate`` [1], zero at
    init) and RGLRU (``_rglru_specs``: the two entry projections, the
    [4, w] conv, the five f32 gate vectors, ``w_out``), each with a
    SwiGLU (``_mlp_specs``) or MoE (``_moe_specs``: an f32 router and
    three expert stacks) FFN and, with post-norms, the f32 ``pn1`` and
    ``pn2``; or the SSD mixer alone (``_ssd_specs``)."""
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
    elif kind in (GLOBAL_ATTN, LOCAL_ATTN, CROSS_ATTN):
        for pre in ("", "c_") if kind == CROSS_ATTN else ("",):
            out.update({
                pre + "wq": Spec((d, cfg.num_heads * hd)),
                pre + "wk": Spec((d, cfg.num_kv_heads * hd)),
                pre + "wv": Spec((d, cfg.num_kv_heads * hd)),
                pre + "wo": Spec((cfg.num_heads * hd, d), scale=out_scale),
            })
        if kind == CROSS_ATTN:
            out["c_ln"] = Spec((d,), f32=True, scale=0.0)
            out["c_gate"] = Spec((1,), f32=True, scale=0.0)
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
    if cfg.post_norms:
        out["pn1"] = Spec((d,), f32=True, scale=0.0)
        out["pn2"] = Spec((d,), f32=True, scale=0.0)
    return out


def info_xy(info: Optional[MeshInfo], degree, layout: str = "auto"
            ) -> Tuple[Axes, Axes, int, int]:
    """(x_axes, y_axes, dx, dy) — the layer's width- vs contraction-
    sharding axes and their sizes (``params.py`` ``info_xy``);
    ``layout='1d'`` flattens everything into x."""
    if info is None:
        return (), (), 1, 1
    if layout == "1d":
        x_ax, y_ax = info.tp_axes(deg_total(degree)), ()
    else:
        x_ax, y_ax = info.xy_axes(degree)
    return x_ax, y_ax, info._size(x_ax), info._size(y_ax)


def _attn_specs(cfg: ArchConfig, info, degree, layout: str,
                seq_shard: int) -> Dict[str, PSpec]:
    """JAX's ``_attn_specs``: heads over x, the contraction rows over y
    when dy divides d_model; ``wo``'s output columns over y only where
    the exit gathers them (x-sharded heads, or dx 1); everything whole
    under ring attention."""
    x_ax, y_ax, dx, dy = info_xy(info, degree, layout)
    if seq_shard > 1:
        return dict.fromkeys(RING_REPLICATED, ())
    plan = attn_plan(cfg, dx)
    d_sh = y_ax if (dy > 1 and cfg.d_model % dy == 0) else ()
    o_d_sh = d_sh if (plan.sharded or dx == 1) else ()
    q = (d_sh, x_ax if plan.sharded else ())
    kv = (d_sh, x_ax if plan.kv_sharded else ())
    return {"wq": q, "wk": kv, "wv": kv,
            "wo": (x_ax if plan.sharded else (), o_d_sh)}


def _mlp_specs(cfg: ArchConfig, info, degree,
               layout: str) -> Dict[str, PSpec]:
    """JAX's ``_mlp_specs``: d_ff over x, the contraction rows over y,
    ``wd``'s output columns over y where the exit gathers them."""
    x_ax, y_ax, dx, dy = info_xy(info, degree, layout)
    f_sh = x_ax if (dx > 1 and cfg.d_ff % dx == 0) else ()
    d_sh = y_ax if (dy > 1 and cfg.d_model % dy == 0) else ()
    out_sh = d_sh if (f_sh or dx == 1) else ()
    return {"wg": (d_sh, f_sh), "wu": (d_sh, f_sh), "wd": (f_sh, out_sh)}


def layer_specs(cfg: ArchConfig, kind: str, info: Optional[MeshInfo] = None,
                degree=None, *, layout: str = "auto",
                seq_shard: int = 1) -> Dict[str, Spec]:
    """One layer of ``kind`` with its partition specs on the mesh ``info``
    (None: one rank) at ``degree`` (``params.py`` ``layer_specs``).  The
    port shards the dense attention and SwiGLU layers; the families run
    whole (their sharded forms are ROADMAP.md A10c)."""
    out = _layer_shapes(cfg, kind)
    pspecs: Dict[str, PSpec] = {}
    if info is not None and kind in (GLOBAL_ATTN, LOCAL_ATTN, CROSS_ATTN):
        pspecs.update(_attn_specs(cfg, info, degree, layout, seq_shard))
    if info is not None and cfg.moe is None and kind != SSD:
        pspecs.update(_mlp_specs(cfg, info, degree, layout))
    return {k: dataclasses.replace(s, pspec=pspecs.get(k, ()))
            for k, s in out.items()}


def _stacked(s: Spec, n: int) -> Spec:
    return Spec((n,) + s.shape, s.f32, s.scale, ((),) + s.dims())


def model_specs(cfg: ArchConfig, info: Optional[MeshInfo] = None, *,
                degrees: Optional[Sequence] = None,
                schedules: Optional[Sequence[str]] = None,
                layout: str = "auto",
                seq_shard: int = 1, max_pos: int = 0) -> Dict[str, Spec]:
    """Flat name -> Spec, in the JAX tree's flatten order (sorted keys:
    ``blocks``, ``embed``, ``encoder``, ``final_ln``, ``groups``,
    ``lm_head``, ``pos_embed``, ``tail``), with partition specs on the
    mesh ``info`` (None: one rank).  whisper's decoder has a learned
    ``pos_embed`` of ``max(max_pos, 2048)`` rows, and an encoder-decoder
    config the ``encoder`` tree: its ``pos_embed`` [context_len, d], its
    ``blocks`` (GLOBAL_ATTN layers stacked ``[encoder_layers, ...]``) and
    its ``final_ln``.

    Stacked layout (``degrees`` None): the stacked blocks (one per
    pattern position) and the tail's layers.  Grouped layout (a plan's
    per-layer ``degrees``, each None, an int or ``(dx, dy)``, and
    ``schedules``): ``groups``, consecutive layers sharing (kind, degree,
    schedule) stacked ``[count, ...]`` (:func:`plan_groups`).  The
    embedding and the head are vocab-sharded over the whole model group
    in every layout (``repro.models.params.model_specs``)."""
    check_supported(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab()
    tp_ax = info.tp_axes(None) if info is not None else ()
    out = {}
    if degrees is None:
        n, pat, tail = stack_layout(cfg)
        for j, kind in enumerate(pat if n else ()):
            for name, s in sorted(layer_specs(
                    cfg, kind, info, layout=layout,
                    seq_shard=seq_shard).items()):
                out[f"['blocks'][{j}]['{name}']"] = _stacked(s, n)
    out["['embed']"] = Spec((vp, d), pspec=(tp_ax, ()))
    out["['final_ln']"] = Spec((d,), f32=True, scale=0.0)
    if degrees is not None:
        if len(degrees) != cfg.num_layers:
            raise ValueError(f"per-layer degrees have {len(degrees)} "
                             f"entries for a {cfg.num_layers}-layer model")
        if info is None or not info.factored:
            tp = info.tp if info is not None else 1
            bad = [g for g in degrees if g is not None and deg_total(g) != tp]
            if bad:
                raise ValueError(
                    f"per-layer degrees {sorted(set(map(str, bad)))} "
                    f"differ from the mesh model group ({tp}) — "
                    f"mixed degrees need the factored mesh "
                    f"(launch/mesh.py::make_factored_mesh); on a plain "
                    f"mesh only per-layer SCHEDULES may vary")
        for g, grp in enumerate(plan_groups(cfg, degrees, schedules)):
            for name, s in sorted(layer_specs(
                    cfg, grp.kind, info, grp.degree,
                    layout=layout).items()):
                out[f"['groups'][{g}]['{name}']"] = _stacked(s, grp.count)
    if not cfg.tie_embeddings:
        out["['lm_head']"] = Spec((d, vp), pspec=((), tp_ax))
    if degrees is None:
        for i, kind in enumerate(tail):
            for name, s in sorted(layer_specs(
                    cfg, kind, info, layout=layout,
                    seq_shard=seq_shard).items()):
                out[f"['tail'][{i}]['{name}']"] = s
    if cfg.name.startswith("whisper"):
        out["['pos_embed']"] = Spec((max(max_pos, 2048), d))
    if cfg.is_encdec:
        out["['encoder']['pos_embed']"] = Spec((cfg.context_len, d))
        for name, s in layer_specs(cfg, GLOBAL_ATTN, info,
                                   layout=layout).items():
            out[f"['encoder']['blocks']['{name}']"] = _stacked(
                s, cfg.encoder_layers)
        out["['encoder']['final_ln']"] = Spec((d,), f32=True, scale=0.0)
    return dict(sorted(out.items(), key=lambda kv: _order(kv[0])))


def head_weight(params: Dict[str, Any]) -> torch.Tensor:
    """The LM head [d, V]: ``lm_head``, or ``embed.T`` when tied."""
    return params["lm_head"] if "lm_head" in params else params["embed"].t()


def _parts(key: str) -> List[str]:
    return [p.strip("'") for p in key[1:-1].split("][")]


def _order(key: str) -> Tuple:
    """Sort key of a flat name in the JAX tree's flatten order: dict keys
    sorted, list entries by index."""
    return tuple(int(p) if p.isdigit() else p for p in _parts(key))


def _parse(key: str) -> Tuple[str, Optional[int], str]:
    """``"['blocks'][1]['wq']"`` -> ("blocks", 1, "wq");
    ``"['embed']"`` -> ("embed", None, "");
    ``"['encoder']['blocks']['wq']"`` -> ("encoder", None, "blocks/wq")
    (a leaf of a nested dict, not a layer of the stack)."""
    parts = _parts(key)
    if len(parts) == 1:
        return parts[0], None, ""
    if parts[1].isdigit():
        return parts[0], int(parts[1]), parts[2]
    return parts[0], None, "/".join(parts[1:])


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat name -> leaf back into the weights dict (inverse of
    :func:`flatten`)."""
    params: Dict[str, Any] = {"blocks": [], "tail": []}
    for key, t in flat.items():
        top, i, name = _parse(key)
        if i is None and name:
            *path, leaf = name.split("/")
            node = params.setdefault(top, {})
            for sub in path:
                node = node.setdefault(sub, {})
            node[leaf] = t
            continue
        if i is None:
            params[top] = t
            continue
        params.setdefault(top, [])
        while len(params[top]) <= i:
            params[top].append({})
        params[top][i][name] = t
    return params


def flatten(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flat name -> leaf, in the JAX tree's flatten order (sorted keys;
    lists in order; a layer's leaves sorted)."""
    flat = {}

    def walk(prefix, node):
        for name in sorted(node):
            if isinstance(node[name], dict):
                walk(f"{prefix}['{name}']", node[name])
            else:
                flat[f"{prefix}['{name}']"] = node[name]

    for top in sorted(params):
        if isinstance(params[top], list):
            for j, layer in enumerate(params[top]):
                walk(f"['{top}'][{j}]", layer)
        elif isinstance(params[top], dict):
            walk(f"['{top}']", params[top])
        else:
            flat[f"['{top}']"] = params[top]
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


def encoder_layers(params: Dict[str, Any]) -> List[Dict[str, torch.Tensor]]:
    """The encoder's layers in order, each its leaves (unbound from the
    stack, as :func:`layer_units` does)."""
    per = {name: t.unbind(0)
           for name, t in params["encoder"]["blocks"].items()}
    n = len(next(iter(per.values())))
    return [{name: ts[i] for name, ts in per.items()} for i in range(n)]


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
    ``TmpCtx``/sub-batch split).  The grouped layout
    (:func:`model_specs`), the trainer's layer loop
    (``models/lm.py``) and the overlap probe all group by it."""
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


def _stack(arrs):
    return (np.stack(arrs) if isinstance(arrs[0], np.ndarray)
            else torch.stack(arrs))


def split_layer_flat(cfg: ArchConfig, flat: Dict[str, Any], *,
                     degrees: Optional[Sequence] = None,
                     schedules: Optional[Sequence[str]] = None
                     ) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Decompose a flat params-like dict (numpy arrays or tensors) into
    ``(static, per_layer)``: ``static`` keeps the non-layer leaves as they
    are; ``per_layer[l]`` maps each layer leaf's name suffix (for example
    ``"['wq']"``) to layer ``l``'s array in layer order
    (``repro.models.params.split_layer_flat`` without pipelines)."""
    static: Dict[str, Any] = {}
    by_slot: Dict[Tuple[str, int], Dict[str, Any]] = {}
    for key, arr in flat.items():
        top, idx, name = _parse(key)
        if idx is None:
            static[key] = arr
        else:
            by_slot.setdefault((top, idx), {})[f"['{name}']"] = arr
    per_layer: List[Dict[str, Any]] = [dict() for _ in
                                       range(cfg.num_layers)]
    if degrees is not None:
        groups = plan_groups(cfg, degrees, schedules)
        base = 0
        for g, grp in enumerate(groups):
            for name, arr in by_slot.get(("groups", g), {}).items():
                if arr.shape[0] != grp.count:
                    raise ValueError(
                        f"group {g} leaf {name} has leading dim "
                        f"{arr.shape[0]}, plan group expects {grp.count}")
                for o in range(grp.count):
                    per_layer[base + o][name] = arr[o]
            base += grp.count
        if base != cfg.num_layers:
            raise ValueError(f"plan groups cover {base} layers, config "
                             f"has {cfg.num_layers}")
        return static, per_layer
    n, pat, _ = stack_layout(cfg)
    for (top, idx), leaves in sorted(by_slot.items()):
        if top == "groups":
            raise ValueError(
                "checkpoint holds grouped (planner-mode) layers but no "
                "per-layer plan was recorded — cannot recover the layer "
                "order")
        for name, arr in leaves.items():
            if top == "blocks":
                for r in range(n):
                    per_layer[r * len(pat) + idx][name] = arr[r]
            else:                                    # tail
                per_layer[n * len(pat) + idx][name] = arr
    return static, per_layer


def pack_layer_flat(cfg: ArchConfig, static: Dict[str, Any],
                    per_layer: Sequence[Dict[str, Any]], *,
                    degrees: Optional[Sequence] = None,
                    schedules: Optional[Sequence[str]] = None
                    ) -> Dict[str, Any]:
    """Inverse of :func:`split_layer_flat`: repack per-layer dicts into
    the target layout's flat view (stacked, or a plan's groups)."""
    flat = dict(static)
    if degrees is not None:
        base = 0
        for g, grp in enumerate(plan_groups(cfg, degrees, schedules)):
            for name in per_layer[base]:
                flat[f"['groups'][{g}]{name}"] = _stack(
                    [per_layer[base + o][name] for o in range(grp.count)])
            base += grp.count
        return flat
    n, pat, tail = stack_layout(cfg)
    for p in range(len(pat) if n else 0):
        for name in per_layer[p]:
            flat[f"['blocks'][{p}]{name}"] = _stack(
                [per_layer[r * len(pat) + p][name] for r in range(n)])
    for t in range(len(tail)):
        for name, arr in per_layer[n * len(pat) + t].items():
            flat[f"['tail'][{t}]{name}"] = arr
    return flat


def relayout_flat(cfg: ArchConfig, flat: Dict[str, Any], src: Dict,
                  dst: Dict) -> Dict[str, Any]:
    """Re-stack a flat params-like dict from the ``src`` plan layout into
    the ``dst`` one (JAX's weight carrier): each side
    ``{"degrees", "schedules"}`` (both optional; degrees None is the
    stacked layout).  Pure restacking: values move, none change."""
    static, per_layer = split_layer_flat(
        cfg, flat, degrees=src.get("degrees"),
        schedules=src.get("schedules"))
    return pack_layer_flat(cfg, static, per_layer,
                           degrees=dst.get("degrees"),
                           schedules=dst.get("schedules"))


def _draw(cfg: ArchConfig, seed: int, device: torch.device,
          max_pos: int) -> Iterator[Tuple[str, torch.Tensor]]:
    """(flat name, whole leaf) of :func:`init_params`, in its order and
    from its one generator, each leaf drawn when it is asked for."""
    wdt = DTYPES[cfg.dtype]
    gen = torch.Generator(device=device).manual_seed(seed)
    for key, s in model_specs(cfg, max_pos=max_pos).items():
        t = torch.zeros(s.shape, dtype=torch.float32 if s.f32 else wdt,
                        device=device)
        if s.scale == -1.0:
            t.fill_(-1.0 if s.f32 else 1.0)
        elif s.scale:
            t.normal_(0.0, s.scale, generator=gen)
        yield key, t
        del t


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: torch.device = torch.device("cpu"),
                max_pos: int = 0) -> Dict[str, Any]:
    """Random weights from ``seed``, drawn in place on ``device`` in the
    storage dtype (no f32 staging copy of the large matrices).  The numbers
    differ from JAX's ``init_params``; tests move JAX weights over with
    :func:`from_flat`.  ``max_pos``: the longest sequence (whisper's
    decoder ``pos_embed``)."""
    return unflatten(dict(_draw(cfg, seed, device, max_pos)))


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":          # ml_dtypes bf16 from JAX
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy() if not arr.flags.writeable else arr)


def from_flat(cfg: ArchConfig, flat: Dict[str, np.ndarray],
              device: torch.device = torch.device("cpu"),
              dtype: Optional[torch.dtype] = None,
              max_pos: int = 0) -> Dict[str, Any]:
    """Build the port's weights from ``repro.models.params.tree_to_flat``
    output: same names, same shapes, no remapping (``max_pos``: the
    sequence JAX's specs were built for)."""
    specs = model_specs(cfg, max_pos=max_pos)
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


def cache_specs(cfg: ArchConfig, *, batch: int, seq: int,
                paged: Optional[Tuple[int, int]] = None,
                info: Optional[MeshInfo] = None,
                layout: str = "auto") -> Dict[str, Any]:
    """The decode state of ``batch`` slots of ``seq`` positions
    (``repro.models.params.cache_specs``): ``{"blocks": [one dict a
    pattern position, each leaf stacked [n, ...]], "tail": [one dict a
    tail layer, [1, ...]]}`` of :class:`Spec` (f32 where JAX's is, else the
    model dtype), with JAX's keys by layer kind:

    * GLOBAL_ATTN: ``k``, ``v`` [n, batch, seq, kvh, hd];
    * LOCAL_ATTN: the same over ``min(seq, window)`` positions, a ring
      (slot = pos % window);
    * CROSS_ATTN: the self-attention's ``k``, ``v`` and the context's
      ``c_k``, ``c_v`` [n, batch, context_len, kvh, hd];
    * RGLRU: ``h`` [n, batch, w] f32 and the conv's last inputs ``conv``
      [n, batch, 3, w];
    * SSD: ``S`` [n, batch, heads, p, state] f32 and ``conv`` [n, batch,
      conv - 1, d_inner + 2 state].

    ``paged=(pages, page_size)`` swaps the GLOBAL_ATTN ``k``, ``v`` for
    page pools [n, pages, page_size, kvh, hd]; every other state stays
    dense.  On the mesh ``info`` (None: one rank) shapes are global and
    the kv-head dim shards as JAX's does, by :func:`attn_plan` at the
    width degree (dx, the x axes alone in 2-D; ``layout`` "1d" flattens
    every model axis into x): over x where the plan shards KV, and as
    ``tp * kv_slice`` heads over x where KV is replicated and each rank
    keeps the slice its q heads need.  The slots are not sharded (a
    ``data`` axis above 1 is refused by the engine).  :func:`zeros_state`
    and :func:`state_from_flat` make a rank's shard."""
    check_supported(cfg)
    hd = cfg.resolved_head_dim
    d_inner, nheads, nstate = ssd_dims(cfg)
    w = cfg.rglru_width or cfg.d_model
    x_ax, _, tp, _ = info_xy(info, None, layout)
    plan = attn_plan(cfg, tp)
    if plan.kv_sharded:
        kvh, kv_sh = cfg.num_kv_heads, x_ax
    elif plan.sharded:
        kvh, kv_sh = tp * plan.kv_slice, x_ax     # duplicated storage
    else:
        kvh, kv_sh = cfg.num_kv_heads, ()
    kv_ps = ((), (), (), kv_sh, ())

    def leaf(*shape, f32=False, pspec=()):
        return Spec(tuple(shape), f32=f32, scale=0.0, pspec=pspec)

    def kv(n, s):
        return {"k": leaf(n, batch, s, kvh, hd, pspec=kv_ps),
                "v": leaf(n, batch, s, kvh, hd, pspec=kv_ps)}

    def state_for(kind, n):
        if kind == GLOBAL_ATTN:
            if paged is None:
                return kv(n, seq)
            pages, page_size = paged
            return {"k": leaf(n, pages, page_size, kvh, hd, pspec=kv_ps),
                    "v": leaf(n, pages, page_size, kvh, hd, pspec=kv_ps)}
        if kind == LOCAL_ATTN:
            return kv(n, min(seq, cfg.window))
        if kind == CROSS_ATTN:
            return {**kv(n, seq),
                    "c_k": leaf(n, batch, cfg.context_len, kvh, hd,
                                pspec=kv_ps),
                    "c_v": leaf(n, batch, cfg.context_len, kvh, hd,
                                pspec=kv_ps)}
        if kind == RGLRU:
            return {"h": leaf(n, batch, w, f32=True),
                    "conv": leaf(n, batch, 3, w)}
        if kind == SSD:
            return {"S": leaf(n, batch, nheads, cfg.ssm_headdim, nstate,
                              f32=True),
                    "conv": leaf(n, batch, cfg.ssm_conv - 1,
                                 d_inner + 2 * nstate)}
        raise ValueError(kind)

    n, pat, tail = stack_layout(cfg)
    return {"blocks": [state_for(k, n) for k in pat] if n else [],
            "tail": [state_for(k, 1) for k in tail]}


def _local_shape(spec: Spec, info: Optional[MeshInfo]) -> Tuple[int, ...]:
    """A rank's block of a leaf of global shape ``spec.shape``."""
    if info is None:
        return spec.shape
    return tuple(n // info.mesh.axes_size(axes) if axes else n
                 for n, axes in zip(spec.shape, spec.dims()))


def zeros_state(cfg: ArchConfig, specs: Dict[str, Any],
                device: torch.device = torch.device("cpu"),
                info: Optional[MeshInfo] = None) -> Dict[str, Any]:
    """Zeros in the tree of :func:`cache_specs` (f32 leaves in f32, the
    rest in the model dtype) on ``device``: on the mesh ``info`` (None:
    one rank) a rank's shard."""
    wdt = DTYPES[cfg.dtype]
    return unflatten({k: torch.zeros(_local_shape(s, info), device=device,
                                     dtype=torch.float32 if s.f32 else wdt)
                      for k, s in flatten(specs).items()})


def state_from_flat(cfg: ArchConfig, flat: Dict[str, np.ndarray],
                    specs: Dict[str, Any],
                    device: torch.device = torch.device("cpu"),
                    info: Optional[MeshInfo] = None,
                    rank: int = 0) -> Dict[str, Any]:
    """A decode state from JAX's (``jax.tree_util.keystr`` names of its
    state tree, numpy leaves, global shapes): the tree of
    :func:`cache_specs` with the same names and shapes, no remapping; on
    the mesh ``info`` ``rank``'s shard of each leaf."""
    fs = flatten(specs)
    missing, extra = sorted(set(fs) - set(flat)), sorted(set(flat) - set(fs))
    if missing or extra:
        raise KeyError(f"{cfg.name}: flat state missing {missing}, "
                       f"unexpected {extra}")
    wdt = DTYPES[cfg.dtype]
    out = {}
    for key, s in fs.items():
        arr = flat[key]
        if tuple(arr.shape) != s.shape:
            raise ValueError(f"{key}: shape {tuple(arr.shape)}, expected "
                             f"{s.shape}")
        if info is not None:
            for dim, axes in enumerate(s.dims()):
                if axes:
                    arr = _take(arr, dim, info.mesh.axes_size(axes),
                                info.mesh.axes_index(rank, axes))
        out[key] = _to_torch(np.ascontiguousarray(arr)).to(
            device=device, dtype=torch.float32 if s.f32 else wdt)
    return unflatten(out)


def state_to_flat(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`state_from_flat`: flat name -> host array (bf16
    leaves as f32, which holds every bf16 value exactly)."""
    return to_flat(state)
