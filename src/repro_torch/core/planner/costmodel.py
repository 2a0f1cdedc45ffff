"""Oases planner cost model (paper §4.2): the port's copy of
``repro.core.planner.costmodel``.

The arithmetic is the JAX package's, line for line, so both packages
give the same plans and estimates for the same inputs
(``tests/test_torch_planner.py`` holds them equal).  What differs is
where the chip terms come from: :meth:`HWConfig.measure_fields` times a
bf16 product and a stream far larger than L2 on the card with CUDA
events, and the link terms, which one card cannot measure, come from
the :data:`H100_80GB_HBM3` fixture.  ``HWConfig``'s field defaults and
:data:`V5E` stay the JAX package's TPU numbers, so a caller that passes
no ``hw`` gets JAX's plan; the port's launchers never use them.

The model graph is blocks = (computation sequence, trailing collective) —
for a transformer layer that is [attn-block, mlp-block].  For each block and
each candidate TMP degree n ∈ {2,4,8,16} (powers of two, paper §4.2) we
compute:

* d(F), d(B)   — per-sub-batch compute seconds (bwd ≈ 2x fwd + recompute),
* c(F), c(B)   — per-sub-batch AllReduce seconds, volume 2K(n-1)/n (paper
                 §4 observation i), K = per-chip activation bytes; with
                 coarse remat the *recompute* collectives are added to c(B)
                 — this is how the planner "models the overlapping schedule"
                 (fine-grained recomputation removes them, §3.2),
* m_s, m_t, m_r — Eq. 6 memory terms (param+optimizer state, saved tensors,
                 backward runtime), per chip.

Eq. 3 node costs use max{compute, comm} overlap; Eq. 4 edge costs charge the
batch-resharding AllGather between degree groups plus the overlap destroyed
by that blocking gather.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import (ArchConfig, CROSS_ATTN, GLOBAL_ATTN,
                                      LOCAL_ATTN, RGLRU, SSD, ShapeConfig,
                                      TrainHParams)
from repro_torch.kernels import bounds


@dataclass(frozen=True)
class HWConfig:
    # The defaults are the JAX package's TPU fixture (a v5e pod), kept so
    # that a caller passing no ``hw`` gets JAX's plan; the port's
    # launchers plan with a calibrated card or H100_80GB_HBM3.
    n_chips: int = 256
    peak_flops: float = 197e12       # bf16
    hbm_bw: float = 819e9
    link_bw: float = 50e9
    hbm_cap: float = 16e9
    mxu_base_eff: float = 0.6        # achievable fraction at healthy shapes
    bytes_act: int = 2               # bf16 activations
    # calibration scale (CPU measurements use different constants)
    comm_latency: float = 5e-6       # per-collective latency floor
    # ---- heterogeneous (per-axis) bandwidth terms, AMP-style ----
    # The commodity-server regime: fast intra-node lanes (NVLink/ICI class)
    # carry the x-axis rings, the thin inter-node NIC carries the y-axis.
    # 0 means "fall back to the uniform link_bw" so every existing caller
    # keeps its single-bandwidth behaviour.
    link_bw_x: float = 0.0           # intra-node (x-axis ring) bytes/s
    link_bw_y: float = 0.0           # inter-node (y-axis ring) bytes/s
    node_size: int = 0               # chips per fast-interconnect node
    # per-hop latency of an inter-node (NIC) crossing; 0 -> comm_latency.
    # Only the decode/serving latency model reads this (training payloads
    # are bandwidth-bound, so the per-hop split would be noise there).
    comm_latency_y: float = 0.0

    @property
    def bw_x(self) -> float:
        return self.link_bw_x or self.link_bw

    @property
    def bw_y(self) -> float:
        return self.link_bw_y or self.link_bw

    @property
    def lat_y(self) -> float:
        return self.comm_latency_y or self.comm_latency

    def ring_bw(self, degree: int) -> float:
        """Effective per-hop bandwidth of a ring over ``degree`` chips: a
        ring confined to one node runs at the intra-node rate; a ring that
        spans nodes is bottlenecked by the slowest (inter-node) hop."""
        ns = self.node_size or self.n_chips
        return self.bw_x if degree <= ns else self.bw_y

    def collective_latency(self, degree: int) -> float:
        """Critical-path latency of one all-reduce over ``degree`` chips at
        decode payloads (bandwidth ~free, hops everything).  Intra-node
        segments ride a switched fabric — log2 depth per phase — while
        every node-boundary crossing pays a full inter-node hop, twice
        (reduce-scatter + all-gather phases)."""
        if degree <= 1:
            return 0.0
        ns = self.node_size or self.n_chips
        intra = 2.0 * self.comm_latency * math.ceil(
            math.log2(min(degree, ns)))
        if degree <= ns:
            return intra
        crossings = math.ceil(degree / ns)
        return intra + 2.0 * crossings * self.lat_y

    def degrade(self, *, n_chips: Optional[int] = None,
                lost_chips: int = 0,
                link_bw_y: Optional[float] = None,
                link_bw_x: Optional[float] = None,
                node_size: Optional[int] = None,
                bw_scale: float = 1.0) -> "HWConfig":
        """The surviving-topology view of this cluster after a fault —
        what the elastic supervisor hands back to :func:`ilp.replan` when
        a host drops or a link degrades (AMP-style heterogeneity
        awareness: replan against *measured* health, not the spec sheet).

        * ``n_chips``/``lost_chips`` — surviving device count (clamped to
          >= 1; ``node_size`` is re-clamped so a partial node never claims
          more chips than survive);
        * ``link_bw_y``/``link_bw_x`` — measured per-link bandwidth
          overrides (a degraded NIC reports its *actual* rate);
        * ``bw_scale`` — uniform multiplier on every link term (straggler
          escalation: the whole collective runs at the slow peer's pace).
        """
        import dataclasses
        n = int(n_chips) if n_chips is not None \
            else self.n_chips - int(lost_chips)
        n = max(n, 1)
        ns = int(node_size) if node_size is not None else self.node_size
        fields: Dict[str, object] = {
            "n_chips": n, "node_size": min(ns, n) if ns else 0}
        if link_bw_y is not None:
            fields["link_bw_y"] = max(float(link_bw_y), 1.0)
        if link_bw_x is not None:
            fields["link_bw_x"] = max(float(link_bw_x), 1.0)
        hw = dataclasses.replace(self, **fields)
        if bw_scale != 1.0:
            s = max(float(bw_scale), 1e-6)
            hw = dataclasses.replace(
                hw, link_bw=hw.link_bw * s,
                link_bw_x=hw.link_bw_x * s, link_bw_y=hw.link_bw_y * s)
        return hw

    @classmethod
    def measure_fields(cls, *, max_devices: int = 8, repeats: int = 5,
                       device=None) -> Dict[str, float]:
        """Profile-guided calibration: the raw micro-bench measurements of
        the roofline terms this model otherwise takes on faith, as a plain
        field dict — this is what
        :mod:`repro_torch.core.planner.calibrate` persists per host, so
        caller ``overrides`` can be applied on top of a cache hit without
        re-profiling (``peak_flops`` is achievable, so ``mxu_base_eff`` is
        folded in and reset to 1.0).

        On the card (``device``: None or a CUDA device; the CPU raises,
        there is no card to calibrate), each timed with CUDA events, best
        of ``repeats`` after a synchronised warm-up:

        * ``peak_flops``: a square bf16 product of side 8192, the
          function the TPU's f32 ``a @ a`` ran there (f32 at default
          precision runs on the bf16 MXU); an f32 product on the card
          would time the CUDA cores, 15x below the rate the model's bf16
          products run at;
        * ``hbm_bw``: an elementwise ``2 * a`` over 1 GiB of f32 (read
          once, written once), far past the 50 MB L2;
        * ``hbm_cap``: the device's total memory.

        The link terms are not measured (one card has no link; rank
        processes sharing it are time-sliced) and come from
        :data:`H100_80GB_HBM3`."""
        import dataclasses as _dc

        import torch

        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(
                f"HWConfig.measure_fields calibrates a CUDA card "
                f"({dev} asked for, CUDA available: "
                f"{torch.cuda.is_available()}): plan with the "
                f"H100_80GB_HBM3 fixture instead (--no-calibrate, or "
                f"REPRO_NO_CALIBRATE=1)")
        n = min(torch.cuda.device_count(), max_devices)

        def _best(fn) -> float:
            fn()
            torch.cuda.synchronize(dev)
            best = float("inf")
            for _ in range(max(repeats, 1)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            return best

        with torch.cuda.device(dev):
            d = 8192
            gen = torch.Generator(device=dev).manual_seed(0)
            a = torch.randn((d, d), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            b = torch.randn((d, d), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            c = torch.empty_like(a)
            t_mm = _best(lambda: torch.matmul(a, b, out=c))
            flops = 2.0 * d * d * d / max(t_mm, 1e-9)
            del a, b, c

            elems = (1 << 30) // 4
            x = torch.ones(elems, device=dev, dtype=torch.float32)
            y = torch.empty_like(x)
            t_cp = _best(lambda: torch.mul(x, 2.0, out=y))
            hbm = 2.0 * elems * 4 / max(t_cp, 1e-9)      # read + write
            del x, y
            torch.cuda.empty_cache()        # the launcher's parent spawns
            cap = torch.cuda.get_device_properties(dev).total_memory

        links = {k: v for k, v in _dc.asdict(H100_80GB_HBM3).items()
                 if k in LINK_FIELDS}
        return dict(n_chips=n, peak_flops=flops, hbm_bw=hbm,
                    hbm_cap=float(cap), mxu_base_eff=1.0, node_size=n,
                    **links)


# The JAX package's TPU fixture, kept for parity; the port's launchers
# never plan with it.
V5E = HWConfig()

# The card the port runs on, named as nvidia-smi names it (H100 SXM, 700 W):
# one 8-card HGX box.  Peak bf16 rate and memory rate are the data sheet's
# (kernels/bounds.py), 80 GB of HBM3; NVLink 4 carries 900 GB/s a card,
# 450 GB/s in each direction of a ring hop.  ``mxu_base_eff`` stays the
# model's achievable share of a data-sheet peak.  ``--no-calibrate`` plans
# with it, and a calibrated config takes its link terms (LINK_FIELDS) from
# it: one card has no link to measure.
H100_80GB_HBM3 = HWConfig(
    n_chips=8, node_size=8, peak_flops=bounds.PEAK_FLOPS["bfloat16"],
    hbm_bw=bounds.PEAK_BYTES, hbm_cap=80e9, link_bw=450e9)
LINK_FIELDS = ("link_bw", "link_bw_x", "link_bw_y", "comm_latency",
               "comm_latency_y")

# Golden-fixture HWConfigs (tests/test_planner_golden.py pins the plans
# these produce so cost-model edits that silently flip Table-6-style
# decisions fail loudly).
#
# * COMMODITY_25GBE — two 8-GPU boxes joined by 25 GbE (~3.1 GB/s): the
#   paper's commodity-server regime.  1D rings spanning both boxes crawl at
#   NIC speed; the 2D hybrid keeps the wide x-ring on PCIe/NVLink-class
#   intra-node lanes and sends only the thin y-traffic across.
# * NVLINK_BOX — a single 16-GPU NVLink-class box: uniform fast links, so
#   the 2D split buys nothing and the planner should stay effectively 1D.
COMMODITY_25GBE = HWConfig(
    n_chips=16, node_size=8, peak_flops=125e12, hbm_bw=1008e9,
    link_bw=3.1e9, link_bw_x=120e9, link_bw_y=3.1e9, hbm_cap=24e9,
    comm_latency_y=30e-6)
NVLINK_BOX = HWConfig(
    n_chips=16, node_size=16, peak_flops=125e12, hbm_bw=1008e9,
    link_bw=250e9, hbm_cap=24e9)


def _dxy(degree) -> Tuple[int, int]:
    """(dx, dy) view of a planner degree; ints are (n, 1)."""
    if isinstance(degree, (tuple, list)):
        return int(degree[0]), int(degree[1])
    return int(degree), 1


def _dtot(degree) -> int:
    dx, dy = _dxy(degree)
    return dx * dy


def _dkey(degree):
    """Hashable canonical form: int for 1D, tuple for 2D."""
    dx, dy = _dxy(degree)
    return dx if dy == 1 else (dx, dy)


def overlapped_time(d: float, c: float, ring_steps: int) -> float:
    """Node cost of a fused collective-matmul block (schedule='fused').

    The kernel streams matmul tiles into a ring collective, so per tile-ring
    the exposed time is ``max(T_comm, T_compute)`` — the slower side fully
    hides the faster — plus one ring step of pipeline fill (the first
    transfer has no prior tile to hide behind).  This is the term that lets
    the planner *choose* fused partitions: comm that a blocking schedule
    charges at ``T_comm + T_compute`` is genuinely free below the compute
    roofline.
    """
    steps = max(ring_steps, 1)
    return max(d, c) + min(d, c) / steps


def overlapped_time_2d(d: float, c_x: float, c_y: float,
                       ring_steps_x: int) -> float:
    """Composed fused cost of a 2D node.

    The x-axis ring overlaps the tile matmuls exactly as in 1D
    (``max(T_comm_x, T_compute)``); the y-axis collectives (entry psums +
    exit gather) then overlap the x-side pipeline fill, so the node pays
    ``max(T_comm_x, T_compute) + max(T_comm_y, fill)``.  Degenerates to
    :func:`overlapped_time` at dy == 1 (c_y == 0)."""
    fill = min(d, c_x) / max(ring_steps_x, 1)
    return max(d, c_x) + max(c_y, fill)


def _mxu_eff(hw: HWConfig, *dims: int) -> float:
    """Efficiency discount for narrow per-chip matmul dims (the paper's
    arithmetic-density caveat, §5.6)."""
    eff = hw.mxu_base_eff
    for d in dims:
        if d < 512:
            eff *= max(d, 16) / 512.0
    return max(eff, 0.02 * hw.mxu_base_eff)


@dataclass
class BlockCost:
    name: str
    flops_fwd: float          # total fwd flops for the whole global batch
    comm_bytes_k: float       # K: per-*replica-group* AllReduce payload bytes
    n_collectives: int        # collectives in this block's forward
    params: int               # parameters in this block
    act_saved: float          # bytes saved for bwd per chip (fine remat)


def _attn_flops(cfg: ArchConfig, tokens: int, seq: int, window=None) -> float:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    proj = 2.0 * tokens * d * (cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd
                               + cfg.num_heads * hd)
    ctx = min(window or seq, seq)
    attn = 2.0 * 2.0 * tokens * ctx * cfg.num_heads * hd
    return proj + attn


def ring_attn_costs(cfg: ArchConfig, blk: BlockCost, shape: ShapeConfig,
                    hp: TrainHParams, hw: HWConfig,
                    options: Sequence) -> NodeCosts:
    """Ring-attention (seq == degree) node costs of an attention block.

    The sequence axis — not the head axis — is sharded over the group:
    every chip holds the FULL attention weights (replicated; their grads
    psum at the shard_map boundary) and 1/n of the sequence.  The block's
    trailing collective disappears (q/k/v/o are all seq-local, ``wo`` is
    replicated), and in its place the KV shard circulates the ring, one
    hop per online-softmax step, each hop issued before the step's block
    compute so the transfer hides under it (kernels/ring_attention.py).
    The exposed time is therefore ``max(T_attn_block, T_kv_ring) + fill``
    — :func:`overlapped_time` with ``n - 1`` ring steps — which the ILP
    consumes as a per-(layer, degree) constant.

    The memory trade this buys (Eq. 6, ring column): saved tensors shrink
    to the seq-local shard — the ``(1 - 1/n)`` gathered-residual saving
    that makes ring win at long context — while the attention weights are
    charged replicated (×n the head-sharded cost; optimizer state still
    ZeRO-shards over dp).  2D degrees and n == 1 are not ring-capable and
    come back as ``inf`` so no consumer can pick them silently.

    Conventions mirror :func:`node_costs`: seconds per iteration (the
    per-slot costs scaled back by micro), memory bytes per chip.
    """
    split = max(hp.split, 1)
    out = NodeCosts([], [], [], [], [], [])
    tokens = shape.global_batch * shape.seq_len
    hd = cfg.resolved_head_dim
    kv_width = 2.0 * cfg.num_kv_heads * hd          # k + v rows per token
    for opt in options:
        dx, dy = _dxy(opt)
        n = dx * dy
        if dy > 1 or n <= 1:
            for lst in (out.d_f, out.c_f, out.d_b, out.c_b,
                        out.mem_s, out.mem_t, out.c_f_y, out.c_b_y):
                lst.append(float("inf"))
            continue
        dp = max(hw.n_chips // n, 1)
        t_chip = tokens / dp
        # same auto-accumulation floor as node_costs: batch rows only
        rows = max(int(shape.global_batch // dp), 1)
        micro = hp.microbatch if hp.microbatch > 0 else \
            min(max(1, int(math.ceil(t_chip / 8192.0))), rows)
        t_live = t_chip / micro
        t_loc = t_live / n                 # seq-local tokens per chip
        # full-width projections on 1/n of the tokens: same flops per chip
        # as head sharding, but the narrow matmul dim is the token axis
        eff = _mxu_eff(hw, cfg.num_heads * hd, int(t_loc // split))
        d_f = blk.flops_fwd / hw.n_chips / (hw.peak_flops * eff) \
            / split / micro
        # KV ring: each chip ships its (k, v) shard n-1 times per pass
        kv_hop = (t_loc / split) * kv_width * hw.bytes_act
        c_f = (n - 1) * (kv_hop / hw.ring_bw(n) + hw.comm_latency)
        d_f *= micro
        c_f *= micro
        recompute = 1.0 if hp.remat else 0.0
        d_b = d_f * (2.0 + recompute)
        # reverse ring rotates the bf16 KV tuple plus f32 (dk, dv) partials
        c_b = c_f * (hw.bytes_act + 4.0) / hw.bytes_act
        zdp = dp if hp.zero1 else 1
        mem_s = blk.params * (2.0 + 12.0 / zdp)
        mem_t = (t_loc * cfg.d_model * hw.bytes_act
                 * (1.5 if hp.fine_remat else 0.5)
                 + 2.0 * t_loc * kv_width * hw.bytes_act)  # 2 in-flight slots
        out.d_f.append(d_f)
        out.c_f.append(c_f)
        out.d_b.append(d_b)
        out.c_b.append(c_b)
        out.mem_s.append(mem_s)
        out.mem_t.append(mem_t)
        out.c_f_y.append(0.0)
        out.c_b_y.append(0.0)
    return out


def _block_costs(cfg: ArchConfig, kind: str, tokens: int, seq: int) -> List[BlockCost]:
    """Blocks for one layer; flops are global-batch totals."""
    d = cfg.d_model
    out = []
    if kind in (GLOBAL_ATTN, LOCAL_ATTN, CROSS_ATTN):
        window = cfg.window if kind == LOCAL_ATTN else None
        fl = _attn_flops(cfg, tokens, seq, window)
        p = d * cfg.resolved_head_dim * (2 * cfg.num_heads
                                         + 2 * cfg.num_kv_heads)
        out.append(BlockCost("attn", fl, tokens * d, 1, p, 2 * tokens * d))
        if kind == CROSS_ATTN:
            out.append(BlockCost("xattn", fl, tokens * d, 1, p,
                                 2 * tokens * d))
    elif kind == RGLRU:
        w = cfg.rglru_width or d
        fl = 2.0 * tokens * d * 3 * w + 10.0 * tokens * w
        out.append(BlockCost("rglru", fl, tokens * d, 1, 3 * d * w,
                             2 * tokens * d))
    elif kind == SSD:
        d_inner = cfg.ssm_expand * d
        nh = d_inner // cfg.ssm_headdim
        n = cfg.ssm_state
        fl = (2.0 * tokens * d * (3 * d_inner + 2 * n + nh)
              + 2.0 * tokens * d_inner * n * 4)
        out.append(BlockCost("ssd", fl, 0.0, 0, 3 * d * d_inner,
                             2 * tokens * d))
    if kind != SSD and cfg.d_ff:
        if cfg.moe is not None:
            fl = 2.0 * tokens * 3 * d * cfg.d_ff * cfg.moe.top_k
            p = cfg.moe.num_experts * 3 * d * cfg.d_ff
        else:
            fl = 2.0 * tokens * 3 * d * cfg.d_ff
            p = 3 * d * cfg.d_ff
        out.append(BlockCost("mlp", fl, tokens * d, 1, p, 2 * tokens * d))
    return out


def layer_blocks(cfg: ArchConfig, shape: ShapeConfig) -> List[List[BlockCost]]:
    """Per layer: its blocks (the planner's graph nodes), for all layers."""
    tokens = shape.global_batch * shape.seq_len
    pat = cfg.layer_pattern
    return [_block_costs(cfg, pat[i % len(pat)], tokens, shape.seq_len)
            for i in range(cfg.num_layers)]


@dataclass
class NodeCosts:
    """Per (block, degree-option): everything Eq. 3/6 needs (seconds/bytes
    per chip, per sub-batch).  ``c_f``/``c_b`` are the TOTAL collective
    seconds of the option; ``c_f_y``/``c_b_y`` hold the y-axis (inter-node)
    component so 2D-aware consumers can recover the x part as ``c - c_y``
    (both are 0 for 1D options)."""
    d_f: List[float]
    c_f: List[float]
    d_b: List[float]
    c_b: List[float]
    mem_s: List[float]
    mem_t: List[float]
    c_f_y: List[float] = None
    c_b_y: List[float] = None

    def __post_init__(self):
        if self.c_f_y is None:
            self.c_f_y = [0.0] * len(self.c_f)
        if self.c_b_y is None:
            self.c_b_y = [0.0] * len(self.c_b)


def node_costs(cfg: ArchConfig, blk: BlockCost, shape: ShapeConfig,
               hp: TrainHParams, hw: HWConfig,
               options: Sequence) -> NodeCosts:
    """Options may mix int (1D) and ``(dx, dy)`` (2D) degrees.

    1D comm: the block-output AllReduce over the full group, charged at the
    heterogeneity-aware ring bandwidth (a ring spanning nodes crawls at the
    inter-node hop — AMP's observation).  2D comm decomposes per axis: the
    x-ring AllReduces the 1/dy-sized output chunk intra-node; the y-axis
    pays the entry partial-sums plus the exit gather, modelled as a full-K
    AllReduce over dy across the inter-node links.
    """
    split = max(hp.split, 1)
    out = NodeCosts([], [], [], [], [], [])
    tokens = shape.global_batch * shape.seq_len
    for opt in options:
        dx, dy = _dxy(opt)
        n = dx * dy
        dp = max(hw.n_chips // n, 1)
        t_chip = tokens / dp                    # tokens on this chip / iter
        # gradient accumulation bounds live activations (auto ~8k tok/chip)
        # — but it splits BATCH ROWS only, so at long sequence the floor is
        # one full sample per microbatch (the regime where the seq axis /
        # ring attention is the only remaining activation-memory lever)
        rows = max(int(shape.global_batch // dp), 1)
        micro = hp.microbatch if hp.microbatch > 0 else \
            min(max(1, int(math.ceil(t_chip / 8192.0))), rows)
        t_live = t_chip / micro
        # width shards over dx only in 2D (the §5.6 arithmetic-density
        # caveat bites later — one of the 2D layout's selling points)
        width = max(cfg.d_ff, cfg.num_heads * cfg.resolved_head_dim) // dx
        eff = _mxu_eff(hw, width, int(t_live // split))
        d_f = blk.flops_fwd / hw.n_chips / (hw.peak_flops * eff) / split / micro
        # AllReduce of the block output: per-chip payload K(n) (per micro,
        # per sub-batch; the totals below are multiplied back by micro)
        k_bytes = (t_live / split) * (blk.comm_bytes_k / max(tokens, 1)) \
            * hw.bytes_act if blk.comm_bytes_k else 0.0
        ring_x = 2.0 * (dx - 1) / dx if dx > 1 else 0.0
        ring_y = 2.0 * (dy - 1) / dy if dy > 1 else 0.0
        # y rings hop between nodes whenever the whole group spills out of
        # one node; the x ring is judged on its own extent
        bw_y_eff = hw.ring_bw(n) if dy > 1 else hw.bw_y
        c_x = c_y = 0.0
        if blk.n_collectives:
            if dx > 1:
                c_x = (k_bytes / dy) * ring_x / hw.ring_bw(dx) \
                    + hw.comm_latency
            if dy > 1:
                c_y = k_bytes * ring_y / bw_y_eff + hw.comm_latency
        c_f = c_x + c_y
        # NOTE: d/c are per (micro x sub-batch) slot; Eq. 3 sums over slots.
        # Scale both by micro so node costs stay per-iteration.
        d_f *= micro
        c_f *= micro
        c_y *= micro
        # backward: 2x fwd compute (+1x recompute when remat)
        recompute = 1.0 if hp.remat else 0.0
        d_b = d_f * (2.0 + recompute)
        c_b = c_f  # grad-side AllReduce
        c_b_y = c_y
        if hp.remat and not hp.fine_remat:
            c_b += c_f  # coarse remat re-executes the forward collective
            c_b_y += c_y
        # memory per chip (Eq. 6): bf16 weights /n, f32 master+m+v ZeRO'd /dp
        zdp = dp if hp.zero1 else 1
        mem_s = blk.params * (2.0 / n + 12.0 / (n * zdp))
        # saved tensors live only for one microbatch; fine remat additionally
        # keeps each block's collective output (the §3.2 memory<->comm trade)
        mem_t = (t_live * cfg.d_model * hw.bytes_act
                 * (1.5 if hp.fine_remat else 0.5))
        out.d_f.append(d_f)
        out.c_f.append(c_f)
        out.d_b.append(d_b)
        out.c_b.append(c_b)
        out.mem_s.append(mem_s)
        out.mem_t.append(mem_t)
        out.c_f_y.append(c_y)
        out.c_b_y.append(c_b_y)
    return out


def edge_cost(cfg: ArchConfig, shape: ShapeConfig, hw: HWConfig,
              n_from, n_to, node_from: NodeCosts, i_from: int,
              i_to: int) -> float:
    """Eq. 4: resharding AllGather + destroyed overlap.

    Degrees may be 2D tuples; the batch resharding depends only on the
    *total* degree (extra-dp axes), so an x/y re-split at equal total is
    free here (weights are already laid out per layer)."""
    n_from, n_to = _dtot(n_from), _dtot(n_to)
    if n_from == n_to:
        return 0.0
    tokens = shape.global_batch * shape.seq_len
    d = cfg.d_model
    if n_to > n_from:
        # batch gathered over ratio r on the way in (forward AllGather)
        dp_to = max(hw.n_chips // n_to, 1)
        r = n_to // n_from
        gathered = tokens / dp_to * d * hw.bytes_act
        t_ag = gathered * (r - 1) / r / hw.link_bw + hw.comm_latency
    else:
        # degree decrease: free local slice fwd, AllGather in backward
        dp_from = max(hw.n_chips // n_from, 1)
        r = n_from // n_to
        gathered = tokens / dp_from * d * hw.bytes_act
        t_ag = gathered * (r - 1) / r / hw.link_bw + hw.comm_latency
    # destroyed overlap: the blocking gather serializes what the last
    # collective of `from` could have hidden (min term of Eq. 4)
    lost = min(node_from.c_f[i_from], node_from.d_f[i_to])
    return t_ag + lost


def estimate_iteration(cfg: ArchConfig, shape: ShapeConfig, hp: TrainHParams,
                       degrees: Sequence, hw: HWConfig = V5E,
                       options: Sequence = (2, 4, 8, 16),
                       stages: int = 1,
                       schedules: Optional[Sequence[str]] = None,
                       seqs: Optional[Sequence[int]] = None) -> Dict:
    """Evaluate f(s) (Eq. 3–5) for a concrete per-layer strategy (entries
    int or ``(dx, dy)``).  Also the cost model used by benchmarks/fig6
    (Spearman vs measured).  ``stages`` > 1: each chip holds only 1/stages
    of the layer stack (pipeline parallelism), scaling the per-layer
    WEIGHT/optimizer memory; saved activations do NOT shrink — a 1F1B
    stage keeps up to min(stages, n_micro) microbatches' residuals in
    flight, which cancels the layer reduction (see
    :func:`pipeline_mem_terms`).

    ``schedules``: optional per-layer schedule names (the executable-plan
    search space) — ``None`` runs every layer under ``hp.schedule``.  At
    a transition out of an oases/merak overlap run the pending collective
    is exposed (the next group's schedule gives it nothing to hide
    behind), which is exactly the conservatism the grouped execution
    shows; uniform inputs reproduce the single-schedule estimate
    bit-for-bit.

    ``seqs``: optional per-layer ring-attention seq shards (the plan's
    seq axis; 1 = head-sharded).  A ring layer's attention block swaps
    its AllReduce for the overlapped KV-ring term (ring_attn_costs) —
    exposed as ``max(T_attn, T_kv_ring) + fill`` regardless of the
    layer's schedule (the ring is its own schedule) — while its MLP
    block keeps the layer schedule.  Every seq-axis change between
    adjacent layers (and a trailing ring layer before the LM head)
    charges one residual regather: the exit AllGather (or its backward
    mirror) that the next group's layout cannot hide — the KV-ring
    exposure at schedule/seq transitions."""
    blocks = layer_blocks(cfg, shape)
    options = list(options)
    for d in degrees:                      # tolerate degrees ∉ options
        if _dkey(d) not in {_dkey(o) for o in options}:
            options.append(_dkey(d))
    opt_index = {_dkey(o): i for i, o in enumerate(options)}
    scheds = (list(schedules) if schedules is not None
              else [hp.schedule] * cfg.num_layers)
    lseqs = list(seqs) if seqs is not None else [1] * cfg.num_layers
    seq = []   # (NodeCosts, option_idx, degree, schedule, ring)
    for layer, degree, sched, sq in zip(blocks, degrees, scheds, lseqs):
        for blk in layer:
            ring = sq > 1 and blk.name in ("attn", "xattn")
            nc = (ring_attn_costs(cfg, blk, shape, hp, hw, options)
                  if ring else node_costs(cfg, blk, shape, hp, hw, options))
            seq.append((nc, opt_index[_dkey(degree)], degree, sched, ring))

    split = max(hp.split, 1)

    def pass_time(dkey, ckey, cykey):
        total = 0.0
        prev_c = 0.0
        for nc, j, n, sched, ring in seq:
            d = getattr(nc, dkey)[j]
            c = getattr(nc, ckey)[j]
            if ring:
                # KV ring overlaps block compute; the pending collective
                # of a preceding overlap run has nothing to hide behind
                total += prev_c
                total += overlapped_time(split * d, split * c,
                                         _dtot(n) - 1)
                prev_c = 0.0
            elif split > 1 and sched in ("oases", "merak"):
                # Eq. 3: sub-batch 0 compute overlaps previous comm; sub-batch
                # 1 compute overlaps own sub-batch-0 comm
                total += max(d, prev_c) + max(d, c)
                prev_c = c
            elif sched == "fused":
                # kernel-level collective matmul: comm is hidden under the
                # tile matmuls of the same block.  2D nodes compose per
                # axis: max(c_x, d) + max(c_y, fill) — the y collectives
                # hide under the x-ring's pipeline fill when thin enough.
                dx, dy = _dxy(n)
                c_y = getattr(nc, cykey)[j]
                total += prev_c   # leftover overlap-run cool-down exposed
                total += overlapped_time_2d(split * d, split * (c - c_y),
                                            split * c_y, dx - 1)
                prev_c = 0.0
            elif sched == "wang":
                # intra-op decomposition hides all but one chunk
                total += prev_c
                prev_c = 0.0
                total += split * d + c / max(hp.split * 2, 1) + c * 0.1
            else:
                total += prev_c
                total += split * d + split * c
                prev_c = 0.0
        total += prev_c   # cool-down: last collective exposed
        return total

    t_f = pass_time("d_f", "c_f", "c_f_y")
    t_b = pass_time("d_b", "c_b", "c_b_y")
    # edges
    t_e = 0.0
    for a in range(len(seq) - 1):
        n1, n2 = seq[a][2], seq[a + 1][2]
        if _dkey(n1) != _dkey(n2):
            t_e += edge_cost(cfg, shape, hw, n1, n2, seq[a][0], seq[a][1],
                             seq[a + 1][1]) * 2  # fwd + bwd reshard
    # seq-axis transitions: entering a ring group slices the residual
    # locally (free) but leaving one regathers it — and the backward pass
    # mirrors the pair, so each boundary nets one exposed AllGather of the
    # per-chip residual over the ring group (incl. the exit before the
    # LM head when the last layer rides the ring)
    tokens = shape.global_batch * shape.seq_len
    for a, sq in enumerate(lseqs + [1]):
        prev = lseqs[a - 1] if a else 1
        if sq == prev:
            continue
        grp = max(prev, sq)
        deg = _dtot(degrees[min(a, len(degrees) - 1)])
        dp_a = max(hw.n_chips // max(deg, 1), 1)
        res = tokens / dp_a * cfg.d_model * hw.bytes_act
        t_e += res * (grp - 1) / grp / hw.ring_bw(grp) + hw.comm_latency
    # memory (Eq. 6)
    s_scale, t_scale = pipeline_mem_scales(stages, hp.microbatch)
    mem = 0.0
    for nc, j, n, _sched, _ring in seq:
        mem += nc.mem_s[j] * s_scale + nc.mem_t[j] * t_scale
    vp = cfg.padded_vocab()
    last = max(_dtot(degrees[-1]), 1)
    head = vp * cfg.d_model * (2.0 / last) * (1 if cfg.tie_embeddings else 2)
    mem += head + head * 6.0    # embed/head + optimizer states
    m_r = 4.0 * shape.global_batch * shape.seq_len * cfg.d_model \
        * hw.bytes_act / (hw.n_chips / last)
    mem += m_r
    total = t_f + t_b + t_e
    return {"iter_s": total, "fwd_s": t_f, "bwd_s": t_b, "edge_s": t_e,
            "mem_bytes": mem, "fits": mem < hw.hbm_cap,
            "tokens_per_s": shape.global_batch * shape.seq_len / total}


# --------------------------------------------------------------------------
# pipeline-parallel composition (PP x TMP, Megatron/AMP-style)
# --------------------------------------------------------------------------
def pipeline_mem_scales(stages: int, n_micro: int) -> Tuple[float, float]:
    """Per-stage scaling of the Eq. 6 memory terms: weights/optimizer state
    (mem_s) shrink 1/stages, but live activations (mem_t) do not — a 1F1B
    stage holds up to min(stages, n_micro) in-flight microbatches, which
    cancels the 1/stages layer reduction.  Returns (s_scale, t_scale)."""
    s = max(stages, 1)
    in_flight = min(s, n_micro) if n_micro > 0 else s
    return 1.0 / s, in_flight / s


def stage_hw(hw: HWConfig, pp: int) -> HWConfig:
    """The hardware slice one pipeline stage owns: n_chips/pp chips with
    the same node topology — a stage that fits inside one node keeps every
    TMP ring on the fast intra-node lanes, which is the whole point of
    placing PP across boxes on commodity clusters."""
    import dataclasses
    return dataclasses.replace(hw, n_chips=max(hw.n_chips // pp, 1))


def p2p_hop_seconds(cfg: ArchConfig, shape: ShapeConfig, hw: HWConfig,
                    pp: int, n_micro: int, degree=1) -> float:
    """One microbatch's activation transfer across one stage boundary.

    Activations are replicated over the stage's TMP group and sharded over
    its data axes, so each chip ships its dp-shard of the microbatch's
    [mb, s, d] tensor to its peer in the next stage.  The hop rides the
    inter-node links when stages occupy whole nodes, the intra-node lanes
    when several stages share one."""
    chips = max(hw.n_chips // max(pp, 1), 1)
    ns = hw.node_size or hw.n_chips
    bw = hw.bw_y if chips >= ns else hw.bw_x
    dp = max(chips // max(_dtot(degree), 1), 1)
    mb_tokens = shape.global_batch * shape.seq_len / max(n_micro, 1)
    return (mb_tokens / dp) * cfg.d_model * hw.bytes_act / bw \
        + hw.comm_latency


# --------------------------------------------------------------------------
# serving latency model (per-token decode, batch = concurrent slots)
# --------------------------------------------------------------------------
def _gather_eff(page_size: int) -> float:
    """HBM efficiency of reading a KV cache through a block table: each
    page is a separate (strided) DMA paying a fixed ~2-row startup against
    ``page_size`` contiguous rows.  0 = dense layout (no discount)."""
    if page_size <= 0:
        return 1.0
    return page_size / (page_size + 2.0)


def _decode_layer_time(cfg: ArchConfig, kind: str, hw: HWConfig, degree,
                       rows: int, kv_len: int, schedule: str, *,
                       q_tokens: int = 1, page_size: int = 0) -> float:
    """One layer's decode-step seconds for ``rows`` slot rows at KV context
    ``kv_len`` under per-stage degree ``(dx, dy)``.

    Decode inverts the training regime: matmuls are memory-bound (the
    whole weight matrix streams from HBM for a handful of rows) and the
    collectives are LATENCY-bound (the payload is ``rows * d_model`` bytes
    — kilobytes, not megabytes).  A fused ring still hides the *bandwidth*
    component under the tile matmuls, but the per-hop latency floor is
    serial and has nothing to hide behind at single-token shapes — the
    overlap term saturates, which is what pushes the latency planner off
    wide rings (toward 2D splits or pipeline stages) on commodity links.

    ``q_tokens > 1`` models a speculative *verify* forward: flops and
    collective payloads scale with the extra tokens per row but the weight
    stream and the KV read do not, and the per-hop latency floor is paid
    ONCE — that amortization is the entire speculative-decoding win.
    ``page_size`` applies the paged-cache gather discount to the KV read.
    """
    dx, dy = _dxy(degree)
    n = dx * dy
    total = 0.0
    for blk in _block_costs(cfg, kind, rows * q_tokens, kv_len):
        w_bytes = blk.params * hw.bytes_act / n
        kv_bytes = 0.0
        if blk.name in ("attn", "xattn"):
            kv_bytes = (2.0 * rows * kv_len * cfg.num_kv_heads
                        * cfg.resolved_head_dim * hw.bytes_act / dx
                        / _gather_eff(page_size))
        width = max(cfg.d_ff, cfg.num_heads * cfg.resolved_head_dim) // dx
        eff = _mxu_eff(hw, width, rows * q_tokens)
        d = max((w_bytes + kv_bytes) / hw.hbm_bw,
                blk.flops_fwd / n / (hw.peak_flops * eff))
        if not blk.n_collectives:
            total += d
            continue
        k_bytes = rows * q_tokens * cfg.d_model * hw.bytes_act
        c_bw = c_lat = 0.0
        if dx > 1:
            c_bw += (k_bytes / dy) * 2.0 * (dx - 1) / dx / hw.ring_bw(dx)
            c_lat += hw.collective_latency(dx)
        if dy > 1:
            c_bw += k_bytes * 2.0 * (dy - 1) / dy / hw.ring_bw(n)
            # the y hops cross nodes whenever the whole group spills out
            # of one (the 2D layout's intended placement)
            ns = hw.node_size or hw.n_chips
            lat_hop = hw.lat_y if n > ns else hw.comm_latency
            c_lat += 2.0 * (dy - 1) * lat_hop
        if schedule == "fused":
            total += max(d, c_bw) + c_lat
        else:
            total += d + c_bw + c_lat
    return total


def _decode_head_time(cfg: ArchConfig, hw: HWConfig, rows: int,
                      n_tmp: int) -> float:
    """LM-head matmul + greedy top-1 all-gather, paid once per engine
    step outside the layer stack.  The embed/head are vocab-sharded over
    the TMP group only and REPLICATED over ``pipe`` (models/params.py) —
    every stage computes the full local head after the broadcast — so the
    sharding divisor is the per-stage group ``n_tmp``, not n_tmp * pp."""
    vp = cfg.padded_vocab()
    w_bytes = vp * cfg.d_model * hw.bytes_act / max(n_tmp, 1)
    flops = 2.0 * rows * cfg.d_model * vp / max(n_tmp, 1)
    t = max(w_bytes / hw.hbm_bw, flops / (hw.peak_flops * hw.mxu_base_eff))
    # greedy argmax all-gather over the TMP group (one phase)
    t += hw.collective_latency(n_tmp) / 2.0
    return t


def decode_step_time(cfg: ArchConfig, shape: ShapeConfig, hp: TrainHParams,
                     hw: HWConfig, degree=1, pp: int = 1, *,
                     virtual_stages: int = 1, n_micro: int = 0,
                     page_size: int = 0, spec_k: int = 0,
                     spec_accept: float = 0.8,
                     draft: Optional[ArchConfig] = None) -> Dict:
    """Per-engine-step latency of sharded decode on a ``(dx, dy, pp)``
    serving mesh — one token for every one of ``shape.global_batch``
    concurrent slots at KV context ``shape.seq_len``.

    ``degree`` is the PER-STAGE TMP degree (int or ``(dx, dy)``); ``pp``
    stages each own ``num_layers / pp`` of the stack on ``n_chips / pp``
    chips.  Under PP the slot batch streams through the stages as
    ``n_micro`` micro-groups (``core/pipeline.decode_stream``):
    ``ticks = n_micro + pp*v - 1`` and every tick runs one stage's layers
    on one micro-group — fewer layers per tick, but the stage weights
    re-stream from HBM once per micro-group, which is the latency/
    throughput trade the planner arbitrates.

    ``page_size > 0`` applies the paged-KV gather discount to the cache
    read.  ``spec_k > 0`` models a speculative round instead of a single
    step: ``spec_k + 1`` forwards of the (replicated, dense-cache)
    ``draft`` model plus one ``q_tokens = spec_k + 1`` verify forward of
    the target, emitting ``E = (1 - a^(k+1)) / (1 - a)`` expected tokens
    per slot (``a = spec_accept``).  The reported ``step_s`` is the
    per-emitted-token equivalent ``round_s / E``, directly comparable to
    the undrafted step — speculative wins exactly where the target step
    is dominated by the per-layer collective latency floor (commodity
    links), because the verify pays that floor once per ``E`` tokens
    while the draft, being replicated, pays none at all.
    """
    batch = max(shape.global_batch, 1)
    kv_len = shape.seq_len
    pat = cfg.layer_pattern
    v = max(virtual_stages, 1)
    dx, dy = _dxy(degree)
    n_s = dx * dy
    if spec_k > 0:
        if draft is None:
            raise ValueError(
                "spec_k > 0 needs a draft ArchConfig — the round time is "
                "(k+1) draft forwards + one verify forward")
        if pp > 1:
            raise ValueError(
                "speculative decoding does not compose with pipeline "
                "stages (lm.build_verify rejects 'pipe' meshes) — model "
                "spec_k on pp=1 candidates only")

    if pp <= 1:
        layers = sum(_decode_layer_time(cfg, pat[i % len(pat)], hw, degree,
                                        batch, kv_len, hp.schedule,
                                        page_size=page_size)
                     for i in range(cfg.num_layers))
        total = layers + _decode_head_time(cfg, hw, batch, n_s)
        micro, t_hop = 1, 0.0
    else:
        # the execution path's resolver, so the planner never reports an
        # n_micro the engine would refuse (explicit non-divisors raise
        # there too)
        from repro_torch.core.pipeline import resolve_decode_micro
        micro = resolve_decode_micro(batch, pp, v, n_micro)
        mb = batch // micro
        per_tick = sum(
            _decode_layer_time(cfg, pat[i % len(pat)], hw, degree, mb,
                               kv_len, hp.schedule, page_size=page_size)
            for i in range(cfg.num_layers)) / pp
        chips = max(hw.n_chips // pp, 1)
        ns = hw.node_size or hw.n_chips
        spans = chips >= ns            # stages own whole nodes
        bw = hw.bw_y if spans else hw.bw_x
        lat = hw.lat_y if spans else hw.comm_latency
        t_hop = mb * cfg.d_model * hw.bytes_act / bw + lat
        ticks = micro + pp * v - 1
        total = ticks * (per_tick + t_hop)
        # broadcast of the last stage's hidden state (psum over pipe)
        total += (batch * cfg.d_model * hw.bytes_act * 2.0 * (pp - 1) / pp
                  / bw + 2 * (pp - 1) * lat)
        total += _decode_head_time(cfg, hw, batch, n_s)

    e_tokens = 1.0
    if spec_k > 0:
        # one round: k+1 draft forwards (replicated — degree 1, dense
        # cache, no collectives) + one (k+1)-token verify of the target
        dpat = draft.layer_pattern
        draft_s = sum(
            _decode_layer_time(draft, dpat[i % len(dpat)], hw, 1, batch,
                               kv_len, hp.schedule)
            for i in range(draft.num_layers))
        draft_s += _decode_head_time(draft, hw, batch, 1)
        verify_s = sum(
            _decode_layer_time(cfg, pat[i % len(pat)], hw, degree, batch,
                               kv_len, hp.schedule, q_tokens=spec_k + 1,
                               page_size=page_size)
            for i in range(cfg.num_layers))
        verify_s += _decode_head_time(cfg, hw, batch * (spec_k + 1), n_s)
        a = min(max(spec_accept, 0.0), 0.999)
        e_tokens = (1.0 - a ** (spec_k + 1)) / (1.0 - a)
        round_s = (spec_k + 1) * draft_s + verify_s
        total = round_s / e_tokens

    # memory: bf16 weights /(pp * n_s) per chip + the KV cache of the
    # stage's layers, head-sharded over dx
    params = sum(b.params for i in range(cfg.num_layers)
                 for b in _block_costs(cfg, pat[i % len(pat)], 1, kv_len))
    mem = params * hw.bytes_act / (pp * n_s)
    # head/embed replicated over pipe: sharded by the TMP group only
    mem += cfg.padded_vocab() * cfg.d_model * hw.bytes_act / max(n_s, 1)
    kv_layers = sum(1 for i in range(cfg.num_layers)
                    if pat[i % len(pat)] in (GLOBAL_ATTN, LOCAL_ATTN,
                                             CROSS_ATTN))
    mem += (kv_layers / pp) * (2.0 * batch * kv_len * cfg.num_kv_heads
                               * cfg.resolved_head_dim * hw.bytes_act / dx)
    if spec_k > 0:
        # replicated draft weights + its dense KV cache on every chip
        dpat = draft.layer_pattern
        dparams = sum(b.params for i in range(draft.num_layers)
                      for b in _block_costs(draft, dpat[i % len(dpat)], 1,
                                            kv_len))
        mem += dparams * hw.bytes_act
        mem += (draft.padded_vocab() * draft.d_model * hw.bytes_act
                + draft.num_layers * 2.0 * batch * kv_len
                * draft.num_kv_heads * draft.resolved_head_dim
                * hw.bytes_act)
    # with spec, step_s is already round_s / E, so batch / step_s IS the
    # emitted-token throughput
    return {"step_s": total, "tok_per_s": batch / total,
            "n_micro": micro, "t_hop": t_hop, "e_tokens": e_tokens,
            "mem_bytes": mem, "fits": mem < hw.hbm_cap}


def pipeline_time(t_tmp: float, pp: int, n_micro: int,
                  virtual_stages: int = 1,
                  t_hop: float = 0.0) -> Tuple[float, float, float]:
    """Compose a full-stack TMP iteration time (modeled on one stage's
    chips — :func:`stage_hw`) into the interleaved-1F1B estimate.

    Each stage is busy ``t_tmp / pp`` per iteration; the fill/drain bubble
    adds ``(pp-1)/v`` microbatch slots; P2P transfers expose the fill/drain
    hops (fwd + bwd) on the critical path plus whatever part of each
    steady-state hop the next microbatch's compute cannot hide.  Returns
    ``(total_s, bubble_fraction, p2p_s)``; degenerates to
    ``(t_tmp, 0, 0)`` at pp == 1.
    """
    if pp <= 1:
        return t_tmp, 0.0, 0.0
    m = max(n_micro, 1)
    v = max(virtual_stages, 1)
    t_mb = t_tmp / (pp * m)              # per-stage per-microbatch slot
    bubble = (pp - 1) * t_mb / v
    p2p = 2.0 * (pp - 1) * t_hop \
        + 2.0 * max(m - 1, 0) * max(t_hop - t_mb, 0.0)
    total = t_tmp / pp + bubble + p2p
    return total, bubble / total if total else 0.0, p2p
