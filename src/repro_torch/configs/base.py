"""Architecture, shape and training configuration: the port's own copies
of ``repro.configs.base.ArchConfig`` (every field; the model path runs
dense global- and local-attention models with post-norms and softcaps,
MoE, the Mamba2 SSD mixer, the Griffin hybrid of RG-LRU and local
attention, cross attention to a stub context and whisper's encoder), of
``ShapeConfig`` and the named shapes, and
of the ``TrainHParams`` fields its training path and the planner read.
Field names, defaults and derived values match the JAX package's, so a
config means the same model in both."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer kinds used in ``layer_pattern`` (repeating cycle over the stack).
GLOBAL_ATTN = "global"      # full causal self attention
LOCAL_ATTN = "local"        # sliding-window causal self attention
RGLRU = "rglru"             # RG-LRU recurrent block (Griffin / RecurrentGemma)
SSD = "ssd"                 # Mamba2 state-space-duality mixer
CROSS_ATTN = "cross"        # self-attn + cross-attn to encoder/vision states


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # 'ep'  -> experts sharded over the model axis (needs E % tp == 0)
    # 'tmp' -> all experts on every rank, expert d_ff sharded
    sharding: str = "ep"
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | hybrid | vlm | audio | moe | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    layer_pattern: Tuple[str, ...] = (GLOBAL_ATTN,)
    window: int = 4096               # local attention window
    attn_softcap: float = 0.0        # attention logit softcap (0 = off)
    final_softcap: float = 0.0       # final logit softcap (0 = off)
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    # SSM (mamba2) params
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    # RG-LRU params
    rglru_width: int = 0             # 0 -> d_model
    # encoder/decoder (whisper) — decoder uses num_layers
    encoder_layers: int = 0
    # cross-attn context (vision/audio frontend stub)
    context_len: int = 0             # number of frontend embedding tokens
    context_dim: int = 0             # frontend embedding dim (0 -> d_model)
    tie_embeddings: bool = False
    post_norms: bool = False         # sandwich norms
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def padded_vocab(self, multiple: int = 256) -> int:
        return _round_up(self.vocab_size, multiple)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the values of the JAX
        package's ``ArchConfig.reduced`` for these fields)."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2 * len(self.layer_pattern)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            window=64,
            context_len=min(self.context_len, 16) if self.context_len else 0,
            context_dim=64 if self.context_dim else 0,
            encoder_layers=min(self.encoder_layers, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32,
            rglru_width=128 if self.rglru_width else 0,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(self.moe, num_experts=4, top_k=2)
            kw["d_ff"] = 64
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class TrainHParams:
    """The port's copy of ``repro.configs.base.TrainHParams``: the fields
    its tensor-parallel training path honours (1-D and 2-D) and the ones
    the planner and plans read, with JAX's defaults.  ``microbatch`` 0
    means auto here (JAX: no accumulation).  What the port does not run
    yet raises at construction: gradient compression (A4) and virtual
    pipeline stages (A8); ``zero1`` has no effect without data
    parallelism (A4), which is what both values mean at one data rank."""
    schedule: str = "oases"          # megatron | wang | merak | oases | fused
    remat: bool = True
    fine_remat: bool = True          # §3.2 fine-grained recomputation
    use_planner: bool = False        # read by nothing; kept for JAX parity
    tmp_layout: str = "auto"         # auto | 1d | 2d
    split: int = 2                   # sub-batch split factor (paper: 2)
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    zero1: bool = True
    grad_compress: bool = False
    microbatch: int = 0               # 0 = auto; > 1 = gradient accumulation
    virtual_stages: int = 1
    loss_chunk: int = 512             # tokens per chunk of the cross entropy
    seq_parallel: bool = False       # Megatron-SP: AG/RS instead of AR
    seq_shard: int = 1               # ring-attention sequence shards (1 = off)

    def __post_init__(self):
        # an unknown schedule, layout or shard factor is rejected at
        # construction, as in JAX
        from repro_torch.core.plan import TMP_LAYOUTS, validate_schedule
        validate_schedule(self.schedule)
        if self.tmp_layout not in TMP_LAYOUTS:
            raise ValueError(
                f"unknown tmp_layout {self.tmp_layout!r}: valid layouts "
                f"are {', '.join(TMP_LAYOUTS)}")
        s = self.seq_shard
        if not isinstance(s, int) or isinstance(s, bool) or s < 1 \
                or s & (s - 1):
            raise ValueError(
                f"bad seq_shard {s!r}: ring-attention sequence shards "
                f"must be a positive power-of-two int (1 = off)")
        for what, on, item in (
                ("gradient compression (grad_compress=True)",
                 self.grad_compress, "A4"),
                (f"virtual pipeline stages (virtual_stages="
                 f"{self.virtual_stages})", self.virtual_stages != 1, "A8")):
            if on:
                raise NotImplementedError(
                    f"the PyTorch port does not run {what} yet "
                    f"(ROADMAP.md {item})")
