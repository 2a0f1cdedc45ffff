"""moonshot-v1-16b-a3b (Moonlight) — MoE 64 experts top-6, expert-parallel
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig, GLOBAL_ATTN, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,                  # MHA
    d_ff=1408,                        # per-expert FFN width
    vocab_size=163840,
    head_dim=128,
    layer_pattern=(GLOBAL_ATTN,),
    moe=MoEConfig(num_experts=64, top_k=6, sharding="ep"),
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
