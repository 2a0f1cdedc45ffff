"""granite-moe-3b-a800m — 40 experts, top 8, expert d_ff sharded under
tensor parallelism ('tmp': 40 % 16 != 0 rules out expert parallelism
over a 16-way model axis) [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.configs.base import GLOBAL_ATTN, ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,                         # per-expert FFN width
    vocab_size=49155,
    head_dim=64,
    layer_pattern=(GLOBAL_ATTN,),
    moe=MoEConfig(num_experts=40, top_k=8, sharding="tmp"),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
