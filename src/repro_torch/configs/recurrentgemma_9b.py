"""recurrentgemma-9b — Griffin-style hybrid: RG-LRU + local attn, 1 attn per
3-layer block [arXiv:2402.19427; unverified]."""
from repro_torch.configs.base import LOCAL_ATTN, RGLRU, ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,                    # 12 full (rglru, rglru, local) blocks + 2
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,                   # MQA on the local-attn layers
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    window=2048,
    rglru_width=4096,
    tie_embeddings=True,
    source="arXiv:2402.19427; unverified",
)
