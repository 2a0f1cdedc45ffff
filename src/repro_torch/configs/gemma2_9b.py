"""gemma2-9b — local/global alternating attention + logit softcaps
[arXiv:2408.00118; hf]."""
from repro_torch.configs.base import ArchConfig, GLOBAL_ATTN, LOCAL_ATTN

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=(LOCAL_ATTN, GLOBAL_ATTN),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
    post_norms=True,
    source="arXiv:2408.00118; hf",
)
