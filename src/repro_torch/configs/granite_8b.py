"""granite-8b — llama-arch dense GQA code model [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ArchConfig, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    head_dim=128,
    layer_pattern=(GLOBAL_ATTN,),
    rope_theta=10_000_000.0,
    source="arXiv:2405.04324; hf",
)
