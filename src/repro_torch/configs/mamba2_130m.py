"""mamba2-130m — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import SSD, ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                           # attention-free, no separate FFN
    vocab_size=50280,
    layer_pattern=(SSD,),
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
