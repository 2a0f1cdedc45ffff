"""whisper-small — encoder-decoder; conv frontend is a STUB (precomputed
frame embeddings) [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ArchConfig, CROSS_ATTN

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,                    # decoder layers (every layer cross-attends)
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,                  # MHA
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    layer_pattern=(CROSS_ATTN,),
    context_len=1500,                 # 30 s of audio at 50 Hz after conv stub
    context_dim=768,
    source="arXiv:2212.04356; unverified",
)
