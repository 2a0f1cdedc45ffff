"""The paper's dense GPT family (Appendix B, Tables 4-5) and the serving
fixtures, as in ``repro.configs.gpt_oases``."""
from repro_torch.configs.base import ArchConfig, GLOBAL_ATTN, ShapeConfig


def _gpt(name, hidden, layers, heads):
    return ArchConfig(
        name=name,
        family="dense",
        num_layers=layers,
        d_model=hidden,
        num_heads=heads,
        num_kv_heads=heads,           # paper models are MHA
        d_ff=4 * hidden,
        vocab_size=50304,             # GPT-2 vocab padded
        layer_pattern=(GLOBAL_ATTN,),
        source="Oases paper, Appendix B Table 4/5",
    )


# Table 4: (hidden, layers, heads, TMP, DP, global batch)
PAPER_TABLE4 = {
    "gpt-h1024": (_gpt("gpt-h1024", 1024, 24, 16), 2, 16, 256),
    "gpt-h2048": (_gpt("gpt-h2048", 2048, 24, 32), 4, 8, 128),
    "gpt-h3072": (_gpt("gpt-h3072", 3072, 24, 48), 4, 8, 32),
    "gpt-h4096": (_gpt("gpt-h4096", 4096, 16, 64), 4, 8, 32),
    "gpt-h6144": (_gpt("gpt-h6144", 6144, 16, 96), 8, 4, 8),
    "gpt-h8192": (_gpt("gpt-h8192", 8192, 8, 128), 8, 4, 8),
    "gpt-h12288": (_gpt("gpt-h12288", 12288, 4, 192), 8, 4, 8),
}

# Table 5: complete-model PMP experiments.
PAPER_TABLE5 = {
    "gpt-18.4b": (_gpt("gpt-18.4b", 6144, 40, 48), 4, 4, 2),   # (cfg, PMP, TMP, DP)
    "gpt-39.1b": (_gpt("gpt-39.1b", 8192, 48, 64), 4, 8, 1),
}

# Serving fixtures: the deep decode target and its draft model.
SERVING_MODELS = {
    "gpt-serve-h4096": _gpt("gpt-serve-h4096", 4096, 64, 32),
    "gpt-draft-h2048": _gpt("gpt-draft-h2048", 2048, 12, 16),
}

PAPER_SEQ_LEN = 1024


def paper_shape(global_batch: int) -> ShapeConfig:
    return ShapeConfig(f"paper_b{global_batch}", PAPER_SEQ_LEN, global_batch, "train")
