"""Architecture registry of the port: ``get_config(name)`` and
``ASSIGNED``, the ten assigned architectures of
``repro.configs.registry`` (the port trains each at tp=1; the dense
global-attention ones at any degree), and the paper's GPT models."""
from __future__ import annotations

from repro_torch.configs import (gemma2_9b, gpt_oases, granite_8b,
                                 granite_moe_3b, internlm2_1_8b,
                                 internlm2_20b, llama32_vision_11b,
                                 mamba2_130m, moonshot_16b_a3b,
                                 recurrentgemma_9b, whisper_small)
from repro_torch.configs.base import ArchConfig

_ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        internlm2_20b,
        granite_8b,
        internlm2_1_8b,
        gemma2_9b,
        recurrentgemma_9b,
        llama32_vision_11b,
        whisper_small,
        moonshot_16b_a3b,
        granite_moe_3b,
        mamba2_130m,
    )
}
for _cfg, *_rest in {**gpt_oases.PAPER_TABLE4,
                     **gpt_oases.PAPER_TABLE5}.values():
    _ARCHS[_cfg.name] = _cfg
for _cfg in gpt_oases.SERVING_MODELS.values():
    _ARCHS[_cfg.name] = _cfg

ASSIGNED = [
    "internlm2-20b",
    "granite-8b",
    "internlm2-1.8b",
    "gemma2-9b",
    "recurrentgemma-9b",
    "llama-3.2-vision-11b",
    "whisper-small",
    "moonshot-v1-16b-a3b",
    "granite-moe-3b-a800m",
    "mamba2-130m",
]


def get_config(name: str) -> ArchConfig:
    try:
        return _ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}") from None
