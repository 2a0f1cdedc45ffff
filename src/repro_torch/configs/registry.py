"""Architecture registry of the port: ``get_config(name)``.

Holds the configurations the port can run so far (dense all-global-
attention models, the MoE ``granite-moe-3b-a800m``, the Mamba2
``mamba2-130m`` and the RG-LRU hybrid ``recurrentgemma-9b``); the other
families of ``repro.configs.registry`` arrive with their layer kinds."""
from __future__ import annotations

from repro_torch.configs import (gpt_oases, granite_moe_3b, internlm2_1_8b,
                                 mamba2_130m, recurrentgemma_9b)
from repro_torch.configs.base import ArchConfig

_ARCHS = {c.name: c for c in (internlm2_1_8b.CONFIG, granite_moe_3b.CONFIG,
                              mamba2_130m.CONFIG, recurrentgemma_9b.CONFIG)}
for _cfg, *_rest in {**gpt_oases.PAPER_TABLE4,
                     **gpt_oases.PAPER_TABLE5}.values():
    _ARCHS[_cfg.name] = _cfg
for _cfg in gpt_oases.SERVING_MODELS.values():
    _ARCHS[_cfg.name] = _cfg


def get_config(name: str) -> ArchConfig:
    try:
        return _ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}") from None
