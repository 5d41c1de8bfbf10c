"""Registry of assigned architectures (``--arch <id>``) + shapes."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ArchConfig, MoEConfig, SSMConfig, HybridConfig, CrossAttnConfig, EncDecConfig,
    ShapeConfig, SHAPES, SMOKE_SHAPE, cell_supported, smoke_reduce,
)

_MODULES = {
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "llama-3.2-vision-90b": "repro_torch.configs.llama_3_2_vision_90b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells():
    """Yield every assigned (arch, shape, supported, skip_reason) cell — 40 total."""
    for aid in ARCH_IDS:
        arch = get_arch(aid)
        for shape in SHAPES.values():
            ok, why = cell_supported(arch, shape)
            yield arch, shape, ok, why


__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "HybridConfig", "CrossAttnConfig",
    "EncDecConfig", "ShapeConfig", "SHAPES", "SMOKE_SHAPE", "ARCH_IDS",
    "get_arch", "get_shape", "all_cells", "cell_supported", "smoke_reduce",
]
