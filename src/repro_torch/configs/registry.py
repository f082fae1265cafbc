"""Architecture registry: maps the exact assignment ids to configs."""
from __future__ import annotations

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      reduced, shape_applicable)
from repro_torch.configs.command_r_35b import CONFIG as _CR
from repro_torch.configs.command_r_plus_104b import CONFIG as _CRP
from repro_torch.configs.falcon_mamba_7b import CONFIG as _FM
from repro_torch.configs.internlm2_20b import CONFIG as _ILM
from repro_torch.configs.llama32_vision_11b import CONFIG as _LV
from repro_torch.configs.mixtral_8x22b import CONFIG as _MIX
from repro_torch.configs.phi35_moe_42b import CONFIG as _PHI
from repro_torch.configs.qwen15_05b import CONFIG as _QW
from repro_torch.configs.recurrentgemma_2b import CONFIG as _RG
from repro_torch.configs.whisper_large_v3 import CONFIG as _WH

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (_PHI, _MIX, _CRP, _CR, _ILM, _QW, _RG, _WH, _LV, _FM)
}

# The paper's own BNN workloads are in repro.core.workloads (BinaryNet /
# AlexNet conv stacks for the ASIC model); they are not LM configs.


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells():
    """Yield every (arch, shape, applicable, reason) assignment cell."""
    for aname, cfg in ARCHS.items():
        for sname, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            yield aname, sname, ok, why


__all__ = ["ARCHS", "SHAPES", "get_arch", "get_shape", "all_cells",
           "reduced", "shape_applicable", "ModelConfig", "ShapeConfig"]
