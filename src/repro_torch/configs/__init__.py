"""The ten LLM architecture configs, copied from ``repro.configs``."""
from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K,
                                      SHAPES, TRAIN_4K, ModelConfig,
                                      ShapeConfig, reduced, shape_applicable)
from repro_torch.configs.registry import ARCHS, all_cells, get_arch, get_shape

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "TRAIN_4K", "PREFILL_32K",
           "DECODE_32K", "LONG_500K", "reduced", "shape_applicable",
           "ARCHS", "get_arch", "get_shape", "all_cells"]
