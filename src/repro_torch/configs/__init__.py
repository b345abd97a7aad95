"""Architecture registry (``input_specs`` waits for the train slice)."""

from .base import (ARCH_IDS, SHAPES, ModelConfig, ShapeConfig, all_archs,
                   get_config, register, scale_config)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "all_archs",
           "get_config", "register", "scale_config"]
