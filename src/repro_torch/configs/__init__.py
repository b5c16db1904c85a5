"""Configuration data the port needs (a copy, never an import of repro)."""
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                      ModelConfig, MoEConfig, SSMConfig,
                                      get_config, list_archs, reduced,
                                      scale_width)
