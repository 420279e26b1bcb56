from repro_torch.configs.base import (ArchConfig, get_config, list_archs,
                                      register)
from repro_torch.configs.shapes import (SHAPES, InputShape, get_shape,
                                        legal_shapes)

__all__ = [
    "ArchConfig", "get_config", "list_archs", "register",
    "SHAPES", "InputShape", "get_shape", "legal_shapes",
]
