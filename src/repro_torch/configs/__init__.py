"""Architecture configs, as in ``repro.configs``."""
from repro_torch.configs.base import (SHAPE_BY_NAME, SHAPES, ArchConfig,
                                      ShapeCell, cell_skip_reason, cells_for)
from repro_torch.configs.registry import (ARCH_IDS, demo_lm, get_config,
                                          get_reduced)
