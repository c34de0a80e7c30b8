from repro_torch.configs.base import HazyConfig, ModelConfig, ShapeConfig, SHAPES, SMOKE_SHAPES
from repro_torch.configs.registry import ARCHS, cells, get_config, smoke_config, LONG_CTX_ARCHS
