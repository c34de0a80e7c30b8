"""Exact assigned config for granite-3-2b (see registry for provenance)."""
from repro_torch.configs.registry import get_config, smoke_config

CONFIG = get_config("granite-3-2b")
SMOKE = smoke_config("granite-3-2b")
