"""Exact assigned config for tinyllama-1.1b (see registry for provenance)."""
from repro_torch.configs.registry import get_config, smoke_config

CONFIG = get_config("tinyllama-1.1b")
SMOKE = smoke_config("tinyllama-1.1b")
