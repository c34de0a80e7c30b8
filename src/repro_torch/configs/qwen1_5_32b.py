"""Exact assigned config for qwen1.5-32b (see registry for provenance)."""
from repro_torch.configs.registry import get_config, smoke_config

CONFIG = get_config("qwen1.5-32b")
SMOKE = smoke_config("qwen1.5-32b")
