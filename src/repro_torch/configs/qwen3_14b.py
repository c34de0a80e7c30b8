"""Exact assigned config for qwen3-14b (see registry for provenance)."""
from repro_torch.configs.registry import get_config, smoke_config

CONFIG = get_config("qwen3-14b")
SMOKE = smoke_config("qwen3-14b")
