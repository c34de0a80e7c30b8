"""Exact assigned config for rwkv6-3b (see registry for provenance)."""
from repro_torch.configs.registry import get_config, smoke_config

CONFIG = get_config("rwkv6-3b")
SMOKE = smoke_config("rwkv6-3b")
