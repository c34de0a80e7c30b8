"""Exact assigned config for llama4-scout-17b-a16e (see registry for provenance)."""
from repro_torch.configs.registry import get_config, smoke_config

CONFIG = get_config("llama4-scout-17b-a16e")
SMOKE = smoke_config("llama4-scout-17b-a16e")
