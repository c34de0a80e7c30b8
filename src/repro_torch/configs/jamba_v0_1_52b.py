"""Exact assigned config for jamba-v0.1-52b (see registry for provenance)."""
from repro_torch.configs.registry import get_config, smoke_config

CONFIG = get_config("jamba-v0.1-52b")
SMOKE = smoke_config("jamba-v0.1-52b")
