"""Exact assigned config for pixtral-12b (see registry for provenance)."""
from repro_torch.configs.registry import get_config, smoke_config

CONFIG = get_config("pixtral-12b")
SMOKE = smoke_config("pixtral-12b")
