"""Exact assigned config for dbrx-132b (see registry for provenance)."""
from repro_torch.configs.registry import get_config, smoke_config

CONFIG = get_config("dbrx-132b")
SMOKE = smoke_config("dbrx-132b")
