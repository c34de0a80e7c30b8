"""Exact assigned config for whisper-tiny (see registry for provenance)."""
from repro_torch.configs.registry import get_config, smoke_config

CONFIG = get_config("whisper-tiny")
SMOKE = smoke_config("whisper-tiny")
