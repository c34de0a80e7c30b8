"""Serving steps of the port (prefill and greedy decode) and their state,
the counterpart of the serving half of `repro/models/steps.py`. The
training step, the loss, the optimizer state and the abstract input specs
wait for the training slice (ROADMAP.md Queue 1 item 10).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.params import init_params
from repro_torch.models.transformer import ModelDef


def make_prefill_step(mdl: ModelDef):
    """Forward over the prompt; returns the last position's logits
    (b, padded vocab). Only that position is unembedded: the other rows
    of the reference's full logits are never read."""
    def prefill_step(params, batch):
        hidden, _ = mdl.forward(params, batch, return_hidden=True)
        return layers.unembed(params["tok"], hidden[:, -1])
    return prefill_step


def make_decode_step(mdl: ModelDef):
    """(params, cache, token (b, 1), index: int) -> (next token (b, 1)
    int32, cache): greedy argmax over the padded vocab, as the reference
    takes it; the cache is written in place."""
    def decode_step(params, cache, token, index: int):
        logits, cache = mdl.decode(params, cache, token, index)
        next_token = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return next_token, cache
    return decode_step


def init_serving_params(mdl: ModelDef, seed: int = 0, device=None):
    """The model's parameters alone (no optimizer state), drawn on
    `device` (None: the GPU; raises without one unless "cpu" is asked)."""
    return init_params(mdl.param_tree, seed, device)


def init_cache(mdl: ModelDef, batch: int, cache_len: int, device=None):
    """A zero decode cache on `device` (None: the GPU): k/v of `cache_len`
    positions, or for the ssm family the RWKV state, whose size does not
    depend on `cache_len` (as in the reference)."""
    return init_params(mdl.cache_specs(batch, cache_len), 0, device)
