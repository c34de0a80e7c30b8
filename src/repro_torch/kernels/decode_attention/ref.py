"""Plain PyTorch version of decode attention, the counterpart of
`repro/kernels/decode_attention/ref.py`. The CPU path of `ops` and the
CUDA kernel's checks use it."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, cache_index: int):
    """q (b, nkv, group, hd); k/v (b, S, nkv, hd); cache positions
    > `cache_index` masked. Logits, softmax and the weighted sum in f32;
    out (b, nkv, group, hd) in q's dtype."""
    hd = q.shape[-1]
    S = k.shape[1]
    logits = torch.einsum("bngd,bsnd->bngs", q.float(), k.float()) \
        * hd ** -0.5
    valid = torch.arange(S, device=q.device) <= cache_index
    logits = logits.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bngs,bsnd->bngd", probs, v.float()).to(q.dtype)
