"""Plain PyTorch version of causal GQA attention, the counterpart of
`repro/kernels/flash_attention/ref.py`. The CPU path of `ops` and the CUDA
kernel's checks use it."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v):
    """q (b, nq, s, hd); k/v (b, nkv, s, hd); causal; kv head = q head //
    group. Logits, softmax and the weighted sum in f32; out in q's dtype."""
    b, nq, s, hd = q.shape
    group = nq // k.shape[1]
    k = k.float().repeat_interleave(group, dim=1)
    v = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * hd ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v).to(q.dtype)
