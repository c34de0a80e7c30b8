"""Plain PyTorch versions of causal GQA attention, forward and backward,
the counterpart of `repro/kernels/flash_attention/ref.py`. The CPU path of
`ops` and the CUDA kernels' checks use them. Layout (b, heads, s, hd)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _logits(q, k):
    """The masked f32 logits (b, nq, s, s) and the group size."""
    b, nq, s, hd = q.shape
    group = nq // k.shape[1]
    k = k.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * hd ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    return logits.masked_fill(~mask, NEG_INF), group


def flash_attention_ref(q, k, v):
    """q (b, nq, s, hd); k/v (b, nkv, s, hd); causal; kv head = q head //
    group. Logits, softmax and the weighted sum in f32; out in q's dtype."""
    logits, group = _logits(q, k)
    probs = torch.softmax(logits, dim=-1)
    v = v.float().repeat_interleave(group, dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v).to(q.dtype)


def flash_attention_fwd_ref(q, k, v):
    """(out, lse): the output of `flash_attention_ref` and the f32
    logsumexp (b, nq, s) of each row's masked, scaled logits, which the
    backward reads to rebuild the probabilities."""
    logits, group = _logits(q, k)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    v = v.float().repeat_interleave(group, dim=1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v).to(q.dtype)
    return out, lse


def flash_attention_bwd_ref(q, k, v, o, lse, do):
    """(dq, dk, dv) in q's dtype, the formulas written out in f32 (not
    autograd): D_i = Σ_d dO_id·O_id, P = exp(S − lse), dV = Pᵀ·dO and
    dP = dO·Vᵀ, dS = P∘(dP − D)·hd^-½, dQ = dS·K, dK = dSᵀ·Q, with dK and
    dV summed over the q heads of each kv head's group."""
    b, nq, s, hd = q.shape
    nkv = k.shape[1]
    logits, group = _logits(q, k)
    p = torch.exp(logits - lse.float()[..., None])
    do32 = do.float()
    d = (do32 * o.float()).sum(-1)
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, vr)
    ds = p * (dp - d[..., None]) * hd ** -0.5
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())

    def fold(x):                         # sum the q heads of each group
        return x.reshape(b, nkv, group, s, hd).sum(2)

    return dq.to(q.dtype), fold(dk).to(q.dtype), fold(dv).to(q.dtype)
