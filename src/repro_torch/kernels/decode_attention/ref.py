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


def decode_attention_split_ref(q, k, v, cache_index: int, n_splits: int,
                               rows: int | None = None):
    """The same function as flash-decoding computes it, the plain form of
    the CUDA kernel's split and combine: rows 0..cache_index in `n_splits`
    runs of `rows` rows (default ceil(n / n_splits); no run may be
    empty). Each run gives f32 partials m = max of its scaled logits,
    l = Σ e^(s − m), acc = Σ e^(s − m) v; they are folded in run order as
    out = Σ e^(m_s − M) acc_s / max(Σ e^(m_s − M) l_s, 1e-30), M = max m_s.
    Shapes and dtypes as `decode_attention_ref`."""
    hd = q.shape[-1]
    n = cache_index + 1
    rows = -(-n // n_splits) if rows is None else rows
    if not (rows > 0 and (n_splits - 1) * rows < n <= n_splits * rows):
        raise ValueError(f"{n_splits} runs of {rows} rows do not cover "
                         f"{n} rows without an empty run")
    qf = q.float()
    parts = []
    for s in range(n_splits):
        lo, hi = s * rows, min((s + 1) * rows, n)
        logits = torch.einsum("bngd,bsnd->bngs", qf,
                              k[:, lo:hi].float()) * hd ** -0.5
        m = logits.amax(-1, keepdim=True)
        p = torch.exp(logits - m)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bngs,bsnd->bngd", p, v[:, lo:hi].float())))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    den = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.exp(m - M)
        den = den + w * l
        acc = acc + w * a
    return (acc / den.clamp_min(1e-30)).to(q.dtype)
