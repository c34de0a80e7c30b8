"""Plain PyTorch versions of the RWKV-6 WKV recurrence: the chunked form
that the TPU kernel and the reference model compute
(`repro/kernels/wkv6/kernel.py` `_wkv_kernel`, `repro/models/rwkv6.py`
`wkv_chunked`), and the exact sequential oracle of
`repro/kernels/wkv6/ref.py`. The CPU path of `ops` and the CUDA kernel's
checks use them.

The chunked form factors the intra-chunk decay exp(a[t-1] − a[i]) into
exp(clip(a[t-1])) · exp(clip(−a[i])) with the exponents clipped at ±40.
That is exact only while the cumulative log-decay within a chunk stays
above −40; past it the chunked form and the sequential oracle differ, and
the chunk boundaries (multiples of `chunk` from position 0) decide the
result. The port reproduces the chunked form, clip and boundaries
included.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CLIP = 40.0                 # exponent clip of the factored intra-chunk form


def wkv6_chunked_ref(r, k, v, la, u, chunk: int = 64, s_in=None):
    """r/k/v/la (b, s, H, K), any float dtype, taken to f32; u (H, K);
    s_in (b, H, K, K) or None for a zero state. Chunks of min(chunk, s)
    tokens from position 0; a ragged last chunk is padded with zeros
    (la = 0: the padding neither decays nor adds to the state). Returns
    (out (b, s, H, K) f32, s_out (b, H, K, K) f32), the state after the
    last real token."""
    r, k, v, la = (t.float() for t in (r, k, v, la))
    u = u.float()
    b, s, H, K = r.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        r, k, v, la = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, la))
    S = (torch.zeros((b, H, K, K), dtype=torch.float32, device=r.device)
         if s_in is None else s_in.float())
    tri = torch.ones((c, c), dtype=torch.float32, device=r.device).tril(-1)
    outs = []
    for c0 in range(0, s + pad, c):
        rr, kk, vv, ll = (t[:, c0:c0 + c] for t in (r, k, v, la))
        a = ll.cumsum(1)                  # cumulative log decay, <= 0
        a_prev = a - ll                   # a[t-1] (0 for t = 0)
        o_inter = torch.einsum("bchk,bhkv->bchv", rr * torch.exp(a_prev), S)
        r_f = rr * torch.exp(a_prev.clamp(-CLIP, CLIP))
        k_f = kk * torch.exp((-a).clamp(-CLIP, CLIP))
        att = torch.einsum("bchk,bdhk->bhcd", r_f, k_f) * tri
        o_intra = torch.einsum("bhcd,bdhv->bchv", att, vv)
        o_bonus = torch.einsum("bchk,bchk->bch", rr * u, kk)[..., None] * vv
        a_last = a[:, -1:]
        k_dec = kk * torch.exp(a_last - a)
        S = S * torch.exp(a_last[:, 0])[..., None] + torch.einsum(
            "bchk,bchv->bhkv", k_dec, vv)
        outs.append(o_inter + o_intra + o_bonus)
    return torch.cat(outs, 1)[:, :s], S


def wkv6_ref(r, k, v, la, u):
    """The exact per-token recurrence. r/k/v/la (b, H, s, K), u (H, K);
    returns (b, H, s, K) f32:
        out_t = r_t · (S + (u ⊙ k_t) v_tᵀ),  S ← diag(e^{la_t}) S + k_t v_tᵀ
    from a zero state."""
    r, k, v, la = (t.float() for t in (r, k, v, la))
    b, H, s, K = r.shape
    S = torch.zeros((b, H, K, K), dtype=torch.float32, device=r.device)
    uf = u.float()[None]
    outs = []
    for t in range(s):
        rr, kk, vv, ll = (x[:, :, t] for x in (r, k, v, la))
        wkv = S + torch.einsum("bhk,bhv->bhkv", uf * kk, vv)
        outs.append(torch.einsum("bhk,bhkv->bhv", rr, wkv))
        S = S * torch.exp(ll)[..., None] + torch.einsum("bhk,bhv->bhkv",
                                                        kk, vv)
    return torch.stack(outs, 2)
