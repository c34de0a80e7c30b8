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


def clip_grad(x):
    """The derivative of clip(x, −40, 40) as `jax.grad` gives it for
    `jnp.clip` (a max, then a min, each splitting a tie evenly): 1 inside,
    1/2 at exactly ±40, 0 outside. `torch.clamp`'s backward gives 1 at the
    bounds."""
    return ((x > -CLIP) & (x < CLIP)).float() + 0.5 * (x.abs() == CLIP).float()


def wkv6_chunked_bwd_ref(r, k, v, la, u, do, chunk: int = 64):
    """The gradient of `wkv6_chunked_ref`'s output from a zero state, as
    `jax.grad` differentiates the reference's `wkv_chunked` (the padding
    wrapper's zero rows included): r/k/v/la/do (b, s, H, K), any float
    dtype, taken to f32; u (H, K). Returns (dr, dk, dv, dla, du), f32:
    the first four (b, s, H, K), du (H, K).

    An explicit reverse pass: the chunks' starting states are rebuilt
    forward, then each chunk, last first, takes the output's gradient do
    and dS, the gradient of the state it hands on (0 after the last
    chunk: the final state is not an output), and gives its inputs'
    gradients and the dS of the chunk before. Within a chunk, with
    a = cumsum(la), a_prev = a − la and a_last its last row:
        o   = (r ⊙ e^{a_prev}) S + tril₋₁[r_f k_fᵀ] v + (Σ r ⊙ u ⊙ k) v
        S'  = diag(e^{a_last}) S + (k ⊙ e^{a_last − a})ᵀ v
    (r_f = r ⊙ e^{clip(a_prev)}, k_f = k ⊙ e^{clip(−a)}); the clip's
    derivative is `clip_grad`'s, and dla is the reverse cumulative sum of
    the gradient of a, less that of a_prev."""
    r, k, v, la, do = (t.float() for t in (r, k, v, la, do))
    u = u.float()
    b, s, H, K = r.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        r, k, v, la, do = (F.pad(t, (0, 0, 0, 0, 0, pad))
                           for t in (r, k, v, la, do))
    n = (s + pad) // c
    S = torch.zeros((b, H, K, K), dtype=torch.float32, device=r.device)
    starts = []
    for c0 in range(0, s + pad, c):
        kk, vv, ll = (t[:, c0:c0 + c] for t in (k, v, la))
        a = ll.cumsum(1)
        a_last = a[:, -1:]
        starts.append(S)
        S = S * torch.exp(a_last[:, 0])[..., None] + torch.einsum(
            "bchk,bchv->bhkv", kk * torch.exp(a_last - a), vv)
    tri = torch.ones((c, c), dtype=torch.float32, device=r.device).tril(-1)
    dS = torch.zeros_like(S)
    du = torch.zeros((H, K), dtype=torch.float32, device=r.device)
    grads = [torch.empty_like(r) for _ in range(4)]
    for i in reversed(range(n)):
        sl = slice(i * c, (i + 1) * c)
        rr, kk, vv, ll, dd = (t[:, sl] for t in (r, k, v, la, do))
        S = starts[i]
        a = ll.cumsum(1)
        a_prev = a - ll
        a_last = a[:, -1:]
        e_prev = torch.exp(a_prev)
        e_rf = torch.exp(a_prev.clamp(-CLIP, CLIP))
        e_kf = torch.exp((-a).clamp(-CLIP, CLIP))
        e_dec = torch.exp(a_last - a)
        e_last = torch.exp(a_last[:, 0])                      # (b, H, K)
        r_in, r_f, k_f, k_dec = rr * e_prev, rr * e_rf, kk * e_kf, kk * e_dec
        att = torch.einsum("bchk,bdhk->bhcd", r_f, k_f) * tri
        d_att = torch.einsum("bchv,bdhv->bhcd", dd, vv) * tri
        beta = torch.einsum("bchk,bchk->bch", rr * u, kk)
        d_beta = torch.einsum("bchv,bchv->bch", dd, vv)
        d_rin = torch.einsum("bchv,bhkv->bchk", dd, S)
        d_rf = torch.einsum("bhcd,bdhk->bchk", d_att, k_f)
        d_kf = torch.einsum("bhcd,bchk->bdhk", d_att, r_f)
        d_kdec = torch.einsum("bchv,bhkv->bchk", vv, dS)
        dv = (torch.einsum("bhcd,bchv->bdhv", att, dd)
              + beta[..., None] * dd
              + torch.einsum("bchk,bhkv->bchv", k_dec, dS))
        d_ru = d_beta[..., None] * kk                 # of r ⊙ u
        du += (d_ru * rr).sum((0, 1))
        dr = d_rin * e_prev + d_rf * e_rf + d_ru * u
        dk = d_kdec * e_dec + d_kf * e_kf + d_beta[..., None] * (rr * u)
        d_ap = d_rin * r_in + d_rf * r_f * clip_grad(a_prev)
        d_a = -d_kdec * k_dec - d_kf * k_f * clip_grad(-a)
        d_a[:, -1] += (dS * S).sum(-1) * e_last + (d_kdec * k_dec).sum(1)
        d_tot = d_a + d_ap
        dla = d_tot.flip(1).cumsum(1).flip(1) - d_ap
        for g, x in zip(grads, (dr, dk, dv, dla)):
            g[:, sl] = x
        dS = dS * e_last[..., None] + torch.einsum("bchk,bchv->bhkv",
                                                   r_in, dd)
    return tuple(g[:, :s] for g in grads) + (du,)


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
