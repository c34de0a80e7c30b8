"""RWKV-6 "Finch" block of the port (attention-free, data-dependent
decay), the counterpart of `repro/models/rwkv6.py` with its names.

Prefill (`time_mix`) runs the chunked WKV form through the `wkv6` kernel
(`kernels/wkv6`: a CUDA tensor launches the kernel, a CPU tensor runs its
plain version): within a chunk of 64 tokens the pairwise decay
exp(a[t-1] − a[i]) is factored into exp(a[t-1]) · exp(−a[i]) with the
exponents clipped at ±40, as the reference computes it. That is exact
while the cumulative in-chunk log-decay stays above −40; past it (at the
reference's random init the per-token log-decay is about −1, so after
about 40 tokens of a chunk) the reference's prefill and its exact decode
recurrence differ, and the port reproduces the reference's chunked form,
chunk boundaries included. Decode (`time_mix_decode`) is the exact
one-step recurrence in plain PyTorch, as the reference computes it outside
any Pallas kernel; it writes the layer's state in place. Training
differentiates `time_mix` through the `wkv6` backward kernel
(`kernels/wkv6/ops.py` `WKV6`).

State per head: S ∈ R^{K×V} (K = V = head size):
    out_t = r_t · (S + (u ⊙ k_t) v_tᵀ)
    S    <- diag(w_t) S + k_t v_tᵀ,   w_t = exp(-exp(ww_t))  (per channel)

rwkv6-3b pads its 40 heads to 48 in the parameter shapes themselves
(`head_pad_to`); the padded columns are drawn like the rest, so every one
of the 48 heads runs, as in the reference.

Under `with mesh:` (a state held in blocks) the time mix splits its heads
over "model" in whole heads: `wr`, `wk`, `wv`, `wg` and the decay LoRA's
second matrix column-parallel, `w0`, `u` and the group norm on the rank's
heads, `wkv6` on those heads, `wo` row-parallel and summed; the channel
mix is column-parallel in `wk`, row-parallel in `wv`, with `wr` whole on
every rank. A width the model degree does not cut into whole heads (or
d_ff it does not divide) computes whole on every rank. On a residual
stream split over "model" (`launch.mesh.stream_split()`) both take the
stream's positions whole (the token shift needs the position before
each), through the gather whose backward takes the rank's block: the
lerps' own sums over "model" already make the gradient whole; the time
mix's partial sums are reduce-scattered back, the channel mix's output,
alike on every rank, is cut to the rank's positions.

bf16 rounds where the reference rounds: the token-shift lerps and the
projections in the parameter dtype, the decay LoRA product cast to f32
before `w0` is added, r/k/v cast to f32 for the WKV step, and the gated
output cast back before `wo`.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.params import ParamSpec
from repro_torch.models.sharding import Blocks

Params = Dict[str, Any]

_LORA = 64          # rank of the data-dependent decay LoRA


def rwkv_head_pad(cfg: ModelConfig) -> int:
    h = cfg.rwkv_num_heads
    return cfg.head_pad_to if cfg.head_pad_to else h


def time_mix_params(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    hd = cfg.rwkv_head_size
    dp = rwkv_head_pad(cfg) * hd  # padded inner width
    pd = cfg.param_dtype
    return {
        # token-shift interpolation factors
        "mu_r": ParamSpec((d,), pd, (None,), "zeros"),
        "mu_k": ParamSpec((d,), pd, (None,), "zeros"),
        "mu_v": ParamSpec((d,), pd, (None,), "zeros"),
        "mu_w": ParamSpec((d,), pd, (None,), "zeros"),
        "mu_g": ParamSpec((d,), pd, (None,), "zeros"),
        # projections (outputs in padded head layout)
        "wr": ParamSpec((d, dp), pd, ("embed", "rwkv_heads"), "fan_in"),
        "wk": ParamSpec((d, dp), pd, ("embed", "rwkv_heads"), "fan_in"),
        "wv": ParamSpec((d, dp), pd, ("embed", "rwkv_heads"), "fan_in"),
        "wg": ParamSpec((d, dp), pd, ("embed", "rwkv_heads"), "fan_in"),
        "wo": ParamSpec((dp, d), pd, ("rwkv_heads", "embed"), "fan_in"),
        # data-dependent decay: ww = w0 + tanh(x @ w1) @ w2
        "w0": ParamSpec((dp,), "float32", ("rwkv_heads",), "zeros"),
        "w1": ParamSpec((d, _LORA), pd, ("embed", None), "fan_in"),
        "w2": ParamSpec((_LORA, dp), pd, (None, "rwkv_heads"), "fan_in"),
        # per-channel bonus
        "u": ParamSpec((dp,), "float32", ("rwkv_heads",), "zeros"),
        # per-head group norm
        "ln_scale": ParamSpec((dp,), pd, ("rwkv_heads",), "ones"),
        "ln_bias": ParamSpec((dp,), pd, ("rwkv_heads",), "zeros"),
    }


def channel_mix_params(cfg: ModelConfig) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    pd = cfg.param_dtype
    return {
        "mu_k": ParamSpec((d,), pd, (None,), "zeros"),
        "mu_r": ParamSpec((d,), pd, (None,), "zeros"),
        "wk": ParamSpec((d, ff), pd, ("embed", "mlp"), "fan_in"),
        "wr": ParamSpec((d, d), pd, ("embed", None), "fan_in"),
        "wv": ParamSpec((ff, d), pd, ("mlp", "embed"), "fan_in"),
    }


def _token_shift(x, last=None):
    """Previous-token x (zeros, or `last` (b, 1, d), at position 0)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _tm_inputs(p: Params, cfg: ModelConfig, x, xs, enter=None):
    """Project r, k, v, g and the log-decay la. r/k/v/la (b, s, H, hd)
    f32 for the WKV step, g (b, s, H·hd) in x's dtype, u (H, hd); H the
    heads of `p` (the rank's, on a mesh, where `enter` takes each input of
    a column-parallel product into the split)."""
    hd = cfg.rwkv_head_size
    H = p["u"].shape[0] // hd
    enter = enter or (lambda t: t)

    def lerp(mu):
        return enter(x + (xs - x) * mu)

    r = lerp(p["mu_r"]) @ p["wr"]
    k = lerp(p["mu_k"]) @ p["wk"]
    v = lerp(p["mu_v"]) @ p["wv"]
    g = lerp(p["mu_g"]) @ p["wg"]
    lora = enter(torch.tanh((x + (xs - x) * p["mu_w"]) @ p["w1"]))
    ww = p["w0"] + (lora @ p["w2"]).float()
    la = -torch.exp(ww.clamp(-8.0, 6.0))      # log-decay, la <= 0
    shp = x.shape[:2] + (H, hd)
    r, k, v, la = (t.reshape(shp) for t in (r, k, v, la))
    u = p["u"].reshape(H, hd)
    return r.float(), k.float(), v.float(), g, la, u


def _group_norm(p: Params, cfg: ModelConfig, o):
    """Per-head layer norm over hd (two-pass variance, eps 64e-5).
    o (b, s, H, hd) f32."""
    mu = o.mean(-1, keepdim=True)
    var = (o - mu).square().mean(-1, keepdim=True)
    H, hd = o.shape[-2], o.shape[-1]
    scale = p["ln_scale"].float().reshape(H, hd)
    bias = p["ln_bias"].float().reshape(H, hd)
    return (o - mu) * torch.rsqrt(var + 64e-5) * scale + bias


def wkv_chunked(r, k, v, la, u, s_in, chunk: int = 64):
    """Chunked-parallel WKV6 (the plain version; all inputs f32).
    r/k/v/la (b, s, H, K); u (H, K); s_in (b, H, K, V). Returns
    out (b, s, H, V), s_out."""
    return wkv6_chunked_ref(r, k, v, la, u, chunk, s_in)


def _gated_out(p: Params, x, o, g):
    """Group-normed WKV output o (b, s, H, hd) f32 gated by silu(g), cast
    to x's dtype, then through `wo`."""
    b, s = o.shape[:2]
    gate = F.silu(g.float())
    out = (o.reshape(b, s, -1) * gate).to(x.dtype)
    return out @ p["wo"]


def _heads_on_mesh(p: Params, cfg: ModelConfig):
    """(the time mix's weights on the state mesh, whether the rank holds
    whole heads of them): its blocks where "model" cuts the padded heads
    into whole heads, else every weight whole (and no mesh: `p`)."""
    mesh = mesh_lib.state_mesh()
    if mesh is None:
        return p, False
    L = Blocks(mesh, p, time_mix_params, cfg)
    if L.on_model("wr", 1) and rwkv_head_pad(cfg) % L.model_size == 0:
        return {k: L.local(k) for k in p}, True
    return L.all_whole(), False


def time_mix(p: Params, cfg: ModelConfig, x, chunk: int = 64):
    """Prefill time mix from a zero state, through the `wkv6` kernel.
    Under autograd (training) `wkv6` runs as the `WKV6` function, whose
    backward is the hand-written `wkv6_bwd` kernel on the card and
    `wkv6_chunked_bwd_ref` on the CPU: the gradient `jax.grad` gives of
    the reference's `wkv_chunked`, exponent clip and chunk edges
    included. Under `with mesh:`, on the rank's heads, over the stream's
    positions gathered whole."""
    p, split = _heads_on_mesh(p, cfg)
    mesh = mesh_lib.state_mesh()
    enter = (functools.partial(mesh_lib.copy_to_group, mesh=mesh) if split
             else None)
    x = mesh_lib.from_stream(x, mesh, same=True)
    r, k, v, g, la, u = _tm_inputs(p, cfg, x, _token_shift(x), enter)
    out = wkv6_ops.wkv6(r, k, v, la, u, chunk=chunk)
    y = _gated_out(p, x, _group_norm(p, cfg, out), g)
    return mesh_lib.to_stream(y, mesh, same=not split)


def time_mix_decode(p: Params, cfg: ModelConfig, x, state):
    """The exact one-step recurrence. state = {"S": (b, H, K, V) f32,
    "last": (b, 1, d)}, views of the layer's cache: S and last are
    written IN PLACE (the reference returns a new state to the same
    effect). Returns y (b, 1, d). Under `with mesh:` S holds the rank's
    heads ("act_heads") where "model" cuts them whole: the step runs on
    those heads, `wo` row-parallel and summed over "model"."""
    p, split = _heads_on_mesh(p, cfg)
    S = state["S"]
    r, k, v, g, la, u = _tm_inputs(p, cfg, x, state["last"])
    rr, kk, vv, ll = r[:, 0], k[:, 0], v[:, 0], la[:, 0]      # (b, H, K)
    b, H, K = rr.shape
    Sv = S.view(b * H, K, K)
    wkv = torch.baddbmm(Sv, (u * kk).reshape(b * H, K, 1),
                        vv.reshape(b * H, 1, K))
    o = torch.bmm(rr.reshape(b * H, 1, K), wkv).reshape(b, 1, H, K)
    S.mul_(torch.exp(ll)[..., None])
    Sv.baddbmm_(kk.reshape(b * H, K, 1), vv.reshape(b * H, 1, K))
    state["last"].copy_(x)
    y = _gated_out(p, x, _group_norm(p, cfg, o), g)
    return mesh_lib.reduce_from_group(y, mesh_lib.state_mesh()) if split \
        else y


def channel_mix(p: Params, x, last=None, cfg: ModelConfig = None):
    """sigmoid(xr·wr) · (relu(xk·wk)² · wv) of the token-shifted lerps.
    Under `with mesh:` (which needs `cfg`): over the stream's positions
    gathered whole, `wk` column-parallel over "mlp", `wv` row-parallel and
    summed, `wr` whole on every rank."""
    mesh = mesh_lib.state_mesh()
    enter = reduce = None
    if mesh is not None:
        L = Blocks(mesh, p, channel_mix_params, cfg)
        if L.on_model("wk", 1):
            p = {k: L.local(k) for k in p}
            enter = functools.partial(mesh_lib.copy_to_group, mesh=mesh)
            reduce = functools.partial(mesh_lib.reduce_from_group, mesh=mesh)
        else:
            p = L.all_whole()
    x = mesh_lib.from_stream(x, mesh, same=True)
    xs = _token_shift(x, last)
    xk = x + (xs - x) * p["mu_k"]
    xr = x + (xs - x) * p["mu_r"]
    if enter is not None:
        xk = enter(xk)
    k = torch.relu(xk @ p["wk"]).square()
    r = torch.sigmoid(xr @ p["wr"])
    kv = k @ p["wv"]
    return mesh_lib.to_stream(r * (kv if reduce is None else reduce(kv)),
                              mesh, same=True)


def rwkv_state_specs(cfg: ModelConfig, batch: int):
    H, hd, d = rwkv_head_pad(cfg), cfg.rwkv_head_size, cfg.d_model
    return {
        "S": ParamSpec((batch, H, hd, hd), "float32",
                       ("batch", "act_heads", None, None), "zeros"),
        "last": ParamSpec((batch, 1, d), cfg.dtype, ("batch", None, None),
                          "zeros"),
        "cm_last": ParamSpec((batch, 1, d), cfg.dtype, ("batch", None, None),
                             "zeros"),
    }
