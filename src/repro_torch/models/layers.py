"""Shared transformer layers of the port: norms, RoPE, GQA attention
(causal, decode, bidirectional and cross), MLP, embedding; the
counterpart of `repro/models/layers.py`.

Parameters are the reference's trees (nested dicts of tensors, the same
names, shapes and layouts), so a reference tree carries across as it is
(`core/convert.py`). The attention forms that a Pallas kernel computes in
the reference go through the port's hand-written kernels:
`causal_attention` through `kernels/flash_attention`, `decode_attention`
and the decode-time cross-attention (`cross_decode_attention`) through
`kernels/decode_attention` (a CUDA tensor launches the kernel, a CPU
tensor runs its plain version). Non-causal attention over a whole
sequence (the whisper encoder, the decoder's prefill cross-attention) is
the reference's jnp `_sdpa`, here `sdpa`, a plain product and softmax.
The q/k/v/o projections, the MLP and the unembedding are plain products,
as in the reference, where XLA and not a Pallas kernel computes them.

The reference pads q heads to `cfg.padded_heads` for TPU sharding; padded
heads meet zero `wo` rows, so the padding is exact and the port runs
attention on the `num_heads` real heads. Then the kernels' mapping
kv head = q head // group equals `_kv_repeat_idx` for every dense config.

Under `with mesh:` (a state held in blocks, `models/sharding.py`) the
training forms run tensor-parallel over "model": attention
column-parallel over the q heads (k and v computed on the rank's
`kv_head_dim` block and gathered whole before their norm, bias and RoPE,
then the kv heads of the rank's q heads taken), `wo` row-parallel and
summed, and so the whisper encoder's attention, the cross-attention and
its `encode_kv`; the MLP column-parallel over "mlp", `w_out`
row-parallel; the embedding masked to the rank's vocab rows and summed;
the unembedding a vocab block (`models/steps.py` takes the softmax over
the blocks). A layer whose heads or width the model degree does not
divide computes whole on every rank. The residual stream between the
layers is split over "model" along its sequence where the reference's
`seq_sp` rule splits it (`launch.mesh.stream_split()`): a layer gathers
its normed input's positions (`mesh.from_stream`) and reduce-scatters its
partial sums back (`mesh.to_stream`); on a whole stream the same calls
are `copy_to_group` and the sum over "model". The final hidden state and
the encoder output enter the unembedding and the cross-attention whole
once (`head_input`, `encoder_output`).

Decode on a mesh (`decode_attention` under `with mesh:`, given the cache's
spec) reads the cache in the reference's blocks (`cache_axes`): a GQA
cache split over its rows ("kv_seq" over "model", or at long context
"long_kv_seq" over ("data", "model")), each rank attending its block of
rows up to the index and the partial outputs combined by their
logsumexp; an MHA-padded cache split over its (padded) heads
("act_heads"), each rank attending its heads. The audio family's cross
cache follows the self cache's head axis: over the padded heads, or whole
over its heads where the self cache splits its rows (each rank then
attends the kv heads of its q heads). Serving (`launch/serve.py`) stays
off the mesh, as the reference's does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.params import (LOGICAL_RULES_TP, ParamSpec,
                                       resolve_axes, spec_axes, torch_dtype)
from repro_torch.models.sharding import Blocks

Params = Dict[str, Any]
F8 = torch.float8_e4m3fn
F8_NAN = 0x7F                 # e4m3fn's NaN, below the sign bit
# |x| above this rounds past 448, e4m3fn's largest finite value; at it
# the tie goes to 448 (even)
F8_ROUNDS_FINITE = 464.0


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-5):
    """f32 input: in f32 throughout. Any other dtype: the sum of squares
    accumulates in f32 (the products of two bf16 are exact in f32), and the
    (…, 1) rescale factor and the scale are applied in the input dtype,
    rounding where the reference rounds."""
    if x.dtype == torch.float32:
        var = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(var + eps) * scale.float()
    d = x.shape[-1]
    xf = x.float()
    ss = (xf * xf).sum(-1)
    rs = torch.rsqrt(ss / d + eps)[..., None]
    return x * rs.to(x.dtype) * scale.to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    d = x.shape[-1]
    xf = x.float()
    mu = (xf.sum(-1) / d)[..., None]
    ss = ((xf * xf).sum(-1) / d)[..., None]
    var = torch.clamp(ss - mu.square(), min=0.0)
    rs = torch.rsqrt(var + eps)
    y = (x - mu.to(x.dtype)) * rs.to(x.dtype)
    return y * scale.to(x.dtype) + bias.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim // 2, dtype=torch.float32,
                        device=device) / (head_dim // 2)
    return theta ** -exps  # (hd/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq). Angles and rotation in f32, out in x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs       # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_params(cfg: ModelConfig, cross: bool = False) -> Params:
    """q/k/v/o projections; the cross-attention's (`cross`, whisper's
    decoder) carry no bias and no q/k norm."""
    d, nq, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_axes = (("embed", "kv_heads", "head_dim") if cfg.mha_padded
               else ("embed", "kv_heads", "kv_head_dim"))
    p: Params = {
        "wq": ParamSpec((d, nq, hd), cfg.param_dtype,
                        ("embed", "heads", "head_dim"), "fan_in"),
        "wk": ParamSpec((d, nkv, hd), cfg.param_dtype, kv_axes, "fan_in"),
        "wv": ParamSpec((d, nkv, hd), cfg.param_dtype, kv_axes, "fan_in"),
        "wo": ParamSpec((nq, hd, d), cfg.param_dtype,
                        ("heads", "head_dim", "embed"), "fan_in"),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = ParamSpec((nq, hd), cfg.param_dtype, ("heads", "head_dim"),
                            "zeros")
        p["bk"] = ParamSpec((nkv, hd), cfg.param_dtype,
                            ("kv_heads", "head_dim"), "zeros")
        p["bv"] = ParamSpec((nkv, hd), cfg.param_dtype,
                            ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm and not cross:
        p["q_norm"] = ParamSpec((hd,), cfg.param_dtype, (None,), "ones")
        p["k_norm"] = ParamSpec((hd,), cfg.param_dtype, (None,), "ones")
    return p


def _kv_repeat_idx(cfg: ModelConfig) -> torch.Tensor:
    """Index of the kv head used by each real q head (the reference's
    mapping restricted to the `num_heads` real heads)."""
    qpk = cfg.num_heads // cfg.num_kv_heads
    return torch.tensor([min(j // qpk, cfg.num_kv_heads - 1)
                         for j in range(cfg.num_heads)], dtype=torch.long)


def _repeat_kv(cfg: ModelConfig, k, v, q0: int = 0, nq: int = None):
    """k and v (b, s, nkv, hd) gathered to q heads q0..q0+nq−1 (all of
    them by default: the reference's `jnp.take(k, _kv_repeat_idx(cfg),
    axis=2)`), for the plain attention forms; the kernels map the heads
    themselves."""
    nq = cfg.num_heads if nq is None else nq
    if q0 == 0 and k.shape[2] == nq == cfg.num_heads:
        return k, v
    idx = _kv_repeat_idx(cfg)[q0:q0 + nq].to(k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def cache_axes(cfg: ModelConfig, long_ctx: bool = False):
    """Logical axes of the KV cache (b, S, heads, hd), the reference's
    `cache_axes`: an MHA-padded config's cache is split over its heads on
    "model"; a GQA config's over its rows, flash-decoding style ("kv_seq",
    or at long context "long_kv_seq")."""
    if cfg.mha_padded:
        return ("batch", None, "act_heads", None)
    return ("batch", "long_kv_seq" if long_ctx else "kv_seq", "act_kv",
            None)


def cache_kv_heads(cfg: ModelConfig, padded: bool = False) -> int:
    """The kv heads a cache holds: the real ones, or with `padded` (the
    layout on a mesh) an MHA-padded config's `padded_heads`, as the
    reference lays out every cache, so that "model" divides them."""
    return (cfg.padded_heads if padded and cfg.mha_padded
            else cfg.num_kv_heads)


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int, mesh,
               long_ctx: bool = False):
    """The spec of a k/v cache leaf (b, S, heads, hd) on `mesh` by the
    reference's rules (a layer's, without the stacked blocks axis)."""
    shape = (batch, cache_len, cache_kv_heads(cfg, True), cfg.head_dim)
    return resolve_axes(cache_axes(cfg, long_ctx), shape, mesh,
                        LOGICAL_RULES_TP)


def project_qkv(p: Params, cfg: ModelConfig, x, positions, *,
                rope: bool = True):
    """q (b, s, num_heads, hd), k and v (b, s, num_kv_heads, hd), RoPE
    applied to q and k unless `rope` is False (the whisper encoder)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def sdpa(q, k, v):
    """The reference's `_sdpa` as its unmasked callers (the whisper
    encoder, cross-attention) run it: q (b, sq, h, hd), k/v (b, sk, h,
    hd); the logits in q's dtype, then f32 and scaled, softmax in f32, the
    probabilities cast to v's dtype for the product with v."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def causal_attention(p: Params, cfg: ModelConfig, x, positions):
    """Full causal self-attention (train / prefill) through the
    `flash_attention` kernel, at any sequence length (the reference splits
    long sequences into query chunks; the kernel skips the blocks above the
    diagonal itself). Under `with mesh:`, `_tp_attention`."""
    mesh = mesh_lib.state_mesh()
    if mesh is not None:
        return _tp_attention(p, cfg, x, positions, mesh)
    q, k, v = project_qkv(p, cfg, x, positions)
    out = flash_ops.flash_attention(q, k, v)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _local_kv_heads(cfg: ModelConfig, q0: int, nq: int):
    """(the kv heads of q heads q0..q0+nq−1, repeated): the kv heads as a
    range (lo, hi) where those q heads map onto whole kv groups at the
    config's ratio (no repeat: the kernel maps q head j to kv head
    j // group), else the index of each q head's kv head."""
    idx = _kv_repeat_idx(cfg)[q0:q0 + nq]
    qpk = cfg.num_heads // cfg.num_kv_heads
    lo, hi = int(idx[0]), int(idx[-1]) + 1
    if (nq == (hi - lo) * qpk
            and torch.equal(idx, torch.arange(lo, hi).repeat_interleave(qpk))):
        return (lo, hi), None
    return None, idx


def _tp_attention(p: Params, cfg: ModelConfig, x, positions, mesh):
    """Causal attention on a mesh, the stream's positions gathered whole
    (`positions` are theirs). q heads split over "model": q on the
    rank's heads, k and v on its `kv_head_dim` block gathered whole over
    "model" (their norm, bias and RoPE need whole heads), then the kv
    heads of the rank's q heads (repeated to them, group 1, where they do
    not form whole groups), the kernel on those heads, `wo` row-parallel,
    summed over "model". Heads that "model" does not divide: the layer
    whole on every rank."""
    L = Blocks(mesh, p, attention_params, cfg)
    if not L.on_model("wq", 1):
        w = L.all_whole()
        x = mesh_lib.from_stream(x, mesh, same=True)
        q, k, v = project_qkv(w, cfg, x, positions)
        out = flash_ops.flash_attention(q, k, v)
        return mesh_lib.to_stream(torch.einsum("bshk,hkd->bsd", out,
                                               w["wo"]), mesh, same=True)
    q, k, v = _tp_qkv(L, cfg, mesh_lib.from_stream(x, mesh), positions)
    k, v = _rank_kv(L, cfg, k, v, q.shape[2])
    out = flash_ops.flash_attention(q, k, v)
    return _tp_out(L, out)


def _rank_kv(L, cfg: ModelConfig, k, v, nq: int):
    """Whole k and v cut to the kv heads of the rank's `nq` q heads, for
    the kernels: a range of whole kv groups where those q heads form them,
    else each q head's kv head (group 1)."""
    span, idx = _local_kv_heads(cfg, L.model_index * nq, nq)
    if span is not None:
        return tuple(t[:, :, span[0]:span[1]].contiguous() for t in (k, v))
    idx = idx.to(k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _tp_out(L, out):
    """The rank's heads of an attention output through its rows of `wo`
    (row-parallel), summed over "model" into the stream's layout."""
    y = torch.einsum("bshk,hkd->bsd", out, L.local("wo"))
    return mesh_lib.to_stream(y, L.mesh)


def _tp_kv(L, xin, key: str):
    """`key`'s ("wk" or "wv") projection of `xin` on every kv head: on the
    rank's `kv_head_dim` block gathered whole over "model", or with the
    weight whole where "model" does not split it."""
    if L.on_model(key, 2):
        t = torch.einsum("bsd,dhk->bshk", xin, L.local(key))
        return mesh_lib.gather_from_group(t, L.mesh, "model", 3)
    return torch.einsum("bsd,dhk->bshk", xin, L.shared(key))


def _tp_qkv(L, cfg: ModelConfig, xin, positions, rope: bool = True):
    """q on the rank's q heads (all of them where "model" does not split
    `wq`), k and v computed on the rank's `kv_head_dim` block and gathered
    whole over "model" (their norm, bias and RoPE need whole heads); RoPE
    unless `rope` is False (the whisper encoder). `xin` has entered the
    split computation (`from_stream`, or `copy_to_group` in decode)."""
    q = torch.einsum("bsd,dhk->bshk", xin, L.local("wq"))
    k, v = _tp_kv(L, xin, "wk"), _tp_kv(L, xin, "wv")
    if "bq" in L.p:
        q = q + L.local("bq")
        k = k + L.shared("bk")
        v = v + L.shared("bv")
    if "q_norm" in L.p:
        q = rms_norm(q, L.shared("q_norm"), cfg.norm_eps)
        k = rms_norm(k, L.shared("k_norm"), cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def bidir_attention(p: Params, cfg: ModelConfig, x):
    """Non-causal self-attention (the whisper encoder), without RoPE:
    the plain `sdpa`, as in the reference. Under `with mesh:` over the
    rank's q heads as `_tp_attention` splits them (k and v repeated to
    those heads), `wo` row-parallel and summed; heads that "model" does
    not divide: the layer whole on every rank."""
    mesh = mesh_lib.state_mesh()
    if mesh is not None:
        L = Blocks(mesh, p, attention_params, cfg)
        if L.on_model("wq", 1):
            q, k, v = _tp_qkv(L, cfg, mesh_lib.from_stream(x, mesh), None,
                              rope=False)
            nq = q.shape[2]
            k, v = _repeat_kv(cfg, k, v, L.model_index * nq, nq)
            return _tp_out(L, sdpa(q, k, v))
        xw = mesh_lib.from_stream(x, mesh, same=True)
        return mesh_lib.to_stream(_bidir(L.all_whole(), cfg, xw), mesh,
                                  same=True)
    return _bidir(p, cfg, x)


def _bidir(p: Params, cfg: ModelConfig, x):
    q, k, v = project_qkv(p, cfg, x, None, rope=False)
    k, v = _repeat_kv(cfg, k, v)
    out = sdpa(q, k, v)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def to_cache_dtype(x, dtype):
    """`x` cast to a cache's dtype as XLA casts it (the reference's
    `k.astype(cache_k.dtype)`), on either device. For f8 e4m3fn, byte for
    byte: round to nearest even (subnormals included), |x| > 464 and ±inf
    to NaN and NaN to NaN, each keeping its sign (sign | 0x7F). torch's own
    cast saturates those to ±448, so it is used only on values that round
    to a finite e4m3 value. Any other dtype: a plain `.to`."""
    dtype = torch_dtype(dtype)
    if dtype != F8:
        return x.to(dtype)
    xf = x.float()
    fits = xf.abs() <= F8_ROUNDS_FINITE             # False for NaN
    finite = torch.where(fits, xf, torch.zeros_like(xf)).to(F8)
    nan = torch.where(xf.view(torch.int32) < 0, 0x80 | F8_NAN, F8_NAN)
    return torch.where(fits, finite.view(torch.uint8),
                       nan.to(torch.uint8)).view(F8)


def decode_attention(p: Params, cfg: ModelConfig, x, cache_k, cache_v,
                     cache_index: int, spec=None):
    """Single-token decode at position `cache_index` (a host int). Writes
    the new k/v into `cache_{k,v}` (b, S, nkv, hd) at `cache_index` IN
    PLACE (the reference donates the cache to the same effect), cast by
    `to_cache_dtype`, and returns (y, cache_k, cache_v), the caches being
    the same storage; attention through the `decode_attention` kernel over
    rows 0..cache_index, which reads an f8 cache as it is (the reference
    dequantizes the whole cache to q's dtype first). Under `with mesh:`
    the caches are the rank's blocks laid out by `spec` (`cache_spec`):
    `_mesh_decode_attention`."""
    mesh = mesh_lib.state_mesh()
    if mesh is not None:
        return _mesh_decode_attention(p, cfg, x, cache_k, cache_v,
                                      cache_index, mesh, spec)
    b = x.shape[0]
    positions = torch.full((b, 1), cache_index, dtype=torch.int32,
                           device=x.device)
    q, k, v = project_qkv(p, cfg, x, positions)
    cache_k[:, cache_index] = to_cache_dtype(k[:, 0], cache_k.dtype)
    cache_v[:, cache_index] = to_cache_dtype(v[:, 0], cache_v.dtype)
    out = decode_ops.decode_attention(q, cache_k, cache_v, cache_index)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache_k, cache_v


def _write_row(cache_k, cache_v, k, v, row: int):
    cache_k[:, row] = to_cache_dtype(k[:, 0], cache_k.dtype)
    cache_v[:, row] = to_cache_dtype(v[:, 0], cache_v.dtype)


def _mesh_decode_attention(p: Params, cfg: ModelConfig, x, cache_k,
                           cache_v, index: int, mesh, spec):
    """Decode attention on the rank's blocks. An MHA-padded cache:
    `_head_decode`. A GQA cache split over its rows: q, k and v computed
    on the rank's heads as in `_tp_attention` and gathered whole over
    "model"; the new row written by the rank whose block holds `index`;
    each rank attends its block [lo, lo + S_r) up to `index` (the kernel
    gives its partial output and logsumexp); the partials combined over
    the cache's axes (an all-reduce max of the logsumexp, then one
    all-reduce sum of the weighted outputs and the weights); `wo`
    row-parallel over "model" and summed."""
    if spec is None:
        raise ValueError("decode on a mesh needs the cache's spec "
                         "(models.layers.cache_spec)")
    L = Blocks(mesh, p, attention_params, cfg)
    b = x.shape[0]
    positions = torch.full((b, 1), index, dtype=torch.int32,
                           device=x.device)
    if cfg.mha_padded:
        return _head_decode(L, cfg, x, cache_k, cache_v, index, positions,
                            spec_axes(spec[2]))
    split = L.on_model("wq", 1)
    q, k, v = _tp_qkv(L, cfg, mesh_lib.copy_to_group(x, mesh), positions)
    nq_r = q.shape[2]
    if split:
        q = mesh_lib.all_gather(q, mesh, "model", 2)
    axes = spec_axes(spec[1])
    rows = cache_k.shape[1]
    lo = mesh.index(axes) * rows if axes else 0
    if lo <= index < lo + rows:
        _write_row(cache_k, cache_v, k, v, index - lo)
    if axes:
        out, lse = decode_ops.decode_attention(q, cache_k, cache_v, index,
                                               row0=lo, with_lse=True)
        out = _combine(out, lse, mesh, axes).to(q.dtype)
    else:
        out = decode_ops.decode_attention(q, cache_k, cache_v, index)
    if split:
        q0 = L.model_index * nq_r
        out = out[:, :, q0:q0 + nq_r]
    y = torch.einsum("bshk,hkd->bsd", out, L.local("wo"))
    if split:
        y = mesh_lib.all_reduce(y.contiguous(), "sum", mesh, "model")
    return y, cache_k, cache_v


def _combine(out, lse, mesh, axes):
    """The whole cache's attention from each rank's block: out (b, 1, nq,
    hd) and lse (b, nq) of its rows; M = the max of lse over `axes`, w =
    e^(lse − M), out = Σ w·out / Σ w (one all-reduce of both sums), in
    f32. A block with no rows (lse = −inf) weighs 0."""
    b, _, nq, hd = out.shape
    m = mesh_lib.all_reduce(lse.clone(), "max", mesh, axes)
    w = torch.exp(lse - m)
    buf = torch.cat([(out[:, 0].float() * w[..., None]).reshape(b, -1), w],
                    dim=1)
    mesh_lib.all_reduce(buf, "sum", mesh, axes)
    num, den = buf[:, :nq * hd].reshape(b, nq, hd), buf[:, nq * hd:]
    return (num / den[..., None])[:, None]


def _head_block(L, key: str, dim: int, h0: int, h1: int):
    """Heads [h0, h1) of weight `key` along `dim`: the rank's own block
    where it is exactly that, else cut from the weight whole over
    "model"."""
    if L.on_model(key, dim):
        n = L.p[key].shape[dim]
        if h0 == L.model_index * n and h1 - h0 == n:
            return L.local(key)
        return L.whole(key).narrow(dim, h0, h1 - h0)
    return L.local(key).narrow(dim, h0, h1 - h0)


def _head_range(L, cfg: ModelConfig, nh: int, head_axes):
    """(h0, h1): the real heads [h0, h1) among the rank's `nh` padded heads
    of a cache split over `head_axes` ("model", or none); empty past the
    real ones."""
    start = L.mesh.index(head_axes) * nh if head_axes else 0
    return min(start, cfg.num_heads), min(start + nh, cfg.num_heads)


def _head_proj(L, x, key: str, bias: str, h0: int, h1: int):
    """`key`'s projection of x on heads [h0, h1). A rank with none of them
    (h1 = h0) still takes part in its weight's gathers."""
    t = torch.einsum("bsd,dhk->bshk", x, _head_block(L, key, 1, h0, h1))
    if bias in L.p:
        t = t + _head_block(L, bias, 0, h0, h1)
    return t


def _pad_heads(t, nh: int):
    """t (b, s, h, hd) with zero heads after its own to `nh`, as the
    reference pads."""
    pad = t.new_zeros(t.shape[:2] + (nh - t.shape[2], t.shape[3]))
    return torch.cat([t, pad], dim=2)


def _head_out(L, cfg: ModelConfig, out, h0: int, h1: int, head_axes):
    """The real heads [h0, h1) of an attention output through their rows
    of `wo`, summed over `head_axes` where the heads are split."""
    y = torch.einsum("bshk,hkd->bsd", out[:, :, :h1 - h0],
                     _head_block(L, "wo", 0, h0, h1))
    if head_axes:
        y = mesh_lib.all_reduce(y.contiguous(), "sum", L.mesh, head_axes)
    return y


def _head_decode(L, cfg: ModelConfig, x, cache_k, cache_v, index: int,
                 positions, head_axes):
    """MHA-padded decode over a cache of padded heads split over
    `head_axes` ("model", or none): the rank computes q, k and v of its
    real heads [h0, min(h0 + nh, num_heads)), zero past them as the
    reference pads, writes them at `index`, attends its heads and puts
    its real heads through their rows of `wo`; the outputs are summed over
    "model" where the heads are split. No combine: every rank holds all
    rows of its heads."""
    nh = cache_k.shape[2]
    h0, h1 = _head_range(L, cfg, nh, head_axes)
    q, k, v = (_head_proj(L, x, w, bias, h0, h1) for w, bias in
               (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    if "q_norm" in L.p:
        q = rms_norm(q, L.local("q_norm"), cfg.norm_eps)
        k = rms_norm(k, L.local("k_norm"), cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q, k, v = (_pad_heads(t, nh) for t in (q, k, v))
    _write_row(cache_k, cache_v, k, v, index)
    out = decode_ops.decode_attention(q, cache_k, cache_v, index)
    return _head_out(L, cfg, out, h0, h1, head_axes), cache_k, cache_v


def cross_attention(p: Params, cfg: ModelConfig, x, enc_kv):
    """Decoder cross-attention over a whole sequence (whisper's prefill):
    q from x without bias or RoPE, `enc_kv` = (k, v) from `encode_kv`,
    every key visible; the plain `sdpa`, as in the reference. Under `with
    mesh:` q on the rank's q heads, `enc_kv` on the same heads (what
    `encode_kv` gives there), `wo` row-parallel and summed over "model";
    heads that "model" does not divide: the layer whole on every rank."""
    mesh = mesh_lib.state_mesh()
    if mesh is not None:
        L = Blocks(mesh, p, attention_params, cfg, cross=True)
        if L.on_model("wq", 1):
            xin = mesh_lib.from_stream(x, mesh)
            q = torch.einsum("bsd,dhk->bshk", xin, L.local("wq"))
            return _tp_out(L, sdpa(q, *enc_kv))
        xw = mesh_lib.from_stream(x, mesh, same=True)
        return mesh_lib.to_stream(_cross(L.all_whole(), cfg, xw, enc_kv),
                                  mesh, same=True)
    return _cross(p, cfg, x, enc_kv)


def _cross(p: Params, cfg: ModelConfig, x, enc_kv):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k, v = _repeat_kv(cfg, *enc_kv)
    out = sdpa(q, k, v)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def cross_decode_attention(p: Params, cfg: ModelConfig, x, cross_k,
                           cross_v, head_axes=()):
    """Decode-time cross-attention: one query a sequence over every row of
    the fixed (b, enc_len, nkv, hd) cross cache, through the
    `decode_attention` kernel at cache_index = enc_len − 1 (the reference
    runs its `cross_attention`, the same function). Under `with mesh:` on
    the rank's block of the cross cache: an MHA-padded cache holds the
    rank's padded heads over `head_axes` (the self cache's head axis), and
    the rank attends the real ones among them as `_head_decode` does; a
    cache whose heads are whole takes the kv heads of the rank's q heads,
    `wo` row-parallel and summed over "model"."""
    index = cross_k.shape[1] - 1
    mesh = mesh_lib.state_mesh()
    if mesh is None:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        out = decode_ops.decode_attention(q, cross_k, cross_v, index)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])
    L = Blocks(mesh, p, attention_params, cfg, cross=True)
    if cfg.mha_padded:
        nh = cross_k.shape[2]
        h0, h1 = _head_range(L, cfg, nh, head_axes)
        q = _pad_heads(_head_proj(L, x, "wq", "bq", h0, h1), nh)
        out = decode_ops.decode_attention(q, cross_k, cross_v, index)
        return _head_out(L, cfg, out, h0, h1, head_axes)
    if not L.on_model("wq", 1):
        w = L.all_whole()
        q = torch.einsum("bsd,dhk->bshk", x, w["wq"])
        out = decode_ops.decode_attention(q, cross_k, cross_v, index)
        return torch.einsum("bshk,hkd->bsd", out, w["wo"])
    q = torch.einsum("bsd,dhk->bshk", x, L.local("wq"))
    k, v = _rank_kv(L, cfg, cross_k, cross_v, q.shape[2])
    out = decode_ops.decode_attention(q, k, v, index)
    y = torch.einsum("bshk,hkd->bsd", out, L.local("wo"))
    return mesh_lib.all_reduce(y.contiguous(), "sum", mesh, "model")


def encode_kv(p: Params, cfg: ModelConfig, enc_out):
    """The cross-attention's k and v (b, enc_len, nkv, hd) of the encoder
    output, on the real heads (the reference pads an MHA-padded config's
    with zero heads). Under `with mesh:` `enc_out` is whole on the rank as
    `encoder_output` gives it, and k and v are on the kv heads of the
    rank's q heads, repeated to them (`cross_attention`'s operands):
    computed as `_tp_qkv` computes them and cut; heads that "model" does
    not divide: whole on every rank."""
    mesh = mesh_lib.state_mesh()
    if mesh is not None:
        L = Blocks(mesh, p, attention_params, cfg, cross=True)
        if L.on_model("wq", 1):
            k, v = _tp_kv(L, enc_out, "wk"), _tp_kv(L, enc_out, "wv")
            nq = L.p["wq"].shape[1]
            return _repeat_kv(cfg, k, v, L.model_index * nq, nq)
        p = L.all_whole()
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    return k, v


def encoder_output(enc, cfg: ModelConfig):
    """The audio family's encoder output (the stream after `enc_norm`)
    whole on the rank, entering every decoder layer's `encode_kv` once
    (the reference's `_FULL`): gathered over "model" from a split stream,
    through `copy_to_group` from a whole one; as the rank computed it
    where "model" does not divide the cross-attention's heads (`encode_kv`
    then computes whole on every rank). Outside a mesh, `enc`."""
    mesh = mesh_lib.state_mesh()
    if mesh is None:
        return enc
    L = Blocks(mesh, {}, attention_params, cfg, cross=True)
    return mesh_lib.from_stream(enc, mesh, same=not L.on_model("wq", 1))


def cross_cache_block(p: Params, cfg: ModelConfig, enc_out, nh: int,
                      head_axes=()):
    """(k, v) of one decoder layer's block of the cross cache, `nh` heads:
    `encode_kv` of the encoder output on the real heads among kv heads
    [h0, h0 + nh), zero after them (a cache of padded heads), where h0 is
    the rank's block over `head_axes` (0 off the mesh or where the heads
    are whole). For serving: under `with mesh:` the weights are taken
    whole."""
    mesh = mesh_lib.state_mesh()
    if mesh is not None:
        L = Blocks(mesh, p, attention_params, cfg, cross=True)
        p = {key: L.whole(key) for key in ("wk", "wv")}
    h0 = mesh.index(head_axes) * nh if head_axes else 0
    h1 = max(h0, min(h0 + nh, cfg.num_kv_heads))
    return tuple(_pad_heads(torch.einsum("bsd,dhk->bshk", enc_out,
                                         p[key][:, h0:h1]), nh)
                 for key in ("wk", "wv"))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(cfg: ModelConfig, gated: bool = True) -> Params:
    """The MLP: gated (the reference's default) or, for the audio family,
    without the gate."""
    d, ff = cfg.d_model, cfg.d_ff
    p = {
        "w_in": ParamSpec((d, ff), cfg.param_dtype, ("embed", "mlp"),
                          "fan_in"),
        "w_out": ParamSpec((ff, d), cfg.param_dtype, ("mlp", "embed"),
                           "fan_in"),
    }
    if gated:
        p["w_gate"] = ParamSpec((d, ff), cfg.param_dtype, ("embed", "mlp"),
                                "fan_in")
    return p


def gelu(x):
    """`jax.nn.gelu`, whose default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(p: Params, x, act=F.silu, cfg: ModelConfig = None):
    """act(x·w_gate) · (x·w_in), or act(x·w_in) without a gate; then
    ·w_out. Under `with mesh:` (which needs `cfg`): the stream's positions
    whole, column-parallel over "mlp", `w_out` row-parallel and summed
    over "model" into the stream's layout."""
    mesh = mesh_lib.state_mesh()
    if mesh is None:
        return _mlp(p, x, act)
    L = Blocks(mesh, p, mlp_params, cfg, gated="w_gate" in p)
    if not L.on_model("w_in", 1):
        return mesh_lib.to_stream(_mlp(L.all_whole(), mesh_lib.from_stream(
            x, mesh, same=True), act), mesh, same=True)
    xin = mesh_lib.from_stream(x, mesh)
    h = xin @ L.local("w_in")
    h = act(xin @ L.local("w_gate")) * h if "w_gate" in p else act(h)
    return mesh_lib.to_stream(h @ L.local("w_out"), mesh)


def _mlp(p: Params, x, act):
    h = x @ p["w_in"]
    h = act(x @ p["w_gate"]) * h if "w_gate" in p else act(h)
    return h @ p["w_out"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_params(cfg: ModelConfig) -> Params:
    vp, d = cfg.padded_vocab(), cfg.d_model
    return {
        "embedding": ParamSpec((vp, d), cfg.param_dtype, ("vocab", "embed"),
                               "normal"),
        "lm_head": ParamSpec((vp, d), cfg.param_dtype, ("vocab", "embed"),
                             "fan_in"),
    }


def embed(p: Params, tokens, cfg: ModelConfig = None):
    """The tokens' rows of the embedding. Under `with mesh:` (which needs
    `cfg`) each rank looks up the tokens in its vocab rows, zeros the
    others, and the rows are summed over "model": reduce-scattered onto
    the rank's positions where the stream starts split."""
    mesh = mesh_lib.state_mesh()
    if mesh is None:
        return p["embedding"][tokens.long()]
    L = Blocks(mesh, p, embed_params, cfg)
    if not L.on_model("embedding", 0):
        return mesh_lib.to_stream(L.whole("embedding")[tokens.long()], mesh,
                                  same=True)
    table = L.local("embedding")
    n = table.shape[0]
    t = tokens.long() - L.model_index * n
    inside = (t >= 0) & (t < n)
    rows = table[t.clamp(0, n - 1)].masked_fill(~inside[..., None], 0)
    return mesh_lib.to_stream(rows, mesh)


def head_input(x, cfg: ModelConfig):
    """The final hidden state (the stream after the final norm) whole on
    the rank, entering `unembed` and the vocab-parallel loss once (the
    reference's `_FULL`): gathered over "model" from a split stream,
    through `copy_to_group` from a whole one; as it is where "model" does
    not split the vocab (the unembedding then computes whole on every
    rank). Outside a mesh, `x`."""
    mesh = mesh_lib.state_mesh()
    if mesh is None:
        return x
    L = Blocks(mesh, {}, embed_params, cfg)
    return mesh_lib.from_stream(x, mesh, same=not L.on_model("lm_head", 0))


def unembed(p: Params, x, cfg: ModelConfig = None):
    """x · lm_headᵀ. Under `with mesh:` (which needs `cfg`) the logits of
    the rank's vocab block (`vocab_block` says which) when "model" splits
    the vocab, x whole on the rank as `head_input` gives it."""
    mesh = mesh_lib.state_mesh()
    if mesh is None:
        return x @ p["lm_head"].T
    L = Blocks(mesh, p, embed_params, cfg)
    if not L.on_model("lm_head", 0):
        return x @ L.whole("lm_head").T
    return x @ L.local("lm_head").T


def vocab_block(cfg: ModelConfig, mesh) -> slice:
    """The padded-vocab columns of `unembed`'s logits on this rank."""
    vp = cfg.padded_vocab()
    L = Blocks(mesh, {}, embed_params, cfg)
    if not L.on_model("lm_head", 0):
        return slice(0, vp)
    n = vp // L.model_size
    return slice(L.model_index * n, (L.model_index + 1) * n)
