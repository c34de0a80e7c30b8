"""Mamba (selective SSM) block of the port, used by the jamba hybrid
architecture; the counterpart of `repro/models/mamba.py` with its names.

Prefill is the reference's chunked selective scan: a loop over chunks of
the sequence carries the SSM state h (b, d_inner, d_state) f32, and
within a chunk the pairs (dA_t, dB_t·x_t) are scanned under
(a, v) ∘ (a', v') = (a·a', v·a' + v'). The reference scans a chunk with
`lax.associative_scan`; torch has none, so the port runs a log-step
(doubling) scan: after the step of width w each position holds the
composition of the w·2 positions ending at it. The two multiply in
different orders, so they agree to f32 rounding, not bit for bit. dA and
dB·x are formed chunk by chunk (elementwise the reference's values): at
jamba's width a whole (b, s, d_inner, d_state) f32 tensor of an 8 × 2,048
prefill is 8.6 GB. Decode is the one-step recurrence, written into the
layer's state in place. The scan is plain torch: no Pallas kernel of the
reference computes it.

Under `with mesh:` (a state held in blocks) the block splits its d_inner
channels over "model": `in_proj` is gathered over "model" and each rank
takes the u and z columns of its channels (the reference's block of
`in_proj` holds u's channels on one rank and z's on another); the conv,
`dt_proj`, A and D are the rank's channels; `x_proj` is row-parallel, its
output summed over "model" before the dt/B/C split; `out_proj` is
row-parallel and summed. A d_inner the model degree does not divide
computes whole on every rank. On a residual stream split over "model"
(`launch.mesh.stream_split()`) the block runs on the stream's positions
gathered whole (the conv and the scan need every earlier position) and
reduce-scatters its output back, as the reference's mixer does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.params import ParamSpec
from repro_torch.models.sharding import Blocks

Params = Dict[str, Any]


def mamba_params(cfg: ModelConfig) -> Params:
    d, di, ds, k, dtr = (cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state,
                         cfg.mamba_d_conv, cfg.dt_rank)
    pd = cfg.param_dtype
    return {
        "in_proj": ParamSpec((d, 2 * di), pd, ("embed", "mamba_inner"),
                             "fan_in"),
        "conv_w": ParamSpec((k, di), pd, ("conv", "mamba_inner"), "fan_in"),
        "conv_b": ParamSpec((di,), pd, ("mamba_inner",), "zeros"),
        "x_proj": ParamSpec((di, dtr + 2 * ds), pd, ("mamba_inner", None),
                            "fan_in"),
        "dt_proj": ParamSpec((dtr, di), pd, (None, "mamba_inner"), "fan_in"),
        "dt_bias": ParamSpec((di,), "float32", ("mamba_inner",), "zeros"),
        "A_log": ParamSpec((di, ds), "float32", ("mamba_inner", "state"),
                           "ones"),
        "D": ParamSpec((di,), "float32", ("mamba_inner",), "ones"),
        "out_proj": ParamSpec((di, d), pd, ("mamba_inner", "embed"),
                              "fan_in"),
    }


def _ssm_inputs(p: Params, cfg: ModelConfig, u, mesh=None):
    """u (b, s, di) post-conv activations -> (dt (b, s, di), B and C
    (b, s, ds), A (di, ds)), all f32: the factors of the reference's dA =
    exp(dt·A) and dB·x = dt·B·u, which `_discretize` forms. With `mesh`,
    u holds the rank's channels and the x_proj product is summed over
    "model" (then used by every rank's channels alike)."""
    ds, dtr = cfg.mamba_d_state, cfg.dt_rank
    xdbl = u @ p["x_proj"]
    if mesh is not None:
        xdbl = mesh_lib.sum_over_group(xdbl, mesh, "model")
    xdbl = xdbl.float()
    dt, B, C = xdbl.split([dtr, ds, ds], dim=-1)
    dt = torch.logaddexp(dt @ p["dt_proj"].float() + p["dt_bias"],
                         torch.zeros((), device=u.device))    # softplus
    return dt, B, C, -torch.exp(p["A_log"])


def _discretize(dt, B, u, A):
    """dA = exp(dt·A) and dBx = dt·B·u, (b, c, di, ds) f32, for the
    tokens given (a chunk, or one decode token)."""
    dA = torch.exp(dt[..., None] * A)
    dBx = dt[..., None] * B[:, :, None, :] * u.float()[..., None]
    return dA, dBx


def _conv(p: Params, u, conv_state=None):
    """Causal depthwise conv1d over u (b, s, di): the k taps summed in
    u's dtype in the reference's order; `conv_state` (b, k-1, di) holds
    the k-1 inputs before u (zeros without it). Returns (silu(out +
    conv_b), the new state: the last k-1 inputs)."""
    k, s = p["conv_w"].shape[0], u.shape[1]
    if conv_state is None:
        conv_state = torch.zeros_like(u[:, :k - 1])
    ext = torch.cat([conv_state, u], dim=1)             # (b, s+k-1, di)
    out = ext[:, 0:s] * p["conv_w"][0]
    for i in range(1, k):
        out = out + ext[:, i:i + s] * p["conv_w"][i]
    return F.silu(out + p["conv_b"]), ext[:, -(k - 1):]


def _scan(a, v):
    """Inclusive scan along axis 1 of the pairs (a, v) under
    (a, v) ∘ (a', v') = (a·a', v·a' + v'), in log2(c) doubling steps."""
    w, c = 1, a.shape[1]
    while w < c:
        v = torch.cat([v[:, :w], v[:, :-w] * a[:, w:] + v[:, w:]], dim=1)
        a = torch.cat([a[:, :w], a[:, :-w] * a[:, w:]], dim=1)
        w *= 2
    return a, v


def _out(p: Params, y, u, z, dtype):
    """y + D·u gated by silu(z) in f32, cast back, then out_proj."""
    y = y + p["D"] * u.float()
    return (y * F.silu(z.float())).to(dtype) @ p["out_proj"]


def _on_mesh(p: Params, cfg: ModelConfig, x, fn):
    """`fn(weights, u, z, mesh)` on the state mesh's blocks: the rank's
    d_inner channels (its u and z columns of `in_proj` gathered over
    "model") over the stream's positions gathered whole, the result summed
    over "model" into the stream's layout; or every weight whole where
    "model" does not divide d_inner; or `p` itself without a mesh."""
    mesh = mesh_lib.state_mesh()
    if mesh is None:
        u, z = (x @ p["in_proj"]).chunk(2, dim=-1)
        return fn(p, u, z, None)
    L = Blocks(mesh, p, mamba_params, cfg)
    if not L.on_model("conv_b", 0):
        w = L.all_whole()
        x = mesh_lib.from_stream(x, mesh, same=True)
        u, z = (x @ w["in_proj"]).chunk(2, dim=-1)
        return mesh_lib.to_stream(fn(w, u, z, None), mesh, same=True)
    w = {k: L.local(k) for k in p}
    di = cfg.mamba_d_inner
    n = di // L.model_size
    c0 = L.model_index * n
    full = mesh_lib.gather_from_group(w["in_proj"], mesh, "model", 1)
    w_uz = torch.cat([full[:, c0:c0 + n], full[:, di + c0:di + c0 + n]], 1)
    u, z = (mesh_lib.from_stream(x, mesh) @ w_uz).chunk(2, dim=-1)
    return mesh_lib.to_stream(fn(w, u, z, mesh), mesh)


def mamba(p: Params, cfg: ModelConfig, x, chunk: int = 256):
    """Prefill forward. x (b, s, d) -> (b, s, d); s a multiple of
    min(chunk, s). Under `with mesh:`, on the rank's channels."""
    return _on_mesh(p, cfg, x, lambda w, u, z, mesh: _mamba(
        w, cfg, u, z, chunk, mesh))


def _mamba(p: Params, cfg: ModelConfig, u, z, chunk: int, mesh=None):
    """The block after `in_proj` on the channels of u and z."""
    b, s, _ = u.shape
    di, ds = u.shape[-1], cfg.mamba_d_state
    u, _ = _conv(p, u)
    dt, B, C, A = _ssm_inputs(p, cfg, u, mesh)
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    h = torch.zeros((b, di, ds), dtype=torch.float32, device=u.device)
    ys = []
    for c0 in range(0, s, chunk):
        c = slice(c0, c0 + chunk)
        a_cum, v_cum = _scan(*_discretize(dt[:, c], B[:, c], u[:, c], A))
        hs = v_cum + a_cum * h[:, None]                 # (b, chunk, di, ds)
        # contract the state dim per chunk: the (b, s, di, ds) history
        # never materializes
        ys.append(torch.einsum("bcin,bcn->bci", hs, C[:, c]))
        h = hs[:, -1]
    return _out(p, torch.cat(ys, dim=1), u, z, u.dtype)


def mamba_decode(p: Params, cfg: ModelConfig, x, state):
    """One token. x (b, 1, d); state = {"h": (b, di, ds) f32, "conv":
    (b, k-1, di)}, views of the layer's cache, written IN PLACE (the
    reference returns a new state to the same effect). Returns
    y (b, 1, d). Under `with mesh:` the state holds the rank's d_inner
    channels ("mamba_inner"), as the block's weights do."""
    return _on_mesh(p, cfg, x, lambda w, u, z, mesh: _mamba_decode(
        w, cfg, x, u, z, state, mesh))


def _mamba_decode(p: Params, cfg: ModelConfig, x, u, z, state, mesh=None):
    u, conv_state = _conv(p, u, state["conv"])
    dt, B, C, A = _ssm_inputs(p, cfg, u, mesh)
    dA, dBx = _discretize(dt, B, u, A)
    h = state["h"] * dA[:, 0] + dBx[:, 0]               # (b, di, ds)
    y = torch.einsum("bin,bn->bi", h, C[:, 0])[:, None]
    state["h"].copy_(h)
    state["conv"].copy_(conv_state)
    return _out(p, y, u, z, x.dtype)


def mamba_state_specs(cfg: ModelConfig, batch: int):
    di, ds, k = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {
        "h": ParamSpec((batch, di, ds), "float32",
                       ("batch", "mamba_inner", "state"), "zeros"),
        "conv": ParamSpec((batch, k - 1, di), cfg.param_dtype,
                          ("batch", None, "mamba_inner"), "zeros"),
    }
