"""Carry reference state across to the port, so that both packages
continue from the same point: the k-view engine with its facade
(`from_reference`), the single-view engine (`single_view_from_reference`),
the host engine shells (`hazy_from_reference`,
`multiview_from_reference`), Layer 2's `EngineState`
(`engine_state_from_reference`), an LM's parameters
(`params_from_reference`), its decode cache (`cache_from_reference`) and
its train state (`train_state_from_reference`).

The state arrives as numpy arrays (the fields of the reference's
`ShardedMultiViewState` or `ShardedHazyState`, the leaves of its params or
cache tree, the attributes of a host engine) plus the host driver's and
facade's state as plain values; nothing here imports the reference
package.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.engine import EngineState
from repro_torch.core.facade import ShardedFacade
from repro_torch.core.hazy import HazyEngine, Stats
from repro_torch.core.linear_model import LinearModel
from repro_torch.core.multiview import MultiViewEngine
from repro_torch.core.skiing import Skiing
from repro_torch.core.waters import Waters
from repro_torch.core.sharded import (ShardedHazy, ShardedHazyState,
                                      ShardedMultiViewHazy,
                                      ShardedMultiViewState)
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.models.params import ParamSpec
from repro_torch.optim import opt_specs, tree_leaves

STATE_DTYPES = {"F": np.float32, "gids": np.int32, "eps": np.float32,
                "labels": np.int8, "W_stored": np.float32,
                "b_stored": np.float32, "lw": np.float32, "hw": np.float32}
SINGLE_VIEW_DTYPES = {"F": np.float32, "eps": np.float32, "labels": np.int8,
                      "perm": np.int32, "w_stored": np.float32,
                      "b_stored": np.float32, "lw": np.float32,
                      "hw": np.float32}


def _blocks(state_np, dtypes, index):
    """Each field of `state_np` as a contiguous array of its dtype, cut
    by `index[field]` where given (a rank's block)."""
    return {f: np.ascontiguousarray(
        np.asarray(state_np[f])[index.get(f, ())], dt)
        for f, dt in dtypes.items()}


def from_reference(state_np: Mapping[str, np.ndarray],
                   host_np: Mapping[str, object],
                   device=None, mesh=None) -> ShardedFacade:
    """The port's `ShardedFacade` continuing from a reference state: its
    `.state` holds the device arrays (same shared order, same f32 stored
    models), its `.driver` the host waters (f64), SKIING counters and
    overflow count, and the facade the host models (W f32, b f64). The
    entity-order feature copy is rebuilt from the scratch rows and gids.
    With `mesh`, the state is the reference's gathered to numpy and the
    rank keeps its block of rows (the reference's layout on a mesh of
    the same shape)."""
    F_s = np.asarray(state_np["F"], np.float32)
    gids = np.asarray(state_np["gids"], np.int32)
    n, d = F_s.shape
    k = np.asarray(state_np["labels"]).shape[0]
    if sorted(gids.tolist()) != list(range(n)):
        raise ValueError("gids must be a permutation of the entity ids")
    driver = ShardedMultiViewHazy(
        n=n, d=d, k=k, M=float(host_np["M"]), p=float(host_np["p"]),
        alpha=float(host_np["alpha"]), cap_frac=float(host_np["cap_frac"]),
        device=device, mesh=mesh)
    rows = driver.rows
    state = ShardedMultiViewState(**{
        f: driver._put(a) for f, a in _blocks(state_np, STATE_DTYPES, {
            "F": rows, "gids": rows, "eps": (slice(None), rows),
            "labels": (slice(None), rows)}).items()})
    driver.restore(host_np["lw"], host_np["hw"],
                   Skiing(S=1.0, alpha=driver.alpha,
                          a=float(host_np["skiing_a"]),
                          reorgs=int(host_np["reorgs"]),
                          total_incremental=float(
                              host_np["total_incremental"])),
                   host_np["overflows"])
    F = np.empty_like(F_s)
    F[gids] = F_s
    return ShardedFacade(driver, F, state, lr=float(host_np["lr"]),
                         l2=float(host_np["l2"]), W=host_np["W"],
                         b=host_np["b"])


def single_view_from_reference(state_np: Mapping[str, np.ndarray],
                               host_np: Mapping[str, object],
                               device=None, mesh=None):
    """The port's `ShardedHazy` and `ShardedHazyState` continuing from a
    reference single-view state: the device arrays in the same eps-sorted
    order (`perm`, f32 stored model), and the driver's host state — waters
    `lw`/`hw` (Python floats), SKIING `skiing_a`, `reorgs`,
    `total_incremental`, and `M`, `p`, `alpha`, `cap_frac`. `overflows`
    is optional (the reference driver does not count them). With `mesh`,
    the state is the reference's gathered to numpy and the rank keeps its
    block of rows and columns."""
    F = np.asarray(state_np["F"])
    perm = np.asarray(state_np["perm"], np.int32)
    n, d = F.shape
    if sorted(perm.tolist()) != list(range(n)):
        raise ValueError("perm must be a permutation of the entity ids")
    driver = ShardedHazy(
        n=n, d=d, M=float(host_np["M"]), p=float(host_np["p"]),
        alpha=float(host_np["alpha"]), cap_frac=float(host_np["cap_frac"]),
        device=device, mesh=mesh)
    rows, cols = driver.rows, driver.cols
    state = ShardedHazyState(**{
        f: driver._put(a) for f, a in _blocks(
            state_np, SINGLE_VIEW_DTYPES, {
                "F": (rows, cols), "eps": rows, "labels": rows,
                "perm": rows, "w_stored": cols}).items()})
    driver.restore(host_np["lw"], host_np["hw"],
                   Skiing(S=1.0, alpha=driver.alpha,
                          a=float(host_np["skiing_a"]),
                          reorgs=int(host_np["reorgs"]),
                          total_incremental=float(
                              host_np["total_incremental"])),
                   host_np.get("overflows", 0),
                   w_stored=state_np["w_stored"])
    return driver, state


def engine_state_from_reference(state, device=None) -> EngineState:
    """The port's Layer 2 `EngineState` from the reference's (numpy or
    jax arrays): the host fields as numpy (W f32, b and the waters
    float64), the bulk fields (F, eps_sorted, perm, inv_perm, labels) as
    tensors on `device` (None means the GPU)."""
    dev = resolve_device(device)

    def host(name, dtype):
        return np.array(getattr(state, name), dtype)

    def put(name, dtype):
        return torch.tensor(host(name, dtype), device=dev)

    return EngineState(
        F=put("F", np.float32), W=host("W", np.float32),
        b=host("b", np.float64), W_stored=host("W_stored", np.float32),
        b_stored=host("b_stored", np.float64), lw=host("lw", np.float64),
        hw=host("hw", np.float64), eps_sorted=put("eps_sorted", np.float32),
        perm=torch.tensor(_checked_perm(state.perm), device=dev),
        inv_perm=put("inv_perm", np.int64), labels=put("labels", np.int8),
        pos_count=host("pos_count", np.int64),
        pending=host("pending", bool), acc=host("acc", np.float64),
        buffer_lo=host("buffer_lo", np.int64),
        buffer_hi=host("buffer_hi", np.int64))


def _model(m) -> LinearModel:
    return LinearModel(np.array(m.w, np.float32), float(m.b))


def _checked_perm(perm) -> np.ndarray:
    """perm (position -> entity id, along the last axis) as int64; raises
    unless each row is a permutation of the entity ids."""
    perm = np.asarray(perm, np.int64)
    rows = perm.reshape(-1, perm.shape[-1])
    if any(sorted(r.tolist()) != list(range(rows.shape[1])) for r in rows):
        raise ValueError("perm must be a permutation of the entity ids")
    return perm


def _no_store(engine):
    if getattr(engine, "store", None) is not None:
        raise NotImplementedError("an engine over a storage tier is not "
                                  "carried across: build the port's engine "
                                  "over its own BufferPool")


def hazy_from_reference(engine, device=None) -> HazyEngine:
    """The port's `HazyEngine` continuing from a reference `HazyEngine`
    (its attributes read as numpy arrays and plain values): the same
    features, policy, cost mode and options; the current, stored and
    pending model, the waters, the SKIING state, the statistics, `perm`,
    `eps_sorted`, the labels, the hot-buffer window and the probe
    counters. The measured-cost telemetry (`cost`) starts afresh."""
    _no_store(engine)
    eng = HazyEngine(np.asarray(engine.F, np.float32),
                     p=engine.waters.p, alpha=engine.skiing.alpha,
                     policy=engine.policy, cost_mode=engine.cost_mode,
                     touch_ns=engine.touch_ns,
                     buffer_frac=engine.buffer_frac, device=device)
    sk = engine.skiing
    eng.restore(
        _checked_perm(engine.perm), engine.eps_sorted, engine.labels_sorted,
        M=float(engine.M),
        waters=Waters(p=engine.waters.p, M=float(engine.M),
                      lw=float(engine.waters.lw), hw=float(engine.waters.hw)),
        model=_model(engine.model), stored=_model(engine.stored),
        _pending=(None if engine._pending is None
                  else _model(engine._pending)),
        skiing=Skiing(S=float(sk.S), alpha=float(sk.alpha), a=float(sk.a),
                      reorgs=int(sk.reorgs),
                      total_incremental=float(sk.total_incremental)),
        stats=Stats(**dataclasses.asdict(engine.stats)),
        sigma=float(engine.sigma), _buffer_lo=int(engine._buffer_lo),
        _buffer_hi=int(engine._buffer_hi),
        disk_touches=int(engine.disk_touches))
    return eng


MULTIVIEW_HOST = ("W_stored", "b_stored", "lw", "hw", "pending",
                  "_waters_stale", "lazy_waste", "buffer_lo", "buffer_hi",
                  "hybrid_hits", "S", "acc", "reorg_counts")


def multiview_from_reference(engine, device=None) -> MultiViewEngine:
    """The port's `MultiViewEngine` continuing from a reference
    `MultiViewEngine` (its attributes read as numpy arrays and plain
    values): the same features, views, policy, cost mode and options; the
    current and stored models, the waters, the SKIING state (S, acc,
    reorg counts), pending and stale masks, lazy waste, statistics,
    `perm`, `eps_sorted`, the labels, the hot-buffer windows and the probe
    counters. The measured-cost telemetry (`cost`) starts afresh."""
    _no_store(engine)
    eng = MultiViewEngine(np.asarray(engine.F, np.float32), engine.k,
                          p=engine.p, alpha=engine.alpha,
                          policy=engine.policy, cost_mode=engine.cost_mode,
                          touch_ns=engine.touch_ns,
                          buffer_frac=engine.buffer_frac, device=device)
    eng.restore(
        _checked_perm(engine.perm), engine.eps_sorted, engine.labels_sorted,
        M=float(engine.M), W=np.array(engine.W, np.float32),
        b=np.array(engine.b, np.float64),
        _waters_dirty=bool(engine._waters_dirty), sigma=float(engine.sigma),
        stats=Stats(**dataclasses.asdict(engine.stats)),
        disk_touches=int(engine.disk_touches),
        **{name: np.array(getattr(engine, name)) for name in MULTIVIEW_HOST})
    return eng


def _tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor; bf16 and f8 e4m3fn arrays (numpy's
    extension types, which `torch.from_numpy` does not take) are carried
    bit for bit."""
    a = np.asarray(a)
    a = np.ascontiguousarray(a) if a.ndim else a.copy()   # keeps 0-d as 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _tree_from_reference(specs, tree_np, device, path="") -> dict:
    """The reference tree's leaves as tensors on `device` in each spec's
    dtype; raises unless the tree has exactly the specs' keys and shapes."""
    if isinstance(specs, ParamSpec):
        t = _tensor(tree_np)
        if tuple(t.shape) != specs.shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                             f"{specs.shape}")
        return t.to(device=device, dtype=specs.dtype)
    if not isinstance(tree_np, Mapping) or set(tree_np) != set(specs):
        got = sorted(tree_np) if isinstance(tree_np, Mapping) else tree_np
        raise ValueError(f"{path or 'tree'}: keys {got} != {sorted(specs)}")
    return {k: _tree_from_reference(specs[k], tree_np[k], device,
                                    f"{path}.{k}".lstrip("."))
            for k in specs}


def params_from_reference(params_np: Mapping, cfg, device=None) -> dict:
    """The port's params from the reference's params tree (numpy leaves):
    for tinyllama-1.1b `tok.{embedding, lm_head}`, `blocks.pos0.{ln1,ln2,
    attn.{wq,wk,wv,wo},mlp.{w_in,w_gate,w_out}}` stacked on a leading
    22-layer axis, and `final_norm`; for rwkv6-3b also `ln0`, and
    `blocks.pos0.{tm,cm}` in place of attn and mlp; for the moe family
    `moe.{router,we_in,we_gate,we_out,shared_i}` in place of mlp; for
    jamba one `pos{i}` per position of its layer plan, with `mixer` (the
    mamba block) in place of attn at the mamba positions; for whisper
    `enc_blocks.{ln1,ln2,attn,mlp}`, `enc_norm` and
    `dec_blocks.{ln1,ln_x,ln2,attn,xattn,mlp}` (layer norms with bias, the
    MLP without a gate). The layouts are the same, so each leaf carries
    across as it is."""
    return _tree_from_reference(build(cfg).param_tree, params_np,
                                resolve_device(device))


def _unpad_kv_heads(a, cfg, path):
    """The reference's k or v cache of an MHA-padded config (kv heads
    padded to `cfg.padded_heads`, the extra heads zero) cut to the port's
    `num_kv_heads`; raises if a padded head holds anything but zeros."""
    a = np.asarray(a)
    nkv = cfg.num_kv_heads
    if a.ndim != 5 or a.shape[3] != cfg.padded_heads:
        return a                    # the shape check reports it
    if np.any(a[:, :, :, nkv:].astype(np.float32) != 0):
        raise ValueError(f"{path}: padded kv heads {nkv}..."
                         f"{cfg.padded_heads - 1} are not all zero")
    return a[:, :, :, :nkv]


def _unpad_group(group, cfg, path):
    """A {k, v, ...} node with its k and v cut to the real heads."""
    if not cfg.mha_padded:
        return group
    return {k: (_unpad_kv_heads(a, cfg, f"{path}.{k}")
                if k in ("k", "v") else a) for k, a in group.items()}


def cache_from_reference(cache_np: Mapping, cfg, device=None) -> dict:
    """The port's decode cache from the reference's: `{"blocks":
    {"pos{i}": ...}}` stacked on blocks (k/v (n_blocks, b, S, nkv, hd) at
    attention positions, the mamba state {h, conv} at mamba positions,
    the RWKV state {S, last, cm_last} for the ssm family) or, for the
    audio family, `{"dec": {"self": {k, v}, "cross": {k, v}}}` stacked on
    decoder layers. An f8 cache carries across byte for byte. For an
    MHA-padded config (`cfg.mha_padded`) the reference holds
    `cfg.padded_heads` kv heads, the extra ones zero (`project_qkv` and
    `encode_kv` pad k and v); they are checked and cut off, since the port
    attends over the real heads only."""
    if "dec" in cache_np:
        dec = {name: _unpad_group(group, cfg, f"dec.{name}")
               for name, group in cache_np["dec"].items()}
        b, S = np.shape(dec["self"]["k"])[1:3]
        tree = {"dec": dec}
    else:
        blocks = dict(cache_np["blocks"])
        b = np.shape(next(iter(blocks["pos0"].values())))[1]
        S = 0
        for pos, block in blocks.items():
            if "k" in block:
                S = np.shape(block["k"])[2]
                blocks[pos] = _unpad_group(block, cfg, f"blocks.{pos}")
        tree = {**cache_np, "blocks": blocks}
    return _tree_from_reference(build(cfg).cache_specs(b, S), tree,
                                resolve_device(device))


def train_state_from_reference(state_np: Mapping, cfg, device=None) -> dict:
    """The port's train state (`models.steps.init_train_state`'s tree) from
    the reference's (numpy leaves): `params` through
    `params_from_reference`, marked to require grad; the AdamW moments
    `opt.m` and `opt.v` (f32) on the same paths; `opt.count` and `step`
    (int32 0-d). The parameter layouts are equal (an MHA-padded config
    pads only its caches), so each leaf carries across as it is."""
    device = resolve_device(device)
    params = params_from_reference(state_np["params"], cfg, device)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    specs = opt_specs(build(cfg).param_tree)
    return {"params": params,
            "opt": _tree_from_reference(specs, state_np["opt"], device,
                                        "opt"),
            "step": _tree_from_reference(specs["count"], state_np["step"],
                                         device, "step")}
