"""Carry a reference device engine across to the port, so that both
packages continue from the same point: the k-view engine with its facade
(`from_reference`) or the single-view engine (`single_view_from_reference`).

The state arrives as numpy arrays (the fields of the reference's
`ShardedMultiViewState` or `ShardedHazyState`) plus the host driver's and
facade's state as plain values; nothing here imports the reference package.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from repro_torch.core.facade import ShardedFacade
from repro_torch.core.skiing import Skiing
from repro_torch.core.sharded import (ShardedHazy, ShardedHazyState,
                                      ShardedMultiViewHazy,
                                      ShardedMultiViewState)

STATE_DTYPES = {"F": np.float32, "gids": np.int32, "eps": np.float32,
                "labels": np.int8, "W_stored": np.float32,
                "b_stored": np.float32, "lw": np.float32, "hw": np.float32}
SINGLE_VIEW_DTYPES = {"F": np.float32, "eps": np.float32, "labels": np.int8,
                      "perm": np.int32, "w_stored": np.float32,
                      "b_stored": np.float32, "lw": np.float32,
                      "hw": np.float32}


def from_reference(state_np: Mapping[str, np.ndarray],
                   host_np: Mapping[str, object],
                   device=None) -> ShardedFacade:
    """The port's `ShardedFacade` continuing from a reference state: its
    `.state` holds the device arrays (same shared order, same f32 stored
    models), its `.driver` the host waters (f64), SKIING counters and
    overflow count, and the facade the host models (W f32, b f64). The
    entity-order feature copy is rebuilt from the scratch rows and gids."""
    F_s = np.asarray(state_np["F"], np.float32)
    gids = np.asarray(state_np["gids"], np.int32)
    n, d = F_s.shape
    k = np.asarray(state_np["labels"]).shape[0]
    if sorted(gids.tolist()) != list(range(n)):
        raise ValueError("gids must be a permutation of the entity ids")
    driver = ShardedMultiViewHazy(
        n=n, d=d, k=k, M=float(host_np["M"]), p=float(host_np["p"]),
        alpha=float(host_np["alpha"]), cap_frac=float(host_np["cap_frac"]),
        device=device)
    state = ShardedMultiViewState(**{
        f: driver._put(np.ascontiguousarray(state_np[f], dt))
        for f, dt in STATE_DTYPES.items()})
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
                               device=None):
    """The port's `ShardedHazy` and `ShardedHazyState` continuing from a
    reference single-view state: the device arrays in the same eps-sorted
    order (`perm`, f32 stored model), and the driver's host state — waters
    `lw`/`hw` (Python floats), SKIING `skiing_a`, `reorgs`,
    `total_incremental`, and `M`, `p`, `alpha`, `cap_frac`. `overflows`
    is optional (the reference driver does not count them)."""
    F = np.asarray(state_np["F"])
    perm = np.asarray(state_np["perm"], np.int32)
    n, d = F.shape
    if sorted(perm.tolist()) != list(range(n)):
        raise ValueError("perm must be a permutation of the entity ids")
    driver = ShardedHazy(
        n=n, d=d, M=float(host_np["M"]), p=float(host_np["p"]),
        alpha=float(host_np["alpha"]), cap_frac=float(host_np["cap_frac"]),
        device=device)
    state = ShardedHazyState(**{
        f: driver._put(np.ascontiguousarray(state_np[f], dt))
        for f, dt in SINGLE_VIEW_DTYPES.items()})
    driver.restore(host_np["lw"], host_np["hw"],
                   Skiing(S=1.0, alpha=driver.alpha,
                          a=float(host_np["skiing_a"]),
                          reorgs=int(host_np["reorgs"]),
                          total_incremental=float(
                              host_np["total_incremental"])),
                   host_np.get("overflows", 0))
    return driver, state
