"""Reduces a profiled slice of the window to plain records (the method of
`chip_smoke.py`'s `_device_time`, with intervals in place of sums):

  busy_s       the union of the device operations' intervals (kernels,
               copies, sets), so overlapping operations count once;
  device_ops   seconds a device operation by name, the most first;
  kernels      launches and seconds of the kernels whose name holds each
               of `KERNELS`;
  range_counts the benchmark's `record_function` ranges in the slice;
  idle_gaps    the device's idle seconds between operations, by what the
               host was inside at the gap's middle;
  launches     the multi-view kernel's launches: (union rows, window rows,
               views, width) from the windows each was given.
"""
from __future__ import annotations

import numpy as np

from hazy_bench.client import RANGE

KERNELS = {"mv_band_reclassify": "mv_band_reclassify_kernel"}
DEPTH = {"commit": 0, "point_read": 0, "members": 0, "apply_models": 1,
         "reorganize": 2}
HOST = {"commit": "host training (commit outside apply_models)",
        "point_read": "point read", "members": "All-Members read",
        "apply_models": "driver (apply_models outside reorganize)",
        "reorganize": "reorganize", None: "client loop (between calls)"}


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged [start, end) rows of an (m, 2) array."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, np.int64)


class _Ranges:
    """Innermost benchmark range at a host time, by nesting depth."""

    def __init__(self, ranges):
        self.levels = []
        for depth in sorted(set(DEPTH.values()), reverse=True):
            rs = sorted((s, e, name) for name, s, e in ranges
                        if DEPTH[name] == depth)
            self.levels.append((np.array([r[0] for r in rs], np.int64),
                                np.array([r[1] for r in rs], np.int64),
                                [r[2] for r in rs]))

    def at(self, t: np.ndarray) -> list:
        """The name of the innermost range holding each time; None where
        no range does."""
        names = [None] * len(t)
        for starts, ends, rn in self.levels:
            if not len(starts):
                continue
            j = np.searchsorted(starts, t, side="right") - 1
            hit = (j >= 0) & (ends[np.maximum(j, 0)] > t)
            for i in np.flatnonzero(hit):
                if names[i] is None:
                    names[i] = rn[j[i]]
        return names


def _union_rows(starts: np.ndarray, widths: np.ndarray) -> int:
    iv = np.stack([starts, starts + widths], 1)[widths > 0]
    u = _union(iv)
    return int((u[:, 1] - u[:, 0]).sum()) if len(u) else 0


def reduce(prof, slice_s: float, launches: list) -> dict:
    from torch.autograd import DeviceType
    dev, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(RANGE):     # a range's device-side span
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            name))
        elif name.startswith(RANGE):
            ranges.append((name[len(RANGE):], e.start_ns(),
                           e.start_ns() + e.duration_ns()))
    iv = np.array([(s, t) for s, t, _ in dev], np.int64).reshape(-1, 2)
    busy = _union(iv)
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9 if len(busy) else 0.0

    by_name = {}
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0) + (t - s)
    device_ops = sorted(([n, v / 1e9] for n, v in by_name.items()),
                        key=lambda x: -x[1])
    kernels = {}
    for label, match in KERNELS.items():
        sel = [t - s for s, t, name in dev if match in name]
        kernels[label] = (len(sel), sum(sel) / 1e9)

    counts = {}
    for name, _, _ in ranges:
        counts[name] = counts.get(name, 0) + 1
    gaps = {}
    if len(busy) > 1:
        g0, g1 = busy[:-1, 1], busy[1:, 0]
        gnames = _Ranges(ranges).at((g0 + g1) // 2)
        for n, d in zip(gnames, g1 - g0):
            gaps[HOST[n]] = gaps.get(HOST[n], 0) + int(d)
    idle_gaps = sorted(([n, v / 1e9] for n, v in gaps.items()),
                       key=lambda x: -x[1])

    rows = []
    if launches:
        import torch
        sb = torch.stack([x[0] for x in launches]).cpu().numpy()
        wd = torch.stack([x[1] for x in launches]).cpu().numpy()
        for j, (_, _, block_n, d) in enumerate(launches):
            starts = sb[j].astype(np.int64) * block_n
            w = wd[j].astype(np.int64)
            rows.append((_union_rows(starts, w), int(w.sum()), len(w), d))
    return {"busy_s": busy_s, "window_s": slice_s,
            "device_ops": device_ops, "kernels": kernels,
            "range_counts": counts, "device_events": len(dev),
            "idle_gaps": idle_gaps,
            "launches": rows}
