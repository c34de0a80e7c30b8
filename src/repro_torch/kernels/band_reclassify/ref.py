"""Plain PyTorch versions of band_reclassify, the counterpart of the
reference's dynamic-slice oracle (`repro/kernels/band_reclassify/ref.py`).
They return new label tensors; the CPU path of `ops` and the CUDA kernels'
checks use them. `band_reclassify_planned_ref` walks a `band_plan` in the
single-view kernel's order, `multiview_band_reclassify_planned_ref` a
`multiview_plan` in the multi-view kernel's."""
from __future__ import annotations

import torch

from repro_torch.core.engine import classify
from repro_torch.kernels.band_reclassify.kernel import multiview_segments
from repro_torch.kernels.row_dot import lane_dot


def band_reclassify_ref(F_sorted, labels, w, b, start_block, width, *,
                        cap: int, block_n: int):
    """Single view. F_sorted (n, d), labels (n, 1) int8, w (d,), b scalar:
    rows [start, start + width) of the `cap`-row window at
    start = start_block·block_n get sign(F·w − b); a window running past
    the table is moved back to fit it, as a dynamic slice is."""
    n, d = F_sorted.shape
    start = min(max(int(start_block) * block_n, 0), max(0, n - cap))
    Fb = F_sorted[start:start + cap].to(torch.float32)
    eps = Fb @ w.to(torch.float32) - b
    new = classify(eps)[:, None]
    old = labels[start:start + cap]
    rows = torch.arange(Fb.shape[0], device=F_sorted.device)[:, None]
    out = labels.clone()
    out[start:start + cap] = torch.where(rows < int(width), new, old)
    return out


def band_reclassify_rows_ref(F, labels, w, b, start_row, width):
    """Single view, row-granular window: labels (n,) int8 with rows
    [start_row, start_row + width) set to sign(F·w − b), the rest kept."""
    lo, hi = int(start_row), int(start_row) + int(width)
    out = labels.clone()
    out[lo:hi] = classify(F[lo:hi].to(torch.float32) @ w.to(torch.float32)
                          - b)
    return out


def band_reclassify_planned_ref(F, labels, w, b, start_row, width, plan):
    """The row-granular form walked as the single-view kernel walks `plan`
    (a `BandPlan`): in loop l, block g takes band rows
    (l · grid + g) · rows_per_block + [0, rows_per_block), each row's dot
    summed in its lanes' order over the plan's chunks."""
    out = labels.clone()
    F32, w32 = F.to(torch.float32), w.to(torch.float32)
    per_chunk = plan.chunk_bytes // F.element_size()
    rows = plan.rows_per_block
    for loop in range(plan.loops):
        for block in range(plan.grid):
            lo = (loop * plan.grid + block) * rows
            hi = min(lo + rows, int(width))
            if lo >= hi:
                break
            r0 = int(start_row)
            out[r0 + lo:r0 + hi] = classify(
                lane_dot(F32[r0 + lo:r0 + hi], w32, per_chunk, plan.lanes)
                - b)
    return out


def multiview_band_reclassify_ref(F, labels, W, b, start_blocks, widths, *,
                                  cap: int, block_n: int):
    """k views over one shared table: the single-view form per view."""
    return torch.stack([
        band_reclassify_ref(F, labels[v][:, None], W[v], b[v],
                            start_blocks[v], widths[v],
                            cap=cap, block_n=block_n)[:, 0]
        for v in range(labels.shape[0])])


def multiview_band_reclassify_planned_ref(F, labels, W, b, start_blocks,
                                          widths, *, block_n: int, plan):
    """k views walked as the multi-view kernel walks `plan` (a
    `MultiviewPlan`): the union of the windows [start_blocks[v]·block_n,
    +widths[v]) as one flat range of rows, segment after segment
    (`multiview_segments`); in loop l, block g takes flat rows
    (l · grid + g) · rows_per_block + [0, rows_per_block), and each row is
    dotted, in its lanes' order over the plan's chunks, with every view
    whose window covers it. Returns new (k, n) int8 labels."""
    out = labels.clone()
    lo = [int(s) * block_n for s in start_blocks.tolist()]
    hi = [a + max(0, int(w)) for a, w in zip(lo, widths.tolist())]
    segs = multiview_segments(lo, hi)
    if not segs:
        return out
    k, dev = labels.shape[0], F.device
    rows = torch.cat([torch.arange(a, a + m, device=dev)
                      for a, m, _ in segs])
    cover = torch.zeros((k, rows.numel()), dtype=torch.bool, device=dev)
    at = 0
    for _, m, mask in segs:                       # views of each flat row
        for v in range(k):
            if mask >> v & 1:
                cover[v, at:at + m] = True
        at += m
    F32, W32 = F.to(torch.float32), W.to(torch.float32)
    per_chunk = plan.chunk_bytes // 4
    step = plan.grid * plan.rows_per_block        # flat rows a loop covers
    for first in range(0, rows.numel(), step):
        r = rows[first:first + step]
        for v in range(k):
            sel = r[cover[v, first:first + step]]
            if sel.numel():
                out[v, sel] = classify(
                    lane_dot(F32[sel], W32[v], per_chunk, plan.lanes) - b[v])
    return out
