"""Plain PyTorch versions of eps_affine, the counterpart of
`repro/kernels/eps_affine/ref.py`: the direct form (the CPU path of `ops`
and the CUDA kernel's checks use it) and the tiled form, which walks a
`tile_plan` in the kernel's order."""
from __future__ import annotations

import torch

from repro_torch.core.engine import classify
from repro_torch.kernels.row_dot import lane_dot

CONSUMERS = 256           # kConsumers in eps_affine.cu: threads on rows


def eps_affine_ref(F, w, b):
    """(eps (n,) f32, labels (n,) int8, positive count () int32) for
    eps = F·w − b, accumulated in fp32."""
    eps = F.to(torch.float32) @ w.to(torch.float32) - b
    return eps, classify(eps), (eps >= 0).sum(dtype=torch.int32)


def eps_affine_tiled_ref(F, w, b, plan):
    """The direct form walked as the kernel walks `plan` (a `TilePlan`):
    block i takes tiles i, i + grid, ... of R rows in turn, each row's dot
    summed in its lanes' order over the plan's chunks; the consumer groups
    of the blocks then take the tail rows in turn, an element a chunk; the
    count is the blocks' totals added in block order."""
    n, d = F.shape
    F32, w32 = F.to(torch.float32), w.to(torch.float32)
    eps = torch.empty(n, dtype=torch.float32, device=F.device)
    totals = [0] * plan.grid
    R = plan.rows_per_tile
    per_chunk = plan.chunk_bytes // F.element_size()
    for block in range(plan.grid):
        for t in range(block, plan.tiles, plan.grid):
            e = lane_dot(F32[t * R:(t + 1) * R], w32, per_chunk,
                         plan.lanes) - b
            eps[t * R:(t + 1) * R] = e
            totals[block] += int((e >= 0).sum())
    tail0 = plan.tiles * R
    e = lane_dot(F32[tail0:], w32, 1, plan.lanes) - b
    eps[tail0:] = e
    groups = CONSUMERS // plan.lanes
    for i, pos in enumerate((e >= 0).tolist()):
        totals[(i // groups) % plan.grid] += pos
    count = 0
    for total in totals:
        count += total
    return eps, classify(eps), torch.tensor(count, dtype=torch.int32)
