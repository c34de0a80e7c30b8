"""Plain PyTorch statement of the summation order of `csrc/row_dot.cuh`,
shared by the plain forms that walk the kernels' plans.

A row's dot is split over `lanes` lanes: the row is cut into chunks of
`per_chunk` elements, lane l accumulates chunks l, l + lanes, ... element
by element, and the lanes' sums are added by the butterfly of
`__shfl_xor_sync` within each warp (32 lanes at most), then warp by warp.
The kernel fuses each product into its sum (fmaf); here product and sum
round apart, so the two may differ in the last bits of a sum, no more.
"""
from __future__ import annotations

import torch


def lane_dot(rows, w, per_chunk: int, lanes: int):
    """(m,) f32 dots of the (m, d) f32 `rows` with the (d,) f32 `w`,
    summed in the order of `lanes` lanes reading `per_chunk` elements at a
    time (d a multiple of per_chunk; lanes a power of two)."""
    m, d = rows.shape
    chunks = d // per_chunk
    per_lane = -(-chunks // lanes)
    pad = (per_lane * lanes - chunks) * per_chunk
    f = torch.nn.functional.pad(rows, (0, pad)).reshape(
        m, per_lane, lanes, per_chunk)
    wv = torch.nn.functional.pad(w, (0, pad)).reshape(
        per_lane, lanes, per_chunk)
    acc = torch.zeros(m, lanes, dtype=torch.float32, device=rows.device)
    for c in range(per_lane):
        for e in range(per_chunk):
            acc = acc + f[:, c, :, e] * wv[c, :, e]
    span = min(lanes, 32)
    acc = acc.reshape(m, lanes // span, span)
    idx = torch.arange(span, device=rows.device)
    off = span // 2
    while off:
        acc = acc + acc[..., idx ^ off]
        off //= 2
    out = acc[:, 0, 0]
    for i in range(1, lanes // span):
        out = out + acc[:, i, 0]
    return out
