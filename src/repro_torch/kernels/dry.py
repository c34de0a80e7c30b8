"""The cost of a kernel call, and the dry run's counter of them.

Each kernel's `kernel.py` gives the cost of one call from its shapes and
dtypes (`Cost`: the FLOPs the function needs and the bytes it must move,
each input read once and each output written once); `chip_smoke.py`
divides them by the card's rates for its bounds, and the dry run
(`launch/dryrun.py`) adds them to its count. A wrapper given `meta`
tensors launches nothing: it returns empty meta outputs of the kernel's
shapes and dtypes and records the call's cost here, under the kernel's
name (`record`). `meta` is a device the caller names, never a fallback.
"""
from __future__ import annotations

import collections
from typing import Dict, NamedTuple


class Cost(NamedTuple):
    flops: int
    bytes: int


CALLS: "collections.Counter[str]" = collections.Counter()
FLOPS: "collections.Counter[str]" = collections.Counter()
BYTES: "collections.Counter[str]" = collections.Counter()


def record(name: str, cost: Cost) -> None:
    """One call of kernel `name` on meta tensors."""
    CALLS[name] += 1
    FLOPS[name] += int(cost.flops)
    BYTES[name] += int(cost.bytes)


def reset() -> None:
    for c in (CALLS, FLOPS, BYTES):
        c.clear()


def snapshot() -> Dict[str, Dict[str, int]]:
    """{kernel: {"calls", "flops", "bytes"}} since the last `reset`."""
    return {k: {"calls": CALLS[k], "flops": FLOPS[k], "bytes": BYTES[k]}
            for k in sorted(CALLS)}
