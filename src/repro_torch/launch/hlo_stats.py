"""Collective traffic of a step from the mesh's records, the counterpart of
`repro/launch/hlo_stats.py` (which parses compiled HLO text; the eager
port has no HLO, and the file keeps its name so that a reader finds the
counterpart).

Every collective of the port is one `dist.all_reduce` of a buffer
(`launch/mesh.py`): an all-reduce of the tensor itself, an all-gather of
the zero-padded whole, a reduce-scatter of the full sum. The mesh records
each as (axes, op) -> calls (`CALLS`) and the bytes of that buffer
(`BYTES`), on a live mesh and an abstract one alike; here they are
summed by the reference's kinds. The convention differs from the
reference's output-operand bytes: an all-gather counts its whole padded
buffer, as the wire carries it.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Mapping, Tuple

KINDS = {"sum": "all-reduce", "max": "all-reduce",
         "all_gather": "all-gather", "reduce_scatter": "reduce-scatter"}


def records(calls: Mapping, nbytes: Mapping
            ) -> Dict[Tuple[Tuple[str, ...], str], Dict[str, int]]:
    """{(axes, op): {"calls", "bytes"}} from the mesh's two counters (or
    their snapshots)."""
    return {key: {"calls": int(calls[key]), "bytes": int(nbytes.get(key, 0))}
            for key in sorted(calls)}


def collective_bytes(recs: Mapping) -> Dict[str, int]:
    """Per-device bytes by kind (`all-reduce`, `all-gather`,
    `reduce-scatter`), `<kind>_count` calls, and `total` over the bytes
    only, the reference's keys, from `records(...)`."""
    out: Dict[str, int] = defaultdict(int)
    counts: Dict[str, int] = defaultdict(int)
    for (_, op), r in recs.items():
        kind = KINDS[op]
        out[kind] += r["bytes"]
        counts[kind + "_count"] += r["calls"]
    out.update(counts)
    out["total"] = sum(v for k, v in out.items()
                       if not k.endswith("_count") and k != "total")
    return dict(out)
