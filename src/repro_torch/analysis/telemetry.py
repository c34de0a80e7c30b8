"""TEL — the single-source-timing pass.

`repro_torch.obs` is the one sanctioned clock: spans, metrics histograms, and
the SKIING measured-cost recorder all read ``repro_torch.obs.clock`` (an alias
of ``time.perf_counter``), so every duration in the tree is mutually
comparable and EXPLAIN ANALYZE / the server's elapsed_us / the REPL
footer can never disagree about what was measured.

    TEL001  raw wall-clock call outside `repro_torch.obs`:
            `time.perf_counter()`, `time.monotonic()`,
            `time.process_time()`, `time.time()` (or their `_ns`
            variants, or the same names imported bare). Route the
            measurement through `repro_torch.obs.clock`, a span, or a
            registry histogram instead.

Exemptions: the `repro_torch.obs` package itself (it IS the clock), and
benchmark harnesses (`benchmarks/` drives the timing study from outside
the tree). Aliasing without calling — ``clock = time.perf_counter`` —
is fine and is exactly how `repro_torch.obs` wraps the stdlib. ``time.sleep``
is not a measurement and is never flagged.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List

from repro_torch.analysis.common import Finding, ModuleSet

_TIMING_FNS = {"perf_counter", "perf_counter_ns", "monotonic",
               "monotonic_ns", "process_time", "process_time_ns",
               "time", "time_ns"}
# bare-name calls that only ever mean the stdlib clock ("time(…)" alone is
# too ambiguous to flag; "perf_counter(…)" is not)
_BARE_FNS = _TIMING_FNS - {"time", "time_ns"}


def _exempt(path: Path) -> bool:
    return "obs" in path.parts or "benchmarks" in path.parts


def _is_raw_clock_call(node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Attribute):
        return (isinstance(f.value, ast.Name) and f.value.id == "time"
                and f.attr in _TIMING_FNS)
    if isinstance(f, ast.Name):
        return f.id in _BARE_FNS
    return False


def check_telemetry(modules: ModuleSet) -> List[Finding]:
    findings: List[Finding] = []
    for path, tree in modules.trees.items():
        if _exempt(path):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and _is_raw_clock_call(node):
                name = ast.unparse(node.func)
                findings.append(modules.finding(
                    path, node, "TEL001",
                    f"raw clock call {name}() outside repro_torch.obs — use "
                    f"repro_torch.obs.clock / a span / a registry histogram "
                    f"so every duration shares one clock"))
    return findings
