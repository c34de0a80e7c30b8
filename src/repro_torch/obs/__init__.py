"""repro_torch.obs — the port's telemetry. For now only `clock`, the one
sanctioned monotonic clock (as in `repro/obs/trace.py`): code of the port
outside this package times through it, never through a raw
`time.perf_counter()` (the `repro.analysis` TEL001 rule). The metrics,
spans and cost hooks of `repro.obs` wait for ROADMAP.md Queue 1 item 8."""
import time

clock = time.perf_counter

__all__ = ["clock"]
