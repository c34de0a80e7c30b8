"""The benchmark of the port `repro_torch`: `run.py` is its command;
`BENCHMARK.json` at the checkout's root names its cells, whose files
(`configs/`, `traffic/`, `metrics/`) this package finds by name."""
