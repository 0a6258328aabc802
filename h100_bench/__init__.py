"""The benchmark of `fast_dit_torch` on the H100: one cell of
`BENCHMARK.json` a run (`run.py`), everything a cell needs found by name
(`cell.py`): configurations, traffic mixes, drivers, limits and per-layer
metric readers as files of their own; the plain reference (`reference/`),
the counts and peaks (`counts.py`) and the trace reader (`trace.py`) are
the yardstick. It imports nothing of JAX or the JAX package."""
