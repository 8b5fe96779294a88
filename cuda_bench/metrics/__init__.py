"""Metric readers, one file per metric of ``BENCHMARK.json`` (end-to-end
and per-layer), named as the metric.

Each exposes ``read(run) -> float | None``: ``run`` is what
``cuda_bench.run.measure`` returns. A reader that finds nothing to read
returns None and the metric is left out of the line."""
