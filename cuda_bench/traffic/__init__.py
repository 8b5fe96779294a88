"""Traffic drivers. A mix (``cuda_bench/workloads/<traffic>.json``) names
its driver, ``traffic/<driver>.py``, and gives its parameters; the driver
exposes ``warmup(ctx)`` and ``run(ctx) -> dict``."""
