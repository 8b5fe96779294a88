"""serve_fill (%): requests served over the samples the engine dispatched
for them, bucket padding included (``BatchingEngine.stats`` before and
after the window)."""
from cuda_bench.metrics._common import percent


def read(run):
    s = run["result"].get("stats")
    if not s or not s["samples"]:
        return None
    return percent((s["samples"] - s["padded_samples"]) / s["samples"])
