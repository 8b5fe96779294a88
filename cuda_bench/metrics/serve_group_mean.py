"""serve_group_mean (requests): requests per batch the engine dispatched
over the window (``BatchingEngine.stats``)."""


def read(run):
    s = run["result"].get("stats")
    if not s or not s["batches"]:
        return None
    return float((s["samples"] - s["padded_samples"]) / s["batches"])
