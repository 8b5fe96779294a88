"""latency_p50_s.serve (s): the median over every request due in the
window, each timed from when it was due to when its result was in hand.
Above the engine's capacity the queue grows through the window, so the
median swings with small changes of speed: a per-layer reading beside
``served_images_per_s``."""
import statistics


def read(run):
    lat = run["result"].get("latencies")
    if not lat:
        return None
    return float(statistics.median(lat))
