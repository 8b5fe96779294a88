"""device_idle.sweep (%): one minus the union of the profiled batch's
kernel intervals over the mean wall time of the window's unprofiled
batches, so that the profiler's own host overhead does not count as
idle."""
import numpy as np

from cuda_bench.metrics._common import percent, profiled


def read(run):
    t = profiled(run)
    walls = run["result"].get("batch_walls")
    if t is None or not walls:
        return None
    return percent(1.0 - (t["busy_us"] / 1e6) / float(np.mean(walls)))
