"""mfu.serve (%): the UNet FLOPs of the requests served in the window (the
engine's padding rows count as no useful work) over the seconds the
engine spent in its batches (the benchmark's span around each of the
engine's ``dispatch_batch`` calls, to its results on the host), against
the 989 TF/s bf16 peak."""
from cuda_bench import flops
from cuda_bench.metrics._common import percent, rows_of, unet_flops


def read(run):
    r = run["result"]
    if not r.get("busy_s"):
        return None
    return percent(unet_flops(run, rows_of(run, served_only=True)) / r["busy_s"] / flops.PEAK_BF16_FLOPS)
