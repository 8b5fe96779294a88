"""mfu.sweep (%): the UNet FLOPs of the window's images (the benchmark's
count, from each image's evals and recursions) over the window's seconds,
against the H100's 989 TF/s bf16 peak. The window is unprofiled."""
from cuda_bench import flops
from cuda_bench.metrics._common import percent, rows_of, unet_flops


def read(run):
    r = run["result"]
    outs = rows_of(run)
    if not outs or "images" not in r:
        return None
    return percent(unet_flops(run, outs) / r["window_s"] / flops.PEAK_BF16_FLOPS)
