"""kernels_per_image.sweep (kernels/image): device kernels (copies and
fills included) the profiled batch ran, per image. Kernels run, not host
launches, so a CUDA-graph replay counts what it runs."""
from cuda_bench.metrics._common import profiled


def read(run):
    t = profiled(run)
    if t is None or "images" not in run["result"]:
        return None
    return float(len(t["kernels"]) / t["rows"])
