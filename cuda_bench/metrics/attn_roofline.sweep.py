"""attn_roofline.sweep (%): the least time the H100 needs for the profiled
batch's attention work (the larger of its FLOPs over 989 TF/s and its
bytes over 3.35 TB/s; ``flops.image_attention``: projections, scores and
values of attn1 and attn2 in every CFG forward and guidance eval the
batch ran) over the device time of the kernels launched inside the UNet's
attn1 / attn2 modules, forward and backward. The modules are known by
their ranges, which a CUDA-graph replay does not open: where the profiled
batch replayed a graph, the attention time is not known and nothing is
read (a share from part of the time would read too high)."""
from cuda_bench import flops
from cuda_bench.metrics._common import attention_time_us, percent, profiled


def read(run):
    t = profiled(run)
    if t is None or "images" not in run["result"] or not t.get("diags") or t.get("graph_launches"):
        return None
    u = run["config"]["arch"]["unet"]
    res = run["config"]["arch"]["attention_res"]
    f = b = 0.0
    for n_evals, recursions in t["diags"]:
        df, db = flops.image_attention(u, n_evals, recursions, res)
        f, b = f + df, b + db
    us = attention_time_us(run)
    if us <= 0:
        return None
    return percent(flops.least_seconds(f, b) / (us / 1e6))
