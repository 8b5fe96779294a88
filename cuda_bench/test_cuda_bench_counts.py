"""The frozen work counts, and each per-layer reader on a hand-built profile."""
from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from cuda_bench import flops, record, trace
from cuda_bench.run import load_file

BENCH_DIR = Path(__file__).resolve().parent
SD15 = json.loads((BENCH_DIR / "configs" / "sd15.json").read_text())["arch"]["unet"]
N_EVALS = np.array([36] + [0] * 49)
RECURSIONS = np.array([3] + [1] * 49)


def test_attention_work_by_hand_at_sd15_shapes():
    # attn1 at 64x64: to_q, to_k, to_v, to_out 2*4096*320*320 each, QK^T and PV 2*4096*4096*320 each
    f, b = flops.attention_work(4096, 4096, 320, 320, 320, True)
    assert f == 4 * 2 * 4096 * 320 * 320 + 2 * 2 * 4096 * 4096 * 320 == 24_830_279_680
    # input and output [4096, 320], four [320, 320] weights, the output bias, in bf16
    assert b == 2 * (2 * 4096 * 320 + 4 * 320 * 320 + 320) == 6_062_720
    # attn2 at 64x64: to_k and to_v read the [77, 768] context
    f, b = flops.attention_work(4096, 77, 320, 320, 768, False)
    assert f == 2 * 2 * 4096 * 320 * 320 + 2 * 2 * 77 * 768 * 320 + 2 * 2 * 4096 * 77 * 320 == 2_157_117_440
    assert b == 2 * (2 * 4096 * 320 + 77 * 768 + 2 * 320 * 320 + 2 * 320 * 768 + 320)


def test_unet_flops_match_the_port_and_the_published_count():
    from guided_attention_tpu_torch.models.unet import UNetConfig
    from guided_attention_tpu_torch.runtime import flops as port

    cfg = UNetConfig()
    assert flops.unet_forward_flops(SD15) == pytest.approx(port.unet_forward_flops(cfg), rel=1e-12)
    assert flops.unet_forward_flops(SD15, 16) == pytest.approx(port.unet_eval_flops(cfg, 16), rel=1e-12)
    # 52 CFG forwards of two rows and 36 evals; the port's count takes an eval at 3x its
    # forward, as a training step's backward would cost, and the benchmark's at what it computes
    per_image = flops.image_flops(SD15, N_EVALS, RECURSIONS)
    assert per_image == 52 * 2 * flops.unet_forward_flops(SD15) + 36 * flops.eval_flops(SD15) == 114_251_458_805_760
    diags = SimpleNamespace(n_evals=N_EVALS, recursions=RECURSIONS)
    assert per_image < port.generation_flops(cfg, diags, 50) == pytest.approx(127.7e12, rel=0.01)
    # the attention layers: 16 in a full forward, 10 up to the eval's last captured layer
    assert len(list(flops._layers(SD15))) == 16 and len(list(flops._layers(SD15, 16))) == 10


def test_eval_backward_by_hand_at_sd15_shapes():
    """Each guidance eval is the truncated forward and the latent's gradient
    through it, with every weight frozen: each product's data gradient once,
    the self-attention score and value products twice (dQ, dK, dP, dV), and
    none of what does not reach the loss."""
    fwd = flops.unet_forward_flops(SD15, 16)
    assert fwd == 408_590_254_080
    no_gradient = (
        2 * 320 * 1280 + 2 * 1280 * 1280  # the time embedding
        # each ResNet's time projection: 8 down, 2 mid, 3 + 3 up to the stop, by their widths
        + 2 * 1280 * (2 * 320 + 2 * 640 + 4 * 1280 + 2 * 1280 + 6 * 1280)
        # each cross-attention's to_k and to_v read the text: 2 at 320, 2 at 640, 6 at 1280 wide
        + 2 * 2 * 77 * 768 * (2 * 320 + 2 * 640 + 6 * 1280)
        # the last block at 16x16 past attn2's scores: its P V, to_out, GEGLU and proj_out
        + 2 * 256 * 77 * 1280 + 2 * 256 * 1280 * 1280 + 2 * 256 * 1280 * 10240 + 2 * 256 * 5120 * 1280
        + 2 * 256 * 1280 * 1280)
    # the self-attention Q K^T and P V once more: 2 layers at 64x64, 2 at 32x32, 5 at 16x16, 1 at 8x8
    self_again = 4 * (2 * 4096**2 * 320 + 2 * 1024**2 * 640 + 5 * 256**2 * 1280 + 64**2 * 1280)
    assert flops.eval_flops(SD15) == 2 * fwd - no_gradient + self_again == 853_083_914_240
    # one layer each: attn1 at 64x64, attn2 at 64x64, and attn2 in the block the eval stops in
    assert flops.attention_backward(4096, 4096, 320, 320, 320, True)[0] == (
        4 * 2 * 4096 * 320 * 320 + 2 * 2 * 2 * 4096 * 4096 * 320)
    assert flops.attention_backward(4096, 77, 320, 320, 768, False)[0] == (
        2 * 2 * 4096 * 320 * 320 + 2 * 2 * 4096 * 77 * 320)
    assert flops.attention_backward(256, 77, 1280, 1280, 768, False, scores_only=True)[0] == (
        2 * 256 * 1280 * 1280 + 2 * 256 * 77 * 1280)


def _profile():
    """A UNet attn1 forward op and its backward, a conv outside attention,
    and a copy on a second stream overlapping the conv."""
    attn = "module: unet.down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    events = [
        trace.Event(attn, None, 0.0, 1),
        trace.Event("aten::mm", 0, 1.0, 1, seq=7),
        trace.Event("module: unet.conv_in", None, 10.0, 1),
        trace.Event("aten::cudnn_convolution", 2, 11.0, 1),
        trace.Event("aten::copy_", None, 12.0, 1),
        trace.Event(trace.BACKWARD_PREFIX + "MmBackward0", None, 20.0, 2, seq=7, fwd_thread=1),
        trace.Event("aten::mm", 5, 21.0, 2),
    ]
    kernels = [trace.Kernel("gemm_a", 100.0, 100.0, 1), trace.Kernel("conv_k", 300.0, 300.0, 3),
               trace.Kernel("copy_k", 400.0, 50.0, 4), trace.Kernel("gemm_b", 700.0, 200.0, 6)]
    return events, kernels


def _run():
    events, kernels = _profile()
    outs = [SimpleNamespace(diagnostics=SimpleNamespace(n_evals=N_EVALS, recursions=RECURSIONS)) for _ in range(8)]
    batch = record.Batch(list(range(8)), ["p"] * 8, outputs=outs)
    traced = {"rows": 2, "wall_s": 3.0, "kernels": kernels, "busy_us": trace.busy_us(kernels),
              "summary": trace.summarize(events, kernels), "diags": [(N_EVALS, RECURSIONS)] * 2}
    return {"config": {"arch": {"unet": SD15, "attention_res": 16}}, "traced": traced,
            "result": {"images": 8, "window_s": 10.0, "batch_walls": [0.002, 0.004], "batches": [batch]}}


def read(name, run):
    return load_file(BENCH_DIR / "metrics" / f"{name}.py", f"m_{name}").read(run)


def test_trace_join_and_union():
    run = _run()
    t = run["traced"]
    assert t["busy_us"] == 100 + 300 + 200  # the copy lies inside the conv
    rows = t["summary"]["rows"]
    attn = "unet.down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    assert rows[(attn, "aten::mm", False)] == [100.0, 1]
    assert rows[(attn, "aten::mm", True)] == [200.0, 1]  # the backward goes to its forward's module
    ops = dict(map(tuple, t["summary"]["device_ops"]))
    assert ops["conv: aten::cudnn_convolution"] == pytest.approx(300e-6)
    assert ops["matmul: aten::mm"] == pytest.approx(300e-6)
    gaps = dict(map(tuple, t["summary"]["idle_gaps"]))
    assert sum(gaps.values()) == pytest.approx((300 - 200 + 700 - 600) * 1e-6)


def test_readers_on_the_profile():
    run = _run()
    assert read("kernels_per_image.sweep", run) == 4 / 2
    assert read("device_idle.sweep", run) == pytest.approx(100 * (1 - 600e-6 / 0.003))
    f, b = flops.image_attention(SD15, N_EVALS, RECURSIONS)
    assert read("attn_roofline.sweep", run) == pytest.approx(100 * flops.least_seconds(2 * f, 2 * b) / 300e-6)
    assert read("evals_per_image.sweep", run) == 36.0
    assert read("mfu.sweep", run) == pytest.approx(
        100 * 8 * flops.image_flops(SD15, N_EVALS, RECURSIONS) / 10.0 / 989e12)
    run["result"].update(busy_s=5.0, served_rows=[(0, k) for k in range(6)])
    assert read("mfu.serve", run) == pytest.approx(
        100 * 6 * flops.image_flops(SD15, N_EVALS, RECURSIONS) / 5.0 / 989e12)
    # a CUDA-graph replay opens no module range: no attention time, no share
    run["traced"]["graph_launches"] = 1
    assert read("attn_roofline.sweep", run) is None and read("kernels_per_image.sweep", run) == 4 / 2
    # nothing to read: nothing returned, never 0
    run["traced"] = None
    assert read("attn_roofline.sweep", run) is None and read("device_idle.sweep", run) is None


# --- the centring term's kink ---------------------------------------------------


def test_kink_flips_take_near_centring_terms_only():
    import torch

    from cuda_bench.check import kink_flips

    off = torch.tensor([[0.1, 3.0], [-0.05, 0.2], [0.01, 0.0]])
    centred = torch.tensor([True, True, False])  # the third token holds no centring term
    flips = kink_flips(off, centred)
    assert len(flips) == 7  # the three near terms of the centred tokens, every nonempty set
    marked = torch.stack(flips).any(dim=0)
    assert marked.tolist() == [[True, False], [True, True], [False, False]]
    assert kink_flips(torch.tensor([[1.0, -2.0]]), torch.tensor([True])) == []


def test_loss_on_the_other_side_of_a_kink():
    """At a centre of mass on its target the centring's gradient is either
    side's: the two differ by twice that term's gradient, the rest alike."""
    import torch

    from cuda_bench.reference import guidance, text

    prompt, anns = text.parse_prompt("a [robot:0.1,0.2,0.4,0.55] and a [blue vase:0.5,0.3,0.4,0.55]")
    spec = text.build_spec(prompt, anns, 4, 0.15, True, "cpu")
    maps = torch.randn(4, 4, text.CONTEXT, generator=torch.Generator().manual_seed(0)) * 0.01
    _, off = guidance.centre_offsets(maps, spec)
    k = int(torch.nonzero(guidance.centred_tokens(spec))[0])
    spec.center_xy[k, 0] += (off[k, 0] - 1e-4) / spec.res  # the column centre just past its target
    _, off = guidance.centre_offsets(maps, spec)
    assert 0 < float(off[k, 0]) < 1e-3
    flip = torch.zeros_like(off, dtype=torch.bool)
    flip[k, 0] = True

    def grad(**kw):
        m = maps.clone().requires_grad_(True)
        return torch.autograd.grad(guidance.loss(m, spec, **kw)[0], m)[0]

    def centring(sign):  # the BOX token's centring term, 0.05 |col - target| / (R - 1)
        m = maps.clone().requires_grad_(True)
        col = guidance.centre_offsets(m, spec)[1][k, 0]
        return torch.autograd.grad(sign * 0.05 * col / (spec.res - 1), m)[0]

    g, g_other = grad(), grad(flip=flip)
    assert torch.allclose(g - g_other, 2 * centring(1.0), atol=1e-6)
    assert float((g - g_other).norm()) > 1e-3 * float(g.norm())
