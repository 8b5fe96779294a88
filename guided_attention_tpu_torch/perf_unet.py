"""The UNet's batch-2 CFG forward, or its batch-1 guidance eval, chained N
times: replayed from one CUDA graph beside the same chain issued eagerly.

    python -m guided_attention_tpu_torch.perf_unet [--bwd] [--noflash] [--norm_bf16]
        [--flash_all] [--fused_cross] [--bwd_block N] [--device cuda|cpu]
        [--model sd15|micro] [--n 20] [--reps 5] [--seed 0]

Counterpart of the JAX package's ``scripts/perf_unet.py``. Default: N
batch-2 CFG forwards of the preset's UNet (``workload.create``: bf16 on the
card, random weights from ``workload.WEIGHT_SEED``), each output eps the
next input latent, the timestep of forward i ``500 - i`` held as a device
tensor, one seeded text context. ``--bwd``: N batch-1 guidance evals, each
a forward that captures the 16x16 cross maps (``("cross", 16)``), the loss
mean(eps) + 0.001 * (sum of the maps), its gradient by
``torch.autograd.grad`` under ``enable_grad`` (as the pipeline's eval
takes it), and the next latent h - 0.001 * grad.

The chain is timed two ways, taking turns rep by rep: (a) captured once
into a CUDA graph (after an eager warm-up on the capture stream) and
replayed, and (b) issued op by op; each with the host clock ending in
``torch.cuda.synchronize()``. A replay issues no per-op host work, so (a)
is the device's time and eager / graph says how much of the chain the host
costs. The graph's final output is held against the eager chain's (both
from the same inputs), and one replay runs under ``torch.profiler`` to
count the port's kernels among the kernels the graph runs. The launch
counters of ``ops.flash_attention`` count Python-side wrapper calls: the
capture counts each kernel put into the graph once, a replay counts
nothing. Prints ms per forward (per eval) both ways, their
ratio and the card's name and power limit, then one JSON line.

Variants, with the JAX script's meanings: ``--noflash`` (no kernel route,
``use_flash_attention=False``), ``--norm_bf16`` (norms in bf16,
``norm_dtype``), ``--flash_all`` (K1/K2 at every self-attention resolution,
``flash_min_seq=256``), ``--fused_cross`` (the uncaptured cross-attention
with at least 2048 queries, the CFG's, through K3, its map thrown away) and
``--bwd_block N`` (the eval's K2 in the tile configuration whose dK/dV
blocks hold N keys; implies ``--bwd``). A flag whose route the kernels do
not take in the chain raises ``ValueError`` naming the shapes; nothing
falls back quietly. The JAX script's ``--upsample_repeat`` is left out: it
replaced ``jax.image.resize``'s gather for the 2x nearest upsampling, and
the port's ``Upsample2D`` already runs PyTorch's own nearest-upsampling
kernel (``F.interpolate``), so there is no gather to replace.

``--device cpu --model micro`` runs the eager chain only (float32); the
graph's fields read as not measured.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from guided_attention_tpu_torch import workload
from guided_attention_tpu_torch.models import unet as unet_mod
from guided_attention_tpu_torch.models.layers import cast_
from guided_attention_tpu_torch.ops import flash_attention as fa
from guided_attention_tpu_torch.ops.attention import merge_heads, split_heads

N = 20
T0 = 500  # the timestep of the chain's first call; call i runs T0 - i
EVAL_CAPTURE = frozenset({("cross", 16)})
LOSS_MAP_WEIGHT = 0.001
STEP = 0.001  # h - STEP * grad
FUSED_CROSS_MIN_SEQ = 2048
FLASH_ALL_MIN_SEQ = 256
# a substring of each port kernel's symbol, per launch counter
KERNEL_SYMBOLS = {
    "flash_self_fwd": ("flash_self_fwd_kernel",),
    "flash_self_bwd": ("dq_kernel", "dkdv_kernel"),
    "cross_attention_map_fwd": ("cross_map_kernel",),
}


@dataclasses.dataclass(frozen=True)
class Variant:
    """The JAX script's flags."""

    bwd: bool = False
    noflash: bool = False
    norm_bf16: bool = False
    flash_all: bool = False
    fused_cross: bool = False
    bwd_block: Optional[int] = None

    def flags(self) -> List[str]:
        out = [f"--{f.name}" for f in dataclasses.fields(self) if getattr(self, f.name) is True]
        return out + ([f"--bwd_block {self.bwd_block}"] if self.bwd_block is not None else [])


def k2_config_for_block(block: int) -> int:
    """The first of ``K2_TILE_CONFIGS`` whose dK/dV pass holds ``block``
    keys per block."""
    for c, (dkdv, _dq) in enumerate(fa.K2_TILE_CONFIGS):
        if dkdv[0] == block:
            return c
    blocks = sorted({dkdv[0] for dkdv, _dq in fa.K2_TILE_CONFIGS})
    raise ValueError(f"--bwd_block {block}: K2 has no tile configuration with {block} keys per block; it has {blocks}")


def apply_variant(unet: torch.nn.Module, variant: Variant) -> None:
    """Set the configuration flags of ``variant`` on ``unet`` in place (the
    tool's own bundle); raises on flags that contradict each other or that
    the model's route does not take."""
    cfg = unet.config
    if variant.noflash and (variant.flash_all or variant.bwd_block is not None):
        raise ValueError("--noflash turns the kernel route off; --flash_all and --bwd_block need it")
    if variant.bwd_block is not None and unet.conv_in.weight.device.type != "cuda":
        raise ValueError("--bwd_block picks a tile configuration of K2, which runs only on CUDA tensors")
    if (variant.flash_all or variant.bwd_block is not None) and not cfg.use_flash_attention:
        raise ValueError("--flash_all and --bwd_block need the kernel route; this model has use_flash_attention=False")
    if variant.noflash:
        cfg = dataclasses.replace(cfg, use_flash_attention=False)
    if variant.flash_all:
        levels = [(cfg.sample_size >> i, c // h) for i, (c, h) in enumerate(zip(cfg.block_out_channels, cfg.num_heads))
                  if cfg.attn_down[i] and (cfg.sample_size >> i) ** 2 >= FLASH_ALL_MIN_SEQ]
        refused = [f"{r}x{r} ({r * r} queries, head_dim {d})" for r, d in levels if d not in fa.KERNEL_HEAD_DIMS]
        if refused:
            raise ValueError(f"--flash_all: K1/K2 take head_dim {fa.KERNEL_HEAD_DIMS}; the self-attention at "
                             f"{', '.join(refused)} does not")
        cfg = dataclasses.replace(cfg, flash_min_seq=FLASH_ALL_MIN_SEQ)
    if variant.norm_bf16:
        cfg = dataclasses.replace(cfg, norm_dtype=torch.bfloat16)
        cast_(unet, cfg.dtype, torch.bfloat16)
    unet.config = cfg


@contextlib.contextmanager
def routes(variant: Variant, seen: Dict[str, list]):
    """``models.unet``'s attention for the time of the block: with
    ``--fused_cross`` an uncaptured cross-attention of at least
    ``FUSED_CROSS_MIN_SEQ`` queries goes through K3 (the JAX script's
    patch), with ``--bwd_block`` the self-attention route's K2 takes the
    block's tile configuration; without either flag it is left as it is.
    ``seen`` gathers the shapes of every call ("cross", "self") and of the
    calls sent to K3 ("fused_cross")."""
    if not variant.fused_cross and variant.bwd_block is None:
        yield
        return
    base = unet_mod.attention
    bwd_config = None if variant.bwd_block is None else k2_config_for_block(variant.bwd_block)

    def routed(q, k, v, heads, **kw):
        nq, nk = q.shape[1], k.shape[1]
        shape = (q.shape[0], nq, nk, q.shape[2])
        seen["self" if nq == nk else "cross"].append(shape)
        plain_cross = not (kw.get("capture") or kw.get("capture_perhead")) and kw.get("pww_mask") is None
        if variant.fused_cross and nk != nq and plain_cross and nq >= FUSED_CROSS_MIN_SEQ:
            seen["fused_cross"].append(shape)
            d = q.shape[-1] // heads
            out, _map = fa.cross_attention_with_map(split_heads(q, heads), split_heads(k, heads), split_heads(v, heads),
                                                    d**-0.5)
            return merge_heads(out).to(q.dtype), None
        return base(q, k, v, heads, bwd_config=bwd_config, **kw)

    unet_mod.attention = routed
    try:
        yield
    finally:
        unet_mod.attention = base


def check_routes(variant: Variant, seen: Dict[str, list], launches: Dict[str, int]) -> None:
    """Raise where a flag's route took no call of the chain."""
    if variant.fused_cross and not seen["fused_cross"]:
        raise ValueError(f"--fused_cross: no uncaptured cross-attention with at least {FUSED_CROSS_MIN_SEQ} queries; "
                         f"cross-attention shapes [B, Nq, Nk, C]: {sorted(set(seen['cross']))}")
    if variant.bwd_block is not None and launches["flash_self_bwd"] == 0:
        raise ValueError(f"--bwd_block: no self-attention took K2; self-attention shapes [B, N, N, C]: "
                         f"{sorted(set(seen['self']))}")


def chain_inputs(unet: torch.nn.Module, batch: int, n: int,
                 seed: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Seeded latent [batch, s, s, C] and context [batch, 77, D] in the
    model dtype, and the timesteps ``T0 - i`` [n] (int64), on the UNet's
    device."""
    cfg = unet.config
    dev = unet.conv_in.weight.device
    g = torch.Generator(device=dev).manual_seed(seed)
    s = cfg.sample_size
    x = torch.randn((batch, s, s, cfg.in_channels), generator=g, device=dev).to(cfg.dtype)
    ctx = torch.randn((batch, 77, cfg.cross_attention_dim), generator=g, device=dev).to(cfg.dtype)
    return x, ctx, T0 - torch.arange(n, device=dev)


def cfg_chain(unet, x: torch.Tensor, ctx: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """``len(ts)`` forwards, each output eps the next input; returns the
    last eps in ``x``'s dtype."""
    h = x
    with torch.no_grad():
        for i in range(ts.shape[0]):
            eps, _aux = unet(h, ts[i], ctx)
            h = eps.to(x.dtype)
    return h


def eval_step(unet, h: torch.Tensor, t, ctx: torch.Tensor, capture=EVAL_CAPTURE) -> Tuple[torch.Tensor, torch.Tensor]:
    """One guidance eval of the JAX script's body: the loss
    mean(eps) + 0.001 * (sum of the captured maps) and its gradient in
    ``h``."""
    with torch.enable_grad():
        v = h.detach().requires_grad_(True)
        eps, aux = unet(v, t, ctx, capture=capture)
        maps = [m for layer in aux["maps"].values() for m in layer]
        loss = eps.float().mean() + LOSS_MAP_WEIGHT * sum(m.sum() for m in maps)
        (grad,) = torch.autograd.grad(loss, v)
    return loss.detach(), grad


def eval_chain(unet, x: torch.Tensor, ctx: torch.Tensor, ts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``len(ts)`` guidance evals, each stepping the latent by
    ``-STEP * grad``; returns (the last latent, the losses [n])."""
    h, losses = x, []
    for i in range(ts.shape[0]):
        loss, grad = eval_step(unet, h, ts[i], ctx)
        h = (h - STEP * grad).to(x.dtype)
        losses.append(loss)
    return h, torch.stack(losses)


def capture_graph(fn: Callable[[], object], warmup: int = 1):
    """``fn`` run ``warmup`` times on the capture stream, then captured
    into a CUDA graph. Returns (graph, what the captured call returned: its
    buffers hold each replay's output, the port kernels' launches made
    while capturing). A capture that fails raises."""
    from guided_attention_tpu_torch.runtime.timing import _capture_stream

    side = _capture_stream(torch.cuda.current_device())
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(fa.LAUNCHES)
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    torch.cuda.synchronize()
    return graph, out, {k: fa.LAUNCHES[k] - before[k] for k in KERNEL_SYMBOLS}


def replay_kernels(graph) -> Dict[str, int]:
    """The kernels one replay of ``graph`` runs (CUPTI's record of the
    replay, through ``torch.profiler``): all of them, and those of each
    port kernel by its symbol."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    counts = {k: sum(1 for n in names if any(s in n for s in symbols)) for k, symbols in KERNEL_SYMBOLS.items()}
    return {"kernels": len(names), **counts}


def rel_errors(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    """(max |got - want| / max |want|, rms(got - want) / rms(want)) in float32."""
    g, w = got.float(), want.float()
    diff = g - w
    return (float(diff.abs().max() / w.abs().max().clamp_min(1e-30)),
            float(diff.pow(2).mean().sqrt() / w.pow(2).mean().sqrt().clamp_min(1e-30)))


def measure(unet, variant: Variant = Variant(), n: int = N, reps: int = 5, seed: int = 0) -> dict:
    """Time the chain of ``variant`` (CFG forwards, or evals with
    ``--bwd``/``--bwd_block``) on ``unet``'s device: graph replays and eager
    chains in turns on CUDA, the eager chain alone on the CPU. Returns the
    readings (ms per call, host walls, graph against eager, kernel nodes
    and captured launches)."""
    cuda = unet.conv_in.weight.device.type == "cuda"
    bwd = variant.bwd or variant.bwd_block is not None
    x, ctx, ts = chain_inputs(unet, 1 if bwd else 2, n, seed)

    def chain():
        return eval_chain(unet, x, ctx, ts) if bwd else (cfg_chain(unet, x, ctx, ts), None)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    seen: Dict[str, list] = {"self": [], "cross": [], "fused_cross": []}
    with routes(variant, seen):
        fa.reset_launches()
        eager_out, eager_losses = chain()  # warm-up; it also shows which routes the chain takes
        sync()
        eager_launches = {k: fa.LAUNCHES[k] for k in KERNEL_SYMBOLS}
        check_routes(variant, seen, eager_launches)
        graph, graph_nodes, captured = None, None, None
        if cuda:
            graph, (graph_out, graph_losses), captured = capture_graph(chain)
            graph_nodes = replay_kernels(graph)
        graph_walls, eager_walls = [], []
        for _ in range(reps):
            if graph is not None:
                t0 = time.perf_counter()
                graph.replay()
                sync()
                graph_walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            eager_out, eager_losses = chain()
            sync()
            eager_walls.append(time.perf_counter() - t0)
    eager_ms = 1e3 * statistics.median(eager_walls) / n
    row = {
        "mode": "eval" if bwd else "cfg",
        "flags": variant.flags(),
        "n": n,
        "reps": reps,
        "batch": x.shape[0],
        "dtype": str(unet.config.dtype).replace("torch.", ""),
        "eager_ms_per_call": eager_ms,
        "eager_walls_s": eager_walls,
        "eager_launches": eager_launches,
        "fused_cross_calls": len(seen["fused_cross"]),
        "finite": bool(torch.isfinite(eager_out.float()).all()),
        "graph_ms_per_call": None, "graph_walls_s": None, "eager_over_graph": None, "bitwise_equal": None,
        "rel_max_err": None, "rel_rms_err": None, "captured_launches": captured, "graph_kernels": graph_nodes,
    }
    if graph is not None:
        graph_ms = 1e3 * statistics.median(graph_walls) / n
        same = torch.equal(graph_out, eager_out) and (not bwd or torch.equal(graph_losses, eager_losses))
        rel_max, rel_rms = rel_errors(graph_out, eager_out)
        row.update(graph_ms_per_call=graph_ms, graph_walls_s=graph_walls, eager_over_graph=eager_ms / graph_ms,
                   bitwise_equal=same, rel_max_err=rel_max, rel_rms_err=rel_rms,
                   finite=row["finite"] and bool(torch.isfinite(graph_out.float()).all()))
        if bwd:
            row["loss_rel_max_err"] = rel_errors(graph_losses, eager_losses)[0]
        del graph
    return row


def report(row: dict, card: str) -> str:
    """One line: ms per call both ways, their ratio, graph against eager."""
    unit = "eval (batch 1, fwd+bwd)" if row["mode"] == "eval" else "CFG forward (batch 2)"
    if row["graph_ms_per_call"] is None:
        return (f"{' '.join(row['flags']) or 'default'}: eager {row['eager_ms_per_call']:.3f} ms per {unit}, "
                f"graph not measured ({card})")
    return (f"{' '.join(row['flags']) or 'default'}: graph {row['graph_ms_per_call']:.3f} ms, eager "
            f"{row['eager_ms_per_call']:.3f} ms per {unit} (eager/graph {row['eager_over_graph']:.3f}), "
            f"N = {row['n']}, {row['reps']} reps; graph vs eager: bitwise {row['bitwise_equal']}, rel max "
            f"{row['rel_max_err']:.3g}; a replay's kernels {row['graph_kernels']} (captured launches "
            f"{row['captured_launches']}; counters count captures, not replays) ({card})")


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--bwd", action="store_true", help="chain batch-1 guidance evals")
    parser.add_argument("--noflash", action="store_true")
    parser.add_argument("--norm_bf16", action="store_true")
    parser.add_argument("--flash_all", action="store_true")
    parser.add_argument("--fused_cross", action="store_true")
    parser.add_argument("--bwd_block", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--model", default="sd15", choices=("sd15", "micro"))
    parser.add_argument("--n", type=int, default=N)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    variant = Variant(args.bwd, args.noflash, args.norm_bf16, args.flash_all, args.fused_cross, args.bwd_block)
    cuda = torch.device(args.device).type == "cuda"
    # raises without a card when the device is CUDA (the default)
    unet = workload.create(args.device, args.model, torch.bfloat16 if cuda else torch.float32).sd.unet
    apply_variant(unet, variant)
    card = "cpu"
    if cuda:
        from guided_attention_tpu_torch.ops.build import load_library
        from guided_attention_tpu_torch.runtime.timing import card_name_and_power

        card = card_name_and_power()
        load_library()
    row = {"model": args.model, "device": args.device, "card": card,
           **measure(unet, variant, n=args.n, reps=args.reps, seed=args.seed)}
    print(report(row, card), flush=True)
    print(card, flush=True)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
