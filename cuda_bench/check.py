"""Whether what the timed path produced is right: the numbers compared.

The program's run is followed step by step from its own recorded state
(``record.Recorder``): a guided generation is chaotic enough that two
correct runs in bf16 and float32 end far apart, so each stage is judged on
the program's input to that stage. For every row of every batch of the
window (cheap, elementwise):

* ``init_max_abs``: the first eval's latents against the draw the
  reference makes from the row's seed (the same generator on the same
  device type; exact, limit 0). It ties the row to its request's seed.
* ``state_rel``: every hand-over between stages, recomputed in float32
  from the program's input and the program's eps or gradient: a
  refinement step ``v - lr * grad``, the gated update after the final
  eval into the CFG forward, the CFG combination and DDIM step, the
  re-noise with the row's next draw, and the last step into the latents
  the row delivered; the worst over all of them of ||p - r|| / ||r||.
* ``delivery``: rows whose delivered output is not the one their own
  request asked for (seed and prompt), batches whose calls do not follow
  the guided loop's order, calls at another step's timestep than the
  reference schedule's, and calls whose context rows differ from those of
  the batch's first CFG forward (exact, limit 0). With ``clip_rel`` on the
  first, that ties every call's text to the reference.

For rows drawn from the run's seed (the expensive part, the reference's
float32 models):

* ``clip_rel``: the context rows the UNet was given against the
  reference's CLIP of the row's prompt and the empty prompt.
* ``eps_rel``: each CFG forward's eps of the row's two rows against the
  reference UNet on the same latents, timestep and context.
* ``grad_rel``: each guidance eval's latent gradient (truncated UNet, cross
  maps, loss, backward) against the reference's; ``loss_rel`` the step's
  final loss the program reported against the reference's loss there.
  Where a token's centre of mass lies within ``KINK_CELLS`` of its target
  in a coordinate, the loss's absolute value has its kink within rounding
  of the program's maps, and the program may stand on the other side: the
  gradient is held against the reference's on either side of each such
  kink, and the nearer one counts.
* ``image_rms``: the delivered uint8 image against the reference's decode
  of the delivered latents, in levels.

``control`` replaces the program's value at each place by the reference's
own computation in fp8 (``reference.nn.Precision("fp8")``) on the same
inputs: the readings a program one precision step below would give.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from cuda_bench.record import Batch
from cuda_bench.reference import guidance, sampler
from cuda_bench.reference.nn import Precision

NUMBERS = ("init_max_abs", "state_rel", "delivery", "clip_rel", "eps_rel", "grad_rel", "loss_rel", "image_rms")
# grid cells (of the R x R attention grid) within which a centre of mass
# may lie on the other side of its target than the float32 reference's
KINK_CELLS = 0.25
MAX_KINKS = 3


def kink_flips(offsets: torch.Tensor, centred: torch.Tensor, cells: float = KINK_CELLS) -> List[torch.Tensor]:
    """Every nonempty set of the (at most ``MAX_KINKS`` nearest) centring
    terms within ``cells`` of their kink, each as a bool[K, 2] ``flip``."""
    dist = torch.where(centred[:, None], offsets.abs(), torch.full_like(offsets, float("inf")))
    near = [int(k) for k in torch.argsort(dist.flatten()) if float(dist.flatten()[k]) < cells][:MAX_KINKS]
    out = []
    for mask in range(1, 2 ** len(near)):
        flip = torch.zeros(dist.numel(), dtype=torch.bool, device=offsets.device)
        flip[[k for j, k in enumerate(near) if mask >> j & 1]] = True
        out.append(flip.reshape(dist.shape))
    return out


def rel(p: torch.Tensor, r: torch.Tensor) -> float:
    r = r.float()
    return float(torch.linalg.vector_norm(p.float() - r) / torch.linalg.vector_norm(r).clamp(min=1e-30))


@dataclasses.dataclass
class Loop:
    """The guided loop's shape, from the traffic's knobs."""

    steps: int
    guided_steps: tuple  # steps with a threshold (the guidance evals run there)
    evals_per_pass: int  # eval0 + refinement steps + the final eval
    passes: int  # re-noise recursions at a guided step up to ``recurse_until``
    recurse_until: int
    lr: List[float]
    guidance_scale: float

    @classmethod
    def of(cls, knobs: Dict) -> "Loop":
        steps = int(knobs.get("num_inference_steps", 50))
        thresholds = {int(k): v for k, v in (knobs.get("thresholds") or {0: 1.0}).items()}
        return cls(steps, tuple(sorted(k for k in thresholds if 0 <= k < steps)), 2 + 10, 3, 14,
                   [sampler.step_size(20.0, (1.0, 0.5), steps, i) for i in range(steps)],
                   float(knobs.get("guidance_scale", 7.5)))

    def plan(self):
        """[(step, pass, kind)] in call order; kind "eval" or "cfg"."""
        out = []
        for i in range(self.steps):
            passes = (self.passes if i <= self.recurse_until else 1) if i in self.guided_steps else 1
            for r in range(passes):
                if i in self.guided_steps:
                    out += [(i, r, "eval")] * self.evals_per_pass
                out.append((i, r, "cfg"))
        return out


class Checker:
    def __init__(self, loop: Loop, device, control: bool = False):
        self.loop = loop
        self.device = device
        self.sched = sampler.schedule(loop.steps)
        self.q8 = Precision("fp8").q if control else None
        self.control = control
        self.worst: Dict[str, float] = {n: 0.0 for n in NUMBERS}
        self.notes: List[str] = []

    def note(self, name: str, value: float, where: str) -> None:
        if not np.isfinite(value):
            value = float("inf")
        if value > self.worst[name]:
            self.worst[name] = value
            self.notes.append(f"{name}={value:.6g} at {where}")

    # the program's value at a hand-over, or under the control the fp8
    # reference's, against the float32 reference
    def side(self, program: torch.Tensor, fn, *inputs) -> torch.Tensor:
        if self.control:
            return self.q8(fn(*(self.q8(x) for x in inputs)))
        return program

    def draws(self, seed: int, n: int, shape):
        g = torch.Generator(device=self.device).manual_seed(int(seed) & 0xFFFFFFFF)
        return [torch.randn(shape, generator=g, device=self.device, dtype=torch.float32) for _ in range(n)]

    # --- every row, elementwise ------------------------------------------
    def chain(self, batch: Batch, bi: int) -> bool:
        """The hand-overs of every row of ``batch``; False when its calls do
        not follow the loop's plan (then nothing else of it is judged)."""
        plan = self.loop.plan()
        B = len(batch.seeds)
        if batch.delivery_errors:
            self.note("delivery", float(batch.delivery_errors), f"batch {bi}: outputs delivered to other requests")
        ok = len(batch.calls) == len(plan) and len(batch.outputs or ()) == B and all(
            c.x.shape[0] == (B if kind == "eval" else 2 * B)
            and (c.grad is not None if kind == "eval" else c.eps is not None)
            for c, (_i, _r, kind) in zip(batch.calls, plan))
        if not ok:
            self.note("delivery", 1.0, f"batch {bi}: {len(batch.calls)} calls for a plan of {len(plan)}")
            return False
        # every call at its step's timestep, and with the context rows of the batch's first
        # CFG forward ([uncond, cond] per row; an eval takes the cond rows alone)
        ctx0 = next(c.ctx for c, e in zip(batch.calls, plan) if e[2] == "cfg")
        wrong_t = sum(c.t != int(self.sched.timesteps[i]) for c, (i, _r, _kind) in zip(batch.calls, plan))
        wrong_ctx = sum(not torch.equal(c.ctx, ctx0 if kind == "cfg" else ctx0[1::2])
                        for c, (_i, _r, kind) in zip(batch.calls, plan))
        if wrong_t:
            self.note("delivery", float(wrong_t), f"batch {bi}: {wrong_t} calls at another step's timestep")
        if wrong_ctx:
            self.note("delivery", float(wrong_ctx), f"batch {bi}: {wrong_ctx} calls with another context")
        g = self.loop.guidance_scale
        shape = (1,) + tuple(batch.calls[0].x.shape[1:])
        n_draws = 1 + sum(1 for k in range(1, len(plan)) if plan[k][2] == "eval" and plan[k - 1][2] == "cfg"
                          and plan[k][0] == plan[k - 1][0])

        def identity(v):
            return v.float()

        for b in range(B):
            where = f"batch {bi} row {b}"
            draws = self.draws(batch.seeds[b], n_draws, shape)
            first = batch.calls[0].x[b:b + 1]
            prog0 = self.q8(draws[0]) if self.control else first.float()
            self.note("init_max_abs", float((prog0 - draws[0].to(first.dtype).float()).abs().max()), where)
            pending, used, k_in_pass = None, 1, 0
            for k, (c, (i, r, kind)) in enumerate(zip(batch.calls, plan)):
                x = c.x[2 * b:2 * b + 1] if kind == "cfg" else c.x[b:b + 1]
                if kind == "cfg" and not torch.equal(c.x[2 * b], c.x[2 * b + 1]):
                    self.note("delivery", 1.0, f"{where} step {i}: the CFG pair's latents differ")
                if pending is not None:
                    expect, fn, ins = pending
                    self.note("state_rel", rel(self.side(x, fn, *ins), expect), f"{where} step {i} pass {r} {kind} {k}")
                if kind == "eval":
                    k_in_pass = k_in_pass + 1 if k > 0 and plan[k - 1][2] == "eval" else 0
                    if k_in_pass == 0:  # eval0 does not move the latent
                        pending = (identity(x), identity, (x,))
                    else:
                        gr, lr = c.grad[b:b + 1], self.loop.lr[i]

                        def step(v, gr, lr=lr):
                            return sampler.gradient_step(v, gr, lr)
                        pending = (step(x, gr), step, (x, gr))
                    continue
                eu, ec = c.eps[2 * b:2 * b + 1], c.eps[2 * b + 1:2 * b + 2]

                def cfg_step(x, eu, ec, i=i):
                    return sampler.ddim(self.sched, i, eu + g * (ec - eu), x)
                if k + 1 < len(plan) and plan[k + 1][2] == "eval" and plan[k + 1][0] == i:
                    draw = draws[used]
                    used += 1

                    def renoised(x, eu, ec, i=i, draw=draw):
                        return sampler.renoise(self.sched, i, cfg_step(x, eu, ec), draw)
                    pending = (renoised(x, eu, ec), renoised, (x, eu, ec))
                else:
                    pending = (cfg_step(x, eu, ec), cfg_step, (x, eu, ec))
            # the last DDIM step into the latents the row delivered
            expect, fn, ins = pending
            out = torch.as_tensor(np.asarray(batch.outputs[b].latents), device=self.device)
            self.note("state_rel", rel(self.side(out, fn, *ins), expect), f"{where} delivered latents")
        return True

    # --- sampled rows, through the reference's models ---------------------
    def reference_row(self, ref, batch: Batch, bi: int, b: int, spec_of, scaling_factor: float, final_loss=None):
        plan = self.loop.plan()
        where = f"batch {bi} row {b}"
        prompt = batch.prompts[b]
        fp8 = Precision("fp8")

        def both(fn):
            """(float32 reference, program side or fp8 control)."""
            r = fn()
            if not self.control:
                return r, None
            ref.set_precision(fp8)
            try:
                return r, fn()
            finally:
                ref.set_precision(Precision("fp32"))

        emb, emb8 = both(lambda: ref.embed(ref.prompt_of(prompt)))
        cfg_calls = [c for c, e in zip(batch.calls, plan) if e[2] == "cfg"]
        ctx_prog = cfg_calls[0].ctx[2 * b:2 * b + 2]
        self.note("clip_rel", rel(emb8 if self.control else ctx_prog, emb), where)
        spec = spec_of(prompt)
        last_loss = None
        for c, (i, r, kind) in zip(batch.calls, plan):
            if kind == "cfg":
                x, ctx = c.x[2 * b:2 * b + 2], c.ctx[2 * b:2 * b + 2]
                e_ref, e8 = both(lambda: ref.eps(x, c.t, ctx))
                self.note("eps_rel", rel(e8 if self.control else c.eps[2 * b:2 * b + 2], e_ref), f"{where} step {i}")
            else:
                v, ctx = c.x[b:b + 1], c.ctx[b:b + 1]
                (l_ref, _g, g_ref, off), o8 = both(lambda: ref.eval_grad(v, c.t, ctx, spec))
                prog = o8[2] if self.control else c.grad[b:b + 1]
                gap, side = rel(prog, g_ref), ""
                for flip in kink_flips(off, guidance.centred_tokens(spec)):
                    other = rel(prog, ref.eval_grad(v, c.t, ctx, spec, flip=flip)[2])
                    if other < gap:
                        at = [(k, ("col", "row")[j], round(float(off[k, j]), 4)) for k, j in flip.nonzero().tolist()]
                        gap, side = other, f"the kink's other side at (token, axis, offset) {at}"
                if side:
                    self.notes.append(f"grad_rel {gap:.6g} at {where} step {i} pass {r}: {side}; "
                                      f"this side {rel(prog, g_ref):.6g}")
                self.note("grad_rel", gap, f"{where} step {i} pass {r}")
                last_loss = (l_ref, None if o8 is None else o8[0])
        out = batch.outputs[b]
        if final_loss is not None and last_loss is not None:
            l_ref, l8 = last_loss
            p = l8 if self.control else torch.as_tensor(float(final_loss(out)))
            self.note("loss_rel", abs(float(p) - float(l_ref)) / max(abs(float(l_ref)), 1e-30), where)
        lat = torch.as_tensor(np.asarray(out.latents), device=self.device)
        img_ref, img8 = both(lambda: ref.decode_u8(lat, scaling_factor))
        img = img8 if self.control else torch.as_tensor(np.asarray(out.images_u8), device=self.device)
        self.note("image_rms", float(torch.sqrt(((img.float() - img_ref.float()) ** 2).mean())), where)


def sample_rows(batches: List[Batch], n: int, rng: np.random.Generator):
    """``n`` (batch, row) pairs drawn from ``rng`` among every row."""
    rows = [(bi, b) for bi, bt in enumerate(batches) for b in range(len(bt.seeds))]
    pick = rng.choice(len(rows), size=min(n, len(rows)), replace=False)
    return [rows[k] for k in sorted(pick)]
