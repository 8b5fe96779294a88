"""The guided denoising loop (counterpart of the JAX package's ``pipeline.py``).

Each step runs, as in the reference (pipeline_guided_attention.py:925-1053):
  * the guidance eval: a cond-only UNet forward that captures the cross maps
    at ``attention_res``, the token losses, and ``torch.autograd.grad`` of
    the loss w.r.t. the latent (or the deep features), inside the
    eval0 / refine / final phase loop (pipeline:501-578);
  * the gradient-update gate and the re-noise recursion ("time travel",
    pipeline:1044-1053);
  * the CFG forward (no gradient; two rows a sample) and the DDIM step in
    float32.

The JAX package traces all of it into one ``lax.scan``; here it is a Python
loop, and each threshold test is a host read of one boolean per sample. The
eval forward is truncated after the last captured layer
(``UNet2DCondition``'s ``truncate``), which XLA's dead-code elimination does
for the JAX program.

The loop runs a batch of B samples (``generate_batch``; the runner's
one-image ``dispatch`` is B = 1), as the JAX package vmaps its one-sample
loop: every sample keeps its own phase, refinement count, momentum, update
gate, recursion count and draws, so sample b of a batch is the one-sample
run of its latents, prompt and noise. Each eval and each recursion pass runs only the samples still in
it (the JAX package evaluates all of them and freezes the finished ones by a
select). The CFG forward's rows are each sample's (uncond, cond) pair in
turn, which is how paint-with-words finds a sample's rows.

Random draws come from one ``noise(kind, i, r)`` callable per sample
("renoise" or "eta", step i, recursion r or None) so that tests can hand in
the JAX package's own draws; the runner's default draws from the sample's
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from guided_attention_tpu_torch.config import HyperParams
from guided_attention_tpu_torch.guidance.losses import (
    compute_loss,
    compute_token_stats,
    meets_threshold,
    per_token_losses,
)
from guided_attention_tpu_torch.guidance.spec import GuidanceSpec, spec_row
from guided_attention_tpu_torch.models.unet import EMPTY_CAPTURE
from guided_attention_tpu_torch.schedulers.ddim import DDIMSchedule, ddim_step, renoise

NoiseSource = Callable[[str, int, Optional[int]], torch.Tensor]
K_TOKENS = 77


def sgd_momentum_update(v, grad, vel, lr):
    """One refinement SGD step (reference pipeline:495-497, 549-553):
    ``torch.optim.SGD([latents], lr=step_size/2.5, momentum=0.8)``.

    Rounds as the JAX function does once compiled, with ``lr`` a float32
    scalar (the pipeline's step size): the weakly typed 0.8 takes the
    latent's dtype (0.80078125 in bf16) and ``0.8 * vel`` is rounded to it;
    the returned momentum is the sum rounded once more, while the latent's
    update reads the float32 sum before that rounding (XLA fuses the two
    and drops the round trip) and scales it by ``lr * 0.4`` (XLA's form of
    ``lr / 2.5``)."""
    m = (torch.tensor(0.8, dtype=v.dtype) * vel).float() + grad.float()
    step = torch.as_tensor(lr, dtype=torch.float32, device=v.device) * torch.tensor(0.4, dtype=torch.float32)
    return (v.float() - step * m).to(v.dtype), m.to(v.dtype)


def plain_update(v, grad, lr, loss):
    """The reference's ``_update_latent`` (pipeline:455-470): v - lr*grad in
    float32, applied only when loss != 0 (``loss`` a scalar, or one per
    sample of v's leading axis)."""
    gate = (loss != 0.0).reshape(loss.shape + (1,) * (v.dim() - loss.dim()))
    return torch.where(gate, (v.float() - lr * grad.float()).to(v.dtype), v)


@dataclasses.dataclass(frozen=True)
class GenStatics:
    """Constants of one generation run (the JAX package's trace-time statics)."""

    num_steps: int = 50
    guidance_scale: float = 7.5
    attention_res: int = 16
    smooth_attentions: bool = True
    sigma: float = 0.5
    kernel_size: int = 3
    max_refinement_steps: int = 10
    run_standard_sd: bool = False
    skip_inert_guidance_passes: bool = True
    sub_prompt_avg_within: bool = False
    only_update_on_threshold_steps: bool = True
    max_iter_to_alter: int = 25
    eta: float = 0.0
    last_threshold: float = 1.0  # meets_threshold(-1, ...) value (pipeline:1083)
    capture_step_maps: bool = True
    capture_eval_maps: bool = False
    # recompute the eval forward during its backward instead of keeping its
    # activations (torch.utils.checkpoint)
    remat_guidance_eval: bool = False
    capture_eval_latents: bool = False
    # 0 = loss scalars and control-flow counters only; 1 = full diagnostics
    diag_level: int = 1


@dataclasses.dataclass
class StepArrays:
    """Host-side per-step arrays indexed by step i (numpy, length S)."""

    step_sizes: np.ndarray  # f32 scale_factor * sqrt(linspace(scale_range))
    thresholds: np.ndarray  # f32, +inf where i not in thresholds
    update_gate: np.ndarray  # bool (pipeline:998)
    guidance_needed: np.ndarray  # bool — the eval can matter at this step
    pww_gates: np.ndarray  # f32 (i < pww_stop) * log1p(sigma_i)


def guidance_gates(statics: GenStatics, hp: HyperParams):
    """(thresholds[S], update_gate[S], guidance_needed[S]) as numpy."""
    S = statics.num_steps
    thresholds = np.full(S, np.inf, np.float32)
    for k, v in hp.thresholds.items():
        if 0 <= int(k) < S:
            thresholds[int(k)] = v
    is_thresh = np.isfinite(thresholds)
    update_gate = is_thresh.copy()
    if not statics.only_update_on_threshold_steps:
        update_gate |= np.arange(S) < statics.max_iter_to_alter
    return thresholds, update_gate, is_thresh | update_gate


def make_step_arrays(statics: GenStatics, hp: HyperParams, sched: DDIMSchedule, scale_factor: float, scale_range) -> StepArrays:
    S = statics.num_steps
    step_sizes = scale_factor * np.sqrt(np.linspace(scale_range[0], scale_range[1], S))
    thresholds, update_gate, guidance_needed = guidance_gates(statics, hp)
    sig = sched.sigmas.detach().cpu().numpy()
    pww = (np.arange(S) < hp.paint_with_words_stop).astype(np.float32) * np.log1p(sig)
    return StepArrays(
        step_sizes=step_sizes.astype(np.float32),
        thresholds=thresholds,
        update_gate=update_gate,
        guidance_needed=guidance_needed,
        pww_gates=pww.astype(np.float32),
    )


@dataclasses.dataclass
class StepDiag:
    """Per-step diagnostics stacked over steps (numpy). At diag_level 0 the
    bulky fields are unit placeholders, as in the JAX package."""

    total_loss: np.ndarray
    group_unscaled: np.ndarray  # [S, G]
    per_token_unscaled: np.ndarray  # [S, K]
    token_attn_sum: np.ndarray  # [S, K]
    col: np.ndarray  # [S, K]
    row: np.ndarray  # [S, K]
    max_attn: np.ndarray  # [S, K]
    refine_iters: np.ndarray  # int32 — last recursion's refinement subiters
    n_evals: np.ndarray  # int32 — guidance evals, cumulative over recursions
    did_update: np.ndarray  # bool
    recursions: np.ndarray  # int32
    latent_mean: np.ndarray  # [S, C]
    latent_std: np.ndarray  # [S, C] (std of |latent|)
    latent_p99: np.ndarray  # [S, C] (99th pct of |latent|)
    x0_pred: np.ndarray  # [S, h, w, C] f16
    latent_in: np.ndarray  # [S, h, w, C] f16 — step-entry latents
    maps: np.ndarray  # [S, R, R, K] f16 final-eval smoothed maps
    eval_unscaled: np.ndarray  # [S, R_sub, K]
    eval_mask: np.ndarray  # bool[S, R_sub]
    eval_maps: np.ndarray  # f16[S, R_sub, R, R, K] (or unit)
    eval_latents: np.ndarray  # f16[S, R_sub, h, w, C] (or unit)

    def sample(self, b: int) -> "StepDiag":
        """Sample ``b`` of a batch's diagnostics (every field [B, S, ...])."""
        return StepDiag(**{f.name: getattr(self, f.name)[b] for f in dataclasses.fields(self)})


def aggregate_cross_maps(maps: Dict[str, Any], res: int, from_where=("up", "down", "mid")):
    """Mean over layers (heads already averaged) of the captured cross maps
    at ``res`` -> [B, R, R, K] (reference utils/ptp_utils.py:273-289)."""
    items = []
    for place in from_where:
        items.extend(maps[f"{place}_cross"])
    stacked = torch.stack(items, dim=0)  # [L, B, Q, K]
    return stacked.mean(dim=0).reshape(-1, res, res, stacked.shape[-1])


def generate_batch(
    sd,
    statics: GenStatics,
    hp: HyperParams,
    emb: torch.Tensor,
    latents0: torch.Tensor,
    spec: GuidanceSpec,
    sched: DDIMSchedule,
    arrays: StepArrays,
    noise: Sequence[NoiseSource],
    from_where: Tuple[str, ...] = ("up", "down", "mid"),
    on_device: Optional[Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]] = None,
    start: int = 0,
    stop: Optional[int] = None,
) -> Tuple[torch.Tensor, StepDiag]:
    """Run the guided loop for B samples: ``latents0`` [B, h, w, C], ``emb``
    [B, 2, 77, D], ``spec`` stacked (``stack_specs``), one noise source per
    sample. Returns (final latents [B, h, w, C], StepDiag with every field
    [B, S, ...]). ``on_device`` maps the stacked diagnostic tensors (still
    on the device, by field name) to the tensors copied to the host; the
    runner's ``trim_heavy_diags`` slices and gathers them there.

    ``start`` / ``stop`` run only the steps [start, stop) of the schedule
    (a segment of a resumable run): ``latents0`` is then the latent entering
    ``start``, the diagnostics hold stop - start steps, and everything per
    step stays keyed by the absolute step."""
    with torch.no_grad():
        return _Loop(sd, statics, hp, emb, spec, sched, arrays, noise, from_where).run(latents0, on_device, start, stop)


@dataclasses.dataclass
class _Pass:
    """One recursion pass's results, one row per sample it ran."""

    prev: torch.Tensor
    x0: torch.Tensor
    loss: torch.Tensor  # [n]
    aux: Dict[str, torch.Tensor]
    bufs: Dict[str, torch.Tensor]
    did_update: List[bool]
    refine_iters: List[int]
    n_evals: List[int]


class _Loop:
    PH_EVAL0, PH_REFINE, PH_FINAL, PH_DONE = 0, 1, 2, 3

    def __init__(self, sd, statics, hp, emb, spec, sched, arrays, noise, from_where):
        self.unet = sd.unet
        self.st = statics
        self.hp = hp
        self.sched = sched
        self.arrays = arrays
        self.noise = noise
        self.from_where = from_where
        self.uncond, self.cond = emb[:, 0], emb[:, 1]
        self.specs = [spec_row(spec, b) for b in range(emb.shape[0])]
        self.pww = spec.pww_masks if spec.pww_masks else None
        self.R = statics.attention_res
        self.R_sub = statics.max_refinement_steps + 2
        self.capture = frozenset({("cross", self.R)})
        self.guided = not statics.run_standard_sd
        self.deep_mode = bool(hp.optimize_deep_latent) and self.guided
        self.timesteps = [int(t) for t in sched.timesteps.tolist()]
        self._indices: Dict[Tuple, torch.Tensor] = {}

    # --- rows of a batch ----------------------------------------------------
    # ``rows`` lists distinct rows in increasing order, so all of them is
    # the identity: the one-sample loop and a batch whose samples move
    # together pay no gather or scatter
    def _index(self, rows) -> torch.Tensor:
        key = tuple(rows)
        if key not in self._indices:
            self._indices[key] = torch.tensor(key, device=self.cond.device)
        return self._indices[key]

    def take(self, x, rows):
        if isinstance(x, dict):
            return {k: self.take(v, rows) for k, v in x.items()}
        return x if len(rows) == x.shape[0] else x[self._index(rows)]

    def put(self, x, rows, y):
        """``x`` with its rows ``rows`` replaced by ``y`` (a new tensor)."""
        if isinstance(x, dict):
            return {k: self.put(x[k], rows, y[k]) for k in x}
        return y if len(rows) == x.shape[0] else x.index_put((self._index(rows),), y)

    # --- UNet calls -------------------------------------------------------
    def unet_eps(self, latents, t, samples, context, cap=EMPTY_CAPTURE, gate=None, deep_inject=None, truncate=False,
                 deep_inject_gate=None):
        pww = None if self.pww is None else {res: self.take(m, samples) for res, m in self.pww.items()}
        return self.unet(latents, t, context, capture=cap, pww=pww, pww_gate=gate, deep_inject=deep_inject,
                         truncate=truncate, deep_inject_gate=deep_inject_gate)

    def guidance_eval(self, base_latents, samples, t, gate, var):
        """(loss [n], aux, grad) of the optimization variable ``var`` [n, ...]
        of the samples ``samples`` through the truncated cond-only UNet
        (reference pipeline:946-973). The gradient is taken of the sum of
        the samples' losses; nothing couples two samples, so each row is
        its sample's own gradient."""
        st, hp, R = self.st, self.hp, self.R
        agg_from = ("up",) if self.deep_mode else self.from_where
        cond = self.take(self.cond, samples)

        def loss_fn(v):
            if self.deep_mode:
                _eps, aux = self.unet_eps(base_latents, t, samples, cond, self.capture, gate, deep_inject=v, truncate=True)
            else:
                _eps, aux = self.unet_eps(v, t, samples, cond, self.capture, gate, truncate=True)
            maps = aggregate_cross_maps(aux["maps"], R, agg_from)
            per_sample = []
            for j, b in enumerate(samples):
                spec = self.specs[b]
                stats = compute_token_stats(maps[j], spec, hp, st.smooth_attentions, st.sigma, st.kernel_size)
                total, _gs, gu, valid = compute_loss(stats, spec, hp, st.sub_prompt_avg_within)
                _scaled, unscaled = per_token_losses(stats, spec, hp)
                per_sample.append((total, gu, valid, unscaled, stats.probs, stats.smoothed, stats.col, stats.row,
                                   stats.max_attn))
            stacked = [torch.stack(field) for field in zip(*per_sample)]
            return (stacked[0].sum(), *stacked)

        with torch.enable_grad():
            v = var.detach().requires_grad_(True)
            outs = checkpoint(loss_fn, v, use_reentrant=False) if st.remat_guidance_eval else loss_fn(v)
            (grad,) = torch.autograd.grad(outs[0], v)
        total, gu, valid, unscaled, probs, smoothed, col, row, max_attn = (o.detach() for o in outs[1:])
        aux = {
            "gu": gu,
            "valid": valid,
            "unscaled_tok": unscaled,
            "attn_sum": probs.sum(dim=(1, 2)),
            "col": col,
            "row": row,
            "max_attn": max_attn,
            "maps": smoothed if st.capture_step_maps else torch.zeros_like(smoothed),
        }
        if st.capture_eval_maps:
            aux["probs16"] = probs.half()
        return total, aux, grad

    def zero_aux(self, n, device):
        K, R = K_TOKENS, self.R
        z = torch.zeros(n, K, device=device)
        return {
            "gu": torch.zeros(n, self.specs[0].n_groups, device=device),
            "valid": torch.zeros(n, self.specs[0].n_groups, dtype=torch.bool, device=device),
            "unscaled_tok": z,
            "attn_sum": z,
            "col": z,
            "row": z,
            "max_attn": z,
            "maps": torch.zeros(n, R, R, K, device=device),
        }

    def eval_buffers(self, latents):
        n, dev = latents.shape[0], latents.device
        K, R, R_sub = K_TOKENS, self.R, self.R_sub
        return {
            "eval_unscaled": torch.zeros(n, R_sub, K, device=dev),
            "eval_mask": torch.zeros(n, R_sub, dtype=torch.bool, device=dev),
            "eval_maps": torch.zeros((n, R_sub, R, R, K) if self.st.capture_eval_maps else (n, 1, 1, 1, 1),
                                     dtype=torch.float16, device=dev),
            "eval_latents": torch.zeros(
                (n, R_sub) + tuple(latents.shape[1:]) if self.st.capture_eval_latents else (n, 1, 1, 1, 1),
                dtype=torch.float16, device=dev,
            ),
        }

    # --- one step's guidance ----------------------------------------------
    def guided_update(self, latents, samples, i, t, gate):
        """Refinement + gradient update of one step (pipeline:961-1007) for
        the samples ``samples``, each with its own phase machine. Returns
        (latents, deep, did_update, entered_refine, loss, aux, refine_iters,
        n_evals, eval buffers), the lists one entry per sample."""
        st, hp, arrays = self.st, self.hp, self.arrays
        PH_EVAL0, PH_REFINE, PH_FINAL, PH_DONE = self.PH_EVAL0, self.PH_REFINE, self.PH_FINAL, self.PH_DONE
        step_size = float(arrays.step_sizes[i])
        lr = step_size * 200.0 if self.deep_mode else step_size
        thresh_i = float(arrays.thresholds[i])
        n, dev = latents.shape[0], latents.device
        bufs = self.eval_buffers(latents)

        if self.deep_mode:
            # fresh capture of the bottleneck (reference pipeline:704)
            cond = self.take(self.cond, samples)
            _eps0, cap0 = self.unet_eps(latents, t, samples, cond, EMPTY_CAPTURE, gate, truncate=True)
            var = cap0["deep"]
        else:
            var = latents

        phase, n_ref, n_ev, needs = [PH_EVAL0] * n, [0] * n, [0] * n, [False] * n
        v, vel = var, torch.zeros_like(var)
        l_fin, g_fin, a_fin = torch.zeros(n, device=dev), torch.zeros_like(var), self.zero_aux(n, dev)
        aux0 = None
        max_ref = st.max_refinement_steps
        while True:
            live = [j for j in range(n) if phase[j] != PH_DONE]
            if not live:
                break
            loss, aux, grad = self.guidance_eval(self.take(latents, live), [samples[j] for j in live], t, gate,
                                                 self.take(v, live))
            met = meets_threshold(aux["gu"], aux["valid"], thresh_i).tolist()
            if aux0 is None:  # every sample's first eval is this one
                aux0 = aux

            if st.diag_level:
                slots = [0 if phase[j] == PH_EVAL0 else (self.R_sub - 1 if phase[j] == PH_FINAL else n_ref[j] + 1)
                         for j in live]
                at = (self._index(live), self._index(slots))
                bufs["eval_unscaled"] = bufs["eval_unscaled"].index_put(at, aux["unscaled_tok"])
                bufs["eval_mask"] = bufs["eval_mask"].index_put(at, torch.ones((), dtype=torch.bool, device=dev))
                if st.capture_eval_maps:
                    bufs["eval_maps"] = bufs["eval_maps"].index_put(at, aux["probs16"])
                if st.capture_eval_latents:
                    cur = self.take(latents if self.deep_mode else v, live)
                    bufs["eval_latents"] = bufs["eval_latents"].index_put(at, cur.half())

            # refining samples take their step; k indexes this eval's rows
            refine = [k for k, j in enumerate(live) if phase[j] == PH_REFINE]
            if refine:
                rows = [live[k] for k in refine]
                g = self.take(grad, refine)
                if hp.use_optimizer:
                    v_new, vel_new = sgd_momentum_update(self.take(v, rows), g, self.take(vel, rows), lr)
                    vel = self.put(vel, rows, vel_new)
                else:
                    v_new = plain_update(self.take(v, rows), g, lr, self.take(loss, refine))
                v = self.put(v, rows, v_new)
                for j in rows:
                    n_ref[j] += 1
            # the eval that stands for the step: eval0 when it meets the
            # threshold, else the final fresh forward
            fin = [k for k, j in enumerate(live) if (phase[j] == PH_EVAL0 and met[k]) or phase[j] == PH_FINAL]
            if fin:
                rows = [live[k] for k in fin]
                l_fin = self.put(l_fin, rows, self.take(loss, fin))
                g_fin = self.put(g_fin, rows, self.take(grad, fin))
                a_fin = self.put(a_fin, rows, self.take({key: aux[key] for key in a_fin}, fin))

            # refine while the latest eval misses the threshold and budget
            # remains (pipeline:501, 560-562), then one final fresh forward
            for k, j in enumerate(live):
                n_ev[j] += 1
                if phase[j] == PH_EVAL0:
                    needs[j] = not met[k]
                    phase[j] = PH_DONE if met[k] else (PH_REFINE if max_ref > 0 else PH_FINAL)
                elif phase[j] == PH_FINAL:
                    phase[j] = PH_DONE
                else:
                    phase[j] = PH_FINAL if (met[k] or n_ref[j] >= max_ref) else PH_REFINE

        # update gate (pipeline:998-1007): the LAST threshold value and the
        # STALE pre-refinement losses decide; the post-refinement gradient
        # is applied
        apply = [False] * n
        if arrays.update_gate[i]:
            met_last = meets_threshold(aux0["gu"], aux0["valid"], st.last_threshold).tolist()
            apply = [not m for m in met_last]
        rows = [j for j in range(n) if apply[j]]
        var2 = v
        if rows:
            var2 = self.put(v, rows, plain_update(self.take(v, rows), self.take(g_fin, rows), lr, self.take(l_fin, rows)))
        did_update = [a or b for a, b in zip(needs, apply)]
        if self.deep_mode:
            return latents, var2, did_update, needs, l_fin, a_fin, n_ref, n_ev, bufs
        return var2, None, did_update, needs, l_fin, a_fin, n_ref, n_ev, bufs

    def cfg_eps(self, latents, samples, t, gate, deep_inject=None, deep_inject_gate=None):
        g = self.st.guidance_scale
        cond = self.take(self.cond, samples)
        if g > 1.0:
            # rows: each sample's (uncond, cond) pair in turn
            n = latents.shape[0]
            pair = latents.repeat_interleave(2, dim=0)
            ctx = torch.stack([self.take(self.uncond, samples), cond], dim=1).flatten(0, 1)
            eps_pair, _ = self.unet_eps(pair, t, samples, ctx, EMPTY_CAPTURE, gate, deep_inject,
                                        deep_inject_gate=deep_inject_gate)
            eps_pair = eps_pair.reshape(n, 2, *eps_pair.shape[1:])
            eps_u, eps_c = eps_pair[:, 0], eps_pair[:, 1]
            return eps_u + g * (eps_c - eps_u)
        eps, _ = self.unet_eps(latents, t, samples, cond, EMPTY_CAPTURE, gate, deep_inject,
                               deep_inject_gate=deep_inject_gate)
        return eps

    def one_pass(self, latents, samples, i, t, gate, r) -> _Pass:
        """guidance + CFG + scheduler for one recursion iteration of the
        samples ``samples``."""
        n, dev = latents.shape[0], latents.device
        if self.guided and (self.arrays.guidance_needed[i] or not self.st.skip_inert_guidance_passes):
            lat2, deep, did_update, entered, loss, aux, ri, nev, bufs = self.guided_update(latents, samples, i, t, gate)
        else:
            lat2, deep, did_update, entered = latents, None, [False] * n, [False] * n
            loss, aux, ri, nev = torch.zeros(n, device=dev), self.zero_aux(n, dev), [0] * n, [0] * n
            bufs = self.eval_buffers(latents)
        # deep mode injects the optimized features only where refinement ran
        inject, inject_gate = None, None
        if self.deep_mode and any(entered):
            inject = deep
            if not all(entered):
                inject_gate = torch.tensor(entered, device=dev)
        eps = self.cfg_eps(lat2, samples, t, gate, inject, inject_gate)
        eta_noise = torch.cat([self.noise[b]("eta", i, r) for b in samples]) if self.st.eta > 0.0 else None
        prev, x0 = ddim_step(self.sched, i, eps.float(), lat2.float(), eta=self.st.eta, noise=eta_noise)
        return _Pass(prev.to(latents.dtype), x0, loss, aux, bufs, did_update, ri, nev)

    # --- the step loop -------------------------------------------------------
    def run(self, latents0, on_device=None, start=0, stop=None):
        """Steps [start, stop) of the schedule (all of them by default);
        nothing but the latents crosses from one step to the next here, and
        each sample's draws come from its own noise source."""
        st, hp = self.st, self.hp
        stop = st.num_steps if stop is None else stop
        if not 0 <= start < stop <= st.num_steps:
            raise ValueError(f"steps [{start}, {stop}) are not a segment of [0, {st.num_steps})")
        B = latents0.shape[0]
        recurse_steps = max(int(hp.recurse_steps), 1) if self.guided else 1
        latents = latents0
        rows = []
        for i in range(start, stop):
            t = self.timesteps[i]
            gate = float(self.arrays.pww_gates[i])
            # re-noise recursion ("time travel"): a sample re-runs the step
            # while its update ran, up to recurse_steps passes
            active, work, r, out = list(range(B)), latents, 0, None
            n_evals, recursions = [0] * B, [0] * B
            while active:
                p = self.one_pass(work, active, i, t, gate, r if recurse_steps > 1 else None)
                for j, b in enumerate(active):
                    n_evals[b] += p.n_evals[j]
                    recursions[b] = r + 1
                out = p if out is None else self._merge(out, active, p)
                again = [j for j in range(len(active))
                         if i <= hp.recurse_until and p.did_update[j] and r + 1 < recurse_steps]
                if again:
                    draws = torch.cat([self.noise[active[j]]("renoise", i, r) for j in again])
                    work = renoise(self.sched, i, self.take(p.prev, again), draws)
                active = [active[j] for j in again]
                r += 1
            rows.append(self._diag_row(latents, out, n_evals, recursions))
            latents = out.prev.to(latents0.dtype)
        return latents, self._stack(rows, on_device)

    def _merge(self, out: _Pass, samples, p: _Pass) -> _Pass:
        """``out`` with the rows of ``samples`` taken from the later pass ``p``."""
        lists = {}
        for name in ("did_update", "refine_iters", "n_evals"):
            merged = list(getattr(out, name))
            for j, b in enumerate(samples):
                merged[b] = getattr(p, name)[j]
            lists[name] = merged
        return _Pass(
            prev=self.put(out.prev, samples, p.prev),
            x0=self.put(out.x0, samples, p.x0),
            loss=self.put(out.loss, samples, p.loss),
            aux=self.put(out.aux, samples, p.aux),
            bufs=self.put(out.bufs, samples, p.bufs),
            **lists,
        )

    def _diag_row(self, latents, out: _Pass, n_evals, recursions):
        row = {
            "total_loss": out.loss,
            "group_unscaled": out.aux["gu"],
            "refine_iters": out.refine_iters,
            "n_evals": n_evals,
            "did_update": out.did_update,
            "recursions": recursions,
        }
        if not self.st.diag_level:
            return row
        aux = out.aux
        lat = out.prev.float()
        absl = lat.abs()
        B, C = lat.shape[0], lat.shape[-1]
        row.update(
            per_token_unscaled=aux["unscaled_tok"],
            token_attn_sum=aux["attn_sum"],
            col=aux["col"],
            row=aux["row"],
            max_attn=aux["max_attn"],
            latent_mean=lat.mean(dim=(1, 2)),
            latent_std=absl.std(dim=(1, 2), correction=0),
            latent_p99=torch.quantile(absl.reshape(B, -1, C), 0.99, dim=1),
            x0_pred=out.x0.half(),
            latent_in=latents.half(),
            maps=aux["maps"].half(),
            **out.bufs,
        )
        return row

    def _stack(self, rows, on_device=None) -> StepDiag:
        """Per-step rows -> StepDiag with every field [B, S, ...]."""
        S = len(rows)
        B = len(rows[0]["n_evals"])
        out = {}
        for name in ("refine_iters", "n_evals", "recursions"):
            out[name] = np.asarray([r[name] for r in rows], np.int32).T.copy()
        out["did_update"] = np.asarray([r["did_update"] for r in rows], bool).T.copy()
        stacked = {k: torch.stack([r[k] for r in rows], dim=1) for k in rows[0] if k not in out}
        if on_device is not None:
            stacked = on_device(stacked)
        # one device->host copy per field
        for name, t in stacked.items():
            out[name] = t.cpu().numpy()
        if not self.st.diag_level:
            unit = {
                "per_token_unscaled": np.zeros((B, S, 1), np.float32),
                "token_attn_sum": np.zeros((B, S, 1), np.float32),
                "col": np.zeros((B, S, 1), np.float32),
                "row": np.zeros((B, S, 1), np.float32),
                "max_attn": np.zeros((B, S, 1), np.float32),
                "latent_mean": np.zeros((B, S, 1), np.float32),
                "latent_std": np.zeros((B, S, 1), np.float32),
                "latent_p99": np.zeros((B, S, 1), np.float32),
                "x0_pred": np.zeros((B, S, 1, 1, 1), np.float16),
                "latent_in": np.zeros((B, S, 1, 1, 1), np.float16),
                "maps": np.zeros((B, S, 1, 1, 1), np.float16),
                "eval_unscaled": np.zeros((B, S, 1, 1), np.float32),
                "eval_mask": np.zeros((B, S, 1), bool),
                "eval_maps": np.zeros((B, S, 1, 1, 1, 1), np.float16),
                "eval_latents": np.zeros((B, S, 1, 1, 1, 1), np.float16),
            }
            out.update(unit)
        return StepDiag(**out)
