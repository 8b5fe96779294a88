"""The guided denoising loop (counterpart of the JAX package's ``pipeline.py``).

Each step runs, as in the reference (pipeline_guided_attention.py:925-1053):
  * the guidance eval: a cond-only UNet forward that captures the cross maps
    at ``attention_res``, the token losses, and ``torch.autograd.grad`` of
    the loss w.r.t. the latent (or the deep features), inside the
    eval0 / refine / final phase loop (pipeline:501-578);
  * the gradient-update gate and the re-noise recursion ("time travel",
    pipeline:1044-1053);
  * the batch-2 CFG forward (no gradient) and the DDIM step in float32.

The JAX package traces all of it into one ``lax.scan``; here it is a Python
loop, and each threshold test is a host read of one boolean. The eval
forward is truncated after the last captured layer (``UNet2DCondition``'s
``truncate``), which XLA's dead-code elimination does for the JAX program.

Random draws come from a ``noise(kind, i, r)`` callable ("renoise" or "eta",
step i, recursion r or None) so that tests can hand in the JAX package's
own draws; the runner's default draws from the run's ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

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
from guided_attention_tpu_torch.guidance.spec import GuidanceSpec
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
    float32, applied only when loss != 0."""
    return torch.where(loss != 0.0, (v.float() - lr * grad.float()).to(v.dtype), v)


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


def aggregate_cross_maps(maps: Dict[str, Any], res: int, from_where=("up", "down", "mid")):
    """Mean over layers (heads already averaged) of the captured cross maps
    at ``res`` -> [R, R, K] (reference utils/ptp_utils.py:273-289)."""
    items = []
    for place in from_where:
        items.extend(maps[f"{place}_cross"])
    stacked = torch.stack([m[0] for m in items], dim=0)  # [L, Q, K]
    return stacked.mean(dim=0).reshape(res, res, stacked.shape[-1])


def generate(
    sd,
    statics: GenStatics,
    hp: HyperParams,
    emb: torch.Tensor,
    latents0: torch.Tensor,
    spec: GuidanceSpec,
    sched: DDIMSchedule,
    arrays: StepArrays,
    noise: NoiseSource,
    from_where: Tuple[str, ...] = ("up", "down", "mid"),
) -> Tuple[torch.Tensor, StepDiag]:
    """Run the guided loop for one sample from ``latents0`` [1, h, w, C]
    (NHWC); returns (final latents, StepDiag)."""
    with torch.no_grad():
        return _Loop(sd, statics, hp, emb, spec, sched, arrays, noise, from_where).run(latents0)


class _Loop:
    PH_EVAL0, PH_REFINE, PH_FINAL, PH_DONE = 0, 1, 2, 3

    def __init__(self, sd, statics, hp, emb, spec, sched, arrays, noise, from_where):
        self.unet = sd.unet
        self.st = statics
        self.hp = hp
        self.spec = spec
        self.sched = sched
        self.arrays = arrays
        self.noise = noise
        self.from_where = from_where
        self.uncond, self.cond = emb[0:1], emb[1:2]
        self.pww = spec.pww_masks if spec.pww_masks else None
        self.R = statics.attention_res
        self.R_sub = statics.max_refinement_steps + 2
        self.capture = frozenset({("cross", self.R)})
        self.guided = not statics.run_standard_sd
        self.deep_mode = bool(hp.optimize_deep_latent) and self.guided
        self.timesteps = [int(t) for t in sched.timesteps.tolist()]

    # --- UNet calls -------------------------------------------------------
    def unet_eps(self, latents, t, context, cap=EMPTY_CAPTURE, gate=None, deep_inject=None, truncate=False):
        return self.unet(latents, t, context, capture=cap, pww=self.pww, pww_gate=gate, deep_inject=deep_inject, truncate=truncate)

    def guidance_eval(self, base_latents, t, gate, var):
        """(loss, aux, grad) of the optimization variable ``var`` through the
        truncated cond-only UNet (reference pipeline:946-973)."""
        st, spec, hp, R = self.st, self.spec, self.hp, self.R
        agg_from = ("up",) if self.deep_mode else self.from_where

        def loss_fn(v):
            if self.deep_mode:
                _eps, aux = self.unet_eps(base_latents, t, self.cond, self.capture, gate, deep_inject=v, truncate=True)
            else:
                _eps, aux = self.unet_eps(v, t, self.cond, self.capture, gate, truncate=True)
            maps = aggregate_cross_maps(aux["maps"], R, agg_from)
            stats = compute_token_stats(maps, spec, hp, st.smooth_attentions, st.sigma, st.kernel_size)
            total, _gs, gu, valid = compute_loss(stats, spec, hp, st.sub_prompt_avg_within)
            _scaled, unscaled = per_token_losses(stats, spec, hp)
            return total, gu, valid, unscaled, stats.probs, stats.smoothed, stats.col, stats.row, stats.max_attn

        with torch.enable_grad():
            v = var.detach().requires_grad_(True)
            outs = checkpoint(loss_fn, v, use_reentrant=False) if st.remat_guidance_eval else loss_fn(v)
            (grad,) = torch.autograd.grad(outs[0], v)
        total, gu, valid, unscaled, probs, smoothed, col, row, max_attn = (o.detach() for o in outs)
        aux = {
            "gu": gu,
            "valid": valid,
            "unscaled_tok": unscaled,
            "attn_sum": probs.sum(dim=(0, 1)),
            "col": col,
            "row": row,
            "max_attn": max_attn,
            "maps": smoothed if st.capture_step_maps else torch.zeros_like(smoothed),
        }
        if st.capture_eval_maps:
            aux["probs16"] = probs.half()
        return total, aux, grad

    def zero_aux(self, device):
        K, R = K_TOKENS, self.R
        z = torch.zeros(K, device=device)
        return {
            "gu": torch.zeros(self.spec.n_groups, device=device),
            "valid": torch.zeros(self.spec.n_groups, dtype=torch.bool, device=device),
            "unscaled_tok": z,
            "attn_sum": z,
            "col": z,
            "row": z,
            "max_attn": z,
            "maps": torch.zeros(R, R, K, device=device),
        }

    def eval_buffers(self, latents):
        dev = latents.device
        K, R, R_sub = K_TOKENS, self.R, self.R_sub
        bufs = {
            "eval_unscaled": torch.zeros(R_sub, K, device=dev),
            "eval_mask": torch.zeros(R_sub, dtype=torch.bool, device=dev),
            "eval_maps": torch.zeros((R_sub, R, R, K) if self.st.capture_eval_maps else (1, 1, 1, 1), dtype=torch.float16, device=dev),
            "eval_latents": torch.zeros(
                (R_sub,) + tuple(latents.shape[1:]) if self.st.capture_eval_latents else (1, 1, 1, 1),
                dtype=torch.float16, device=dev,
            ),
        }
        return bufs

    # --- one step's guidance ----------------------------------------------
    def guided_update(self, latents, i, t, gate):
        """Refinement + gradient update of one step (pipeline:961-1007).
        Returns (latents, deep, did_update, entered_refine, loss, aux,
        refine_iters, n_evals, eval buffers)."""
        st, hp, arrays = self.st, self.hp, self.arrays
        step_size = float(arrays.step_sizes[i])
        lr = step_size * 200.0 if self.deep_mode else step_size
        thresh_i = float(arrays.thresholds[i])
        bufs = self.eval_buffers(latents)

        if self.deep_mode:
            # fresh capture of the bottleneck (reference pipeline:704)
            _eps0, cap0 = self.unet_eps(latents, t, self.cond, EMPTY_CAPTURE, gate, truncate=True)
            var = cap0["deep"]
        else:
            var = latents

        phase, n_ref, n_ev, v = self.PH_EVAL0, 0, 0, var
        needs, aux0 = False, None
        l_fin, g_fin, a_fin = torch.zeros((), device=latents.device), torch.zeros_like(var), self.zero_aux(latents.device)
        vel = torch.zeros_like(var)
        max_ref = st.max_refinement_steps
        while phase != self.PH_DONE:
            n_ev += 1
            loss, aux, grad = self.guidance_eval(latents, t, gate, v)
            first, refining, final = phase == self.PH_EVAL0, phase == self.PH_REFINE, phase == self.PH_FINAL
            met = bool(meets_threshold(aux["gu"], aux["valid"], thresh_i))

            if st.diag_level:
                slot = 0 if first else (self.R_sub - 1 if final else n_ref + 1)
                bufs["eval_unscaled"][slot] = aux["unscaled_tok"]
                bufs["eval_mask"][slot] = True
                if st.capture_eval_maps:
                    bufs["eval_maps"][slot] = aux["probs16"]
                if st.capture_eval_latents:
                    cur = latents if self.deep_mode else v
                    bufs["eval_latents"][slot] = cur[0].half()

            if first:
                needs, aux0 = not met, aux
            if refining:
                if hp.use_optimizer:
                    v, vel = sgd_momentum_update(v, grad, vel, lr)
                else:
                    v = plain_update(v, grad, lr, loss)
                n_ref += 1
            if (first and met) or final:
                l_fin, g_fin, a_fin = loss, grad, aux

            # refine while the latest eval misses the threshold and budget
            # remains (pipeline:501, 560-562), then one final fresh forward
            if first:
                phase = self.PH_DONE if met else (self.PH_REFINE if max_ref > 0 else self.PH_FINAL)
            elif final:
                phase = self.PH_DONE
            else:
                phase = self.PH_FINAL if (met or n_ref >= max_ref) else self.PH_REFINE

        # update gate (pipeline:998-1007): the LAST threshold value and the
        # STALE pre-refinement losses decide; the post-refinement gradient
        # is applied
        not_met_last = not bool(meets_threshold(aux0["gu"], aux0["valid"], st.last_threshold))
        apply = bool(arrays.update_gate[i]) and not_met_last
        var2 = plain_update(v, g_fin, lr, l_fin) if apply else v
        did_update = needs or apply
        if self.deep_mode:
            return latents, var2, did_update, needs, l_fin, a_fin, n_ref, n_ev, bufs
        return var2, None, did_update, needs, l_fin, a_fin, n_ref, n_ev, bufs

    def cfg_eps(self, latents, t, gate, deep_inject=None):
        g = self.st.guidance_scale
        if g > 1.0:
            pair = torch.cat([latents, latents], dim=0)
            ctx = torch.cat([self.uncond, self.cond], dim=0)
            eps_pair, _ = self.unet_eps(pair, t, ctx, EMPTY_CAPTURE, gate, deep_inject)
            eps_u, eps_c = eps_pair[0:1], eps_pair[1:2]
            return eps_u + g * (eps_c - eps_u)
        eps, _ = self.unet_eps(latents, t, self.cond, EMPTY_CAPTURE, gate, deep_inject)
        return eps

    def one_pass(self, latents, i, t, gate, r):
        """guidance + CFG + scheduler for one recursion iteration."""
        if self.guided and (self.arrays.guidance_needed[i] or not self.st.skip_inert_guidance_passes):
            lat2, deep, did_update, entered, loss, aux, ri, nev, bufs = self.guided_update(latents, i, t, gate)
        else:
            lat2, deep, did_update, entered = latents, None, False, False
            loss, aux, ri, nev = torch.zeros((), device=latents.device), self.zero_aux(latents.device), 0, 0
            bufs = self.eval_buffers(latents)
        inject = deep if (self.deep_mode and entered) else None
        eps = self.cfg_eps(lat2, t, gate, inject)
        eta_noise = self.noise("eta", i, r) if self.st.eta > 0.0 else None
        prev, x0 = ddim_step(self.sched, i, eps.float(), lat2.float(), eta=self.st.eta, noise=eta_noise)
        return prev.to(latents.dtype), x0, did_update, loss, aux, ri, nev, bufs

    # --- the step loop -------------------------------------------------------
    def run(self, latents0):
        st, hp = self.st, self.hp
        recurse_steps = max(int(hp.recurse_steps), 1)
        latents = latents0
        rows = []
        for i in range(st.num_steps):
            t = self.timesteps[i]
            gate = float(self.arrays.pww_gates[i])
            if recurse_steps > 1 and self.guided:
                r, done, work, n_evals = 0, False, latents, 0
                while not done and r < recurse_steps:
                    prev, x0, did_update, loss, aux, refine_iters, nev, bufs = self.one_pass(work, i, t, gate, r)
                    n_evals += nev
                    done = i > hp.recurse_until or not did_update or r + 1 >= recurse_steps
                    if not done:
                        work = renoise(self.sched, i, prev, self.noise("renoise", i, r))
                    r += 1
                recursions = r
            else:
                prev, x0, did_update, loss, aux, refine_iters, n_evals, bufs = self.one_pass(latents, i, t, gate, None)
                recursions = 1
            rows.append(self._diag_row(latents, prev, x0, loss, aux, refine_iters, n_evals, did_update, recursions, bufs))
            latents = prev.to(latents0.dtype)
        return latents, self._stack(rows)

    def _diag_row(self, latents, prev, x0, loss, aux, refine_iters, n_evals, did_update, recursions, bufs):
        row = {
            "total_loss": loss,
            "group_unscaled": aux["gu"],
            "refine_iters": refine_iters,
            "n_evals": n_evals,
            "did_update": did_update,
            "recursions": recursions,
        }
        if not self.st.diag_level:
            return row
        lat = prev.float()
        absl = lat.abs()
        C = lat.shape[-1]
        row.update(
            per_token_unscaled=aux["unscaled_tok"],
            token_attn_sum=aux["attn_sum"],
            col=aux["col"],
            row=aux["row"],
            max_attn=aux["max_attn"],
            latent_mean=lat.mean(dim=(0, 1, 2)),
            latent_std=absl.std(dim=(0, 1, 2), correction=0),
            latent_p99=torch.quantile(absl.reshape(-1, C), 0.99, dim=0),
            x0_pred=x0[0].half(),
            latent_in=latents[0].half(),
            maps=aux["maps"].half(),
            **bufs,
        )
        return row

    def _stack(self, rows) -> StepDiag:
        S = len(rows)
        out = {}
        for name in ("refine_iters", "n_evals", "recursions"):
            out[name] = np.asarray([r[name] for r in rows], np.int32)
        out["did_update"] = np.asarray([r["did_update"] for r in rows], bool)
        tensor_names = [k for k in rows[0] if k not in out]
        # one device->host copy per field
        for name in tensor_names:
            out[name] = torch.stack([r[name] for r in rows]).cpu().numpy()
        if not self.st.diag_level:
            unit = {
                "per_token_unscaled": np.zeros((S, 1), np.float32),
                "token_attn_sum": np.zeros((S, 1), np.float32),
                "col": np.zeros((S, 1), np.float32),
                "row": np.zeros((S, 1), np.float32),
                "max_attn": np.zeros((S, 1), np.float32),
                "latent_mean": np.zeros((S, 1), np.float32),
                "latent_std": np.zeros((S, 1), np.float32),
                "latent_p99": np.zeros((S, 1), np.float32),
                "x0_pred": np.zeros((S, 1, 1, 1), np.float16),
                "latent_in": np.zeros((S, 1, 1, 1), np.float16),
                "maps": np.zeros((S, 1, 1, 1), np.float16),
                "eval_unscaled": np.zeros((S, 1, 1), np.float32),
                "eval_mask": np.zeros((S, 1), bool),
                "eval_maps": np.zeros((S, 1, 1, 1, 1), np.float16),
                "eval_latents": np.zeros((S, 1, 1, 1, 1), np.float16),
            }
            out.update(unit)
        return StepDiag(**out)
