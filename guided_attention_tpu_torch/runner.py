"""GuidedAttentionPipeline: the user-facing pipeline object.

Counterpart of the single-sample path of the JAX package's ``runner.py``:
the same keyword surface and validation, a prepare cache keyed by every
option, decode to uint8 on the device, and ``PipelineOutput``.

Seed semantics: the initial latents and every re-noise / eta draw come, in
loop order, from one ``torch.Generator`` on the model's device seeded with
the seed. The JAX package draws them from ``jax.random``, so the same seed
gives a different image in the two packages; ``dispatch(latents=...,
noise=...)`` hands in explicit draws instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from guided_attention_tpu_torch.annotation import Annotation, parse_prompt
from guided_attention_tpu_torch.config import HyperParams
from guided_attention_tpu_torch.guidance.custom import CustomLossRegistry, default_registry
from guided_attention_tpu_torch.guidance.spec import GuidanceSpec, build_guidance_spec
from guided_attention_tpu_torch.models.bundle import StableDiffusion
from guided_attention_tpu_torch.pipeline import GenStatics, NoiseSource, StepDiag, generate, make_step_arrays
from guided_attention_tpu_torch.schedulers.ddim import make_ddim_schedule


def _mask_seed(seed) -> int:
    """Seeds up to 2^32-2 (the reference GUI range) as unsigned 32-bit."""
    return int(seed) & 0xFFFFFFFF


class GeneratorNoise:
    """Default noise source: standard-normal draws, in call order, from the
    run's generator."""

    def __init__(self, generator: torch.Generator, shape, device):
        self.generator = generator
        self.shape = tuple(shape)
        self.device = device

    def __call__(self, kind: str, i: int, r: Optional[int]) -> torch.Tensor:
        return torch.randn(self.shape, generator=self.generator, device=self.device, dtype=torch.float32)


@dataclasses.dataclass
class PipelineOutput:
    images: Optional[np.ndarray]  # [1, H, W, 3] float in [0, 1] (from uint8)
    latents: np.ndarray  # [1, h, w, C] (float32 for bf16 runs)
    diagnostics: StepDiag
    spec: GuidanceSpec
    prompt: str
    annotations: List[Annotation]
    images_u8: Optional[np.ndarray] = None  # [1, H, W, 3] uint8

    def average_maps(self) -> Optional[np.ndarray]:
        """Maps averaged over the steps that evaluated guidance, or None."""
        d = self.diagnostics
        maps = np.asarray(d.maps, np.float32)
        if maps.ndim != 4 or maps.shape[1] < 2:
            return None
        mask = np.asarray(d.n_evals) > 0
        if not mask.any():
            return None
        return maps[mask].mean(axis=0)


@dataclasses.dataclass
class PendingOutput:
    """A generation whose results still lie on the device; ``result()``
    copies them to the host once."""

    _img_u8: Optional[torch.Tensor]
    _latents: torch.Tensor
    _diags: StepDiag
    spec: GuidanceSpec
    prompt: str
    annotations: List[Annotation]

    def result(self) -> PipelineOutput:
        u8 = None if self._img_u8 is None else self._img_u8.cpu().numpy()
        return PipelineOutput(
            images=None if u8 is None else u8.astype(np.float32) / 255.0,
            # numpy has no bfloat16: bf16 latents arrive as float32 (exact)
            latents=(self._latents.float() if self._latents.dtype == torch.bfloat16 else self._latents).cpu().numpy(),
            diagnostics=self._diags,
            spec=self.spec,
            prompt=self.prompt,
            annotations=self.annotations,
            images_u8=u8,
        )


def _hp_key(hp: HyperParams):
    return tuple(
        tuple(sorted(v.items())) if isinstance(v, dict) else v for v in dataclasses.asdict(hp).values()
    )


_UNHASHABLE_OPTS = ("annotations", "hp", "thresholds", "scale_range")


def _freeze_annotations(annotations):
    """Value-based hashable form of caller-supplied annotations, or None when
    an entry has a target of an unknown type (then the prepare is not cached)."""
    out = []
    for a in annotations:
        t = getattr(a, "target", None)
        if t is None:
            tk = None
        elif isinstance(t, (tuple, list)):
            tk = tuple(float(v) for v in t)
        elif hasattr(t, "x"):  # Rect
            tk = (float(t.x), float(t.y), float(t.width), float(t.height), float(t.size))
        else:
            return None
        try:
            out.append((str(a.subprompt), int(a.kind), tk))
        except (TypeError, ValueError, AttributeError):
            return None
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class PrepareOptions:
    """Every knob that shapes one prepared generation; ``dispatch`` mirrors
    these fields and ``cache_key`` derives the prepare-cache identity from
    the field list."""

    meta_prompt: Optional[str] = None
    prompt: Optional[str] = None
    annotations: Optional[List[Annotation]] = None
    hp: Optional[HyperParams] = None
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    max_iter_to_alter: int = 25
    attention_res: int = 16
    run_standard_sd: bool = False
    thresholds: Optional[Dict[int, float]] = None
    scale_factor: float = 20.0
    scale_range: Tuple[float, float] = (1.0, 0.5)
    smooth_attentions: bool = True
    sigma: float = 0.5
    kernel_size: int = 3
    sd_2_1: bool = False
    only_update_on_threshold_steps: bool = True
    sub_prompt_avg_within: bool = False
    skip_inert_guidance_passes: bool = True
    diagnostic_level: int = 0
    negative_prompt: str = ""
    capture_eval_maps: bool = False
    capture_diagnostics: bool = True
    eta: float = 0.0
    capture_eval_latents: bool = False
    remat_guidance_eval: bool = False

    @classmethod
    def from_locals(cls, ns: Dict[str, Any]) -> "PrepareOptions":
        return cls(**{f.name: ns[f.name] for f in dataclasses.fields(cls)})

    def cache_key(self, registry_version: int):
        ann_key = None
        if self.annotations is not None:
            ann_key = _freeze_annotations(self.annotations)
            if ann_key is None:
                return None
        scalars = tuple(getattr(self, f.name) for f in dataclasses.fields(self) if f.name not in _UNHASHABLE_OPTS)
        return (
            registry_version,
            scalars,
            ann_key,
            _hp_key(self.hp) if self.hp is not None else None,
            tuple(sorted(self.thresholds.items())) if self.thresholds is not None else None,
            tuple(self.scale_range),
        )


class GuidedAttentionPipeline:
    """prompt + annotations -> guided image."""

    def __init__(self, sd: StableDiffusion, registry: Optional[CustomLossRegistry] = None):
        self.sd = sd
        self.registry = registry or default_registry()
        self._prepare_cache: Dict[Any, Any] = {}
        self._registry_version = 0

    def register_custom_loss(self, name: str, loss) -> None:
        """(reference run.py:229-232)"""
        self.registry.register(name, loss)
        self._registry_version += 1  # prepared specs bake in the registry

    def _prepare(self, opts: PrepareOptions):
        cache_key = opts.cache_key(self._registry_version)
        if cache_key is not None:
            hit = self._prepare_cache.get(cache_key)
            if hit is not None:
                return hit
        prepared = self._prepare_uncached(opts)
        if cache_key is not None:
            if len(self._prepare_cache) >= 64:
                self._prepare_cache.pop(next(iter(self._prepare_cache)))
            self._prepare_cache[cache_key] = prepared
        return prepared

    def _prepare_uncached(self, o: PrepareOptions):
        if not 1 <= o.num_inference_steps <= 10_000:
            raise ValueError(f"num_inference_steps must be in [1, 10000], got {o.num_inference_steps}")
        if not o.run_standard_sd and o.smooth_attentions and not o.sigma > 0:
            raise ValueError(
                f"sigma must be > 0 (got {o.sigma}); pass smooth_attentions=False to disable smoothing"
            )
        if not 1 <= o.kernel_size <= 99:
            raise ValueError(f"kernel_size must be in [1, 99], got {o.kernel_size}")
        for name in ("guidance_scale", "scale_factor", "sigma", "eta"):
            if not math.isfinite(getattr(o, name)):
                raise ValueError(f"{name} must be finite, got {getattr(o, name)}")
        if not all(math.isfinite(v) for v in o.scale_range):
            raise ValueError(f"scale_range must be finite, got {o.scale_range}")
        sample = self.sd.config.latent_size
        if o.attention_res < 1 or o.attention_res > sample or sample % o.attention_res or o.attention_res & (o.attention_res - 1):
            raise ValueError(
                f"attention_res must be a power-of-two divisor of the UNet latent resolution ({sample}), "
                f"got {o.attention_res}"
            )

        hp = o.hp or HyperParams()
        if o.thresholds is not None:
            hp = hp.replace(thresholds=o.thresholds)
        if len(hp.thresholds) == 0:  # pipeline:916-917
            hp = hp.replace(thresholds={0: float("inf")})

        prompt, annotations = o.prompt, o.annotations
        custom_losses: Dict[str, Any] = {}
        if o.meta_prompt is not None:
            prompt, annotations, custom_losses = parse_prompt(o.meta_prompt, self.registry.as_dict())
        if prompt is None:
            raise ValueError("pass meta_prompt or prompt")
        annotations = annotations or []

        dev = self.sd.device
        spec = build_guidance_spec(
            self.sd.tokenizer, prompt, annotations, hp, custom_losses,
            attention_res=o.attention_res, normalize_eot=o.sd_2_1, device=dev,
        )
        thr_values = list(hp.thresholds.values())
        statics = GenStatics(
            num_steps=o.num_inference_steps,
            guidance_scale=o.guidance_scale,
            attention_res=o.attention_res,
            smooth_attentions=o.smooth_attentions,
            sigma=o.sigma,
            kernel_size=o.kernel_size,
            run_standard_sd=bool(o.run_standard_sd),
            skip_inert_guidance_passes=o.skip_inert_guidance_passes,
            sub_prompt_avg_within=o.sub_prompt_avg_within,
            only_update_on_threshold_steps=o.only_update_on_threshold_steps,
            max_iter_to_alter=o.max_iter_to_alter,
            last_threshold=float(thr_values[-1]) if thr_values else float("inf"),
            capture_eval_maps=o.capture_eval_maps and o.capture_diagnostics,
            capture_eval_latents=o.capture_eval_latents and o.capture_diagnostics,
            capture_step_maps=o.capture_diagnostics,
            diag_level=1 if o.capture_diagnostics else 0,
            eta=float(o.eta),
            remat_guidance_eval=o.remat_guidance_eval,
        )
        sched = make_ddim_schedule(o.num_inference_steps, device=dev)
        arrays = make_step_arrays(statics, hp, sched, o.scale_factor, o.scale_range)
        emb = self.sd.encode_prompt(prompt, o.negative_prompt)
        return hp, prompt, annotations, spec, statics, sched, arrays, emb

    def dispatch(
        self,
        meta_prompt: Optional[str] = None,
        prompt: Optional[str] = None,
        annotations: Optional[List[Annotation]] = None,
        hp: Optional[HyperParams] = None,
        seed: int = 42,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        max_iter_to_alter: int = 25,
        attention_res: int = 16,
        run_standard_sd: bool = False,
        thresholds: Optional[Dict[int, float]] = None,
        scale_factor: float = 20.0,
        scale_range: Tuple[float, float] = (1.0, 0.5),
        smooth_attentions: bool = True,
        sigma: float = 0.5,
        kernel_size: int = 3,
        sd_2_1: bool = False,
        only_update_on_threshold_steps: bool = True,
        sub_prompt_avg_within: bool = False,
        skip_inert_guidance_passes: bool = True,
        diagnostic_level: int = 0,
        negative_prompt: str = "",
        latents=None,
        decode: bool = True,
        capture_eval_maps: bool = False,
        capture_diagnostics: bool = True,
        eta: float = 0.0,
        capture_eval_latents: bool = False,
        remat_guidance_eval: bool = False,
        noise: Optional[NoiseSource] = None,
    ) -> PendingOutput:
        """Run one generation; the results stay on the device until
        ``.result()``. ``latents`` ([1, h, w, C], NHWC) replaces the seeded
        initial latents and ``noise(kind, i, r)`` the seeded re-noise / eta
        draws."""
        opts = PrepareOptions.from_locals(locals())
        hp, prompt, annotations, spec, statics, sched, arrays, emb = self._prepare(opts)
        cfg = self.sd.config
        dev = self.sd.device
        shape = (1, cfg.latent_size, cfg.latent_size, cfg.unet.in_channels)
        gen = torch.Generator(device=dev).manual_seed(_mask_seed(seed))
        lat0 = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(cfg.unet.dtype)
        if latents is not None:
            lat0 = torch.as_tensor(np.asarray(latents) if not torch.is_tensor(latents) else latents, device=dev).clone()
        if noise is None:
            noise = GeneratorNoise(gen, shape, dev)
        final, diags = generate(self.sd, statics, hp, emb, lat0, spec, sched, arrays, noise)
        img_u8 = self.sd.decode_latents_u8(final) if decode else None
        return PendingOutput(img_u8, final, diags, spec, prompt, annotations)

    def __call__(self, *args, **kwargs) -> PipelineOutput:
        return self.dispatch(*args, **kwargs).result()
