"""GuidedAttentionPipeline: the user-facing pipeline object.

Counterpart of the JAX package's ``runner.py``: ``dispatch`` (one image)
and ``dispatch_batch`` / ``generate_batch`` (one image per seed, one prompt
for all or one per seed), with the same keyword surface and validation, a
prepare cache keyed by every option, decode to uint8 on the device, and
``PipelineOutput``. The batch entries take a ``mesh``
(``parallel.make_mesh``): with several processes, one GPU each, every rank
runs its data row's rows of the batch and holds the whole batch's latents
and diagnostics afterwards, and the primary the images
(``parallel/batch.py``); on a mesh with a tensor axis the ranks of a data
row run its rows together, each with its slices of the UNet's projections
(``parallel.mesh.shard_unet``, cached per mesh).

Seed semantics: a sample's initial latents and every re-noise / eta draw
come, in loop order, from one ``torch.Generator`` on the model's device
seeded with its seed, in a batch as alone. The JAX package draws them from
``jax.random``, so the same seed gives a different image in the two
packages; ``latents=`` and ``noise=`` hand in explicit draws instead.

``generate_resumable`` / ``generate_batch_resumable`` run the same loop in
segments of ``checkpoint_every`` steps and persist, after each, the
latents and each sample's generator state (``runtime/checkpoint``); run
again with the same configuration, they resume from the newest state and
give the uninterrupted run's bits, which are ``dispatch``'s.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from guided_attention_tpu_torch.annotation import Annotation, parse_prompt
from guided_attention_tpu_torch.config import HyperParams, RunConfig
from guided_attention_tpu_torch.guidance.custom import CustomLossRegistry, default_registry
from guided_attention_tpu_torch.guidance.spec import GuidanceSpec, build_guidance_spec, stack_specs
from guided_attention_tpu_torch.models.bundle import StableDiffusion
from guided_attention_tpu_torch.parallel import batch as pbatch
from guided_attention_tpu_torch.parallel.mesh import shard_unet
from guided_attention_tpu_torch.parallel.multihost import barrier
from guided_attention_tpu_torch.pipeline import (
    GenStatics,
    NoiseSource,
    StepDiag,
    guidance_gates,
    make_step_arrays,
)
from guided_attention_tpu_torch.schedulers.ddim import make_ddim_schedule


def _mask_seed(seed) -> int:
    """Seeds up to 2^32-2 (the reference GUI range) as unsigned 32-bit."""
    return int(seed) & 0xFFFFFFFF


# --- diagnostic trimming (opt-in: dispatch*(trim_heavy_diags=True)) ---
# x0_pred and latent_in stack S steps of [h, w, C] f16, but artifacts at
# diagnostic_level 0 read only steps [0, 1, 2] (the reference's
# always_save_iter, pipeline:881). The per-step maps [S, R, R, K] and
# eval_unscaled [S, R_sub, K] are nonzero only at steps that can run the
# guidance eval (``guidance_gates``; with the default thresholds {0: 1.0},
# step 0 alone), so they are gathered down to those steps on the device
# before the device-to-host copy and scattered back into full-shape zeros
# on the host (exact: the dropped steps were zeros).
_TRIM_KEEP = 3


def _trim_plan(statics: GenStatics, hp: HyperParams):
    """The eval-step indices the maps/eval_unscaled gather keeps, or None
    when every step could eval (skip_inert_guidance_passes off: trimming
    would drop real content)."""
    if statics.run_standard_sd:
        return ()
    if not statics.skip_inert_guidance_passes:
        return None
    _thr, _upd, needed = guidance_gates(statics, hp)
    return tuple(int(i) for i in np.where(needed)[0])


def _apply_trim(fields: Dict[str, torch.Tensor], keep) -> Dict[str, torch.Tensor]:
    """The heavy per-step diagnostics [B, S, ...], still on the device, with
    x0_pred and latent_in cut to their first steps and maps/eval_unscaled
    gathered at ``keep`` (the ``_trim_plan``); no-op without them
    (capture_diagnostics=False)."""
    if "x0_pred" not in fields:
        return fields
    out = dict(fields)
    out["x0_pred"], out["latent_in"] = fields["x0_pred"][:, :_TRIM_KEEP], fields["latent_in"][:, :_TRIM_KEEP]
    if keep is not None:
        idx = torch.tensor(keep, dtype=torch.long, device=fields["maps"].device)
        out["maps"], out["eval_unscaled"] = fields["maps"][:, idx], fields["eval_unscaled"][:, idx]
    return out


def _scatter_trimmed(diags: StepDiag, keep, S: int) -> StepDiag:
    """Host-side inverse of the maps/eval_unscaled gather on batched
    diagnostics [B, S, ...]: the kept steps scattered back into full-[S]
    zeros. No-op when nothing was gathered."""
    if keep is None or diags.maps.shape[-1] <= 1 or diags.maps.shape[1] == S:
        return diags

    def scatter(x):
        full = np.zeros(x.shape[:1] + (S,) + x.shape[2:], x.dtype)
        full[:, list(keep)] = x
        return full

    return dataclasses.replace(diags, maps=scatter(diags.maps), eval_unscaled=scatter(diags.eval_unscaled))


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
    resumed_from_step: int = 0  # the step a resumable run picked up at (0: fresh)

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
class PendingBatch:
    """A batch generation whose results still lie on the device (on the
    host already when gathered over a mesh); ``result()`` copies them to the
    host once and splits them per sample."""

    _img_u8: Optional[torch.Tensor]  # [B, H, W, 3] uint8
    _latents: torch.Tensor  # [B, h, w, C]
    _diags: StepDiag  # every field [B, S, ...]
    per_out: List[Tuple[str, List[Annotation], GuidanceSpec]]  # per sample (prompt, annotations, spec)
    seeds: List[int]
    # trim_heavy_diags: the kept eval steps and the step count, for the
    # host-side scatter of the gathered maps/eval_unscaled
    _trim_keep: Optional[Tuple[int, ...]] = None
    _trim_S: int = 0

    def result(self) -> List[PipelineOutput]:
        diags = self._diags
        if self._trim_keep is not None:
            diags = _scatter_trimmed(diags, self._trim_keep, self._trim_S)
        u8 = None if self._img_u8 is None else self._img_u8.cpu().numpy()
        # numpy has no bfloat16: bf16 latents arrive as float32 (exact)
        lat = (self._latents.float() if self._latents.dtype == torch.bfloat16 else self._latents).cpu().numpy()
        outputs = []
        for b, (prompt, annotations, spec) in enumerate(self.per_out):
            # copies: a view would alias every output to one batch buffer
            img = None if u8 is None else u8[b : b + 1].copy()
            outputs.append(PipelineOutput(
                images=None if img is None else img.astype(np.float32) / 255.0,
                latents=lat[b : b + 1].copy(),
                diagnostics=diags.sample(b),
                spec=spec,
                prompt=prompt,
                annotations=annotations,
                images_u8=img,
            ))
        return outputs


@dataclasses.dataclass
class PendingOutput:
    """A generation whose results still lie on the device; ``result()``
    copies them to the host once."""

    _batch: PendingBatch

    def result(self) -> PipelineOutput:
        return self._batch.result()[0]


def _hp_key(hp: HyperParams):
    return tuple(
        tuple(sorted(v.items())) if isinstance(v, dict) else v for v in dataclasses.asdict(hp).values()
    )


def _cache_put(lock: threading.Lock, cache: Dict[Any, Any], key, value, limit: int) -> None:
    """Insert into a bounded cache, dropping its oldest entry when full."""
    with lock:
        if key not in cache and len(cache) >= limit:
            cache.pop(next(iter(cache)))
        cache[key] = value


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
        self._stack_cache: Dict[Any, Any] = {}  # stacked (spec, emb) per prompt set
        # guards the two caches' reads and writes, not the work between them:
        # the serving engine prepares requests in handler threads while its
        # batcher thread runs a batch (frontends/server.py)
        self._cache_lock = threading.Lock()
        self._registry_version = 0
        self._sharded: Dict[Any, StableDiffusion] = {}  # the bundle with this rank's UNet slices, per mesh

    def register_custom_loss(self, name: str, loss) -> None:
        """(reference run.py:229-232)"""
        self.registry.register(name, loss)
        self._registry_version += 1  # prepared specs bake in the registry

    def _prepare(self, opts: PrepareOptions):
        cache_key = opts.cache_key(self._registry_version)
        if cache_key is not None:
            with self._cache_lock:
                hit = self._prepare_cache.get(cache_key)
            if hit is not None:
                return hit
        prepared = self._prepare_uncached(opts)
        if cache_key is not None:
            _cache_put(self._cache_lock, self._prepare_cache, cache_key, prepared, 64)
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
        trim_heavy_diags: bool = False,
    ) -> PendingOutput:
        """Run one generation; the results stay on the device until
        ``.result()``. ``latents`` ([1, h, w, C], NHWC) replaces the seeded
        initial latents and ``noise(kind, i, r)`` the seeded re-noise / eta
        draws. ``trim_heavy_diags`` copies x0_pred and latent_in for the
        first three steps only, and maps/eval_unscaled for the steps that
        can run the guidance eval (the rest are zeros, restored on the
        host)."""
        opts = PrepareOptions.from_locals(locals())
        noise = None if noise is None else [noise]
        return PendingOutput(self._dispatch(opts, [seed], None, latents, noise, decode, trim_heavy_diags))

    def __call__(self, *args, **kwargs) -> PipelineOutput:
        return self.dispatch(*args, **kwargs).result()

    def _prepare_batch(self, opts: PrepareOptions, seeds: Sequence[int], meta_prompts: Optional[Sequence[str]]):
        """Prepare every sample (one prompt for all, or ``meta_prompts``, one
        per seed) and stack the specs and embeddings along the batch axis;
        the stacks are cached per prompt set (at most 16)."""
        if len(seeds) == 0:
            raise ValueError("seeds must hold at least one seed")
        if meta_prompts is not None:
            if opts.meta_prompt is not None or opts.prompt is not None or opts.annotations is not None:
                raise TypeError("pass either meta_prompts (one per seed) or a single meta_prompt/prompt")
            if len(meta_prompts) != len(seeds):
                raise ValueError(f"meta_prompts has {len(meta_prompts)} entries for {len(seeds)} seeds")
            prepared = [self._prepare(dataclasses.replace(opts, meta_prompt=mp)) for mp in meta_prompts]
        else:
            prepared = [self._prepare(opts)] * len(seeds)
        hp, _prompt, _anns, _spec, statics, sched, arrays, _emb = prepared[0]
        ck = opts.cache_key(self._registry_version)
        stack_key = None if ck is None else (tuple(meta_prompts) if meta_prompts is not None else len(seeds), ck)
        with self._cache_lock:
            stacked = self._stack_cache.get(stack_key) if stack_key is not None else None
        if stacked is None:
            stacked = (stack_specs([p[3] for p in prepared]), torch.stack([p[7] for p in prepared]))
            if stack_key is not None:
                _cache_put(self._cache_lock, self._stack_cache, stack_key, stacked, 16)
        spec, emb = stacked
        per_out = [(p[1], p[2], p[3]) for p in prepared]
        return per_out, hp, spec, statics, sched, arrays, emb

    def _sd_for(self, mesh) -> StableDiffusion:
        """The bundle a rank of ``mesh`` runs: ``self.sd``, or on a tensor
        axis a copy whose UNet holds this rank's slices (made once per mesh;
        ``self.sd`` is not changed and shares every replicated tensor)."""
        if mesh is None or mesh.tensor_axis is None:
            return self.sd
        key = (mesh, id(self.sd.unet))
        with self._cache_lock:
            sd = self._sharded.get(key)
        if sd is None:
            sd = dataclasses.replace(self.sd, unet=shard_unet(self.sd.unet, mesh))
            _cache_put(self._cache_lock, self._sharded, key, sd, 4)
        return sd

    def _latent_shape(self) -> Tuple[int, int, int, int]:
        cfg = self.sd.config
        return (1, cfg.latent_size, cfg.latent_size, cfg.unet.in_channels)

    def _seeded(self, seeds) -> Tuple[List[torch.Generator], torch.Tensor]:
        """Each seed's generator on the model's device, and the initial
        latents [B, h, w, C] in the model dtype, the first draw of each."""
        dev, shape = self.sd.device, self._latent_shape()
        gens = [torch.Generator(device=dev).manual_seed(_mask_seed(s)) for s in seeds]
        lat0 = torch.cat([torch.randn(shape, generator=g, device=dev, dtype=torch.float32) for g in gens])
        return gens, lat0.to(self.sd.config.unet.dtype)

    def _dispatch(self, opts: PrepareOptions, seeds, meta_prompts, latents, noise, decode: bool,
                  trim: bool = False, mesh=None) -> PendingBatch:
        shard = pbatch.Shard(mesh, len(seeds))
        # every rank's prepare and rows, or an error on every rank
        per_out, keep, S, (final, diags, img_u8) = shard.agree(
            lambda: self._run_rows(shard, opts, seeds, meta_prompts, latents, noise, decode, trim, mesh))
        final, diags = shard.gather((final, diags))
        return PendingBatch(shard.gather_images(img_u8), final, diags, per_out, list(seeds), keep, S)

    def _run_rows(self, shard, opts, seeds, meta_prompts, latents, noise, decode, trim, mesh):
        """``_dispatch``'s work on this rank: prepare, draw and run its rows."""
        per_out, hp, spec, statics, sched, arrays, emb = self._prepare_batch(opts, seeds, meta_prompts)
        dev = self.sd.device
        B = len(seeds)
        shape = self._latent_shape()
        gens, lat0 = self._seeded(seeds[shard.rows])
        if latents is not None:
            lat0 = torch.as_tensor(np.asarray(latents) if not torch.is_tensor(latents) else latents, device=dev).clone()
            if tuple(lat0.shape) != (B,) + shape[1:]:
                raise ValueError(f"latents must be {(B,) + shape[1:]}, got {tuple(lat0.shape)}")
            lat0 = shard.take(lat0)
        if noise is None:
            noise = [GeneratorNoise(g, shape, dev) for g in gens]
        elif len(noise) != B:
            raise ValueError(f"noise has {len(noise)} sources for {B} seeds")
        else:
            noise = shard.take(noise)
        keep = _trim_plan(statics, hp) if trim else None
        on_device = functools.partial(_apply_trim, keep=keep) if trim else None
        rows = pbatch.run_rows(shard, self._sd_for(mesh), statics, hp, emb, lat0, spec, sched, arrays, noise,
                               on_device=on_device, decode=decode)
        return per_out, keep, statics.num_steps, rows

    def dispatch_batch(
        self,
        seeds: Sequence[int],
        meta_prompt: Optional[str] = None,
        meta_prompts: Optional[Sequence[str]] = None,
        prompt: Optional[str] = None,
        annotations: Optional[List[Annotation]] = None,
        hp: Optional[HyperParams] = None,
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
        noise: Optional[Sequence[NoiseSource]] = None,
        trim_heavy_diags: bool = False,
        mesh=None,
    ) -> PendingBatch:
        """Run one generation per seed as one batch on the device; the
        results stay there until ``.result()``, which returns one
        ``PipelineOutput`` per seed (the reference loops seeds serially,
        run.py:97-98; BASELINE config 5: '8 seeds/batch multi-prompt
        generation').

        ``meta_prompts`` (one per seed) gives each sample its own prompt,
        annotations and embedding; every prompt must produce the same
        number of sub-prompt groups and identical custom-loss bindings
        (``guidance.spec.stack_specs``). With ``meta_prompt`` (or
        ``prompt``) every seed shares one prompt. Sample b equals the
        one-sample ``dispatch`` of seed b and its prompt, up to the order of
        floating-point operations (a batch runs other kernel shapes).

        ``latents`` ([B, h, w, C]) and ``noise`` (one ``NoiseSource`` per
        seed) replace the seeded draws; ``trim_heavy_diags`` is
        ``dispatch``'s.

        ``mesh`` (``parallel.make_mesh``) splits the batch over the data
        axis of the process group, one GPU per process; every process makes
        this same call. The ranks of a data row run its rows (B must divide
        evenly by the data axis), over the tensor axis when there is one
        (each rank its slices of the UNet's projections, the partial
        results summed over the row's tensor group), and decode them; the
        call returns once every rank holds the whole batch's latents and
        diagnostics (gathered over gloo) and the primary its images;
        ``images`` is None on the other ranks. A rank whose prepare or rows
        raise makes the call raise ``parallel.batch.BatchFailed`` on every
        rank. Over the data axis alone, sample b is bit for bit the
        one-process batch of its rank's rows; over a tensor axis it agrees
        with it to the rounding of the sums. With one process, ``mesh``
        changes nothing."""
        opts = PrepareOptions.from_locals(locals())
        return self._dispatch(opts, list(seeds), meta_prompts, latents, noise, decode, trim_heavy_diags, mesh)

    def generate_batch(self, seeds: Sequence[int], **kwargs) -> List[PipelineOutput]:
        """``dispatch_batch(seeds, ...).result()`` (same keyword surface)."""
        return self.dispatch_batch(seeds, **kwargs).result()

    # --- resumable generation -------------------------------------------
    def _identity_parts(self) -> Tuple[str, ...]:
        # a generator state is only valid for its device type, and latents
        # for their dtype: both are part of a run's identity
        cfg = self.sd.config
        return f"model={cfg.name}", f"dtype={cfg.unet.dtype}", f"device={self.sd.device.type}"

    def _resumable(self, opts: PrepareOptions, seeds: Sequence[int], meta_prompts, identity: str,
                   checkpoint_every: int, state_dir: str, resume: bool, decode: bool, keep_state: bool,
                   on_segment, mesh=None) -> List[PipelineOutput]:
        """The loop of both resumable entries: restore the newest state of
        ``identity`` (step reached, latents, diagnostics, generator states),
        run the remaining steps in segments of the ``checkpoint_every`` grid
        and persist each one. Over a ``mesh`` each rank runs its rows, and
        after each segment every rank writes the identical whole-batch
        state (per-process temporary files, then an atomic rename)."""
        from guided_attention_tpu_torch.runtime import checkpoint as ckpt

        per_out, hp, spec, statics, sched, arrays, emb = self._prepare_batch(opts, seeds, meta_prompts)
        dev, shape, S = self.sd.device, self._latent_shape(), statics.num_steps
        shard = pbatch.Shard(mesh, len(seeds))
        st = ckpt.latest_state(state_dir, identity) if resume else None
        # a state without one generator state per sample cannot resume
        if st is not None and st[3] is not None and len(st[3]) == len(seeds):
            start, lat, diags, states = st
            latents = shard.take(torch.as_tensor(lat)).to(dev)
            gens = []
            for state in shard.take(states):
                gens.append(torch.Generator(device=dev))
                gens[-1].set_state(torch.from_numpy(np.array(state, np.uint8)))
        else:
            start, diags = 0, None
            gens, latents = self._seeded(seeds[shard.rows])
        for a, b in ckpt.segment_bounds(start, S, checkpoint_every) if start < S else ():
            noise = [GeneratorNoise(g, shape, dev) for g in gens]
            whole, seg, _ = pbatch.generate_batch(shard, self._sd_for(mesh), statics, hp, emb, latents, spec, sched,
                                                  arrays, noise, start=a, stop=b)
            states = shard.gather(torch.stack([g.get_state() for g in gens]))
            ckpt.save_state(state_dir, identity, b, whole, seg, seg_start=a, generators=list(states))
            latents = shard.take(whole).to(dev)
            diags = seg if diags is None else ckpt.concat_diags([diags, seg])
            if on_segment is not None:
                on_segment(b, S)
        img_u8 = shard.gather_images(self.sd.decode_latents_u8(latents)) if decode else None
        outs = PendingBatch(img_u8, shard.gather(latents), diags, per_out, list(seeds)).result()
        if not keep_state:
            barrier()  # no rank is still writing this run's state
            ckpt.clear_state(state_dir, identity)
        for o in outs:
            o.resumed_from_step = start
        return outs

    def generate_resumable(
        self,
        seed: int = 42,
        checkpoint_every: int = 10,
        state_dir: str = "outputs/state",
        resume: bool = True,
        decode: bool = True,
        keep_state: bool = False,
        on_segment: Optional[Callable[[int, int], None]] = None,
        **kwargs,
    ) -> PipelineOutput:
        """One image with mid-run checkpoints: the loop runs in segments of
        ``checkpoint_every`` steps and persists (step, latents, diagnostics,
        generator state) to ``state_dir`` after each. Called again with the
        same configuration and seed, it resumes from the newest state and
        gives the uninterrupted run's bits, which are ``dispatch``'s of the
        seed. The state files are removed when the run completes, unless
        ``keep_state``; ``on_segment(step_done, total_steps)`` is called
        after each persisted segment. Keywords: ``dispatch``'s options
        (``PrepareOptions``), without latents or noise."""
        from guided_attention_tpu_torch.runtime import checkpoint as ckpt

        opts = PrepareOptions(**kwargs)
        identity = ckpt.run_identity(repr(opts), f"seed={_mask_seed(seed)}", *self._identity_parts())
        return self._resumable(opts, [seed], None, identity, checkpoint_every, state_dir, resume, decode,
                               keep_state, on_segment)[0]

    def generate_batch_resumable(
        self,
        seeds: Sequence[int],
        checkpoint_every: int = 10,
        state_dir: str = "outputs/state",
        resume: bool = True,
        decode: bool = True,
        keep_state: bool = False,
        on_segment: Optional[Callable[[int, int], None]] = None,
        meta_prompts: Optional[Sequence[str]] = None,
        mesh=None,
        **kwargs,
    ) -> List[PipelineOutput]:
        """``generate_batch`` with mid-run checkpoints, as
        ``generate_resumable``: the whole batch runs in segments and
        persists its latents, diagnostics and every sample's generator
        state after each. ``meta_prompts`` gives one prompt per seed,
        ``meta_prompt=`` (a keyword of ``PrepareOptions``) one for all.
        ``mesh`` is ``dispatch_batch``'s: every rank persists the whole
        batch's state, every sample's generator state included, and on
        resume takes back its rows' latents and generator states."""
        from guided_attention_tpu_torch.runtime import checkpoint as ckpt

        opts = PrepareOptions(**kwargs)
        identity = ckpt.run_identity(
            repr(opts), f"seeds={[_mask_seed(s) for s in seeds]}",
            f"prompts={None if meta_prompts is None else list(meta_prompts)}", *self._identity_parts())
        return self._resumable(opts, list(seeds), meta_prompts, identity, checkpoint_every, state_dir, resume,
                               decode, keep_state, on_segment, mesh)


def pipeline_from_config(config: RunConfig, registry: Optional[CustomLossRegistry] = None) -> GuidedAttentionPipeline:
    """The pipeline a ``RunConfig`` names, as the reference's load_model
    builds it (run.py:18-29): SD1.x by default, SD2.1 with ``sd_2_1`` (or
    the ``model`` preset), bf16 unless ``dtype`` is "float32" (and
    ``half_precision`` is off), the weights of ``model_path`` (a diffusers
    directory) or random ones, on ``config.device``."""
    dtype = torch.bfloat16 if config.half_precision or config.dtype == "bfloat16" else torch.float32
    model = config.model or ("sd21" if config.sd_2_1 else "sd15")
    sd = StableDiffusion.create(model, dtype, device=config.device, checkpoint_dir=config.model_path)
    return GuidedAttentionPipeline(sd, registry)
