"""Run configuration and hyper-parameter sweep states.

The port's own copy of the JAX package's ``config.py`` (the two must not
share code): ``HyperParams``, the per-run guidance hyper-parameters;
``get_hyperparam_states``, the sweep grid; and ``RunConfig``, the CLI's
configuration, field for field, plus ``device`` (the port takes its device
explicitly: "cuda" by default, "cpu" on request).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class HyperParams:
    """Per-run guidance hyper-parameters.

    Defaults equal the reference's ``hyperParameterOverrides``
    (utils/shared_state.py:21), so the effective default thresholds are
    ``{0: 1.0}``: heavy optimization at step 0 only.
    """

    strict: bool = False
    inside_loss_scale: float = 0.2
    outside_loss_scale: float = 0.2
    shrink_factor: float = 0.15
    thresholds: Dict[int, float] = dataclasses.field(default_factory=lambda: {0: 1.0})
    use_optimizer: bool = False  # SGD+momentum refinement (pipeline:495-497)
    recurse_until: int = 14  # last step index eligible for re-noise recursion
    recurse_steps: int = 3  # "time travel" resampling count (pipeline:914)
    bb_center_weight: float = 0.05  # extra box-centering term (pipeline:430)
    paint_with_words_stop: int = 0  # 0 == off (ptp_utils.py:113)
    paint_with_words_weight: float = 1.0
    # Attend-and-Excite style max-attention loss weight for KEYWORD tokens
    # (0.0 keeps reference parity).
    keyword_max_loss_scale: float = 0.0
    # Optimize the UNet bottleneck features instead of the latent; the
    # gradient step is scaled x200 and losses aggregate "up" maps only.
    optimize_deep_latent: bool = False
    meta_prompt: Optional[str] = None  # per-state meta-prompt override

    def replace(self, **kw) -> "HyperParams":
        return dataclasses.replace(self, **kw)


# The reference's sweep grid: a base override dict composed with a list of
# per-iteration overrides (utils/shared_state.py:21-36).
DEFAULT_HYPERPARAM_ITERATIONS: List[Dict[str, Any]] = [{}]


def get_hyperparam_states(
    base: Optional[HyperParams] = None,
    iterations: Optional[List[Dict[str, Any]]] = None,
) -> List[HyperParams]:
    """Expand the sweep grid (reference utils/shared_state.py:29-36)."""
    base = base or HyperParams()
    return [base.replace(**overrides)
            for overrides in (iterations if iterations is not None else DEFAULT_HYPERPARAM_ITERATIONS)]


@dataclasses.dataclass
class RunConfig:
    """Top-level run configuration (reference config.py:6-58)."""

    # Guiding meta prompt, e.g. 'a [rat:.1,.2] and a [fox:.5,.4]'
    meta_prompt: str = ""
    # Multiple meta prompts: with batch_size > 1 the (prompt x seed) grid is
    # batched into multi-prompt batches; prompts must share group structure
    # (see runner.dispatch_batch). Empty => use meta_prompt.
    meta_prompts: Optional[List[str]] = None
    # Whether to use Stable Diffusion v2.1 (base)
    sd_2_1: bool = False
    # Random seeds to generate with
    seeds: List[int] = dataclasses.field(default_factory=lambda: [42])
    # Output root
    output_path: Path = Path("./outputs")
    # Number of denoising steps
    n_inference_steps: int = 50
    # Classifier-free guidance scale
    guidance_scale: float = 7.5
    # Number of denoising steps eligible for guided-attention updates
    max_iter_to_alter: int = 25
    # UNet resolution at which attention maps are aggregated for losses
    attention_res: int = 16
    # Run plain Stable Diffusion (no guidance)
    run_standard_sd: bool = False
    # step-index -> loss threshold for iterative latent refinement
    # (HyperParams.thresholds overrides this for every sweep state unless
    # --thresholds is given, matching the reference's overrideConfig,
    # run.py:75-79)
    thresholds: Dict[int, float] = dataclasses.field(default_factory=lambda: {0: 0.1, 3: 0.8})
    # Latent update step scale
    scale_factor: float = 20.0
    # Linear decay range multiplying scale_factor (sqrt applied per step)
    scale_range: Tuple[float, float] = (1.0, 0.5)
    # Gaussian-smooth token maps before computing losses
    smooth_attentions: bool = True
    sigma: float = 0.5
    kernel_size: int = 3
    # Save final-step per-token cross-attention overlays (viewers/vis.py, cv2)
    save_cross_attention_maps: bool = False
    # bfloat16 weights/activations (reference: fp16, README.md:33)
    half_precision: bool = False
    # Launch the web UI (not in the port yet)
    interactive: bool = False
    # 0 == none, 1 == medium, 2 == all
    diagnostic_level: int = 0
    # Draw annotation overlays on the outputs
    annotate: bool = False
    # Average (vs sum) per-token losses within a sub-prompt
    sub_prompt_avg_within: bool = False
    # Dump a 16x16 map PNG for every prompt token at each loss evaluation
    save_all_maps: bool = False
    # Keep full-resolution per-head maps for one diagnostic step
    save_individual_ca_maps: bool = False
    # Only apply the gradient update on steps listed in `thresholds`
    only_update_on_threshold_steps: bool = True
    # DDIM eta (reference pipeline:906, 1027-1029; default 0.0 = deterministic DDIM)
    eta: float = 0.0
    # ---- additions with no reference counterpart ----
    # Model checkpoint directory (diffusers format); None => random init
    model_path: Optional[str] = None
    # Architecture preset override ("sd15", "sd21", "micro"); empty => pick
    # from sd_2_1 like the reference's load_model (run.py:18-29)
    model: str = ""
    # Skip guidance UNet passes on steps that can never update the latent
    skip_inert_guidance_passes: bool = True
    # Number of seeds to generate per device batch
    batch_size: int = 1
    # Mesh shape over the processes, e.g. {"data": 4} (parallel/mesh.py)
    mesh_shape: Optional[Dict[str, int]] = None
    # dtype for compute: "bfloat16" or "float32"
    dtype: str = "bfloat16"
    # Hyperparameter sweep grid: list of HyperParams field overrides applied
    # per inner loop (reference shared_state.hyperParameterIterations,
    # utils/shared_state.py:22). None => single default state.
    hyperparam_iterations: Optional[List[Dict[str, Any]]] = None
    # Write a torch.profiler Chrome trace of the run to this directory
    profile_dir: Optional[str] = None
    # Checkpoint generation state every N denoising steps; 0 == off
    checkpoint_every: int = 0
    # Where generation state files live; default <output_path>/state
    state_dir: Optional[str] = None
    # Multi-process launch, one GPU per process (parallel/multihost.py);
    # absent values come from torchrun's environment
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # The device the models run on: "cuda" (default) or "cpu"
    device: str = "cuda"

    # Filled in by the frontends after parsing
    prompt: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.output_path, str):
            self.output_path = Path(self.output_path)

    def ensure_output_dir(self):
        self.output_path.mkdir(exist_ok=True, parents=True)
