"""CLI entry and orchestration (the reference's run.py).

Every RunConfig field is a --flag (the reference uses pyrallis,
run.py:235-236; here a dataclass-driven argparse, as in the JAX package's
CLI). ``execute`` runs seeds x hyperparameter states (reference
run.py:93-135): seed by seed, or with ``--batch_size > 1`` the (prompt x
seed) grid of each state in batches on the device (``dispatch_batch``), and
writes the same artifact tree as the JAX package's CLI
(``runtime/artifacts``). With ``--checkpoint_every N`` each run (or each
batch) persists its state every N steps under ``--state_dir`` (default
``<output_path>/state``) through ``generate_resumable`` /
``generate_batch_resumable``, and the same command run again resumes
where it stopped.

Usage:
  python -m guided_attention_tpu_torch.frontends.cli --meta_prompt "a [robot:.6,.3,.4,.55] and a [vase:0,.3,.4,.55]" --seeds 28 42
  python -m guided_attention_tpu_torch.frontends.cli --device cpu --model micro --n_inference_steps 3 --meta_prompt ...

``--interactive true`` serves the web UI instead (``frontends/gui.py``,
http://127.0.0.1:5000), through the serving engine.

Several GPUs, one process each (``parallel/``): launch N processes with
torchrun, ``python -m torch.distributed.run --standalone --nproc_per_node N
-m guided_attention_tpu_torch.frontends.cli --batch_size N ...``, or start
each with ``--num_processes N --process_id I --coordinator_address
host:port``. The batch path then splits each chunk over the mesh's data axis
(``--mesh_shape '{"data": N}'``, the default over N processes), padded up
to it by repeating the chunk's last sample (the padded outputs are
dropped), and only rank 0 writes the artifact tree. A tensor axis
(``--mesh_shape '{"data": 1, "tensor": 2}'``) splits the UNet's
transformer projections over the ranks of each data row (``parallel/``).
``--interactive`` over several processes serves the web UI from rank 0
while the other ranks follow each batch (``frontends/server.follow``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from guided_attention_tpu_torch.config import HyperParams, RunConfig, get_hyperparam_states
from guided_attention_tpu_torch.parallel import multihost
from guided_attention_tpu_torch.parallel.mesh import make_mesh
from guided_attention_tpu_torch.runtime.artifacts import annotate_image, image_grid, write_run_artifacts
from guided_attention_tpu_torch.runtime.native import AsyncArtifactWriter, write_png


def _add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        if f.name in ("prompt",):
            continue
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.default_factory is not dataclasses.MISSING:  # type: ignore
            default = f.default_factory()  # type: ignore
        arg = f"--{f.name}"
        if f.type in ("bool", bool):
            parser.add_argument(arg, type=lambda s: s.lower() in ("1", "true", "yes"), default=default)
        elif f.type in ("int", int, "Optional[int]"):
            parser.add_argument(arg, type=int, default=default)
        elif f.type in ("float", float, "Optional[float]"):
            parser.add_argument(arg, type=float, default=default)
        elif f.name == "seeds":
            parser.add_argument(arg, type=int, nargs="+", default=default)
        elif f.name == "meta_prompts":
            parser.add_argument(arg, type=str, nargs="+", default=default)
        elif f.name in ("thresholds", "mesh_shape", "hyperparam_iterations"):
            parser.add_argument(arg, type=json.loads, default=default)
        elif f.name == "scale_range":
            parser.add_argument(arg, type=float, nargs=2, default=default)
        else:
            parser.add_argument(arg, type=str, default=default)


def parse_args(argv: Optional[List[str]] = None) -> RunConfig:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    _add_dataclass_args(parser, RunConfig)
    ns = parser.parse_args(argv)
    kwargs = {f.name: getattr(ns, f.name) for f in dataclasses.fields(RunConfig) if hasattr(ns, f.name)}
    if isinstance(kwargs.get("thresholds"), dict):
        kwargs["thresholds"] = {int(k): float(v) for k, v in kwargs["thresholds"].items()}
    if isinstance(kwargs.get("output_path"), str):
        kwargs["output_path"] = Path(kwargs["output_path"])
    if isinstance(kwargs.get("scale_range"), list):
        kwargs["scale_range"] = tuple(kwargs["scale_range"])
    config = RunConfig(**kwargs)
    argv_list = argv if argv is not None else list(sys.argv[1:])
    config._thresholds_explicit = "--thresholds" in argv_list
    return config


def setup(config: RunConfig):
    """Load the model and build the pipeline (reference run.py:139-145)."""
    from guided_attention_tpu_torch.runner import pipeline_from_config

    return pipeline_from_config(config)


def state_prompts(config: RunConfig, hp: HyperParams) -> List[str]:
    """Meta-prompts for one sweep state (reference run.py:75-79): a state's
    meta_prompt override outranks config-level prompts (including
    --meta_prompts); otherwise --meta_prompts, or the single --meta_prompt."""
    if hp.meta_prompt:
        return [hp.meta_prompt]
    return list(config.meta_prompts) if config.meta_prompts else [config.meta_prompt]


def plan_batch_chunks(config: RunConfig, states: List[HyperParams]):
    """The batched sweep's work plan: per sweep state, the (prompt x seed)
    grid chunked into batch_size slices. Returns [(hp, [(meta_prompt, seed),
    ...])] in execution order."""
    chunks = []
    for hp in states:
        pairs = [(mp, s) for mp in state_prompts(config, hp) for s in config.seeds]
        for lo in range(0, len(pairs), config.batch_size):
            chunks.append((hp, pairs[lo : lo + config.batch_size]))
    return chunks


def execute(config: RunConfig, pipe, hyperparam_iterations: Optional[List[Dict[str, Any]]] = None,
            stats: Optional[Dict[str, float]] = None, mesh=None):
    """Seeds x hyperparameter sweep with artifact output (reference
    run.py:93-135). Returns the last final image's path (None for no
    seeds); ``stats``, when given, receives the images made and the
    seconds spent generating and writing artifacts. ``mesh`` is the
    config's (``--mesh_shape``), made here when not given."""
    if multihost.is_primary():  # artifacts are rank 0's job
        config.ensure_output_dir()
    if hyperparam_iterations is None:
        hyperparam_iterations = config.hyperparam_iterations
    # Precedence (reference run.py:75-79, shared_state.py:21): the sweep base
    # state's thresholds ({0: 1.0}) override RunConfig's default thresholds;
    # an explicitly given --thresholds replaces the base.
    base_hp = HyperParams()
    if getattr(config, "_thresholds_explicit", False):
        base_hp = base_hp.replace(thresholds=dict(config.thresholds))
    states = get_hyperparam_states(base_hp, hyperparam_iterations)
    # level-0 sweeps read the heavy per-step diagnostics only at steps
    # [0, 1, 2] (x0 preds): copy just those (save_individual_ca_maps needs
    # the full latent_in). Not on the resumable paths: they persist the
    # whole run's diagnostics
    resumable = config.checkpoint_every > 0
    trim = config.diagnostic_level == 0 and not config.save_individual_ca_maps and not resumable
    state_dir = str(config.state_dir or (config.output_path / "state"))
    resume_kw = dict(checkpoint_every=config.checkpoint_every, state_dir=state_dir)

    def run_kwargs(hp):
        return dict(
            num_inference_steps=config.n_inference_steps,
            guidance_scale=config.guidance_scale,
            max_iter_to_alter=config.max_iter_to_alter,
            attention_res=config.attention_res,
            run_standard_sd=config.run_standard_sd,
            hp=hp,
            scale_factor=config.scale_factor,
            scale_range=config.scale_range,
            smooth_attentions=config.smooth_attentions,
            sigma=config.sigma,
            kernel_size=config.kernel_size,
            sd_2_1=config.sd_2_1,
            only_update_on_threshold_steps=config.only_update_on_threshold_steps,
            sub_prompt_avg_within=config.sub_prompt_avg_within,
            skip_inert_guidance_passes=config.skip_inert_guidance_passes,
            diagnostic_level=config.diagnostic_level,
            capture_eval_maps=config.save_all_maps,
            # per-subiter pred_pre_optim snapshots (reference pipeline:517-535)
            capture_eval_latents=config.diagnostic_level > 0,
            eta=config.eta,
        )

    def report_resume(step: int) -> None:
        if step:
            print(f"  resumed from step {step}")

    # several processes (or an explicit mesh): every chunk is split over the
    # data axis, padded up to it by repeating its last sample
    if mesh is None:
        mesh = _mesh(config)
    data = mesh.shape.get("data", 1) if mesh is not None else 1

    t0 = time.perf_counter()
    work = []  # (seed, hp, meta_prompt, PipelineOutput)
    if config.batch_size > 1 or mesh is not None:
        # one multi-prompt batch per chunk when its prompts differ
        for hp, chunk in plan_batch_chunks(config, states):
            padded = chunk + [chunk[-1]] * (-len(chunk) % data)
            seeds = [s for _, s in padded]
            prompts = [mp for mp, _ in padded]
            print(f"Seeds (batch): {seeds}")
            prompt_kw = dict(meta_prompt=prompts[0]) if len(set(prompts)) == 1 else dict(meta_prompts=prompts)
            if resumable:
                # each chunk persists its whole batch every N steps
                outs = pipe.generate_batch_resumable(seeds, mesh=mesh, **resume_kw, **prompt_kw, **run_kwargs(hp))
                report_resume(outs[0].resumed_from_step)
            else:
                outs = pipe.dispatch_batch(seeds, mesh=mesh, **prompt_kw, trim_heavy_diags=trim,
                                           **run_kwargs(hp)).result()
            # zipped with the unpadded chunk: the padded outputs are dropped
            work.extend((s, hp, mp, o) for (mp, s), o in zip(chunk, outs))
    else:
        for seed in config.seeds:
            for hp in states:
                for meta_prompt in state_prompts(config, hp):
                    if resumable:
                        print(f"Seed: {seed} (resumable, every {config.checkpoint_every} steps)")
                        out = pipe.generate_resumable(seed=seed, meta_prompt=meta_prompt, **resume_kw,
                                                      **run_kwargs(hp))
                        report_resume(out.resumed_from_step)
                    else:
                        print(f"Seed: {seed}")
                        out = pipe.dispatch(meta_prompt=meta_prompt, seed=seed, trim_heavy_diags=trim,
                                            **run_kwargs(hp)).result()
                    work.append((seed, hp, meta_prompt, out))
    t1 = time.perf_counter()
    if not work:  # empty --seeds: nothing generated, nothing to grid
        return None
    if not multihost.is_primary():
        if stats is not None:
            stats.update(images=len(work), generate_s=t1 - t0, artifacts_s=0.0)
        return None

    images, image_path = [], None
    async_writer = AsyncArtifactWriter(2)
    try:
        for seed, hp, meta_prompt, out in work:
            img, image_path, writer = write_run_artifacts(
                pipe,
                out,
                output_path=config.output_path,
                seed=seed,
                hp=hp,
                meta_prompt=meta_prompt,
                interactive=config.interactive,
                annotate=config.annotate,
                save_cross_attention_maps=config.save_cross_attention_maps,
                diagnostic_level=config.diagnostic_level,
                save_all_maps=config.save_all_maps,
                save_individual_ca_maps_flag=config.save_individual_ca_maps,
                async_writer=async_writer,
            )
            images.append(img)
        grid = image_grid(images)
        # the reference annotates the grid with the annotations the LAST run
        # left in its shared state (run.py:132-133)
        annotate_image(grid, out.annotations, size=grid.shape[1])
        grid_path = config.output_path / f"{writer.clean}.png"
        if not write_png(grid, grid_path):
            raise OSError(f"could not write {grid_path}")
    finally:
        async_writer.close()
    if stats is not None:
        stats.update(images=len(work), generate_s=t1 - t0, artifacts_s=time.perf_counter() - t1)
    return image_path


def _mesh(config: RunConfig):
    """The mesh of ``--mesh_shape`` (default over several processes:
    ``{"data": N}``), or None for one process without one."""
    if not config.mesh_shape and multihost.process_count() == 1:
        return None
    return make_mesh(config.mesh_shape, device=config.device)


def main(argv: Optional[List[str]] = None, stats: Optional[Dict[str, float]] = None):
    """Parse ``argv`` (default: the command line), join the process group
    of a multi-process launch, build the pipeline on this rank's device and
    run the sweep, or serve the web UI with ``--interactive``; ``stats``
    goes to ``execute``."""
    config = parse_args(argv)
    multihost.initialize(config.coordinator_address, config.num_processes, config.process_id)
    config.device = str(multihost.rank_device(config.device))
    mesh = _mesh(config)  # before the model: a mesh the process group cannot hold is refused at once
    pipe = setup(config)
    if config.interactive and mesh is not None:
        from guided_attention_tpu_torch.frontends.gui import run_server
        from guided_attention_tpu_torch.frontends.server import follow

        if multihost.is_primary():
            run_server(config, pipe, mesh=mesh)
        else:
            follow(pipe, mesh)
    elif config.interactive:
        from guided_attention_tpu_torch.frontends.gui import run_server

        run_server(config, pipe)
    elif config.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if pipe.sd.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            execute(config, pipe, stats=stats, mesh=mesh)
        if multihost.is_primary():
            out_dir = Path(config.profile_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(out_dir / "trace.json"))
            print(f"profiler trace written to {out_dir / 'trace.json'}")
    else:
        execute(config, pipe, stats=stats, mesh=mesh)


if __name__ == "__main__":
    main()
