"""One rank of ``tests/test_torch_port_parallel.py``'s two-process run, and
the inputs both sides share. It imports the port only (no JAX).

    python tests/torch_port_parallel_child.py RANK ROOT

ROOT holds the native checkpoint (``ckpt/``), JAX's initial latents
(``jax_latents.npy``) and one empty directory per rank; the rank joins the
gloo group through the ``file://`` store ``ROOT/store`` and saves its
outputs to ``ROOT/out<RANK>.npz``.
"""
import dataclasses
import os
import sys

import numpy as np
import torch

GUIDED = dict(meta_prompt="a [dog:.2,.3] x", num_inference_steps=2, thresholds={0: 0.5})
BOX_A, BOX_B = "a [dog:.1,.1,.4,.4] x", "a [dog:.5,.5,.4,.4] x"
MULTI = dict(meta_prompts=[BOX_A, BOX_A, BOX_B, BOX_B], num_inference_steps=2, thresholds={0: 0.5}, decode=False)
RESUME = dict(meta_prompt="a [dog:.2,.3] x", num_inference_steps=3, thresholds={0: 0.5})
STANDARD = dict(meta_prompt="a dog", run_standard_sd=True, num_inference_steps=2)
SEEDS = [1, 2, 3, 4]
CLI_META = "a [robot:.6,.3,.4,.55] and a [vase:0,.3,.4,.55]"


def cli_argv(ckpt, out, *extra):
    return ["--meta_prompt", CLI_META, "--seeds", "28", "42", "--model", "micro", "--dtype", "float32",
            "--device", "cpu", "--n_inference_steps", "2", "--model_path", str(ckpt), "--output_path", str(out),
            *extra]


def outputs_dict(tag: str, outs) -> dict:
    """A batch's outputs as flat arrays: latents, uint8 images (where
    there are any) and every StepDiag field, stacked over the samples."""
    from guided_attention_tpu_torch.pipeline import StepDiag

    res = {f"{tag}_latents": np.stack([o.latents for o in outs]),
           f"{tag}_has_images": np.array([o.images_u8 is not None for o in outs])}
    if outs[0].images_u8 is not None:
        res[f"{tag}_images"] = np.stack([o.images_u8 for o in outs])
    for f in dataclasses.fields(StepDiag):
        res[f"{tag}_diag_{f.name}"] = np.stack([getattr(o.diagnostics, f.name) for o in outs])
    return res


class Preempted(Exception):
    pass


def die_after_first(done: int, total: int) -> None:
    if done >= 1:
        raise Preempted


def main(rank: int, root: str) -> None:
    from guided_attention_tpu_torch.frontends import cli
    from guided_attention_tpu_torch.models.bundle import StableDiffusion
    from guided_attention_tpu_torch.parallel import multihost
    from guided_attention_tpu_torch.parallel.mesh import make_mesh
    from guided_attention_tpu_torch.runner import GuidedAttentionPipeline

    torch.set_num_threads(1)
    ckpt = os.path.join(root, "ckpt")
    os.chdir(os.path.join(root, f"rank{rank}"))  # the CLI's tree goes to ./tree
    # the CLI first: it joins the process group through its own flags
    cli.main(cli_argv(ckpt, "tree", "--batch_size", "2", "--num_processes", "2", "--process_id", str(rank),
                      "--coordinator_address", "file://" + os.path.join(root, "store")))
    if (multihost.process_count(), multihost.process_index()) != (2, rank):
        raise SystemExit("the CLI did not join the process group")

    pipe = GuidedAttentionPipeline(StableDiffusion.create("micro", torch.float32, device="cpu", checkpoint_dir=ckpt))
    mesh = make_mesh({"data": 2})
    res = {}
    res.update(outputs_dict("guided", pipe.generate_batch(SEEDS, mesh=mesh, **GUIDED)))
    res.update(outputs_dict("multi", pipe.generate_batch([1, 2, 1, 2], mesh=mesh, **MULTI)))
    # the one-process batches of this rank's rows (no mesh: nothing is gathered)
    rows = multihost.local_batch_slice(len(SEEDS))
    res.update(outputs_dict("guided_ref", pipe.generate_batch(SEEDS[rows], **GUIDED)))
    res.update(outputs_dict("multi_ref", pipe.generate_batch(
        [1, 2, 1, 2][rows], **dict(MULTI, meta_prompts=MULTI["meta_prompts"][rows]))))

    state = os.path.join(root, "state")
    res.update(outputs_dict("uninterrupted", pipe.generate_batch(SEEDS, mesh=mesh, decode=False, **RESUME)))
    try:
        pipe.generate_batch_resumable(SEEDS, mesh=mesh, checkpoint_every=1, state_dir=state, keep_state=True,
                                      decode=False, on_segment=die_after_first, **RESUME)
        raise SystemExit("the preemption hook did not fire")
    except Preempted:
        pass
    multihost.barrier()  # both ranks have written the step-1 state
    res["state_files"] = np.array(sorted(os.listdir(state)))
    outs = pipe.generate_batch_resumable(SEEDS, mesh=mesh, checkpoint_every=1, state_dir=state, **RESUME)
    res.update(outputs_dict("resumed", outs))
    res["resumed_from"] = np.array([o.resumed_from_step for o in outs])
    res["state_left"] = np.array(len(os.listdir(state)))

    lat = np.load(os.path.join(root, "jax_latents.npy"))
    res.update(outputs_dict("standard", pipe.generate_batch(SEEDS, mesh=mesh, latents=lat, decode=False,
                                                            **STANDARD)))

    g = torch.Generator().manual_seed(rank)
    tree = {"bf16": torch.randn(2, 3, generator=g).to(torch.bfloat16),
            "parts": [np.arange(4, dtype=np.int32).reshape(2, 2) + 10 * rank, np.array([[rank == 0], [True]])],
            "f16": (torch.randn(2, 5, generator=g).numpy() * 1000).astype(np.float16)}
    whole = multihost.to_host(tree)
    res["to_host_bf16_bits"] = whole["bf16"].view(torch.int16).numpy()
    res["to_host_int32"], res["to_host_bool"] = whole["parts"]
    res["to_host_f16"] = whole["f16"]
    res["mine_bf16_bits"] = tree["bf16"].view(torch.int16).numpy()
    res["mine_f16"] = tree["f16"]
    np.savez(os.path.join(root, f"out{rank}.npz"), **res)
    multihost.barrier()
    print("rank", rank, "done", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2])
