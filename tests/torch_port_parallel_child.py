"""One rank of ``tests/test_torch_port_parallel.py``'s two-process run, and
the inputs both sides share. It imports the port only (no JAX). Both ranks
run the data-parallel cases over ``{"data": 2}``, then the tensor axis over
``{"data": 1, "tensor": 2}``, then serve: rank 0 runs a ``BatchingEngine``
over ``{"data": 2}`` and rank 1 follows it, failing on purpose in its
second batch.

    python tests/torch_port_parallel_child.py RANK ROOT

ROOT holds the native checkpoint (``ckpt/``), JAX's initial latents
(``jax_latents.npy``) and one empty directory per rank; the rank joins the
gloo group through the ``file://`` store ``ROOT/store`` and saves its
outputs to ``ROOT/out<RANK>.npz``.
"""
import dataclasses
import os
import sys
import time

import numpy as np
import torch

GUIDED = dict(meta_prompt="a [dog:.2,.3] x", num_inference_steps=2, thresholds={0: 0.5})
BOX_A, BOX_B = "a [dog:.1,.1,.4,.4] x", "a [dog:.5,.5,.4,.4] x"
MULTI = dict(meta_prompts=[BOX_A, BOX_A, BOX_B, BOX_B], num_inference_steps=2, thresholds={0: 0.5}, decode=False)
RESUME = dict(meta_prompt="a [dog:.2,.3] x", num_inference_steps=3, thresholds={0: 0.5})
STANDARD = dict(meta_prompt="a dog", run_standard_sd=True, num_inference_steps=2)
SEEDS = [1, 2, 3, 4]
CLI_META = "a [robot:.6,.3,.4,.55] and a [vase:0,.3,.4,.55]"
TP_SEEDS = SEEDS[:2]  # rank 0's rows of the data-parallel batch: its guided_ref is their one-process run
# one guidance eval each: plain, deep-latent, and paint-with-words with a
# nonzero gate (a gradient through the score max)
EVAL_META = "a [dog:.1,.1,.5,.5] and a [cat:.5,.4,.4,.5]"
EVAL_CASES = {"plain": ({}, 0.0), "deep": ({"optimize_deep_latent": True}, 0.0),
              "pww": ({"paint_with_words_stop": 5, "paint_with_words_weight": 2.0}, 0.7)}
SERVE_SEEDS = (11, 12)  # two requests: one bucket-2 batch, a row per rank
SERVE_KNOBS = dict(num_inference_steps=2, thresholds={0: 0.5})
FAIL_TIMEOUT_S = 60.0  # the failed follower's ticket must fail within this


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


def eval_case(pipe, sd, case: str):
    """(loss, latent gradient) of one guidance eval of ``EVAL_META`` on the
    bundle ``sd`` (the pipeline's, or a rank's tensor-sharded copy)."""
    from guided_attention_tpu_torch.config import HyperParams
    from guided_attention_tpu_torch.guidance.spec import stack_specs
    from guided_attention_tpu_torch.models.unet import EMPTY_CAPTURE
    from guided_attention_tpu_torch.pipeline import _Loop
    from guided_attention_tpu_torch.runner import PrepareOptions

    fields, gate = EVAL_CASES[case]
    hp, _p, _a, spec, statics, sched, arrays, emb = pipe._prepare(
        PrepareOptions(meta_prompt=EVAL_META, hp=HyperParams(**fields)))
    lat = torch.randn((1, 16, 16, 4), generator=torch.Generator().manual_seed(5))
    t = int(sched.timesteps[0])
    loop = _Loop(sd, statics, hp, emb[None], stack_specs([spec]), sched, arrays, None, ("up", "down", "mid"))
    var = lat
    if loop.deep_mode:
        with torch.no_grad():
            var = loop.unet_eps(lat, t, [0], loop.cond, EMPTY_CAPTURE, gate, truncate=True)[1]["deep"]
    loss, _aux, grad = loop.guidance_eval(lat, [0], t, gate, var)
    return np.float64(loss), grad.numpy()


def serve(pipe, mesh, rank: int) -> dict:
    """Rank 0: an engine over ``mesh`` serves two requests, then one whose
    batch fails on rank 1; rank 1 follows. Each rank also runs the
    one-process batch of its row."""
    from guided_attention_tpu_torch.frontends import server
    from guided_attention_tpu_torch.parallel.batch import BatchFailed

    res = {}
    ref = pipe.generate_batch([SERVE_SEEDS[rank]], meta_prompt=GUIDED["meta_prompt"], capture_diagnostics=False,
                              **SERVE_KNOBS)
    res["serve_ref_images"], res["serve_ref_latents"] = ref[0].images_u8, ref[0].latents
    if rank == 0:
        engine = server.BatchingEngine(pipe, max_wait_ms=0.0, buckets=(2, 4), mesh=mesh, _start_thread=False)
        tickets = [engine.submit(GUIDED["meta_prompt"], seed=s, **SERVE_KNOBS) for s in SERVE_SEEDS]
        engine._thread.start()
        outs = [t.result(timeout=120) for t in tickets]
        res["served_images"] = np.stack([o.images_u8 for o in outs])
        res["served_latents"] = np.stack([o.latents for o in outs])
        t0 = time.monotonic()
        ticket = engine.submit(GUIDED["meta_prompt"], seed=7, **SERVE_KNOBS)
        try:
            ticket.result(timeout=FAIL_TIMEOUT_S)
            res["fail_error"] = np.array("no error")
        except BatchFailed as e:
            res["fail_error"] = np.array(str(e))
        except TimeoutError:
            res["fail_error"] = np.array("timeout")
        res["fail_s"] = np.array(time.monotonic() - t0)
        res["served_stats_errors"] = np.array(engine.snapshot()["errors"])
        engine.close(timeout=60)
    else:
        run_rows = pipe._run_rows
        calls = []

        def fails_second(*a, **k):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("injected follower fault")
            return run_rows(*a, **k)

        pipe._run_rows = fails_second
        try:
            res["followed"] = np.array(server.follow(pipe, mesh))
        finally:
            del pipe._run_rows
    return res


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

    # ---- the tensor axis: both ranks run every row, each its heads
    tp = make_mesh({"data": 1, "tensor": 2}, device="cpu")
    res["tp_backend"] = np.array(tp.tensor_backend)
    res.update(outputs_dict("tp_standard", pipe.generate_batch(TP_SEEDS, mesh=tp, latents=lat[:2], decode=False,
                                                               **STANDARD)))
    res.update(outputs_dict("one_standard", pipe.generate_batch(TP_SEEDS, latents=lat[:2], decode=False,
                                                                **STANDARD)))
    res.update(outputs_dict("tp_guided", pipe.generate_batch(TP_SEEDS, mesh=tp, **GUIDED)))
    for case in EVAL_CASES:
        res[f"eval_{case}_tp_loss"], res[f"eval_{case}_tp_grad"] = eval_case(pipe, pipe._sd_for(tp), case)
        res[f"eval_{case}_one_loss"], res[f"eval_{case}_one_grad"] = eval_case(pipe, pipe.sd, case)
    # the maps a forward captures: head means (cross and self) and per-head
    lat = torch.randn((2, 16, 16, 4), generator=torch.Generator().manual_seed(3))
    ctx = pipe.sd.encode_prompt(EVAL_META).expand(2, -1, -1).contiguous()
    for tag, unet in (("tp", pipe._sd_for(tp).unet), ("one", pipe.sd.unet)):
        # a layer returns its per-head map in place of the head mean: two forwards
        for capture, kind in (({("cross", 8), ("self", 8)}, ("cross", "self")), ({("cross_perhead", 8)}, ("cross_perhead",))):
            with torch.no_grad():
                maps = unet(lat, 500, ctx, capture=frozenset(capture))[1]["maps"]
            for key in (f"{place}_{k}" for place in ("down", "up") for k in kind):
                res[f"maps_{tag}_{key}"] = torch.stack(maps[key]).numpy()

    res.update(serve(pipe, mesh, rank))

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
