"""Batch generation over a mesh: each data row runs its rows of the batch.

Counterpart of the JAX package's ``parallel/batch.py``
(``build_batch_generate``). There one jitted program runs the vmapped
one-sample loop with the batch axis sharded over the mesh's "data" axis,
and each host glues its slice into global arrays. Here each rank (one
process, one GPU) runs ``pipeline.generate_batch`` on its rows, on its own
device, and the finished rows are gathered to every rank
(``multihost.to_host``). What a rank runs is its own:

  * its seeds' generators and initial latents (the runner draws them for
    its seeds only), so every sample's draws depend on its seed and not on
    the slicing;
  * its rows of caller-given latents and noise sources;
  * its rows of the stacked text embeddings and guidance spec. Every rank
    prepares the whole batch's prompts (each output carries its prompt and
    spec), but never runs more than its rows;
  * the segment bounds ``start`` / ``stop`` of a resumable run, which are
    the same on every rank.

Sample b of a data-parallel batch is therefore the one-process
``generate_batch`` of its rank's rows, bit for bit, images included: each
rank decodes its own rows, and the uint8 images go to the primary.

The rows follow a rank's **data index**: on a mesh with a tensor axis the
ranks of one data row run the same rows (each with its slices of the
UNet, ``mesh.shard_unet``, and the same seeds, so the same initial
latents), and a gather keeps the rows of each row's tensor index 0.

A rank that raises while the others run their rows would leave them
waiting in the gather: ``Shard.agree`` has every rank report whether its
part succeeded before anything is gathered, and raises ``BatchFailed`` on
every rank when one failed, so the ranks stay in step and the caller (the
serving engine's batcher) answers with an error instead of hanging.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from guided_attention_tpu_torch import pipeline
from guided_attention_tpu_torch.guidance.spec import GuidanceSpec, spec_row
from guided_attention_tpu_torch.parallel.mesh import Mesh
from guided_attention_tpu_torch.parallel.multihost import (
    all_gather_object,
    gather_to_primary,
    local_batch_slice,
    process_count,
    to_host,
)


class BatchFailed(RuntimeError):
    """A rank of the mesh failed its part of a batch; raised on every rank."""


class Shard:
    """This rank's rows of a batch of ``n`` samples over ``mesh``'s data
    axis (those of its data index); without a mesh, every row, and nothing
    is gathered."""

    def __init__(self, mesh: Optional[Mesh], n: int):
        if mesh is not None and mesh.size != process_count():
            raise ValueError(f"mesh {mesh.shape} has {mesh.size} ranks; the process group has {process_count()}")
        self.gathers = mesh is not None and process_count() > 1
        self.sources = mesh.row_sources if self.gathers else None
        self.rows = local_batch_slice(n, mesh) if mesh is not None else slice(0, n)

    def agree(self, fn: Callable[[], Any]) -> Any:
        """``fn()``'s result once every rank's ``fn`` has returned; when one
        raised, ``BatchFailed`` on every rank, naming the ranks and their
        errors (from the rank's own error where it failed). ``fn()`` itself
        when nothing is gathered."""
        if not self.gathers:
            return fn()
        out, err = None, None
        try:
            out = fn()
        except Exception as e:  # reported to every rank below, then raised on all of them
            err = e
        said = all_gather_object(None if err is None else f"{type(err).__name__}: {err}")
        failed = [f"rank {r}: {m}" for r, m in enumerate(said) if m is not None]
        if failed:
            raise BatchFailed("; ".join(failed)) from err
        return out

    def take(self, x: Any) -> Any:
        """This rank's rows of a batch-leading tensor, array, list or
        stacked ``GuidanceSpec`` (None stays None)."""
        if x is None:
            return None
        if isinstance(x, GuidanceSpec):
            return spec_row(x, self.rows)
        if isinstance(x, tuple):
            return list(x)[self.rows]
        return x[self.rows]

    def gather(self, tree):
        """The whole batch of ``tree`` on every rank (``multihost.to_host``);
        ``tree`` itself when nothing is gathered."""
        return to_host(tree, self.sources) if self.gathers else tree

    def gather_images(self, images):
        """The whole batch of uint8 images on the primary, None elsewhere
        (None stays None)."""
        if images is None or not self.gathers:
            return images
        return gather_to_primary(images, self.sources)


def run_rows(shard: Shard, sd, statics, hp, emb, latents0, spec, sched, arrays, noise, on_device=None,
             start: int = 0, stop: Optional[int] = None, decode: bool = False):
    """Run ``shard``'s rows of the batch on this rank, nothing gathered:
    ``emb`` and ``spec`` hold the whole batch's rows (cut here),
    ``latents0`` and ``noise`` this rank's only (drawn from its seeds'
    generators). Returns (final latents, ``StepDiag``, uint8 images or
    None) of the rows, as ``pipeline.generate_batch`` leaves them."""
    final, diags = pipeline.generate_batch(sd, statics, hp, shard.take(emb), latents0, shard.take(spec), sched,
                                           arrays, noise, on_device=on_device, start=start, stop=stop)
    return final, diags, sd.decode_latents_u8(final) if decode else None


def generate_batch(shard: Shard, sd, statics, hp, emb, latents0, spec, sched, arrays, noise, on_device=None,
                   start: int = 0, stop: Optional[int] = None, decode: bool = False):
    """``run_rows`` on every rank (``Shard.agree``), then the whole batch's
    (final latents, ``StepDiag``, uint8 images or None): without gathering,
    ``pipeline.generate_batch``'s outputs as they are (on the device); when
    gathered, the latents as a CPU tensor in the model dtype, and the images
    on the primary only."""
    final, diags, images = shard.agree(lambda: run_rows(shard, sd, statics, hp, emb, latents0, spec, sched, arrays,
                                                        noise, on_device, start, stop, decode))
    images = shard.gather_images(images)
    final, diags = shard.gather((final, diags))
    return final, diags, images
