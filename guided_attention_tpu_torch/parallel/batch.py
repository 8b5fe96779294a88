"""Data-parallel batch generation: each rank runs its rows of the batch.

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
"""
from __future__ import annotations

from typing import Any, Optional

from guided_attention_tpu_torch import pipeline
from guided_attention_tpu_torch.guidance.spec import GuidanceSpec, spec_row
from guided_attention_tpu_torch.parallel.mesh import Mesh
from guided_attention_tpu_torch.parallel.multihost import gather_to_primary, local_batch_slice, process_count, to_host


class Shard:
    """This rank's rows of a batch of ``n`` samples over ``mesh``'s data
    axis; without a mesh, every row, and nothing is gathered."""

    def __init__(self, mesh: Optional[Mesh], n: int):
        if mesh is not None and mesh.size != process_count():
            raise ValueError(f"mesh {mesh.shape} has {mesh.size} ranks; the process group has {process_count()}")
        self.gathers = mesh is not None and process_count() > 1
        self.rows = local_batch_slice(n) if mesh is not None else slice(0, n)

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
        return to_host(tree) if self.gathers else tree

    def gather_images(self, images):
        """The whole batch of uint8 images on the primary, None elsewhere."""
        return gather_to_primary(images) if self.gathers else images


def generate_batch(shard: Shard, sd, statics, hp, emb, latents0, spec, sched, arrays, noise, on_device=None,
                   start: int = 0, stop: Optional[int] = None, decode: bool = False):
    """Run ``shard``'s rows of the batch: ``emb`` and ``spec`` hold the
    whole batch's rows (cut here), ``latents0`` and ``noise`` this rank's
    only (drawn from its seeds' generators). Returns the whole batch's
    (final latents, ``StepDiag``, uint8 images or None): without gathering,
    ``pipeline.generate_batch``'s outputs as they are (on the device); when
    gathered, the latents as a CPU tensor in the model dtype, and the images
    on the primary only."""
    final, diags = pipeline.generate_batch(sd, statics, hp, shard.take(emb), latents0, shard.take(spec), sched,
                                           arrays, noise, on_device=on_device, start=start, stop=stop)
    images = sd.decode_latents_u8(final) if decode else None
    if images is not None:
        images = shard.gather_images(images)
    final, diags = shard.gather((final, diags))
    return final, diags, images
