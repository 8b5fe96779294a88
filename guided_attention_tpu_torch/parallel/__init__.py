"""Data and tensor parallelism over several GPUs, one process each (``torch.distributed``)."""
from guided_attention_tpu_torch.parallel.mesh import DEFAULT_TP_RULES, Mesh, make_mesh, shard_unet  # noqa: F401
