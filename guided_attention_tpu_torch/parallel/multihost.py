"""Several processes, one GPU each, over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/multihost.py``. The algorithm
needs no communication between samples, so data parallelism is: start the
process group, give each process its slice of the seed batch, and gather the
finished batch back to the host. Each process drives one GPU from its own
interpreter: the port's loop is bound by the host (one Python thread issues
every launch), so several devices behind one process would share one
interpreter lock.

The one collective is that final gather of latents, diagnostics and
generator states, which go to numpy or CPU tensors anyway, so the group is
gloo over CPU tensors. It also lets two ranks share one card, which NCCL
refuses; no device collective is needed until the mesh has a ``tensor``
axis. Without a group (one process) every helper here is the identity of
one process.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the gloo process group of ``num_processes`` processes as
    ``process_id``; a no-op at one process and when this process has
    joined already. Absent arguments come from torchrun's environment
    (``WORLD_SIZE``, ``RANK``, and ``MASTER_ADDR`` / ``MASTER_PORT`` for the
    rendezvous). ``coordinator_address`` is ``host:port``, or an init URL
    (``tcp://host:port``, ``file:///path`` for processes of one machine)."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or dist.is_initialized():
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=init_method, world_size=num_processes, rank=process_id)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def rank_device(device: Any = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a bare
    "cuda" in a group of several processes (ranks beyond the machine's cards
    share them, and say so), else ``device`` as given. A rank that finds no
    GPU raises; only an explicit "cpu" runs on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {process_index()}: device {device!r} requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    if dev.index is None and process_count() > 1:
        n = torch.cuda.device_count()
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", process_index())) % n)
        if process_count() > n:
            print(f"rank {process_index()}: {process_count()} ranks share {n} GPU(s); this one runs on {dev}",
                  file=sys.stderr, flush=True)
    if dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


def local_batch_slice(global_batch: int) -> slice:
    """This process's rows of a [global_batch, ...] leading axis split
    evenly across the processes in rank order (the JAX package's formula).
    A batch that does not divide raises: callers pad it (the CLI repeats a
    chunk's last sample)."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} does not split evenly over {n} processes; pad it to a "
                         f"multiple of {n}")
    per = global_batch // n
    start = process_index() * per
    return slice(start, start + per)


def _map(tree, fn: Callable):
    """``tree`` with ``fn`` applied to each tensor and numpy leaf (through
    dicts, lists, tuples and dataclasses; None stays None)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _map(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree)})
    raise TypeError(f"to_host: unsupported leaf {type(tree).__name__}")


def _as_bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def to_host(tree):
    """The whole batch of every leaf ([b, ...] rows on each rank), on every
    rank, concatenated along axis 0 in rank order. Numpy leaves come back
    as numpy, tensors as CPU tensors of their dtype (numpy has no
    bfloat16). Each leaf travels as its bytes, packed into one gloo
    all-gather: the gather is exact for every dtype and needs no dtype
    support from gloo. At one process the leaves are returned as they are."""
    n = process_count()
    if n == 1:
        return tree
    leaves: List[Any] = []
    _map(tree, leaves.append)
    if any(x.ndim == 0 for x in leaves):
        raise ValueError("to_host gathers arrays with a leading batch axis, not scalars")
    chunks = [_as_bytes(x) for x in leaves]
    mine = torch.from_numpy(np.concatenate(chunks) if chunks else np.zeros(0, np.uint8))
    every = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(every, mine)
    every = [t.numpy() for t in every]
    offsets = np.cumsum([0] + [c.size for c in chunks])
    out = iter(range(len(leaves)))

    def gathered(x):
        i = next(out)
        raw = np.concatenate([e[offsets[i] : offsets[i + 1]] for e in every])
        shape = (n * x.shape[0],) + tuple(x.shape[1:])
        if isinstance(x, torch.Tensor):
            return torch.from_numpy(raw).view(x.dtype).reshape(shape)
        return raw.view(x.dtype).reshape(shape)

    return _map(tree, gathered)


def gather_to_host(x):
    """``to_host`` of one array."""
    return to_host(x)


def gather_to_primary(x: torch.Tensor) -> Optional[torch.Tensor]:
    """The whole batch of ``x`` ([b, ...] on each rank, same dtype and
    shape) as a CPU tensor on the primary, in rank order, and None on every
    other rank; ``x`` itself at one process."""
    n = process_count()
    if n == 1:
        return x
    mine = x.detach().cpu().contiguous()
    parts = [torch.empty_like(mine) for _ in range(n)] if is_primary() else None
    dist.gather(mine, parts, dst=0)
    return torch.cat(parts) if parts is not None else None


def barrier() -> None:
    """Wait for every process of the group (none at one process)."""
    if process_count() > 1:
        dist.barrier()
