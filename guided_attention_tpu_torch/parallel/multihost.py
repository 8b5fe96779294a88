"""Several processes, one GPU each, over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/multihost.py``. The algorithm
needs no communication between samples, so data parallelism is: start the
process group, give each process its slice of the seed batch, and gather the
finished batch back to the host. Each process drives one GPU from its own
interpreter: the port's loop is bound by the host (one Python thread issues
every launch), so several devices behind one process would share one
interpreter lock.

The data axis needs one collective, the final gather of latents,
diagnostics and generator states, which go to numpy or CPU tensors anyway,
so the world group is gloo over CPU tensors. It also lets two ranks share
one card, which NCCL refuses. The mesh's ``tensor`` axis needs device
collectives: ``tensor_groups`` makes one subgroup per data row of the mesh,
on NCCL where each of its ranks has a card of its own and on gloo where
ranks share one (gloo reduces CUDA tensors through host copies). Every
group has a finite timeout (``TIMEOUT_S``), so a rank that fails turns its
partners' wait into an error instead of a hang. Without a group (one
process) every helper here is the identity of one process.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import sys
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective of the world group waits for the other ranks before it
# raises; a tensor group waits half of it, so that a rank whose tensor
# collective timed out still meets the others in the world group
TIMEOUT_S = 600.0


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the gloo process group of ``num_processes`` processes as
    ``process_id``; a no-op at one process and when this process has
    joined already. Absent arguments come from torchrun's environment
    (``WORLD_SIZE``, ``RANK``, and ``MASTER_ADDR`` / ``MASTER_PORT`` for the
    rendezvous). ``coordinator_address`` is ``host:port``, or an init URL
    (``tcp://host:port``, ``file:///path`` for processes of one machine).
    Every collective of the group raises after ``TIMEOUT_S`` seconds of
    waiting."""
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
    dist.init_process_group("gloo", init_method=init_method, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


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


def local_batch_slice(global_batch: int, mesh=None) -> slice:
    """This process's rows of a [global_batch, ...] leading axis split
    evenly across the processes in rank order (the JAX package's formula),
    or, given a ``parallel.mesh.Mesh``, across its data axis by this rank's
    data index (the ranks of one data row share its rows). A batch that
    does not divide raises: callers pad it (the CLI repeats a chunk's last
    sample)."""
    if mesh is None:
        n, index, over = process_count(), process_index(), "processes"
    else:
        n, index, over = mesh.shape.get("data", 1), mesh.data_index, "data rows of the mesh"
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} does not split evenly over {n} {over}; pad it to a "
                         f"multiple of {n}")
    per = global_batch // n
    return slice(index * per, (index + 1) * per)


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


def to_host(tree, sources: Optional[Sequence[int]] = None):
    """The whole batch of every leaf ([b, ...] rows on each rank), on every
    rank, concatenated along axis 0 in rank order: the rows of the ranks
    ``sources`` (default: every rank; a mesh with a tensor axis names one
    rank per data row, whose partners hold the same rows). Numpy leaves
    come back as numpy, tensors as CPU tensors of their dtype (numpy has no
    bfloat16). Each leaf travels as its bytes, packed into one gloo
    all-gather: the gather is exact for every dtype and needs no dtype
    support from gloo. At one process the leaves are returned as they are."""
    if process_count() == 1:
        return tree
    leaves: List[Any] = []
    _map(tree, leaves.append)
    if any(x.ndim == 0 for x in leaves):
        raise ValueError("to_host gathers arrays with a leading batch axis, not scalars")
    chunks = [_as_bytes(x) for x in leaves]
    mine = torch.from_numpy(np.concatenate(chunks) if chunks else np.zeros(0, np.uint8))
    every = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(every, mine)
    every = [every[r].numpy() for r in (range(process_count()) if sources is None else sources)]
    n = len(every)
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


def gather_to_primary(x: torch.Tensor, sources: Optional[Sequence[int]] = None) -> Optional[torch.Tensor]:
    """The whole batch of ``x`` ([b, ...] on each rank, same dtype and
    shape) as a CPU tensor on the primary, the rows of the ranks
    ``sources`` (default: every rank) in rank order, and None on every
    other rank; ``x`` itself at one process."""
    n = process_count()
    if n == 1:
        return x
    mine = x.detach().cpu().contiguous()
    parts = [torch.empty_like(mine) for _ in range(n)] if is_primary() else None
    dist.gather(mine, parts, dst=0)
    if parts is None:
        return None
    return torch.cat([parts[r] for r in (range(n) if sources is None else sources)])


def barrier() -> None:
    """Wait for every process of the group (none at one process)."""
    if process_count() > 1:
        dist.barrier()


def broadcast_object(obj: Any = None) -> Any:
    """Rank 0's ``obj`` on every rank (pickled over the world group): the
    serving engine's lockstep messages. ``obj`` itself at one process."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order, on every rank."""
    if process_count() == 1:
        return [obj]
    every: List[Any] = [None] * process_count()
    dist.all_gather_object(every, obj)
    return every


def _place(device: torch.device) -> Tuple[str, str, Optional[int]]:
    """Where a rank's tensors live: (host, device type, CUDA index)."""
    if device.type != "cuda":
        return socket.gethostname(), device.type, None
    index = device.index if device.index is not None else torch.cuda.current_device()
    return socket.gethostname(), "cuda", index


def tensor_groups(rows: Sequence[Sequence[int]], device: Any) -> Tuple[Any, str]:
    """One subgroup per row of ranks (a data row of the mesh; every rank
    makes this call with the same rows, in the same order) for the tensor
    axis's device collectives; returns this rank's (group, backend).

    The backend is NCCL where every rank of the row has a CUDA card of its
    own (``device`` is the rank's), else gloo: NCCL refuses two ranks on one
    card, and gloo reduces and broadcasts CUDA tensors through host copies,
    so the tensor axis uses only those two collectives. The choice is said
    on stderr by the first rank of each row."""
    places = all_gather_object(_place(torch.device(device)))
    me = process_index()
    mine = None
    for row in rows:
        where = [places[r] for r in row]
        own = all(p[1] == "cuda" for p in where) and len(set(where)) == len(where)
        backend = "nccl" if own and dist.is_nccl_available() else "gloo"
        group = dist.new_group(list(row), backend=backend, timeout=datetime.timedelta(seconds=TIMEOUT_S / 2))
        if me in row:
            mine = (group, backend)
            if me == row[0]:
                why = ("each rank on a card of its own" if backend == "nccl" else
                       "ranks share " + ", ".join(sorted({f"{p[1]}:{p[2]}" if p[2] is not None else p[1]
                                                         for p in where})))
                print(f"rank {me}: tensor group {list(row)} on {backend} ({why})", file=sys.stderr, flush=True)
    if mine is None:
        raise ValueError(f"rank {me} is in none of the tensor groups {[list(r) for r in rows]}")
    return mine
