"""What the timed path computed, kept for the check after the window.

``Recorder`` hooks the port's UNet module: for every call it keeps the
tensors the call was given (latents, timestep, context), the eps it
returned, and, for a guidance eval (whose latents require a gradient),
the gradient the program took with respect to those latents (a hook on
that tensor). It keeps references, copies nothing, and adds no kernel.
Calls are grouped into the batch that was open when they ran.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional


@dataclasses.dataclass
class Call:
    x: Any  # latents [n, h, w, C]
    t: int
    ctx: Any  # [n, 77, D]
    truncate: bool
    eps: Any = None  # [n, h, w, C]; None for a truncated eval forward
    grad: Any = None  # [n, h, w, C] for an eval


@dataclasses.dataclass
class Batch:
    seeds: List[int]
    prompts: List[str]
    calls: List[Call] = dataclasses.field(default_factory=list)
    outputs: Optional[list] = None  # one PipelineOutput per row, as delivered
    delivery_errors: int = 0  # requests handed a row made for another request
    start: float = 0.0
    end: float = 0.0


class Recorder:
    def __init__(self, unet):
        self.batches: List[Batch] = []
        self.open: Optional[Batch] = None
        self._handles = [unet.register_forward_pre_hook(self._pre, with_kwargs=True),
                         unet.register_forward_hook(self._post, with_kwargs=True)]

    def begin(self, seeds, prompts) -> Batch:
        self.open = Batch(list(seeds), list(prompts))
        self.batches.append(self.open)
        return self.open

    def end(self) -> None:
        self.open = None

    def _pre(self, _module, args, kwargs):
        if self.open is None:
            return
        x = args[0]
        call = Call(x.detach(), int(args[1]), args[2].detach(), bool(kwargs.get("truncate", False)))
        if x.requires_grad:
            def keep(g, call=call):
                call.grad = g.detach()
            x.register_hook(keep)
        self.open.calls.append(call)

    def _post(self, _module, _args, _kwargs, out):
        if self.open is not None and out[0] is not None:
            self.open.calls[-1].eps = out[0].detach()

    def close(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
