"""Per-run guidance hyper-parameters.

The port's own copy of ``HyperParams`` from the JAX package's ``config.py``
(the two must not share code). ``RunConfig`` belongs to the frontends and
arrives with them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


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
