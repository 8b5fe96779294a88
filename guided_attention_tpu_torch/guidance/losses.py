"""The vectorized guidance loss engine (counterpart of the JAX package's
``guidance/losses.py``).

Masked tensor ops over all 77 token slots at once, differentiable end to end
so that ``torch.autograd.grad`` takes the loss back to the latent.

Loss formulas (reference parity):
  * re-softmax: token maps x100, softmax over the valid token slots
    (pipeline:217-219), masked so indices never shift.
  * COOR centering: 1*|col - x*R|/(R-1) + 4*|row - y*R|/(R-1)
    (pipeline:390-395), (col,row) the attention-mass centroid at cell centres.
  * BOX (non-strict): inside = 1 - mass_inside, outside = mass_outside
    (helpers.py:265-277), scaled inside*0.2 + outside*0.2*3 plus
    bb_center_weight * centering (pipeline:426-434).
  * BOX strict: per-pixel hinges with the spec's weight maps (helpers.py:250-264).
  * KEYWORD: max(0, 1 - max_attn) * keyword_max_loss_scale.
  * custom plugin losses summed into their own group (pipeline:286-289).
  * grouping: sum (or mean) per sub-prompt, then sum (pipeline:358-387).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from guided_attention_tpu_torch.annotation import AnnotationType
from guided_attention_tpu_torch.config import HyperParams
from guided_attention_tpu_torch.guidance.smoothing import smooth_maps
from guided_attention_tpu_torch.guidance.spec import GuidanceSpec


@dataclasses.dataclass
class TokenStats:
    """Per-token statistics computed from the aggregated attention maps."""

    probs: torch.Tensor  # f32[R,R,K] — re-softmaxed maps (unsmoothed)
    smoothed: torch.Tensor  # f32[R,R,K] — smoothed maps used for losses
    max_attn: torch.Tensor  # f32[K]
    col: torch.Tensor  # f32[K] — attention centroid x (cell units)
    row: torch.Tensor  # f32[K] — attention centroid y
    inside_loss: torch.Tensor  # f32[K]
    outside_loss: torch.Tensor  # f32[K]
    custom_loss: torch.Tensor  # f32[] — summed plugin losses


def compute_token_stats(
    maps: torch.Tensor,
    spec: GuidanceSpec,
    hp: HyperParams,
    smooth_attentions: bool = True,
    sigma: float = 0.5,
    kernel_size: int = 3,
) -> TokenStats:
    """maps: f32[R,R,K] aggregated cross-attention probabilities."""
    maps = maps.float()
    R = maps.shape[0]

    logits = torch.where(spec.valid_text[None, None, :], maps * 100.0, float("-inf"))
    probs = torch.softmax(logits, dim=-1)

    if smooth_attentions:
        smoothed = smooth_maps(probs.movedim(-1, 0), kernel_size, sigma).movedim(0, -1)
    else:
        smoothed = probs

    max_attn = smoothed.amax(dim=(0, 1))

    # Double-where safe division: invalid slots have zero mass, and a floor
    # alone NaNs the gradient (d(x/m)/dm divides by m**2, which underflows).
    mass = smoothed.sum(dim=(0, 1), keepdim=True)
    mass_ok = mass > 1e-12
    norm = torch.where(mass_ok, smoothed / torch.where(mass_ok, mass, torch.ones_like(mass)), 0.0)
    grid = torch.arange(R, dtype=torch.float32, device=maps.device) + 0.5
    col = torch.einsum("hwk,w->k", norm, grid)
    row = torch.einsum("hwk,h->k", norm, grid)

    inside = spec.inside_mask.movedim(0, -1)  # [R,R,K]
    if hp.strict:
        w_in = spec.w_in.movedim(0, -1)
        w_out = spec.w_out.movedim(0, -1)
        at_most = spec.at_most[None, None, :]
        inside_loss = (w_in * 2.0 * torch.clamp(at_most - norm, min=0.0)).sum(dim=(0, 1))
        outside_loss = (w_out * torch.clamp(norm, min=0.0)).sum(dim=(0, 1))
    else:
        inside_loss = 1.0 - (norm * inside).sum(dim=(0, 1))
        outside_loss = (norm * (1.0 - inside)).sum(dim=(0, 1))

    # plugin losses see the unsmoothed re-softmaxed maps (invalid slots zero)
    custom_total = torch.zeros((), dtype=torch.float32, device=maps.device)
    for _name, fn, args in spec.custom_losses:
        custom_total = custom_total + fn.calc_loss(probs, spec, args).reshape(())

    return TokenStats(
        probs=probs,
        smoothed=smoothed,
        max_attn=max_attn,
        col=col,
        row=row,
        inside_loss=inside_loss,
        outside_loss=outside_loss,
        custom_loss=custom_total,
    )


def _centering_loss(col, row, xy, R: int):
    """1*|col - x*R|/(R-1) + 4*|row - y*R|/(R-1) (pipeline:390-395)."""
    part1 = 1.0 * torch.abs(col - xy[..., 0] * R) / (R - 1)
    part2 = 4.0 * torch.abs(row - xy[..., 1] * R) / (R - 1)
    return part1 + part2


def per_token_losses(
    stats: TokenStats, spec: GuidanceSpec, hp: HyperParams
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled and unscaled per-token losses, zero for unbound slots."""
    R = spec.attention_res
    is_coor = (spec.ann_type == int(AnnotationType.COOR)) & spec.token_mask
    is_box = (spec.ann_type == int(AnnotationType.BOX)) & spec.token_mask
    is_kw = (spec.ann_type == int(AnnotationType.KEYWORD)) & spec.token_mask

    centering = _centering_loss(stats.col, stats.row, spec.center_xy, R)
    box_unscaled = stats.inside_loss + stats.outside_loss
    box_loss = (
        hp.inside_loss_scale * stats.inside_loss
        + hp.outside_loss_scale * stats.outside_loss * 3.0
        + hp.bb_center_weight * centering
    )
    kw_loss = hp.keyword_max_loss_scale * torch.clamp(1.0 - stats.max_attn, min=0.0)

    coor_part = torch.where(is_coor, centering, 0.0)
    kw_part = torch.where(is_kw, kw_loss, 0.0)
    scaled = coor_part + torch.where(is_box, box_loss, 0.0) + kw_part
    unscaled = coor_part + torch.where(is_box, box_unscaled, 0.0) + kw_part
    return scaled, unscaled


def group_by_subprompt(
    per_token: torch.Tensor, spec: GuidanceSpec, hp: HyperParams, custom: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(group_sums f32[G], group_counts f32[G], group_valid bool[G])
    (pipeline:358-387)."""
    n = spec.n_groups
    gid = torch.where(spec.token_mask, spec.subprompt_id, n)  # park unbound at n
    zeros = per_token.new_zeros(n + 1)
    sums = zeros.index_add(0, gid, per_token)[:n]
    counts = zeros.index_add(0, gid, torch.ones_like(per_token))[:n]
    group_valid = counts > 0
    if spec.custom_group >= 0:
        onehot = torch.zeros(n, dtype=per_token.dtype, device=per_token.device)
        onehot[spec.custom_group] = 1.0
        sums = sums + onehot * custom
        counts = counts + onehot
        group_valid = group_valid | onehot.bool()
    return sums, counts, group_valid


def compute_loss(
    stats: TokenStats,
    spec: GuidanceSpec,
    hp: HyperParams,
    sub_prompt_avg_within: bool = False,
):
    """(total, groups_scaled, groups_unscaled, group_valid)."""
    scaled, unscaled = per_token_losses(stats, spec, hp)
    gs, cs, valid = group_by_subprompt(scaled, spec, hp, stats.custom_loss)
    gu, cu, _ = group_by_subprompt(unscaled, spec, hp, stats.custom_loss)
    if sub_prompt_avg_within:
        gs = torch.where(valid, gs / torch.clamp(cs, min=1.0), 0.0)
        gu = torch.where(valid, gu / torch.clamp(cu, min=1.0), 0.0)
    total = torch.where(valid, gs, 0.0).sum()
    return total, gs, gu, valid


def meets_threshold(
    groups_unscaled: torch.Tensor, group_valid: torch.Tensor, threshold
) -> torch.Tensor:
    """True iff every valid group's unscaled loss is <= threshold
    (pipeline:1074-1088), over the last axis: [G] gives one answer, [B, G]
    one per sample. The pipeline's last-value rule calls it with the
    LAST threshold of the run's dict (meets_threshold(-1), pipeline:1083)."""
    return torch.all(torch.where(group_valid, groups_unscaled <= threshold, True), dim=-1)
