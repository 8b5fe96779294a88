"""Offline viewer: grids of per-iteration attention-map PNGs.

Counterpart of the JAX package's ``viewers/batch_map_view.py`` (reference
utils/batch_map_view.py:6-96): point it at a run's per-seed folder of the
artifact tree (``runtime/artifacts``) and it grids every 16x16 token map by
(iter, subiter), optionally titling each with its per-token loss parsed back
out of the run's .txt log ("{iter:02d}.{subiter:02d} loss for {word}:
{value}"). Host only: matplotlib is imported inside the calls.

Usage: python -m guided_attention_tpu_torch.viewers.batch_map_view <folder> [token] [view_losses] [--save out.png]
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional


def parse_losses_from_log(log_path: str, token: str) -> Dict[str, float]:
    """{"iter.subiter": loss} of ``token`` from a run log ({} without one)."""
    losses: Dict[str, float] = {}
    if not os.path.exists(log_path):
        return losses
    with open(log_path) as f:
        for line in f:
            if f"loss for {token}" in line:
                losses[line.split(" ")[0]] = float(line.split(":")[-1])
    return losses


def collect_maps(folder: str, only_token: Optional[str] = None):
    """The 16x16 map PNGs of ``folder`` grouped by token, in file-name
    order; each entry (filename, image, iter, subiter)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups: Dict[str, list] = {}
    for fname in sorted(os.listdir(folder)):
        if not fname.endswith(".png"):
            continue
        img = plt.imread(os.path.join(folder, fname))
        parts = fname.split("_")
        if img.shape[0] != 16 or len(parts) < 3:
            continue
        token = parts[2]
        if only_token is not None and only_token != token:
            continue
        it = sub = None
        for i, p in enumerate(parts[:-1]):
            if p == "iter":
                it = parts[i + 1]
            elif p == "subiter":
                sub = parts[i + 1].replace(".png", "")
        groups.setdefault(token, []).append((fname, img, it, sub))
    return groups


def show_attn_plot(folder: str, only_token: Optional[str] = None, view_losses: bool = False,
                   save_path: Optional[str] = None):
    """One row of map tiles per token (20 to a row), shown, or saved to
    ``save_path``; returns the figure (None when ``folder`` has no maps)."""
    import matplotlib

    if save_path:
        matplotlib.use("Agg")
    import matplotlib.gridspec as gridspec
    import matplotlib.pyplot as plt

    groups = collect_maps(folder, only_token)
    if not groups:
        print("no 16x16 maps found in", folder)
        return None
    losses = parse_losses_from_log(folder + ".txt", only_token) if view_losses else {}

    max_width = 20
    fig = plt.figure(figsize=(20, 5))
    plt.subplots_adjust(left=0.02, right=0.98, bottom=0.1, top=0.9, wspace=0.1, hspace=0.1)
    outer = gridspec.GridSpec(len(groups), 1, hspace=0.3)
    for gi, (token, maps) in enumerate(groups.items()):
        rows = len(maps) // max_width + 1
        inner = gridspec.GridSpecFromSubplotSpec(rows, max_width, subplot_spec=outer[gi], wspace=0.1, hspace=0.01)
        for k, (_fname, img, it, sub) in enumerate(maps):
            ax = fig.add_subplot(inner[k])
            ax.set_xticks([])
            ax.set_yticks([])
            loss = losses.get(f"{it}.{sub}")
            suffix = "" if loss is None else f" l:{loss:.2f}"
            ax.set_title(token + suffix if k == 0 else f"{it}.{sub}{suffix}", fontsize=6)
            ax.imshow(img)
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    else:
        plt.show()
    return fig


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    save = sys.argv[sys.argv.index("--save") + 1] if "--save" in sys.argv else None
    if save is not None:
        args.remove(save)
    if not args:
        print("Requires Folder Name")
        raise SystemExit(-1)
    show_attn_plot(args[0], args[1] if len(args) > 1 else None, bool(args[2]) if len(args) > 2 else False, save)


if __name__ == "__main__":
    main()
