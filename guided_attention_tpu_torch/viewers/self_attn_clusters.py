"""Offline viewer: KMeans clustering of a saved self-attention matrix.

Counterpart of the JAX package's ``viewers/self_attn_clusters.py``
(reference utils/self_attn_clusters_view.py:7-37): load a 256x256
self-attention .npy (16x16 pixels attending to 16x16 pixels), sweep k over
2..14, and show or save the 16x16 cluster-label segmentations and the
inertia and silhouette curves. Host only: sklearn and matplotlib are
imported inside the call. KMeans draws its initial centres from numpy's
global generator.

Usage: python -m guided_attention_tpu_torch.viewers.self_attn_clusters <file.npy> [--save outdir]
"""
from __future__ import annotations

import os
import sys

import numpy as np


def cluster_self_attention(path: str, k_range=range(2, 15), save_dir=None):
    """Returns (ks, inertias, silhouettes); one segmentation figure per k
    and the two curves are shown, or saved under ``save_dir``."""
    from sklearn.cluster import KMeans
    from sklearn.metrics import silhouette_score

    import matplotlib

    if save_dir:
        matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    def emit(name: str) -> None:
        if save_dir:
            plt.savefig(os.path.join(save_dir, name))
            plt.clf()
        else:
            plt.show()

    ca = np.load(path).reshape(256, 256)
    res = int(np.sqrt(ca.shape[0]))
    ks, inertias, sils = [], [], []
    for k in k_range:
        km = KMeans(n_clusters=k, n_init=10).fit(ca)
        print(f"{k} --- {km.inertia_}")
        ks.append(k)
        inertias.append(km.inertia_)
        sils.append(silhouette_score(ca, km.labels_))
        plt.imshow(km.labels_.reshape(res, res), cmap="viridis")
        emit(f"clusters_k{k}.png")
    for name, ys in (("inertia", inertias), ("silhouette", sils)):
        plt.plot(ks, ys)
        plt.xlabel("k")
        plt.ylabel(name)
        emit(f"{name}.png")
    return ks, inertias, sils


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    save_dir = None
    if "--save" in sys.argv:
        save_dir = sys.argv[sys.argv.index("--save") + 1]
        args.remove(save_dir)
        os.makedirs(save_dir, exist_ok=True)
    if not args:
        print("Requires File Name")
        raise SystemExit(-1)
    cluster_self_attention(args[0], save_dir=save_dir)


if __name__ == "__main__":
    main()
