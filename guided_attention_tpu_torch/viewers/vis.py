"""Cross-attention relevance visualization (``--save_cross_attention_maps``).

Counterpart of the JAX package's ``viewers/vis.py`` (reference
utils/vis_utils.py:12-60, utils/ptp_utils.py:14-56): JET heat-map overlays
of per-token maps on the generated image, bilinear-upsampled 16 -> 256,
each labeled under the tile, in one row. It reads a ``PipelineOutput``'s
diagnostics. The resizing, the colormap and the text are cv2's, imported
inside the calls; the PNG goes through the native writer.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from guided_attention_tpu_torch.runtime.native import write_png


def upsample_relevance(map16: np.ndarray, out_res: int = 256) -> np.ndarray:
    """Bilinear 16x16 -> out_res x out_res, min-max normalized
    (reference vis_utils.py:38-55)."""
    import cv2

    up = cv2.resize(np.asarray(map16, np.float32), (out_res, out_res), interpolation=cv2.INTER_LINEAR)
    lo, hi = up.min(), up.max()
    if hi > lo:
        up = (up - lo) / (hi - lo)
    return up


def heatmap_on_image(image01: np.ndarray, relevance: np.ndarray) -> np.ndarray:
    """JET colormap overlay (reference vis_utils.py:40-45); returns uint8 RGB."""
    import cv2

    img = np.asarray(image01, np.float32)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-8)
    heat = cv2.applyColorMap(np.uint8(255 * relevance), cv2.COLORMAP_JET)
    heat = cv2.cvtColor(heat, cv2.COLOR_BGR2RGB).astype(np.float32) / 255
    cam = heat + img
    cam = cam / cam.max()
    return np.uint8(255 * cam)


def text_under_image(image: np.ndarray, text: str, text_color=(0, 0, 0)) -> np.ndarray:
    """(reference ptp_utils.py:14-23)"""
    import cv2

    h, w, c = image.shape
    offset = int(h * 0.2)
    img = np.ones((h + offset, w, c), dtype=np.uint8) * 255
    img[:h] = image
    font = cv2.FONT_HERSHEY_SIMPLEX
    tw, th = cv2.getTextSize(text, font, 1, 2)[0]
    cv2.putText(img, text, ((w - tw) // 2, h + offset - th // 2), font, 1, text_color, 2)
    return img


def view_images(images, num_rows: int = 1, offset_ratio: float = 0.02, save_path=None) -> np.ndarray:
    """Grid of uint8 images with white padding (reference ptp_utils.py:26-56);
    returns the uint8 canvas, written to ``save_path`` when given."""
    if isinstance(images, np.ndarray) and images.ndim == 4:
        images = list(images)
    elif not isinstance(images, list):
        images = [images]
    num_empty = len(images) % num_rows
    empty = np.ones(images[0].shape, dtype=np.uint8) * 255
    images = [i.astype(np.uint8) for i in images] + [empty] * num_empty
    n = len(images)
    h, w, c = images[0].shape
    offset = int(h * offset_ratio)
    cols = n // num_rows
    canvas = np.ones((h * num_rows + offset * (num_rows - 1), w * cols + offset * (cols - 1), 3), dtype=np.uint8) * 255
    for i in range(num_rows):
        for j in range(cols):
            canvas[i * (h + offset) : i * (h + offset) + h, j * (w + offset) : j * (w + offset) + w] = images[i * cols + j]
    if save_path and not write_png(canvas, save_path):
        raise OSError(f"could not write {save_path}")
    return canvas


def show_cross_attention(
    out,
    tokens: Sequence[Tuple[int, str]],
    step: int = -1,
    out_res: int = 256,
    save_path=None,
    avg: bool = False,
) -> np.ndarray:
    """Overlay each bound token's map (from diagnostics) on the output image
    (reference vis_utils.py:12-35). ``tokens`` = spec.words. ``avg=True``
    overlays the maps averaged over the steps that evaluated guidance
    (``PipelineOutput.average_maps``) instead of one step's."""
    import cv2

    if avg:
        maps = out.average_maps()
        if maps is None:
            raise ValueError("no averaged maps available (run_standard_sd or capture_diagnostics=False)")
    else:
        maps = out.diagnostics.maps[step]  # [R, R, K]
    image = out.images[0]
    img_small = cv2.resize((image * 255).astype(np.uint8), (out_res, out_res))
    tiles = []
    for tok, word in tokens:
        rel = upsample_relevance(np.asarray(maps[:, :, tok], np.float32), out_res)
        tile = heatmap_on_image(img_small.astype(np.float32) / 255, rel)
        tiles.append(text_under_image(tile, word))
    return view_images(np.stack(tiles), save_path=save_path)
