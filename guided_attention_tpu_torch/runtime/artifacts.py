"""Host-side artifact sink: logs, attention-map PNGs, x0 snapshots, overlays.

Counterpart of the JAX package's ``runtime/artifacts.py``: the loop returns
stacked per-step diagnostics (``pipeline.StepDiag``) and this module
writes the reference's artifact tree afterwards (reference
pipeline_guided_attention.py:1096-1123, utils/helpers.py:292-349,
run.py:113-134), with the same file names, the same run-log text and the
same pixels for the same inputs.

Every PNG goes through the port's native writer (``runtime/native``), and
the final image, the grid and the boxes and crosshairs of ``annotate`` are
numpy, so the artifacts written by default need neither PIL, matplotlib
nor cv2. Three options import a package, inside the call: the annotation
text labels (Pillow; without it the image keeps its boxes and crosshairs),
the latent-stats figure at ``diagnostic_level > 0`` (matplotlib; without
it the figure is not written), each with a printed notice, and
``save_cross_attention_maps`` (``viewers/vis.py``, cv2 and Pillow, which
raises without them).

Output tree:
  outputs/{meta_prompt_clean}/{seed}{hyper}.png        final image
  outputs/{meta_prompt_clean}/{seed}{hyper}.txt        run log (schema below)
  outputs/{meta_prompt_clean}/{seed}{hyper}figure.png  latent-stats figure
  outputs/{meta_prompt_clean}/{seed}/_attnmap_{token}_...iter_{i:02d}..._subiter_{k:02d}.png
  outputs/{meta_prompt_clean}/{seed}/..._pred....png    x0 predictions
  outputs/{meta_prompt_clean}.png                       grid across seeds

Log schema (read back by the batch_map_view viewer, reference
utils/batch_map_view.py:46-54):
  "{iter:02d}.{subiter:02d} loss for {word}: {value}"
"""
from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from guided_attention_tpu_torch.annotation import Annotation, AnnotationType, meta_prompt_clean
from guided_attention_tpu_torch.runtime.native import AsyncArtifactWriter, to_u8, write_png

COLORS = ["#0000a0", "#a00000", "#00a000", "#ecf024", "#8d24f0"]  # helpers.py:125
NAME_MAX = 255  # longest file name most file systems take


def get_color(i: int) -> str:
    return COLORS[i % len(COLORS)]


def _rgb(color: str) -> np.ndarray:
    return np.array([int(color[k : k + 2], 16) for k in (1, 3, 5)], np.uint8)


class RunLog:
    """In-memory line log (reference helpers.py:292-307)."""

    def __init__(self):
        self.lines: List[str] = []

    def log(self, text: str, also_print: bool = False):
        self.lines.append(text + os.linesep)
        if also_print:
            print(text)

    def clear(self):
        self.lines = []

    def save(self, filename):
        Path(filename).parent.mkdir(parents=True, exist_ok=True)
        with open(filename, "w") as fp:
            fp.writelines(self.lines)
        self.clear()


def dict_to_string(d) -> str:
    """Hyperparameter state -> filename suffix (reference helpers.py:281-290)."""
    if isinstance(d, dict):
        s = ""
        for k, v in d.items():
            if k == "meta_prompt":
                continue
            s += "_" + str(k) + "_" + dict_to_string(v)
        return s
    return str(d)


# ---- drawing in numpy, at the pixels Pillow's ImageDraw sets: coordinates
# truncated toward zero, both ends inclusive, clipped to the image ----
def _hline(img, y, x0, x1, rgb):
    h, w = img.shape[:2]
    if 0 <= y < h:
        img[y, max(x0, 0) : min(x1, w - 1) + 1] = rgb


def _vline(img, x, y0, y1, rgb):
    h, w = img.shape[:2]
    if 0 <= x < w:
        img[max(y0, 0) : min(y1, h - 1) + 1, x] = rgb


def _rectangle(img, x0, y0, x1, y1, rgb, width):
    """Outline ``width`` pixels wide, inside the corners (ImageDraw.rectangle)."""
    for i in range(width):
        _hline(img, y0 + i, x0, x1, rgb)
        _hline(img, y1 - i, x0, x1, rgb)
        _vline(img, x0 + i, y0, y1, rgb)
        _vline(img, x1 - i, y0, y1, rgb)


def _label_drawer():
    """A function drawing a text label in place on a uint8 image through
    Pillow (its font, as the JAX package draws it), or None without Pillow."""
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError:
        return None
    try:
        font = ImageFont.truetype("arial.ttf", 20)
    except OSError:
        font = ImageFont.load_default()

    def draw(img: np.ndarray, xy, text: str, color: str) -> None:
        pil = Image.fromarray(img)
        ImageDraw.Draw(pil).text(xy, text, fill=color, font=font)
        img[...] = np.asarray(pil)

    return draw


def annotate_image(img: np.ndarray, annotations: Sequence[Annotation], size: int = 512) -> None:
    """Draw crosshairs, boxes and their sub-prompts in place on a uint8
    [H, W, 3] image (reference helpers.py:129-152); without Pillow, the
    boxes and crosshairs alone, with a notice."""
    label = _label_drawer()
    if label is None and annotations:
        print("annotation labels need Pillow; drawing boxes and crosshairs only")
    for i, ann in enumerate(annotations):
        color = get_color(i)
        rgb = _rgb(color)
        if ann.kind == AnnotationType.COOR:
            x, y = ann.target
            px, py = x * size, y * size
            ln = 15
            _hline(img, int(py), int(px - ln), int(px + ln), rgb)
            _vline(img, int(px), int(py - ln), int(py + ln), rgb)
            xy = (px, py)
        elif ann.kind == AnnotationType.BOX:
            r = ann.target
            _rectangle(img, int(r.x * size), int(r.y * size), int(r.right * size), int(r.bottom * size), rgb, 2)
            xy = (r.x * size, r.y * size)
        else:
            continue
        if label is not None:
            label(img, xy, ann.subprompt, color)


def image_grid(images: List[np.ndarray]) -> np.ndarray:
    """Square-ish grid of uint8 [H, W, 3] images on black (reference
    vis_utils.py:63-73)."""
    n = len(images)
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    h, w = images[0].shape[:2]
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, img in enumerate(images):
        r, c = divmod(i, cols)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = img
    return grid


def save_latent_stats_figure(diag, path: Path) -> None:
    """means + p99 per channel over steps (reference helpers.py:335-349);
    matplotlib's object-oriented API (no pyplot global state). Without
    matplotlib, a notice and no figure."""
    try:
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure
    except ImportError:
        print(f"the latent-stats figure needs matplotlib; not writing {path.name}")
        return

    fig = Figure()
    FigureCanvasAgg(fig)
    ax = fig.add_subplot()
    C = diag.latent_mean.shape[-1]
    for c in range(C):
        ax.plot(diag.latent_mean[:, c], label=f"ch{c} mean")
        ax.plot(diag.latent_p99[:, c], label=f"ch{c} 99")
    ax.legend(loc="best")
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path)


class ArtifactWriter:
    """Materialize a PipelineOutput's diagnostics into the reference's
    artifact tree for one (seed, hyperparam-state) run."""

    def __init__(
        self,
        output_path: Path,
        meta_prompt: str,
        seed: int,
        hyper_suffix: str = "",
        interactive: bool = False,
        async_writer: Optional[AsyncArtifactWriter] = None,
    ):
        self.root = Path(output_path)
        self.clean = meta_prompt_clean(meta_prompt, interactive)
        self.seed = seed
        self.hyper_suffix = hyper_suffix
        self.run_dir = self.root / self.clean
        self.step_dir = self.run_dir / str(seed)
        self.log = RunLog()
        self.async_writer = async_writer if async_writer is not None else AsyncArtifactWriter(2)

    def _state_name(self, step: int, subiter: int) -> str:
        # reference shared_state.get_name() tags (shared_state.py:39-51)
        return (
            f"cur_seed_{self.seed}_cur_time_step_iter_{step:02d}_"
            f"optimizeDeepLatent_False__subiter_{subiter:02d}"
        )

    def write_run_log(self, out, words: Dict[int, str]) -> None:
        """Reconstruct the reference's log lines from stacked diagnostics."""
        d = out.diagnostics
        S = d.total_loss.shape[0]
        for i in range(S):
            self.log.log(f"iteration {i}")
            for k in range(d.eval_mask.shape[1]):
                if not d.eval_mask[i, k]:
                    continue
                for tok, word in words.items():
                    self.log.log(f"{i:02d}.{k:02d} loss for {word}: {float(d.eval_unscaled[i, k, tok])}")
            for tok, word in words.items():
                self.log.log(f"{word}: {float(d.token_attn_sum[i, tok])}")
                self.log.log(f"weighted center col: {float(d.col[i, tok])}")
                self.log.log(f"weighted center row: {float(d.row[i, tok])}")
            if d.did_update[i]:
                self.log.log(f"\t Finished with loss of: {float(d.total_loss[i])} iter: {int(d.refine_iters[i])}")
            self.log.log(f"Iteration {i} | Loss: {float(d.total_loss[i]):0.4f}")
        self.log.save(self.run_dir / f"{self.seed}{self.hyper_suffix}.txt")

    def write_step_maps(self, out, words: Dict[int, str], only_eval_steps: bool = True) -> None:
        """Per-token 16x16 attention-map PNGs named for batch_map_view."""
        d = out.diagnostics
        for i in range(d.maps.shape[0]):
            if only_eval_steps and not d.eval_mask[i].any():
                continue
            subiter = max(int(d.eval_mask[i].sum()) - 1, 0)
            for tok, word in words.items():
                fname = f"_attnmap_{word}_{self.clean}{self._state_name(i, subiter)}.png"
                self.async_writer.submit_map(d.maps[i, :, :, tok], self.step_dir / fname)
        self.async_writer.flush()

    def write_x0_preds(self, out, decode_fn, steps: Sequence[int]) -> None:
        """Decode and save x0 predictions for the selected steps (reference
        always_save_iter=[0,1,2], pipeline:881,1036), all in one
        ``decode_fn`` call: numpy latents [n, h, w, C] -> images [n, H, W, 3]
        in [0, 1]."""
        d = out.diagnostics
        steps = [i for i in steps if i < d.x0_pred.shape[0]]
        if not steps:
            return
        imgs = np.asarray(decode_fn(np.stack([d.x0_pred[i] for i in steps])))
        self.step_dir.mkdir(parents=True, exist_ok=True)
        for i, img01 in zip(steps, imgs):
            fname = (self.clean + self._state_name(i, 0) + "_pred").replace(".", "_") + ".png"
            self.async_writer.submit_image(img01, self.step_dir / fname)
        self.async_writer.flush()

    def write_final_image(self, out, annotations, annotate: bool = False):
        """The final image (uint8, annotated on request) at
        ``{seed}{hyper}.png``, or ``{seed}.png`` when that name is too long
        (reference run.py:119-125). Returns (image, path)."""
        img = to_u8(out.images[0]).copy()
        if annotate:
            annotate_image(img, annotations, size=img.shape[1])
        self.run_dir.mkdir(parents=True, exist_ok=True)
        name = f"{self.seed}{self.hyper_suffix}.png"
        path = self.run_dir / name
        if len(name.encode()) > NAME_MAX or not write_png(img, path):
            path = self.run_dir / f"{self.seed}.png"
            if not write_png(img, path):
                raise OSError(f"could not write {path}")
        return img, path


def dynamic_thresholding(
    latents: np.ndarray,
    per_channel: bool = False,
    center_means: bool = False,
    max_value: float = 2.5,
) -> np.ndarray:
    """Latent-clamp experiment the reference ships but never calls
    (reference utils/helpers.py:352-371): rescale so the 99th percentile of
    |latents| stays <= max_value, optionally per channel and mean-centered.
    NHWC numpy in -> new array out."""
    lat = np.array(latents, dtype=np.float32, copy=True)
    if per_channel:
        for c in range(lat.shape[-1]):
            p = np.quantile(np.abs(lat[..., c]), 0.99)
            if p > max_value:
                lat[..., c] *= max_value / p
        if center_means:
            for c in range(lat.shape[-1]):
                lat[..., c] -= lat[..., c].mean()
    else:
        p = np.quantile(np.abs(lat), 0.99)
        if p > max_value:
            lat *= max_value / p
        if center_means:
            lat -= lat.mean()
    return lat


def _step_inputs(pipe, out, step: int):
    """The step-entry latents [1, h, w, C] on the device, the prompt's
    embeddings [2, 77, D] and the step's timestep, for a re-run forward."""
    from guided_attention_tpu_torch.schedulers.ddim import make_ddim_schedule

    sd = pipe.sd
    d = out.diagnostics
    lat = torch.as_tensor(np.asarray(d.latent_in[step], np.float32), device=sd.device)[None]
    sched = make_ddim_schedule(d.latent_in.shape[0], device=sd.device)
    return lat.to(sd.config.unet.dtype), sd.encode_prompt(out.prompt), int(sched.timesteps[step])


def individual_ca_maps(pipe, out, step: int = 12) -> Dict[str, List[np.ndarray]]:
    """Per-head cross-attention probabilities [H, Q, K] of every layer, by
    place ("up", "down", "mid"), from one cond-only forward at ``step``'s
    entry latents (the loop itself never pays for this)."""
    d = out.diagnostics
    step = min(step, d.latent_in.shape[0] - 1)
    lat, emb, t = _step_inputs(pipe, out, step)
    resolutions = sorted({lat.shape[1] // f for f in (1, 2, 4, 8)})
    cap = frozenset({("cross_perhead", r) for r in resolutions})
    with torch.no_grad():
        _eps, aux = pipe.sd.unet(lat, t, emb[1:2], capture=cap)
    return {place: [m[0].float().cpu().numpy() for m in aux["maps"][f"{place}_cross_perhead"]]
            for place in ("up", "down", "mid")}


def save_individual_ca_maps(pipe, out, step: int = 12, heads_dir: Optional[Path] = None,
                            async_writer: Optional[AsyncArtifactWriter] = None):
    """Per-head, per-resolution cross-attention map dump for one step
    (reference pipeline_guided_attention.py:319-346, save_maps_at=12)."""
    maps = individual_ca_maps(pipe, out, step)
    writer = async_writer if async_writer is not None else AsyncArtifactWriter(2)
    heads_dir = Path(heads_dir) if heads_dir else Path("individual_maps")
    agg = []
    for location in ("up", "down", "mid"):
        for map_iter, probs in enumerate(maps[location], start=1):
            H, Q, K = probs.shape
            res = int(np.sqrt(Q))
            grids = probs.reshape(H, res, res, K)
            for h in range(H):
                m1 = grids[h, :, :, 1]
                tag = f"{location}_res_{res}_head_{h}_mapiter_{map_iter}_avg_{m1.mean():.3}_max_{m1.max():.3}"
                writer.submit_map(m1, heads_dir / f"{tag}.png")
            writer.submit_map(grids.mean(0)[:, :, 1], heads_dir / f"{location}_res_{res}_avgheads_mapiter_{map_iter}.png")
            if res == pipe.sd.config.unet.sample_size // 4:
                agg.append(grids.mean(0))
    if agg:
        writer.submit_map(np.stack(agg).mean(0)[:, :, 1], heads_dir / "final.png")
    writer.flush()
    return heads_dir


def save_self_attention_npy(pipe, out, step: int = -1, path=None, res: int = 16):
    """Aggregate self-attention at ``res`` for one step and save it as .npy
    (reference pipeline:309-317 save_numpy('self_attn'))."""
    S = out.diagnostics.latent_in.shape[0]
    step = step % S
    lat, emb, t = _step_inputs(pipe, out, step)
    with torch.no_grad():
        _eps, aux = pipe.sd.unet(lat, t, emb[1:2], capture=frozenset({("self", res)}))
    items = [m for location in ("up", "down", "mid") for m in aux["maps"][f"{location}_self"]]
    agg = torch.stack([m[0].float() for m in items]).mean(0).cpu().numpy()  # [Q, Q]
    path = Path(path) if path else Path(f"self_attn_step{step}.npy")
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, agg.reshape(res, res, res * res))
    return path


def decode_numpy(pipe, latents: np.ndarray) -> np.ndarray:
    """Numpy latents [n, h, w, C] -> decoded images [n, H, W, 3] float32 in
    [0, 1], through the model on its device."""
    sd = pipe.sd
    lat = torch.as_tensor(np.asarray(latents, np.float32), device=sd.device).to(sd.config.unet.dtype)
    return sd.decode_latents(lat).float().cpu().numpy()


def diagnostic_x0_image(pipe, lat: torch.Tensor, i: int, emb: torch.Tensor, sched) -> np.ndarray:
    """The x0 estimate at step ``i`` from latents [1, h, w, C], decoded
    [H, W, 3]: one CFG forward at the reference's hard-coded scale 7.5
    (pipeline:533) and the DDIM step's x0."""
    from guided_attention_tpu_torch.schedulers.ddim import ddim_step

    sd = pipe.sd
    with torch.no_grad():
        eps, _ = sd.unet(torch.cat([lat, lat]), int(sched.timesteps[i]), emb)
        eps_u, eps_c = eps[0:1], eps[1:2]
        noise = eps_u + 7.5 * (eps_c - eps_u)
        _prev, x0 = ddim_step(sched, i, noise.float(), lat.float())
        return sd.decode_latents(x0.to(sd.config.unet.dtype)).float().cpu().numpy()[0]


def save_diagnostic_preds(pipe, out, writer: "ArtifactWriter", diagnostic_level: int = 1):
    """Diagnostic-level image snapshots (reference pipeline:937-957,
    1034-1037, 517-535): 'pred_pre_optim' x0 estimates for every step that
    evaluated guidance (diag >= 1) and 'xt' latent decodes (diag >= 2).

    With per-refinement-slot latents (``capture_eval_latents``), one
    pred_pre_optim per (iter, subiter) from the latent that entered each
    evaluation; without them, one per step from the step-entry latents."""
    from guided_attention_tpu_torch.schedulers.ddim import make_ddim_schedule

    if diagnostic_level < 1:
        return
    sd = pipe.sd
    d = out.diagnostics
    S = d.latent_in.shape[0]
    dev, dtype = sd.device, sd.config.unet.dtype
    sched = make_ddim_schedule(S, device=dev)
    emb = sd.encode_prompt(out.prompt)
    per_slot = d.eval_latents.ndim == 5 and d.eval_latents.shape[-1] > 1

    def as_lat(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)[None].to(dtype)

    def pred_pre_optim(lat, i, subiter):
        img = diagnostic_x0_image(pipe, lat, i, emb, sched)
        fname = (writer.clean + writer._state_name(i, subiter) + "_pred_pre_optim").replace(".", "_") + ".png"
        writer.async_writer.submit_image(img, writer.step_dir / fname)

    for i in range(S):
        if not d.eval_mask[i].any():
            continue
        if per_slot:
            for slot in np.nonzero(d.eval_mask[i])[0]:
                pred_pre_optim(as_lat(d.eval_latents[i, slot]), i, int(slot))
        else:
            pred_pre_optim(as_lat(d.latent_in[i]), i, 0)
        if diagnostic_level > 1:
            img_xt = decode_numpy(pipe, np.asarray(d.latent_in[i])[None])[0]
            fname = (writer.clean + writer._state_name(i, 0) + "_xt").replace(".", "_") + ".png"
            writer.async_writer.submit_image(img_xt, writer.step_dir / fname)
    writer.async_writer.flush()


def write_eval_maps(writer: "ArtifactWriter", out, words: Dict[int, str]) -> None:
    """Per-(iter, subiter) map PNGs from StepDiag.eval_maps (the reference
    dumps at every loss evaluation, pipeline:237-246). Requires a run with
    capture_eval_maps=True."""
    d = out.diagnostics
    if d.eval_maps.shape[-1] <= 1:
        raise ValueError("run with capture_eval_maps=True to dump per-eval maps")
    S, R_sub = d.eval_mask.shape
    for i in range(S):
        for k in range(R_sub):
            if not d.eval_mask[i, k]:
                continue
            for tok, word in words.items():
                fname = f"_attnmap_{word}_{writer.clean}{writer._state_name(i, k)}.png"
                writer.async_writer.submit_map(np.asarray(d.eval_maps[i, k, :, :, tok], np.float32),
                                               writer.step_dir / fname)
    writer.async_writer.flush()


def write_run_artifacts(
    pipe,
    out,
    *,
    output_path: Path,
    seed: int,
    hp,
    meta_prompt: str,
    interactive: bool = False,
    annotate: bool = False,
    save_cross_attention_maps: bool = False,
    diagnostic_level: int = 0,
    save_all_maps: bool = False,
    save_individual_ca_maps_flag: bool = False,
    async_writer: Optional[AsyncArtifactWriter] = None,
):
    """Write one generation's artifact tree (the reference's per-seed output
    block, run.py:104-135): final image (and annotation overlay), run log,
    per-step attention-map PNGs, x0 prediction snapshots, and, on request,
    the latent-stats figure and the per-head, overlay and diagnostic dumps.
    Returns (uint8 image, image_path, writer)."""
    hp_state = {
        "strict": hp.strict,
        "inside_loss_scale": hp.inside_loss_scale,
        "outside_loss_scale": hp.outside_loss_scale,
        "shrink_factor": hp.shrink_factor,
        "thresholds": hp.thresholds,
        "use_optimizer": hp.use_optimizer,
        "recurse_until": hp.recurse_until,
        "recurse_steps": hp.recurse_steps,
    }
    writer = ArtifactWriter(output_path, meta_prompt, seed, dict_to_string(hp_state), interactive=interactive,
                            async_writer=async_writer)
    words = {tok: word for tok, word in out.spec.words}
    if save_all_maps:
        # a map PNG for every real prompt token (reference config.py:51)
        ids = pipe.sd.tokenizer.encode(out.prompt)
        words = {i: pipe.sd.tokenizer.decode([t]) for i, t in enumerate(ids) if 0 < i < len(ids) - 1}
    img, image_path = writer.write_final_image(out, out.annotations, annotate)
    writer.write_run_log(out, words)
    if save_cross_attention_maps:
        from guided_attention_tpu_torch.viewers.vis import show_cross_attention

        show_cross_attention(out, list(out.spec.words),
                             save_path=writer.run_dir / f"{seed}{writer.hyper_suffix}cross_attention.png")
    if diagnostic_level > 0:
        save_latent_stats_figure(out.diagnostics, writer.run_dir / f"{seed}{writer.hyper_suffix}figure.png")
    if save_all_maps:
        write_eval_maps(writer, out, words)
    else:
        writer.write_step_maps(out, words)
    # x0 preds at iters [0, 1, 2] are unconditional (reference pipeline:881)
    writer.write_x0_preds(out, lambda lat: decode_numpy(pipe, lat), [0, 1, 2])
    if save_individual_ca_maps_flag:
        save_individual_ca_maps(pipe, out, step=12, heads_dir=writer.step_dir / "heads",
                                async_writer=writer.async_writer)
    if diagnostic_level > 0:
        save_diagnostic_preds(pipe, out, writer, diagnostic_level)
    return img, image_path, writer
