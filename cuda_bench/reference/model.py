"""The reference's models, built in float32 from the benchmark's weights."""
from __future__ import annotations

from typing import Dict

import torch

from cuda_bench.reference import guidance, text
from cuda_bench.reference.clip import CLIPTextModel
from cuda_bench.reference.nn import FP32, Precision, set_precision
from cuda_bench.reference.unet import UNet
from cuda_bench.reference.vae import AutoencoderKL


def build(arch: Dict, device=None) -> Tuple[UNet, CLIPTextModel, AutoencoderKL]:
    """The three modules of a configuration file's ``arch`` (unet, clip,
    vae sizes), with parameters on ``device`` (``"meta"``: shapes only)."""
    u, c, v = arch["unet"], arch["clip"], arch["vae"]
    with torch.device(device or "cpu"):
        unet = UNet(u["block_out_channels"], u["layers_per_block"], u["cross_attention_dim"], u["num_heads"],
                    u["attn_down"], u["use_linear_projection"], u["norm_num_groups"])
        clip = CLIPTextModel(c["vocab_size"], c["hidden_size"], c["num_layers"], c["num_heads"],
                             c["intermediate_size"], c["max_position_embeddings"], c["hidden_act"])
        vae = AutoencoderKL(v["block_out_channels"], v["layers_per_block"], v["norm_num_groups"])
    return unet, clip, vae


class Reference:
    """Float32 UNet, CLIP and VAE holding float32 copies of ``weights``
    ({"unet": state dict, "text_encoder": ..., "vae": ...})."""

    def __init__(self, arch: Dict, weights: Dict[str, Dict[str, torch.Tensor]], device):
        self.device = torch.device(device)
        self.unet, self.clip, self.vae = build(arch, "meta")
        for name, module in (("unet", self.unet), ("text_encoder", self.clip), ("vae", self.vae)):
            state = {k: t.to(self.device, torch.float32) for k, t in weights[name].items()}
            module.load_state_dict(state, assign=True)
            module.requires_grad_(False)
            module.eval()
        self.prec = FP32

    def set_precision(self, prec: Precision) -> None:
        self.prec = prec
        for m in (self.unet, self.clip, self.vae):
            set_precision(m, prec)

    @torch.no_grad()
    def embed(self, prompt: str, negative: str = "") -> torch.Tensor:
        """[2, 77, D]: (negative, prompt)."""
        ids = torch.tensor([text.pad_ids(negative), text.pad_ids(prompt)], device=self.device)
        return self.clip(ids)

    @torch.no_grad()
    def eps(self, x: torch.Tensor, t: int, ctx: torch.Tensor) -> torch.Tensor:
        return self.unet(self.prec.q(x), t, ctx)[0]

    def eval_grad(self, v: torch.Tensor, t: int, ctx: torch.Tensor, spec: text.Spec, flip=None):
        """(loss, unscaled group losses, d loss / d v, centring offsets
        [K, 2]) of one sample's latent ``v`` [1, h, w, 4] through the
        truncated UNet's cross maps; ``flip`` as ``guidance.loss``'s."""
        with torch.enable_grad():
            v = self.prec.q(v).detach().requires_grad_(True)
            _, maps = self.unet(v, t, ctx, capture_res=spec.res, truncate=True)
            agg = torch.stack(maps).mean(dim=0).reshape(spec.res, spec.res, -1)
            total, groups = guidance.loss(agg, spec, flip=flip)
            (grad,) = torch.autograd.grad(total, v)
            _, off = guidance.centre_offsets(agg.detach(), spec)
        return total.detach(), groups.detach(), grad, off

    @torch.no_grad()
    def decode_u8(self, latents: torch.Tensor, scaling_factor: float) -> torch.Tensor:
        img = self.vae.decode(self.prec.q(latents) / scaling_factor)
        return torch.round(torch.clamp(img / 2.0 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)

    def spec(self, meta_prompt: str, res: int, normalize_eot: bool, shrink_factor: float = 0.15) -> text.Spec:
        prompt, anns = text.parse_prompt(meta_prompt)
        return text.build_spec(prompt, anns, res, shrink_factor, normalize_eot, self.device)

    @staticmethod
    def prompt_of(meta_prompt: str) -> str:
        return text.parse_prompt(meta_prompt)[0]

