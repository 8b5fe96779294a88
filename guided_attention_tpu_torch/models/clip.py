"""CLIP text encoder (SD 1.x ViT-L/14 and SD 2.1 OpenCLIP ViT-H variants).

Counterpart of the JAX package's ``models/clip.py``: token + position
embeddings, pre-LN blocks with causal attention, a final LayerNorm. SD1.x
uses quick_gelu, hidden 768, 12 layers, 12 heads; SD2.1 uses gelu, hidden
1024 and 23 layers (its checkpoint is truncated to the penultimate layer).
Module names equal transformers' CLIPTextModel keys. LayerNorms run in
float32, the rest in the compute dtype.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from guided_attention_tpu_torch.models.layers import LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # "gelu" for SD2.1
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32


class CLIPAttention(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        d = c.hidden_size
        self.heads = c.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x, causal_mask):
        b, n, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x) * (hd**-0.5))
        k = split(self.k_proj(x))
        v = split(self.v_proj(x))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) + causal_mask
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.act = c.hidden_act
        self.fc1 = nn.Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.self_attn = CLIPAttention(c)
        self.layer_norm2 = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.mlp = CLIPMLP(c)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x).to(x.dtype), causal_mask)
        return x + self.mlp(self.layer_norm2(x).to(x.dtype))


class CLIPEmbeddings(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Embedding(c.max_position_embeddings, c.hidden_size)


class CLIPEncoder(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(c) for _ in range(c.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(c)
        self.encoder = CLIPEncoder(c)
        self.final_layer_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """input_ids [B, 77] (int64) -> last_hidden_state [B, 77, hidden]."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    @torch.no_grad()
    def init_position_embedding_(self, generator: torch.Generator) -> None:
        """flax initializes the position table N(0, 0.01^2)."""
        self.text_model.embeddings.position_embedding.weight.normal_(0.0, 0.01, generator=generator)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        dtype = tm.embeddings.token_embedding.weight.dtype
        n = input_ids.shape[-1]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[None, :n]
        causal = torch.full((n, n), float("-inf"), dtype=torch.float32, device=input_ids.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x).to(dtype)
