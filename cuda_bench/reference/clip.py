"""Plain CLIP text encoder (SD1.x ViT-L/14, SD2.1's OpenCLIP ViT-H truncated
to its penultimate layer), float32. Module names equal transformers'
CLIPTextModel keys."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cuda_bench.reference.nn import FP32, LayerNorm, Precision, QLinear


class CLIPAttention(nn.Module):
    prec: Precision = FP32

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = QLinear(d, d)
        self.k_proj = QLinear(d, d)
        self.v_proj = QLinear(d, d)
        self.out_proj = QLinear(d, d)

    def forward(self, x, causal_mask):
        b, n, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, hd).transpose(1, 2)

        p = self.prec
        q = split(self.q_proj(x) * (hd**-0.5))
        scores = torch.matmul(p.q(q), p.q(split(self.k_proj(x))).transpose(-1, -2)) + causal_mask
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(p.q(probs), p.q(split(self.v_proj(x)))).transpose(1, 2).reshape(b, n, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, d: int, inner: int, act: str):
        super().__init__()
        self.act = act
        self.fc1 = QLinear(d, inner)
        self.fc2 = QLinear(inner, d)

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, d: int, heads: int, inner: int, act: str, eps: float):
        super().__init__()
        self.layer_norm1 = LayerNorm(d, eps=eps)
        self.self_attn = CLIPAttention(d, heads)
        self.layer_norm2 = LayerNorm(d, eps=eps)
        self.mlp = CLIPMLP(d, inner, act)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class _Holder(nn.Module):
    pass


class CLIPTextModel(nn.Module):
    """input_ids [B, 77] -> last hidden state [B, 77, hidden], float32."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int, num_heads: int, intermediate_size: int,
                 max_position_embeddings: int, hidden_act: str, layer_norm_eps: float = 1e-5):
        super().__init__()
        tm = self.text_model = _Holder()
        tm.embeddings = _Holder()
        tm.embeddings.token_embedding = nn.Embedding(vocab_size, hidden_size)
        tm.embeddings.position_embedding = nn.Embedding(max_position_embeddings, hidden_size)
        tm.encoder = _Holder()
        tm.encoder.layers = nn.ModuleList([
            CLIPEncoderLayer(hidden_size, num_heads, intermediate_size, hidden_act, layer_norm_eps)
            for _ in range(num_layers)])
        tm.final_layer_norm = LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        n = input_ids.shape[-1]
        x = tm.embeddings.token_embedding(input_ids).float() + tm.embeddings.position_embedding.weight[None, :n].float()
        causal = torch.full((n, n), float("-inf"), dtype=torch.float32, device=input_ids.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x)
