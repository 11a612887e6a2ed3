"""The FLMR vision -> late-interaction mapping networks.

Port of ravqa_tpu/models/mapping.py:
- MappingMLP, VisionMapping: a Tanh-MLP (vision_dim -> lm_dim*prefix/2 ->
  lm_dim*prefix) whose output reshapes to `prefix_len` extra query tokens
  per image;
- TransformerMapping (PreFLMR): the vision patch embeddings through an
  input linear, a stack of post-LN layers (self-attention over the
  patches, cross-attention to the text encoder's hidden states with the
  text pads masked, an FFN) and an output linear into the late-interaction
  space: one text-conditioned query token per patch.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .transformer import (EncoderConfig, MlpBlock, MultiHeadAttention,
                          _layer_norm, attention_bias_from_mask)


class MappingMLP(nn.Module):
    """sizes[0] -> ... -> sizes[-1]; Tanh after all but the last layer."""

    def __init__(self, sizes: Sequence[int], device=None):
        super().__init__()
        self.dense = nn.ModuleList(
            nn.Linear(sizes[i], sizes[i + 1], device=device)
            for i in range(len(sizes) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.dense):
            x = layer(x)
            if i < len(self.dense) - 1:
                x = torch.tanh(x)
        return x


class VisionMapping(nn.Module):
    """(..., vision_dim) features -> (..., prefix_len, lm_dim) tokens."""

    def __init__(self, vision_dim: int, lm_dim: int = 128,
                 prefix_len: int = 32, device=None):
        super().__init__()
        out_dim = lm_dim * prefix_len
        self.lm_dim = lm_dim
        self.prefix_len = prefix_len
        self.mlp = MappingMLP((vision_dim, out_dim // 2, out_dim),
                              device=device)

    def forward(self, image_features: torch.Tensor) -> torch.Tensor:
        h = self.mlp(image_features)
        return h.reshape(h.shape[:-1] + (self.prefix_len, self.lm_dim))


class TransformerMappingLayer(nn.Module):
    """Post-LN decoder layer: x = LN_self(x + self_attn(x)); x =
    LN_cross(x + cross_attn(x, text)); x = LN_out(x + mlp(x))."""

    def __init__(self, cfg: EncoderConfig, text_dim: int, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.attention = MultiHeadAttention(cfg, device=device)
        self.ln_self = nn.LayerNorm(h, eps=cfg.layer_norm_eps, device=device)
        self.cross_attention = MultiHeadAttention(cfg, device=device,
                                                  kv_dim=text_dim)
        self.ln_cross = nn.LayerNorm(h, eps=cfg.layer_norm_eps,
                                     device=device)
        self.mlp = MlpBlock(cfg, device=device)
        self.ln_out = nn.LayerNorm(h, eps=cfg.layer_norm_eps, device=device)

    def forward(self, x, text_hidden, text_bias):
        x = _layer_norm(self.ln_self, x + self.attention(x))
        x = _layer_norm(self.ln_cross, x + self.cross_attention(
            x, text_bias, kv=text_hidden))
        return _layer_norm(self.ln_out, x + self.mlp(x))


class TransformerMapping(nn.Module):
    """PreFLMR transformer mapping network: patch_features (B, P,
    vision_dim), text_hidden (B, Lt, text_dim) and text_mask (B, Lt) ->
    (B, P, lm_dim). The layers take the JAX package's EncoderConfig
    defaults (erf GELU, LayerNorm eps 1e-12, no dropout)."""

    def __init__(self, vision_dim: int, text_dim: int,
                 hidden_size: int = 768, lm_dim: int = 128,
                 num_layers: int = 1, num_heads: int = 12,
                 intermediate_size: int = 3072, device=None):
        super().__init__()
        cfg = EncoderConfig(hidden_size=hidden_size, num_layers=num_layers,
                            num_heads=num_heads,
                            intermediate_size=intermediate_size)
        self.input_linear = nn.Linear(vision_dim, hidden_size, device=device)
        self.layers = nn.ModuleList(
            TransformerMappingLayer(cfg, text_dim, device=device)
            for _ in range(num_layers))
        self.output_linear = nn.Linear(hidden_size, lm_dim, device=device)

    def forward(self, patch_features: torch.Tensor,
                text_hidden: torch.Tensor,
                text_mask: torch.Tensor) -> torch.Tensor:
        x = self.input_linear(patch_features.float())
        text_bias = attention_bias_from_mask(text_mask)
        for layer in self.layers:
            x = layer(x, text_hidden, text_bias)
        return self.output_linear(x)
