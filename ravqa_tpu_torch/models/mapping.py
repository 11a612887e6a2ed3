"""The FLMR vision -> late-interaction mapping network.

Port of ravqa_tpu/models/mapping.py (MappingMLP, VisionMapping): a Tanh-MLP
(vision_dim -> lm_dim*prefix/2 -> lm_dim*prefix) whose output reshapes to
`prefix_len` extra query tokens per image. The PreFLMR TransformerMapping
comes later (ROADMAP.md A5).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


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
