"""BERT text encoder (port of ravqa_tpu/models/bert.py).

Module and parameter names follow the JAX package's Flax tree, so
``models.convert`` maps a JAX params tree onto ``state_dict`` keys by rule.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .transformer import (EncoderConfig, TransformerEncoder, _layer_norm,
                          attention_bias_from_mask)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout_rate: float = 0.0
    remat: bool = False                  # per-layer backward remat

    @property
    def encoder_cfg(self) -> EncoderConfig:
        return EncoderConfig(
            hidden_size=self.hidden_size,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            intermediate_size=self.intermediate_size,
            layer_norm_eps=self.layer_norm_eps,
            dropout_rate=self.dropout_rate,
            remat=self.remat,
        )

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        """A small config for tests (same sizes as the JAX package's)."""
        base = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                    intermediate_size=128, max_position_embeddings=128,
                    type_vocab_size=2)
        base.update(kw)
        return BertConfig(**base)


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                h, device=device)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h,
                                                  device=device)
        self.embeddings_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps,
                                          device=device)
        self.encoder = TransformerEncoder(cfg.encoder_cfg, device=device)
        self.pooler = nn.Linear(h, h, device=device)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None,
                deterministic: bool = True,
                generator: torch.Generator | None = None):
        """-> (hidden states (B, T, H), pooled (B, H)). Dropout (the
        encoder's) is live when not `deterministic`."""
        t = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos_ids = torch.arange(t, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos_ids)
             + self.token_type_embeddings(token_type_ids))
        x = _layer_norm(self.embeddings_ln, x)
        x = self.encoder(x, attention_bias_from_mask(attention_mask),
                         deterministic, generator)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled
