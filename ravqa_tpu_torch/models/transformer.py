"""Post-LayerNorm transformer-encoder building blocks (BERT).

Port of ravqa_tpu/models/transformer.py for the BERT text towers: exact
(erf) GELU, attention logits and softmax in float32, additive -1e9 bias on
padded keys, LayerNorm in float32. Dropout sits where the JAX package puts
it (the attention probabilities and the MLP's output) and is live only when
not `deterministic`; `remat` recomputes each layer in the backward
(torch.utils.checkpoint, as the JAX package's nn.remat). The pre-LayerNorm
(ViT/CLIP) variant and cross-attention come with the vision towers
(ROADMAP.md A5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """HF "gelu": the exact erf form."""
    return F.gelu(x, approximate="none")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    dropout_rate: float = 0.0
    # recompute each layer in the backward: activation memory of one layer
    # instead of num_layers, at about a third more operations
    remat: bool = False


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax nn.Dropout's form: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate). `generator` None means off (deterministic)."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.dropout_rate = cfg.dropout_rate
        self.query = nn.Linear(h, h, device=device)
        self.key = nn.Linear(h, h, device=device)
        self.value = nn.Linear(h, h, device=device)
        self.out = nn.Linear(h, h, device=device)

    def forward(self, x: torch.Tensor,
                attention_bias: torch.Tensor | None = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        b, t, h = x.shape
        nh = self.num_heads
        hd = h // nh
        q = self.query(x).view(b, t, nh, hd)
        k = self.key(x).view(b, t, nh, hd)
        v = self.value(x).view(b, t, nh, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5,
                              k).float()
        if attention_bias is not None:
            logits = logits + attention_bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        probs = dropout(probs, self.dropout_rate, generator)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(ctx.reshape(b, t, h))


class MlpBlock(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                             device=device)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                             device=device)
        self.dropout_rate = cfg.dropout_rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(self.fc2(gelu(self.fc1(x))), self.dropout_rate,
                       generator)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in float32, cast back to the input type."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(x.dtype)


class EncoderLayer(nn.Module):
    """Post-LN: x = LN1(x + attn(x)); x = LN2(x + mlp(x))."""

    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.attention = MultiHeadAttention(cfg, device=device)
        self.ln1 = nn.LayerNorm(h, eps=cfg.layer_norm_eps, device=device)
        self.mlp = MlpBlock(cfg, device=device)
        self.ln2 = nn.LayerNorm(h, eps=cfg.layer_norm_eps, device=device)

    def forward(self, x, attention_bias=None, seed: Optional[int] = None):
        """seed: None runs without dropout; an int draws this layer's
        dropout masks from a generator seeded with it, so a recompute under
        remat draws the same masks."""
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(seed)
        x = _layer_norm(self.ln1,
                        x + self.attention(x, attention_bias, gen))
        return _layer_norm(self.ln2, x + self.mlp(x, gen))


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.remat = cfg.remat
        self.dropout_rate = cfg.dropout_rate
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device=device) for _ in range(cfg.num_layers))

    def forward(self, x, attention_bias=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Dropout is live when not `deterministic` (and dropout_rate > 0):
        one seed per layer is drawn from `generator` (a CPU generator; None
        takes torch's default one)."""
        seeds = [None] * len(self.layers)
        if not deterministic and self.dropout_rate > 0:
            seeds = torch.randint(2 ** 62, (len(self.layers),),
                                  generator=generator).tolist()
        for layer, seed in zip(self.layers, seeds):
            if self.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint
                x = checkpoint(layer, x, attention_bias, seed,
                               use_reentrant=False)
            else:
                x = layer(x, attention_bias, seed)
        return x


def attention_bias_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) 1/0 mask -> (B, 1, 1, T) additive float32 bias, -1e9 on pads."""
    bias = (1.0 - attention_mask.float()) * -1e9
    return bias[:, None, None, :]
