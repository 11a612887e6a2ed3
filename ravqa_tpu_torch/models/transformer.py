"""Transformer-encoder building blocks: post-LayerNorm (BERT) and
pre-LayerNorm (CLIP/ViT).

Port of ravqa_tpu/models/transformer.py: the activations by name (exact
erf GELU for BERT, CLIP's quick_gelu), attention logits and softmax in
float32, additive -1e9 bias on padded keys, cross-attention through `kv`
(queries from x, keys and values from kv), LayerNorm in float32. Dropout
sits where the JAX package puts it (the attention probabilities and the
MLP's output) and is live only when not `deterministic`; `remat`
recomputes each layer in the backward (torch.utils.checkpoint, as the JAX
package's nn.remat).
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


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's gelu variant: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


# the JAX package's activations that its configs use (BERT, the
# transformer mapping and ViT-G: "gelu"; CLIP ViT-B/L: "quick_gelu")
ACTIVATIONS = {"gelu": gelu, "quick_gelu": quick_gelu}


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    activation: str = "gelu"
    layer_norm_eps: float = 1e-12
    pre_layernorm: bool = False          # False: BERT post-LN; True: ViT/CLIP
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
    """Self-attention over x, or cross-attention to a `kv` sequence of
    width kv_dim (default: the hidden size)."""

    def __init__(self, cfg: EncoderConfig, device=None,
                 kv_dim: Optional[int] = None):
        super().__init__()
        h = cfg.hidden_size
        kv_dim = kv_dim or h
        self.num_heads = cfg.num_heads
        self.dropout_rate = cfg.dropout_rate
        self.query = nn.Linear(h, h, device=device)
        self.key = nn.Linear(kv_dim, h, device=device)
        self.value = nn.Linear(kv_dim, h, device=device)
        self.out = nn.Linear(h, h, device=device)

    def forward(self, x: torch.Tensor,
                attention_bias: torch.Tensor | None = None,
                generator: Optional[torch.Generator] = None,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, h = x.shape
        hd = h // self.num_heads
        src = x if kv is None else kv.to(x.dtype)
        q = self.query(x)
        # a tensor-parallel rank (parallel.tp) holds a slice of the heads
        nh = q.shape[-1] // hd
        q = q.view(b, t, nh, hd)
        k = self.key(src).view(b, src.shape[1], nh, hd)
        v = self.value(src).view(b, src.shape[1], nh, hd)
        logits = upcast(torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5,
                                     k))
        if attention_bias is not None:
            logits = logits + attention_bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        probs = dropout(probs, self.dropout_rate, generator)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(ctx.reshape(b, t, nh * hd))


class MlpBlock(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                             device=device)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                             device=device)
        self.dropout_rate = cfg.dropout_rate
        self.act = ACTIVATIONS[cfg.activation]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(self.fc2(self.act(self.fc1(x))), self.dropout_rate,
                       generator)


def upcast(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or in float64 when it is float64 (a float64 reference
    run of a model keeps its softmaxes and norms in float64)."""
    return x if x.dtype == torch.float64 else x.float()


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in float32, cast back to the input type."""
    return F.layer_norm(upcast(x), ln.normalized_shape, upcast(ln.weight),
                        upcast(ln.bias), ln.eps).to(x.dtype)


class EncoderLayer(nn.Module):
    """Post-LN (BERT): x = LN1(x + attn(x)); x = LN2(x + mlp(x)).
    Pre-LN (ViT/CLIP): x = x + attn(LN1(x)); x = x + mlp(LN2(x))."""

    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.pre_layernorm = cfg.pre_layernorm
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
        if self.pre_layernorm:
            x = x + self.attention(_layer_norm(self.ln1, x), attention_bias,
                                   gen)
            return x + self.mlp(_layer_norm(self.ln2, x), gen)
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
