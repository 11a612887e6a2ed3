"""T5 encoder-decoder: the RAG answer generator.

Port of ravqa_tpu/models/t5.py (t5 v1.0 with ReLU, v1.1 / Flan with
gated-GELU): RMSNorm with a float32 variance, relative-position-bucket
attention bias (only the first layer of each stack owns the table; the
later layers reuse its bias), no 1/sqrt(d_kv) scaling of the attention
logits, a tied (scaled by d_model^-0.5) or untied LM head.

Decoding goes through ``decode_step``: the self-attention cache is written
at its ``index`` and the slots not yet written are masked. The
cross-attention keys and values depend only on the encoder output, so
``cross_kv(enc)`` computes them once per sequence and every step uses
them; the JAX package recomputes them from ``enc`` at every step.
``decode_step`` takes either (a tensor ``enc`` is projected on each call,
as the JAX package does). The decoder batch may hold g rows per encoder
row (the beams of beam search, beam-major within a sequence): the g rows
of a sequence attend to its keys and values as extra query rows of one
batch entry, so nothing of the encoder side is repeated.

Linear layers keep the JAX module names: ``q``/``k``/``v``/``o`` of
(d_model -> heads * d_kv) and back, ``wi``/``wi_0``/``wi_1``/``wo``; the
stacks are the ModuleLists ``encoder`` and ``decoder`` (the JAX package's
``encoder_<i>``/``decoder_<i>``). models/convert.py carries the JAX
parameters across, and ``convert_hf_t5_params`` reads an HF state_dict
into this module's. ``reset_parameters`` draws weights at the scales of the
flax initializers (lecun-normal kernels, embeddings of std d^-1/2) from a
generator on the modules' device.

With ``remat`` and grad enabled (training), each encoder and decoder
block runs under torch.utils.checkpoint (non-reentrant): the backward
keeps the blocks' inputs and recomputes one block at a time. The block's
parameters go into the checkpoint as inputs, and the recompute runs the
block on those same tensors (torch.func.functional_call), so a caller that
swapped weights in for the forward (the executor's LoRA merge) gets its
recompute on them too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import upcast

NEG_BIAS = -1e9
# flax's truncated normal (+-2 std) has std 0.8796 of its untruncated scale
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: Optional[int] = None
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    feed_forward_proj: str = "relu"        # "relu" | "gated-gelu"
    tie_word_embeddings: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    remat: bool = False    # recompute each block in the backward (only
    #   when grad is enabled: the JAX package's nn.remat(T5Block))

    @property
    def n_dec(self) -> int:
        return self.num_decoder_layers or self.num_layers

    @staticmethod
    def tiny(**kw) -> "T5Config":
        base = dict(vocab_size=512, d_model=64, d_kv=16, d_ff=128,
                    num_layers=2, num_heads=4)
        base.update(kw)
        return T5Config(**base)

    @staticmethod
    def flan_t5_xl(**kw) -> "T5Config":
        base = dict(vocab_size=32128, d_model=2048, d_kv=64, d_ff=5120,
                    num_layers=24, num_heads=32,
                    feed_forward_proj="gated-gelu",
                    tie_word_embeddings=False)
        base.update(kw)
        return T5Config(**base)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated at +-2 std whose variance is
    1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def init_flax_defaults(module: nn.Module, generator: torch.Generator) -> None:
    """The flax defaults on the standard layers of `module`: Linear and
    Conv2d kernels lecun-normal over their fan-in, Embedding rows normal
    with std 1/sqrt(features), zero biases, unit norm scales."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
        elif isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, m.embedding_dim ** -0.5,
                             generator=generator)
        elif isinstance(m, (nn.LayerNorm, RMSNorm)):
            m.weight.fill_(1.0)
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.LayerNorm)) \
                and m.bias is not None:
            m.bias.zero_()


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = upcast(x).square().mean(-1, keepdim=True)
        return self.weight * (x * torch.rsqrt(var + self.eps))


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """HF T5's bucket function, in the JAX package's float32 arithmetic."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # the JAX package divides by np.log(...), which JAX rounds to float32
    log_ratio = torch.tensor(math.log(max_distance / max_exact),
                             dtype=torch.float32)
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / log_ratio
        * (num_buckets - max_exact)).to(ret.dtype)
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


# what decode_step takes for the encoder side: the encoder output (the
# keys and values projected on each call), or cross_kv's per-layer pairs
EncoderSide = Union[torch.Tensor, Sequence[tuple]]


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False,
                 bidirectional: bool = True, device=None):
        super().__init__()
        self.cfg = cfg
        self.bidirectional = bidirectional
        inner = cfg.num_heads * cfg.d_kv
        for name in ("q", "k", "v"):
            setattr(self, name, nn.Linear(cfg.d_model, inner, bias=False,
                                          device=device))
        self.o = nn.Linear(inner, cfg.d_model, bias=False, device=device)
        self.relative_attention_bias = (
            nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads,
                         device=device) if has_relative_bias else None)

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        # a tensor-parallel rank (parallel.tp) holds a slice of the heads
        return x.reshape(*x.shape[:2], -1, self.cfg.d_kv)

    def project_kv(self, src: torch.Tensor) -> tuple:
        """(B, T, D) -> this layer's keys and values, (B, T, H, d_kv)."""
        return self.heads(self.k(src)), self.heads(self.v(src))

    def position_bias(self, tq: int, tk: int, offset: int,
                      device) -> torch.Tensor:
        """(1, H, Tq, Tk) relative bias for queries at offset + [0, Tq)."""
        cfg = self.cfg
        ctx = torch.arange(tk, device=device)[None, :]
        qry = (offset + torch.arange(tq, device=device))[:, None]
        rp = relative_position_bucket(
            ctx - qry, self.bidirectional,
            cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        return self.relative_attention_bias(rp).permute(2, 0, 1)[None]

    def forward(self, x, kv=None, mask_bias=None, position_bias=None,
                decode_cache=None):
        """x (B, Tq, D). kv: None (self-attention), the encoder output
        (Be, Tk, D), or its projected (keys, values) pair, where B = Be * g
        (g query rows of x per encoder row). decode_cache: {"k", "v" (B,
        Tmax, H, d_kv), "index": int} for incremental self-attention,
        written in place at index. Returns (out, position_bias,
        new_cache)."""
        b, tq, _ = x.shape
        q = self.heads(self.q(x))
        if kv is None:
            k, v = self.project_kv(x)
        elif isinstance(kv, torch.Tensor):
            k, v = self.project_kv(kv)
        else:
            k, v = kv
        new_cache = None
        if decode_cache is not None:
            idx = decode_cache["index"]
            ck, cv = decode_cache["k"], decode_cache["v"]
            ck[:, idx:idx + tq] = k
            cv[:, idx:idx + tq] = v
            k, v = ck, cv
            new_cache = {"k": ck, "v": cv, "index": idx + tq}
        be, tk = k.shape[0], k.shape[1]
        g = b // be
        # the g rows of each encoder row attend as extra query rows
        q = q.reshape(be, g * tq, *q.shape[2:])
        # T5 does not scale by sqrt(d_kv)
        logits = upcast(torch.einsum("bqhd,bkhd->bhqk", q, k))
        if position_bias is None and self.relative_attention_bias is not None:
            offset = decode_cache["index"] if decode_cache is not None else 0
            position_bias = self.position_bias(tq, tk, offset, x.device)
        if position_bias is not None:
            # the bias covers every head; a tensor-parallel rank adds its
            # heads' slice (tp_heads, set by parallel.apply_tp)
            tp = getattr(self, "tp_heads", None)
            logits = logits + (position_bias if tp is None
                               else position_bias[:, tp])
        if mask_bias is not None:
            logits = logits + mask_bias
        if decode_cache is not None:
            # mask cache slots not yet written (zeros would leak attention)
            valid = torch.arange(tk, device=x.device) < new_cache["index"]
            logits = logits + torch.where(valid, 0.0, NEG_BIAS)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return (self.o(ctx.reshape(b, tq, -1)), position_bias, new_cache)


class T5FF(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.gated = cfg.feed_forward_proj == "gated-gelu"
        if not self.gated and cfg.feed_forward_proj != "relu":
            raise ValueError(f"feed_forward_proj {cfg.feed_forward_proj!r}")
        names = ("wi_0", "wi_1") if self.gated else ("wi",)
        for name in names:
            setattr(self, name, nn.Linear(cfg.d_model, cfg.d_ff, bias=False,
                                          device=device))
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, device=device)

    def forward(self, x):
        if self.gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool = False,
                 has_relative_bias: bool = False, device=None):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.ln1 = RMSNorm(cfg.d_model, eps, device=device)
        self.self_attn = T5Attention(cfg, has_relative_bias,
                                     bidirectional=not is_decoder,
                                     device=device)
        if is_decoder:
            self.ln_cross = RMSNorm(cfg.d_model, eps, device=device)
            self.cross_attn = T5Attention(cfg, device=device)
        self.is_decoder = is_decoder
        self.ln2 = RMSNorm(cfg.d_model, eps, device=device)
        self.ff = T5FF(cfg, device=device)

    def forward(self, x, enc=None, self_bias=None, cross_bias=None,
                position_bias=None, decode_cache=None):
        h, position_bias, new_cache = self.self_attn(
            self.ln1(x), mask_bias=self_bias, position_bias=position_bias,
            decode_cache=decode_cache)
        x = x + h
        if self.is_decoder:
            h, _, _ = self.cross_attn(self.ln_cross(x), kv=enc,
                                      mask_bias=cross_bias)
            x = x + h
        return x + self.ff(self.ln2(x)), position_bias, new_cache


def run_block(blk: nn.Module, remat: bool, *args):
    """blk(*args), under non-reentrant checkpointing when `remat` and grad
    is enabled, with the parameters it holds now as the checkpoint's
    inputs (see the module docstring)."""
    if not (remat and torch.is_grad_enabled()):
        return blk(*args)
    from torch.utils.checkpoint import checkpoint
    names, tensors = zip(*blk.named_parameters())

    def run(*flat):
        return torch.func.functional_call(
            blk, dict(zip(names, flat[:len(names)])), flat[len(names):])
    return checkpoint(run, *tensors, *args, use_reentrant=False)


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    return ((1.0 - mask.float()) * -1e9)[:, None, None, :]


def _causal_bias(t: int, device=None) -> torch.Tensor:
    m = torch.tril(torch.ones(t, t, device=device))
    return ((1.0 - m) * -1e9)[None, None]


class T5Model(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.encoder = nn.ModuleList(
            T5Block(cfg, False, i == 0, device=device)
            for i in range(cfg.num_layers))
        self.encoder_final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_eps,
                                        device=device)
        self.decoder = nn.ModuleList(
            T5Block(cfg, True, i == 0, device=device)
            for i in range(cfg.n_dec))
        self.decoder_final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_eps,
                                        device=device)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        nn.Linear(cfg.d_model, cfg.vocab_size, bias=False,
                                  device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        init_flax_defaults(self, generator)

    def encode(self, input_ids=None, attention_mask=None,
               inputs_embeds=None) -> torch.Tensor:
        """Encoder hidden states (B, T, D); inputs_embeds lets BLIP-2
        prepend its projected vision tokens."""
        x = self.shared(input_ids) if inputs_embeds is None else inputs_embeds
        bias = _mask_bias(attention_mask) if attention_mask is not None \
            else None
        pos = None
        for blk in self.encoder:
            x, pos, _ = run_block(blk, self.cfg.remat, x, None, bias, None,
                                  pos)
        return self.encoder_final_ln(x)

    def decode(self, decoder_input_ids, enc, enc_mask=None,
               decoder_attention_mask=None) -> torch.Tensor:
        """Teacher-forced decode. Returns logits (B, Td, V)."""
        x = self.shared(decoder_input_ids)
        self_bias = _causal_bias(decoder_input_ids.shape[1], x.device)
        if decoder_attention_mask is not None:
            self_bias = self_bias + _mask_bias(decoder_attention_mask)
        cross_bias = _mask_bias(enc_mask) if enc_mask is not None else None
        pos = None
        for blk in self.decoder:
            x, pos, _ = run_block(blk, self.cfg.remat, x, enc, self_bias,
                                  cross_bias, pos)
        return self._logits(self.decoder_final_ln(x))

    def _logits(self, x):
        if self.lm_head is None:
            return (x * self.cfg.d_model ** -0.5) @ self.shared.weight.T
        return self.lm_head(x)

    def cross_kv(self, enc: torch.Tensor) -> list:
        """Each decoder layer's cross-attention (keys, values) of the
        encoder output, (B, T, H, d_kv) each: decode_step's encoder side
        computed once."""
        return [blk.cross_attn.project_kv(enc) for blk in self.decoder]

    def decode_step(self, token_ids, enc: EncoderSide, enc_mask, caches):
        """Incremental decode of token_ids (B, 1). enc: the encoder output
        (Be, T, D) or cross_kv(enc), with B = Be * g rows (g beams a
        sequence, beam-major); enc_mask (Be, T). Returns (logits (B, 1, V),
        new caches)."""
        x = self.shared(token_ids)
        cross_bias = _mask_bias(enc_mask) if enc_mask is not None else None
        side = ([enc] * len(self.decoder) if isinstance(enc, torch.Tensor)
                else enc)
        new_caches = []
        pos = None
        for blk, kv, cache in zip(self.decoder, side, caches):
            x, pos, nc = blk(x, enc=kv, cross_bias=cross_bias,
                             position_bias=pos, decode_cache=cache)
            new_caches.append(nc)
        return self._logits(self.decoder_final_ln(x)), new_caches

    def forward(self, input_ids=None, attention_mask=None,
                decoder_input_ids=None, decoder_attention_mask=None,
                inputs_embeds=None):
        enc = self.encode(input_ids, attention_mask, inputs_embeds)
        return self.decode(decoder_input_ids, enc, attention_mask,
                           decoder_attention_mask)

    def init_cache(self, batch: int, max_len: int) -> list:
        cfg = self.cfg
        w = self.shared.weight

        def zeros():
            return torch.zeros(batch, max_len, cfg.num_heads, cfg.d_kv,
                               dtype=w.dtype, device=w.device)
        return [{"k": zeros(), "v": zeros(), "index": 0}
                for _ in range(cfg.n_dec)]


def shift_right(labels: torch.Tensor, decoder_start_token_id: int,
                pad_token_id: int, ignore_index: int = -100) -> torch.Tensor:
    """HF _shift_right: labels -> decoder_input_ids."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == ignore_index,
                       torch.full_like(shifted, pad_token_id), shifted)


# ---------------------------------------------------------------------------
# HF conversion
# ---------------------------------------------------------------------------

def convert_hf_t5_params(state_dict: dict, cfg: T5Config,
                         prefix: str = "") -> dict[str, torch.Tensor]:
    """An HF T5ForConditionalGeneration state_dict (its keys under
    `prefix`) -> the port's T5Model state_dict: the key names the JAX
    package's convert_hf_t5_params reads (:341). nn.Linear keeps HF's (out,
    in) weights; the relative-position table is taken where HF has it (the
    first block of each stack); gated-GELU reads wi_0 / wi_1; lm_head only
    when the embeddings are untied (a tied head reads `shared`)."""
    from .convert_flmr import _t

    def g(name):
        return _t(state_dict[prefix + name])

    sd = {"shared.weight": g("shared.weight"),
          "encoder_final_ln.weight": g("encoder.final_layer_norm.weight"),
          "decoder_final_ln.weight": g("decoder.final_layer_norm.weight")}
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = g("lm_head.weight")
    ff = (("wi_0", "wi_1", "wo") if cfg.feed_forward_proj == "gated-gelu"
          else ("wi", "wo"))

    def attn(hf: str, ours: str):
        for w in ("q", "k", "v", "o"):
            sd[f"{ours}.{w}.weight"] = g(f"{hf}.{w}.weight")
        rb = f"{hf}.relative_attention_bias.weight"
        if prefix + rb in state_dict:
            sd[f"{ours}.relative_attention_bias.weight"] = g(rb)

    for stack, n, sub in (("encoder", cfg.num_layers,
                           (("SelfAttention", "self_attn", "ln1"),
                            ("DenseReluDense", "ff", "ln2"))),
                          ("decoder", cfg.n_dec,
                           (("SelfAttention", "self_attn", "ln1"),
                            ("EncDecAttention", "cross_attn", "ln_cross"),
                            ("DenseReluDense", "ff", "ln2")))):
        for i in range(n):
            for j, (hf_name, ours, ln) in enumerate(sub):
                hf = f"{stack}.block.{i}.layer.{j}"
                mine = f"{stack}.{i}.{ours}"
                if ours == "ff":
                    for w in ff:
                        sd[f"{mine}.{w}.weight"] = g(
                            f"{hf}.DenseReluDense.{w}.weight")
                else:
                    attn(f"{hf}.{hf_name}", mine)
                sd[f"{stack}.{i}.{ln}.weight"] = g(f"{hf}.layer_norm.weight")
    return sd
