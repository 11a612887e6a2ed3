"""BLIP-2 (vision encoder, Q-Former, T5): the RAVQA-v2 generator.

Port of ravqa_tpu/models/blip2.py (HF Blip2ForConditionalGeneration with a
T5 language tower):

- Blip2VisionModel: a pre-LN ViT (EVA ViT-g/14 in the published config)
  over NHWC pixels: a patch embedding with bias, the class token, learned
  positions, layers with a fused ``qkv`` projection (with bias, q scaled by
  head_dim^-0.5), float32 LayerNorms of eps 1e-6, the exact (erf) GELU,
  and a final ``post_layernorm``; no pre-layernorm;
- QFormer: post-LN BERT-style layers (eps 1e-12) over
  ``num_query_tokens`` learned queries, cross-attending to the image
  features every ``cross_attention_frequency``-th layer (the query-only
  path: BLIP-2 feeds no text to the Q-Former);
- ``language_projection`` to the T5 width; the projected query tokens are
  prepended to the text token embeddings for the T5 encoder, their mask
  ones.

The patch embedding keeps a Conv2d's (out, in, kh, kw) weight and runs as
a patch unfold and one matmul (each patch in (kh, kw, channel) order), so
cuDNN's TF32 setting cannot change its numbers. The JAX parameters come
across through models/convert.py; convert_hf_blip2_params reads an HF
state_dict.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .t5 import T5Config, T5Model, init_flax_defaults
from .transformer import _layer_norm, attention_bias_from_mask, upcast


@dataclasses.dataclass(frozen=True)
class Blip2VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1408           # EVA ViT-g
    num_layers: int = 39
    num_heads: int = 16
    intermediate_size: int = 6144
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def tiny(**kw):
        base = dict(image_size=32, patch_size=8, hidden_size=32,
                    num_layers=2, num_heads=4, intermediate_size=64)
        base.update(kw)
        return Blip2VisionConfig(**base)


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    encoder_hidden_size: int = 1408    # vision hidden
    cross_attention_frequency: int = 2
    layer_norm_eps: float = 1e-12

    @staticmethod
    def tiny(**kw):
        base = dict(hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, encoder_hidden_size=32)
        base.update(kw)
        return QFormerConfig(**base)


@dataclasses.dataclass(frozen=True)
class Blip2Config:
    vision: Blip2VisionConfig = dataclasses.field(
        default_factory=Blip2VisionConfig)
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    t5: T5Config = dataclasses.field(default_factory=T5Config.flan_t5_xl)
    num_query_tokens: int = 32

    @staticmethod
    def tiny(**kw):
        base = dict(vision=Blip2VisionConfig.tiny(),
                    qformer=QFormerConfig.tiny(),
                    t5=T5Config.tiny(), num_query_tokens=4)
        base.update(kw)
        return Blip2Config(**base)


def _attend(q, k, v, num_heads: int, bias=None):
    """Scaled dot-product attention over (B, T, hidden) projections:
    q * head_dim^-0.5, float32 logits plus `bias`, softmax."""
    b, tq, hidden = q.shape
    hd = hidden // num_heads
    q = q.reshape(b, tq, num_heads, hd)
    k = k.reshape(b, k.shape[1], num_heads, hd)
    v = v.reshape(b, v.shape[1], num_heads, hd)
    logits = upcast(torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k))
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, tq, hidden)


class Blip2VisionLayer(nn.Module):
    def __init__(self, cfg: Blip2VisionConfig, device=None):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.num_heads = cfg.num_heads
        self.ln1 = nn.LayerNorm(h, eps=eps, device=device)
        self.qkv = nn.Linear(h, 3 * h, bias=cfg.qkv_bias, device=device)
        self.projection = nn.Linear(h, h, device=device)
        self.ln2 = nn.LayerNorm(h, eps=eps, device=device)
        self.fc1 = nn.Linear(h, cfg.intermediate_size, device=device)
        self.fc2 = nn.Linear(cfg.intermediate_size, h, device=device)

    def forward(self, x):
        b, t, h = x.shape
        qkv = self.qkv(_layer_norm(self.ln1, x)).reshape(b, t, 3, h)
        ctx = _attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                      self.num_heads)
        x = x + self.projection(ctx)
        h = F.gelu(self.fc1(_layer_norm(self.ln2, x)))
        return x + self.fc2(h)


class Blip2VisionModel(nn.Module):
    def __init__(self, cfg: Blip2VisionConfig, device=None):
        super().__init__()
        if cfg.image_size % cfg.patch_size:
            raise ValueError(f"image_size {cfg.image_size} is not a multiple "
                             f"of patch_size {cfg.patch_size}")
        self.cfg = cfg
        h, p = cfg.hidden_size, cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, h, p, stride=p, device=device)
        self.class_embedding = nn.Parameter(torch.zeros(h, device=device))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.num_patches + 1, h, device=device))
        self.layers = nn.ModuleList(Blip2VisionLayer(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.post_layernorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps,
                                           device=device)

    def embed_patches(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> (B, P, hidden): the stride-p convolution as a
        patch unfold ((kh, kw, c) order) and one matmul."""
        b, hh, ww, c = pixel_values.shape
        s, p = self.cfg.image_size, self.cfg.patch_size
        if (hh, ww, c) != (s, s, 3):
            raise ValueError(f"expected pixels (B, {s}, {s}, 3); got "
                             f"{tuple(pixel_values.shape)}")
        x = pixel_values.to(self.patch_embedding.weight.dtype).reshape(
            b, s // p, p, s // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (s // p) ** 2, p * p * c)
        w = self.patch_embedding.weight              # (out, in, kh, kw)
        return F.linear(x, w.permute(0, 2, 3, 1).reshape(w.shape[0], -1),
                        self.patch_embedding.bias)

    def forward(self, pixel_values):
        """(B, H, W, 3) pixels -> (B, P + 1, hidden), post-layernormed."""
        x = self.embed_patches(pixel_values)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None]
        for layer in self.layers:
            x = layer(x)
        return _layer_norm(self.post_layernorm, x)


class QFormerAttention(nn.Module):
    def __init__(self, cfg: QFormerConfig, is_cross: bool = False,
                 device=None):
        super().__init__()
        h = cfg.hidden_size
        kv_in = cfg.encoder_hidden_size if is_cross else h
        self.num_heads = cfg.num_heads
        self.query = nn.Linear(h, h, device=device)
        self.key = nn.Linear(kv_in, h, device=device)
        self.value = nn.Linear(kv_in, h, device=device)
        self.output = nn.Linear(h, h, device=device)

    def forward(self, x, kv=None, bias=None):
        src = x if kv is None else kv
        ctx = _attend(self.query(x), self.key(src), self.value(src),
                      self.num_heads, bias)
        # BERT-style output block: the residual LayerNorm is the layer's
        return self.output(ctx)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross: bool = False,
                 device=None):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = QFormerAttention(cfg, device=device)
        self.attention_ln = nn.LayerNorm(h, eps=eps, device=device)
        self.has_cross = has_cross
        if has_cross:
            self.crossattention = QFormerAttention(cfg, True, device=device)
            self.crossattention_ln = nn.LayerNorm(h, eps=eps, device=device)
        self.intermediate_query = nn.Linear(h, cfg.intermediate_size,
                                            device=device)
        self.output_query = nn.Linear(cfg.intermediate_size, h,
                                      device=device)
        self.output_ln = nn.LayerNorm(h, eps=eps, device=device)

    def forward(self, x, image_embeds=None, image_bias=None):
        x = _layer_norm(self.attention_ln, x + self.attention(x))
        if self.has_cross:
            h = self.crossattention(x, kv=image_embeds, bias=image_bias)
            x = _layer_norm(self.crossattention_ln, x + h)
        h = self.output_query(F.gelu(self.intermediate_query(x)))
        return _layer_norm(self.output_ln, x + h)


class QFormer(nn.Module):
    def __init__(self, cfg: QFormerConfig, device=None):
        super().__init__()
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                      device=device)
        self.layers = nn.ModuleList(
            QFormerLayer(cfg, i % cfg.cross_attention_frequency == 0,
                         device=device) for i in range(cfg.num_layers))

    def forward(self, query_embeds, image_embeds, image_mask=None):
        x = _layer_norm(self.layernorm, query_embeds)
        bias = attention_bias_from_mask(image_mask) \
            if image_mask is not None else None
        for layer in self.layers:
            x = layer(x, image_embeds, bias)
        return x


class Blip2T5(nn.Module):
    def __init__(self, cfg: Blip2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.vision_model = Blip2VisionModel(cfg.vision, device=device)
        self.qformer = QFormer(cfg.qformer, device=device)
        self.query_tokens = nn.Parameter(torch.zeros(
            cfg.num_query_tokens, cfg.qformer.hidden_size, device=device))
        self.language_projection = nn.Linear(cfg.qformer.hidden_size,
                                             cfg.t5.d_model, device=device)
        self.language_model = T5Model(cfg.t5, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The flax initializers' scales (t5.init_flax_defaults), and
        N(0, 0.02) for the class and position embeddings and the query
        tokens, from `generator` on the parameters' device."""
        init_flax_defaults(self, generator)
        for p in (self.vision_model.class_embedding,
                  self.vision_model.position_embedding, self.query_tokens):
            p.normal_(0.0, 0.02, generator=generator)

    def encode_image(self, pixel_values):
        """Pixels -> projected language tokens (B, n_query, d_model)."""
        img = self.vision_model(pixel_values)
        q = self.query_tokens.expand(img.shape[0], *self.query_tokens.shape)
        return self.language_projection(self.qformer(q, img))

    def encode_tokens(self, vis, input_ids, attention_mask):
        """encode with the projected vision tokens `vis` (B, n_query,
        d_model) given: (encoder hidden, full mask)."""
        txt = self.language_model.shared(input_ids)
        embeds = torch.cat([vis, txt], dim=1)
        mask = torch.cat([torch.ones(vis.shape[:2], dtype=attention_mask.dtype,
                                     device=attention_mask.device),
                          attention_mask], dim=1)
        return self.language_model.encode(attention_mask=mask,
                                          inputs_embeds=embeds), mask

    def encode(self, pixel_values, input_ids, attention_mask):
        """(encoder hidden, full mask) with the vision tokens prepended."""
        return self.encode_tokens(self.encode_image(pixel_values), input_ids,
                                  attention_mask)

    def forward(self, pixel_values, input_ids, attention_mask,
                decoder_input_ids):
        """Teacher-forced logits (N, Td, V) of N = B * g text rows over B
        images: each image is encoded once and its projected tokens serve
        its g consecutive rows (a question's passages), where the JAX
        package repeats the pixels g times before the vision tower; the
        rows are independent, so the logits are the same."""
        vis = self.encode_image(pixel_values)
        vis = vis.repeat_interleave(input_ids.shape[0] // vis.shape[0], dim=0)
        enc, mask = self.encode_tokens(vis, input_ids, attention_mask)
        return self.language_model.decode(decoder_input_ids, enc, mask)

    # decoding helpers: T5Model's API, for generation.py
    def init_cache(self, batch: int, max_len: int):
        return self.language_model.init_cache(batch, max_len)

    def cross_kv(self, enc):
        return self.language_model.cross_kv(enc)

    def decode_step(self, token_ids, enc, enc_mask, caches):
        return self.language_model.decode_step(token_ids, enc, enc_mask,
                                               caches)


# ---------------------------------------------------------------------------
# HF conversion
# ---------------------------------------------------------------------------

def convert_hf_blip2_params(state_dict: dict,
                            cfg: Blip2Config) -> dict[str, torch.Tensor]:
    """An HF Blip2ForConditionalGeneration state_dict (T5 language model)
    -> the port's Blip2T5 state_dict: the key names the JAX package's
    convert_hf_blip2_params reads (:273). The vision tower (the patch
    convolution's OIHW weight kept; the class and position embeddings and
    the query tokens without their leading 1s), the Q-Former (cross-
    attention on every cross_attention_frequency-th layer),
    language_projection, and the T5 under `language_model.`
    (convert_hf_t5_params)."""
    from .convert_flmr import _t
    from .t5 import convert_hf_t5_params

    def g(name):
        return _t(state_dict[name])

    v, qc = cfg.vision, cfg.qformer
    sd = {"vision_model.patch_embedding.weight":
          g("vision_model.embeddings.patch_embedding.weight"),
          "vision_model.patch_embedding.bias":
          g("vision_model.embeddings.patch_embedding.bias"),
          "vision_model.class_embedding":
          g("vision_model.embeddings.class_embedding").reshape(-1),
          "vision_model.position_embedding":
          g("vision_model.embeddings.position_embedding").reshape(
              -1, v.hidden_size),
          "query_tokens": g("query_tokens").reshape(cfg.num_query_tokens,
                                                    qc.hidden_size)}

    def copy(hf: str, ours: str, bias: bool = True):
        sd[f"{ours}.weight"] = g(f"{hf}.weight")
        if bias:
            sd[f"{ours}.bias"] = g(f"{hf}.bias")

    copy("vision_model.post_layernorm", "vision_model.post_layernorm")
    for i in range(v.num_layers):
        hf, ours = f"vision_model.encoder.layers.{i}", \
            f"vision_model.layers.{i}"
        copy(f"{hf}.layer_norm1", f"{ours}.ln1")
        copy(f"{hf}.self_attn.qkv", f"{ours}.qkv", bias=v.qkv_bias)
        copy(f"{hf}.self_attn.projection", f"{ours}.projection")
        copy(f"{hf}.layer_norm2", f"{ours}.ln2")
        copy(f"{hf}.mlp.fc1", f"{ours}.fc1")
        copy(f"{hf}.mlp.fc2", f"{ours}.fc2")
    copy("qformer.layernorm", "qformer.layernorm")
    for i in range(qc.num_layers):
        hf, ours = f"qformer.encoder.layer.{i}", f"qformer.layers.{i}"
        parts = [("attention", "attention"), ("intermediate_query.dense",
                                              "intermediate_query"),
                 ("output_query.dense", "output_query"),
                 ("output_query.LayerNorm", "output_ln"),
                 ("attention.output.LayerNorm", "attention_ln")]
        if i % qc.cross_attention_frequency == 0:
            parts += [("crossattention", "crossattention"),
                      ("crossattention.output.LayerNorm",
                       "crossattention_ln")]
        for src, dst in parts:
            if src in ("attention", "crossattention"):
                for w in ("query", "key", "value"):
                    copy(f"{hf}.{src}.attention.{w}", f"{ours}.{dst}.{w}")
                copy(f"{hf}.{src}.output.dense", f"{ours}.{dst}.output")
            else:
                copy(f"{hf}.{src}", f"{ours}.{dst}")
    copy("language_projection", "language_projection")
    lm = convert_hf_t5_params(state_dict, cfg.t5, prefix="language_model.")
    sd.update({f"language_model.{k}": t for k, t in lm.items()})
    return sd
