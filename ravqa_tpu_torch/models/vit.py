"""CLIP-style ViT vision encoder, CLIP preprocessing and the HF checkpoint
key mapping.

Port of ravqa_tpu/models/vit.py. ``CLIPVisionModel`` takes (B, H, W, 3)
float pixels (NHWC, as the JAX package) and returns (last_hidden, pooled):
patch embedding without bias, the class token, learned positions,
``pre_layernorm``, a pre-LN encoder, then the CLS row (or the mean of the
patch rows with ``global_pool``) through ``post_layernorm``.

The patch embedding is the JAX package's stride-p, bias-free convolution
(Flax pads ``SAME``, which is no padding when the image size is a multiple
of the patch size; other sizes are refused) written as a patch unfold and
one matmul: each patch flattens in (kh, kw, channel) order, the order of
the Flax kernel (kh, kw, in, out) reshaped to (kh * kw * in, out). It needs
no cuDNN, so TF32 in cuDNN cannot change its numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .transformer import EncoderConfig, TransformerEncoder, _layer_norm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5
    activation: str = "quick_gelu"      # CLIP; plain ViT uses "gelu"
    use_pre_layernorm: bool = True      # CLIP has pre_layrnorm before blocks
    global_pool: bool = False           # MAE-style mean-pool instead of CLS
    remat: bool = False                 # per-layer backward remat

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def encoder_cfg(self) -> EncoderConfig:
        return EncoderConfig(
            hidden_size=self.hidden_size,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            intermediate_size=self.intermediate_size,
            activation=self.activation,
            layer_norm_eps=self.layer_norm_eps,
            pre_layernorm=True,
            remat=self.remat,
        )

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        base = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                    num_heads=4, intermediate_size=128)
        base.update(kw)
        return ViTConfig(**base)

    @staticmethod
    def clip_base_p16() -> "ViTConfig":
        return ViTConfig()  # openai/clip-vit-base-patch16

    @staticmethod
    def clip_large_p14() -> "ViTConfig":
        # openai/clip-vit-large-patch14, PreFLMR_ViT-L's vision tower
        return ViTConfig(patch_size=14, hidden_size=1024, num_layers=24,
                         num_heads=16, intermediate_size=4096)

    @staticmethod
    def clip_g_p14() -> "ViTConfig":
        # laion CLIP-ViT-bigG sizes (PreFLMR ViT-G; vision_embedding 1664)
        return ViTConfig(patch_size=14, hidden_size=1664, num_layers=48,
                         num_heads=16, intermediate_size=8192,
                         activation="gelu")


class CLIPVisionModel(nn.Module):
    """(B, H, W, 3) float pixels -> (last_hidden (B, 1 + P, hidden),
    pooled (B, hidden))."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        if cfg.image_size % cfg.patch_size:
            raise ValueError(f"image_size {cfg.image_size} is not a multiple "
                             f"of patch_size {cfg.patch_size}")
        self.cfg = cfg
        h, p = cfg.hidden_size, cfg.patch_size
        self.patch_embedding = nn.Linear(p * p * 3, h, bias=False,
                                         device=device)
        self.class_embedding = nn.Parameter(torch.zeros(h, device=device))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.num_patches + 1, h, device=device))
        if cfg.use_pre_layernorm:
            self.pre_layernorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps,
                                              device=device)
        self.encoder = TransformerEncoder(cfg.encoder_cfg, device=device)
        self.post_layernorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps,
                                           device=device)

    def patches(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> (B, P, p * p * 3), each patch in (kh, kw, c)
        order, patches row-major (the convolution's output order)."""
        b, hh, ww, c = pixel_values.shape
        s, p = self.cfg.image_size, self.cfg.patch_size
        if (hh, ww, c) != (s, s, 3):
            raise ValueError(f"expected pixels (B, {s}, {s}, 3); got "
                             f"{tuple(pixel_values.shape)}")
        x = pixel_values.reshape(b, s // p, p, s // p, p, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, (s // p) ** 2,
                                                   p * p * c)

    def forward(self, pixel_values: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None):
        cfg = self.cfg
        x = self.patch_embedding(self.patches(pixel_values.float()))
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None]
        if cfg.use_pre_layernorm:
            x = _layer_norm(self.pre_layernorm, x)
        x = self.encoder(x, None, deterministic, generator)
        rep = x[:, 1:].mean(dim=1) if cfg.global_pool else x[:, 0]
        return x, _layer_norm(self.post_layernorm, rep)


def convert_hf_clip_vision_params(state_dict: dict, cfg: ViTConfig,
                                  prefix: str = "vision_model.") -> dict:
    """HF CLIPVisionModel weights (a state dict of tensors or numpy arrays,
    HF key names under `prefix`) -> CLIPVisionModel's state_dict (float32
    CPU tensors). The JAX package's convert_hf_clip_vision_params maps the
    same keys into its Flax tree."""
    def g(name):
        t = state_dict[prefix + name]
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)
        return torch.tensor(a.astype(np.float32))

    # torch conv weight (out, in, kh, kw) -> (out, kh * kw * in)
    w = g("embeddings.patch_embedding.weight")
    sd = {"patch_embedding.weight": w.permute(0, 2, 3, 1).reshape(
              w.shape[0], -1),
          "class_embedding": g("embeddings.class_embedding"),
          "position_embedding": g("embeddings.position_embedding.weight"),
          "post_layernorm.weight": g("post_layernorm.weight"),
          "post_layernorm.bias": g("post_layernorm.bias")}
    if cfg.use_pre_layernorm:
        # HF's spelling
        sd["pre_layernorm.weight"] = g("pre_layrnorm.weight")
        sd["pre_layernorm.bias"] = g("pre_layrnorm.bias")
    names = {"self_attn.q_proj": "attention.query",
             "self_attn.k_proj": "attention.key",
             "self_attn.v_proj": "attention.value",
             "self_attn.out_proj": "attention.out",
             "layer_norm1": "ln1", "mlp.fc1": "mlp.fc1",
             "mlp.fc2": "mlp.fc2", "layer_norm2": "ln2"}
    for i in range(cfg.num_layers):
        for hf, ours in names.items():
            for leaf in ("weight", "bias"):
                sd[f"encoder.layers.{i}.{ours}.{leaf}"] = g(
                    f"encoder.layers.{i}.{hf}.{leaf}")
    return sd


# ---------------------------------------------------------------------------
# CLIP image preprocessing (resize + normalize)
# ---------------------------------------------------------------------------

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) float32 weights of jax.image.resize's "bilinear"
    (triangle) kernel along one axis, by its own rule: sample i sits at
    (i + 0.5) / scale - 0.5 in the input (scale = n_out / n_in); on a
    shrink the kernel widens by 1 / scale (antialiasing); each row is
    divided by its sum over the input's samples (the edges renormalize,
    nothing is padded).

    The rounding follows what XLA compiles on the CPU: the weights take the
    sample position with one rounding (a fused multiply-add), their row
    sums with two (a multiply, then an add), so a row sums to 1 within
    ~1e-5, not exactly; the JAX function's output does the same."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))   # a Python float, rounded once
    kernel_scale = max(inv_scale, f32(1.0))
    taps = np.arange(n_in, dtype=f32)[None]

    def triangle(sample):
        x = np.abs(sample[:, None] - taps) / kernel_scale
        return np.maximum(f32(0.0), f32(1.0) - x)

    i = np.arange(n_out, dtype=f32) + f32(0.5)
    fused = (i.astype(np.float64) * float(inv_scale) - 0.5).astype(f32)
    w = triangle(fused)
    total = triangle(i * inv_scale - f32(0.5)).sum(axis=1, keepdims=True,
                                                   dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    return torch.tensor(w, dtype=torch.float32)


def clip_preprocess(images: torch.Tensor, image_size: int = 224
                    ) -> torch.Tensor:
    """(B, H, W, 3) uint8/float [0, 255] -> (B, S, S, 3) normalized float32:
    the JAX package's bilinear resize (antialiased when it shrinks) as
    out = Wy . img . Wx^T per channel, then CLIP's mean and std."""
    x = images.float() / 255.0
    _, h, w, _ = x.shape
    wy = resize_weights(h, image_size).to(x.device)
    wx = resize_weights(w, image_size).to(x.device)
    x = torch.einsum("yh,bhwc,xw->byxc", wy, x, wx)
    mean = torch.as_tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.as_tensor(CLIP_IMAGE_STD, device=x.device)
    return (x - mean) / std

