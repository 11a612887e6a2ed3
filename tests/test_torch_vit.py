"""ravqa_tpu_torch.models.vit and the pre-LN encoder against
ravqa_tpu.models.vit at tiny width.

JAX parameters from `model.init` are carried into the port through
models/convert.py; both sides get the same pixels (NHWC, from a numpy
seed). Tolerance: max abs 1e-5. Both sides run float32; XLA and PyTorch
order the patch embedding, matmul, softmax and LayerNorm reductions
differently, which moves values by a few float32 ulps per layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.models import transformer as jax_transformer
from ravqa_tpu.models import vit as jax_vit
from ravqa_tpu_torch.models import flax_to_state_dict
from ravqa_tpu_torch.models.transformer import (EncoderConfig,
                                                MultiHeadAttention,
                                                TransformerEncoder)
from ravqa_tpu_torch.models.vit import (CLIPVisionModel, ViTConfig,
                                        clip_preprocess,
                                        convert_hf_clip_vision_params)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _load(module, params):
    module.load_state_dict(flax_to_state_dict(jax.device_get(params)),
                           strict=True)
    return module.eval()


@pytest.mark.parametrize("activation,global_pool,pre_layernorm", [
    ("quick_gelu", False, True), ("gelu", False, True),
    ("quick_gelu", True, True), ("gelu", True, False)])
def test_clip_vision_model_matches_jax(activation, global_pool,
                                       pre_layernorm):
    kw = dict(activation=activation, global_pool=global_pool,
              use_pre_layernorm=pre_layernorm)
    jcfg = jax_vit.ViTConfig.tiny(**kw)
    cfg = ViTConfig.tiny(**kw)
    px = np.random.default_rng(0).uniform(-2, 2, (3, 32, 32, 3)).astype(
        np.float32)
    jm = jax_vit.CLIPVisionModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(px))["params"]
    want_h, want_p = jm.apply({"params": params}, jnp.asarray(px))
    tm = _load(CLIPVisionModel(cfg), params)
    with torch.no_grad():
        got_h, got_p = tm(torch.from_numpy(px))
    assert got_h.shape == (3, 1 + 16, 64) and got_p.shape == (3, 64)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=ATOL)


def test_clip_vision_model_refuses_other_sizes():
    with pytest.raises(ValueError, match="multiple"):
        CLIPVisionModel(ViTConfig.tiny(image_size=30))
    tm = CLIPVisionModel(ViTConfig.tiny())
    with pytest.raises(ValueError, match="expected pixels"):
        tm(torch.zeros(1, 24, 24, 3))


@pytest.mark.parametrize("pre_layernorm", [True, False])
def test_encoder_layers_match_jax(pre_layernorm):
    """The shared encoder in both layouts, with a padding bias: BERT's
    post-LN (eps 1e-12, erf GELU) and CLIP's pre-LN (eps 1e-5,
    quick_gelu)."""
    kw = dict(hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, pre_layernorm=pre_layernorm,
              activation="quick_gelu" if pre_layernorm else "gelu",
              layer_norm_eps=1e-5 if pre_layernorm else 1e-12)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    mask = np.ones((2, 7), np.float32)
    mask[1, 4:] = 0
    bias = jax_transformer.attention_bias_from_mask(jnp.asarray(mask))
    jm = jax_transformer.TransformerEncoder(
        jax_transformer.EncoderConfig(**kw))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), bias)["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), bias))
    tm = _load(TransformerEncoder(EncoderConfig(**kw)), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(np.asarray(bias)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_cross_attention_matches_jax():
    """Queries from x, keys and values from a wider kv sequence, its pads
    masked."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    kv = rng.normal(size=(2, 9, 48)).astype(np.float32)
    mask = np.ones((2, 9), np.float32)
    mask[0, 6:] = 0
    bias = jax_transformer.attention_bias_from_mask(jnp.asarray(mask))
    cfg = dict(hidden_size=32, num_heads=4)
    jm = jax_transformer.MultiHeadAttention(
        jax_transformer.EncoderConfig(**cfg))
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), bias,
                     kv=jnp.asarray(kv))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), bias,
                               kv=jnp.asarray(kv)))
    tm = _load(MultiHeadAttention(EncoderConfig(**cfg), kv_dim=48), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(np.asarray(bias)),
                 kv=torch.from_numpy(kv))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("size", [(300, 280), (100, 100), (224, 224)])
def test_clip_preprocess_matches_jax(size):
    """A shrink (antialiased), a stretch and the identity."""
    img = np.random.default_rng(3).integers(0, 256, (2,) + size + (3,),
                                            dtype=np.uint8)
    want = np.asarray(jax_vit.clip_preprocess(jnp.asarray(img), 224))
    got = clip_preprocess(torch.from_numpy(img), 224).numpy()
    assert got.shape == want.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _hf_clip_state_dict(cfg, seed=4):
    """A synthetic HF CLIPVisionModel state dict (numpy) in HF's layout."""
    rng = np.random.default_rng(seed)
    h, p, i = cfg.hidden_size, cfg.patch_size, cfg.intermediate_size

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    pre = "vision_model."
    sd = {pre + "embeddings.patch_embedding.weight": r(h, 3, p, p),
          pre + "embeddings.class_embedding": r(h),
          pre + "embeddings.position_embedding.weight":
              r(cfg.num_patches + 1, h),
          pre + "pre_layrnorm.weight": r(h), pre + "pre_layrnorm.bias": r(h),
          pre + "post_layernorm.weight": r(h),
          pre + "post_layernorm.bias": r(h)}
    for n in range(cfg.num_layers):
        lp = f"{pre}encoder.layers.{n}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[lp + f"self_attn.{name}.weight"] = r(h, h)
            sd[lp + f"self_attn.{name}.bias"] = r(h)
        for name in ("layer_norm1", "layer_norm2"):
            sd[lp + f"{name}.weight"] = r(h)
            sd[lp + f"{name}.bias"] = r(h)
        sd[lp + "mlp.fc1.weight"], sd[lp + "mlp.fc1.bias"] = r(i, h), r(i)
        sd[lp + "mlp.fc2.weight"], sd[lp + "mlp.fc2.bias"] = r(h, i), r(h)
    return sd


def test_hf_clip_mapping_matches_jax():
    """The HF key mapping lands every weight where the JAX package's puts
    it (carried across), and the model built from it gives the JAX
    model's output."""
    cfg = ViTConfig.tiny()
    jcfg = jax_vit.ViTConfig.tiny()
    hf = _hf_clip_state_dict(cfg)
    got = convert_hf_clip_vision_params(
        {k: torch.from_numpy(v) for k, v in hf.items()}, cfg)
    jparams = jax_vit.convert_hf_clip_vision_params(hf, jcfg)
    want = flax_to_state_dict(jparams)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    tm = CLIPVisionModel(cfg)
    tm.load_state_dict(got, strict=True)
    px = np.random.default_rng(5).uniform(-2, 2, (2, 32, 32, 3)).astype(
        np.float32)
    _, want_p = jax_vit.CLIPVisionModel(jcfg).apply({"params": jparams},
                                                    jnp.asarray(px))
    with torch.no_grad():
        _, got_p = tm.eval()(torch.from_numpy(px))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=ATOL)


def test_vit_configs_match_jax():
    for name in ("tiny", "clip_base_p16", "clip_large_p14", "clip_g_p14"):
        got = dataclasses.asdict(getattr(ViTConfig, name)())
        want = dataclasses.asdict(getattr(jax_vit.ViTConfig, name)())
        want = {k: v for k, v in want.items() if k in got}
        assert got == want, name
    large = ViTConfig.clip_large_p14()
    assert (large.image_size, large.patch_size, large.num_patches) == \
        (224, 14, 256)
