"""ravqa_tpu_torch.models.blip2 against ravqa_tpu.models.blip2 at tiny width.

The JAX Blip2T5's parameters come into the port through models/convert.py
(the patch embedding's HWIO kernel as a Conv2d OIHW weight, the fused qkv,
the class and position embeddings, the query tokens, the Q-Former and the
language projection, and the T5 tower). Both sides get the same seeded
numpy pixels, ids and masks. Tolerance: 1e-4 max abs on hidden states and
logits (float32 on both sides; reductions summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.models import blip2 as jax_blip2
from ravqa_tpu.models import t5 as jax_t5
from ravqa_tpu_torch.models import flatten_params
from ravqa_tpu_torch.models.blip2 import (Blip2Config, Blip2T5,
                                          Blip2VisionConfig, QFormerConfig)
from ravqa_tpu_torch.models.convert import (generator_to_flax,
                                            generator_to_state_dict)
from ravqa_tpu_torch.models.t5 import T5Config

ATOL = 1e-4
B = 2


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _configs(ff="gated-gelu", **t5kw):
    """The tiny BLIP-2 of both packages: 3 vision layers, 3 Q-Former layers
    (cross-attention in layers 0 and 2), 4 query tokens, a tiny T5."""
    kw = dict(feed_forward_proj=ff, tie_word_embeddings=False, **t5kw)
    vis, qf = dict(num_layers=3), dict(num_layers=3)
    jcfg = jax_blip2.Blip2Config(
        vision=jax_blip2.Blip2VisionConfig.tiny(**vis),
        qformer=jax_blip2.QFormerConfig.tiny(**qf),
        t5=jax_t5.T5Config.tiny(**kw), num_query_tokens=4)
    tcfg = Blip2Config(vision=Blip2VisionConfig.tiny(**vis),
                       qformer=QFormerConfig.tiny(**qf),
                       t5=T5Config.tiny(**kw), num_query_tokens=4)
    return jcfg, tcfg


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(B, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(2, 512, (B, 7)).astype(np.int32)
    mask = np.ones((B, 7), np.int32)
    mask[1, 4:] = 0
    dec = rng.integers(2, 512, (B, 3)).astype(np.int32)
    return px, ids, mask, dec


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _configs()
    jm = jax_blip2.Blip2T5(jcfg)
    px, ids, mask, dec = _inputs()
    p = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(px),
                               jnp.asarray(ids), jnp.asarray(mask),
                               jnp.asarray(dec))["params"])
    tm = Blip2T5(tcfg)
    tm.load_state_dict(generator_to_state_dict(p), strict=True)
    return jm, p, tm.eval()


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b.detach())).max())


def test_vision_model_matches_jax(pair):
    jm, p, tm = pair
    px = _inputs(1)[0]
    want = jax_blip2.Blip2VisionModel(jm.cfg.vision).apply(
        {"params": p["vision_model"]}, jnp.asarray(px))
    with torch.no_grad():
        got = tm.vision_model(torch.tensor(px))
    assert got.shape == (B, 1 + 16, 32)
    assert _err(want, got) < ATOL


def test_qformer_matches_jax(pair):
    """The Q-Former alone, with an image mask on the cross-attention."""
    jm, p, tm = pair
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, 4, 32)).astype(np.float32)
    img = rng.normal(size=(B, 17, 32)).astype(np.float32)
    img_mask = np.ones((B, 17), np.int32)
    img_mask[0, 10:] = 0
    for m in (None, img_mask):
        want = jax_blip2.QFormer(jm.cfg.qformer).apply(
            {"params": p["qformer"]}, jnp.asarray(q), jnp.asarray(img),
            None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = tm.qformer(torch.tensor(q), torch.tensor(img),
                             None if m is None else torch.tensor(m))
        assert _err(want, got) < ATOL
    assert [layer.has_cross for layer in tm.qformer.layers] == [True, False,
                                                                True]


def test_encode_image_and_encode_match_jax(pair):
    jm, p, tm = pair
    px, ids, mask, _ = _inputs(4)
    want_img = jm.apply({"params": p}, jnp.asarray(px),
                        method=jax_blip2.Blip2T5.encode_image)
    want_enc, want_mask = jm.apply(
        {"params": p}, jnp.asarray(px), jnp.asarray(ids), jnp.asarray(mask),
        method=jax_blip2.Blip2T5.encode)
    with torch.no_grad():
        got_img = tm.encode_image(torch.tensor(px))
        got_enc, got_mask = tm.encode(torch.tensor(px), torch.tensor(ids),
                                      torch.tensor(mask))
        # one image's tokens repeated for two inputs each == the image
        # repeated before the vision tower
        rep_ids = np.repeat(ids, 2, axis=0)
        rep_mask = np.repeat(mask, 2, axis=0)
        once, _ = tm.encode_tokens(got_img.repeat_interleave(2, 0),
                                   torch.tensor(rep_ids),
                                   torch.tensor(rep_mask))
        twice, _ = tm.encode(torch.tensor(np.repeat(px, 2, axis=0)),
                             torch.tensor(rep_ids), torch.tensor(rep_mask))
    assert got_img.shape == (B, 4, 64)
    assert _err(want_img, got_img) < ATOL
    assert got_enc.shape == (B, 4 + 7, 64)
    assert _err(want_enc, got_enc) < ATOL
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert float((once - twice).abs().max()) < 1e-5


def test_forward_and_decode_step_match_jax(pair):
    """Blip2T5.__call__ (teacher-forced logits) and one decode step on the
    encoder output's cross_kv."""
    jm, p, tm = pair
    px, ids, mask, dec = _inputs(5)
    want = jm.apply({"params": p}, jnp.asarray(px), jnp.asarray(ids),
                    jnp.asarray(mask), jnp.asarray(dec))
    enc, emask = jm.apply({"params": p}, jnp.asarray(px), jnp.asarray(ids),
                          jnp.asarray(mask),
                          method=jax_blip2.Blip2T5.encode)
    want_step, _ = jm.apply(
        {"params": p}, jnp.asarray(dec[:, :1]), enc, emask,
        jm.apply({"params": p}, B, 3, method=jax_blip2.Blip2T5.init_cache),
        method=jax_blip2.Blip2T5.decode_step)
    with torch.no_grad():
        got = tm(torch.tensor(px), torch.tensor(ids), torch.tensor(mask),
                 torch.tensor(dec))
        tenc, tmask = tm.encode(torch.tensor(px), torch.tensor(ids),
                                torch.tensor(mask))
        got_step, _ = tm.decode_step(torch.tensor(dec[:, :1]),
                                     tm.cross_kv(tenc), tmask,
                                     tm.init_cache(B, 3))
    assert got.shape == (B, 3, 512)
    assert _err(want, got) < ATOL
    assert _err(want_step, got_step) < ATOL


def test_float64_copy_stays_float64(pair):
    """A float64 copy of the generator (the reference a float32 run is
    measured against) keeps its softmaxes, LayerNorms and RMSNorm variances
    in float64, and agrees with the JAX float32 run."""
    import copy
    from unittest import mock

    import torch.nn.functional as F
    jm, p, tm = pair
    t64 = copy.deepcopy(tm).double()
    px, ids, mask, dec = _inputs(5)
    want = jm.apply({"params": p}, jnp.asarray(px), jnp.asarray(ids),
                    jnp.asarray(mask), jnp.asarray(dec))
    with torch.no_grad(), \
            mock.patch.object(torch, "softmax", wraps=torch.softmax) as sm, \
            mock.patch.object(F, "layer_norm", wraps=F.layer_norm) as ln:
        got = t64(torch.tensor(px, dtype=torch.float64), torch.tensor(ids),
                  torch.tensor(mask), torch.tensor(dec))
    assert got.dtype == torch.float64
    assert {c.args[0].dtype for c in sm.call_args_list} == {torch.float64}
    assert {c.args[0].dtype for c in ln.call_args_list} == {torch.float64}
    assert _err(want, got) < ATOL
    norm = t64.language_model.encoder_final_ln
    x = torch.randn(3, 64, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(
            norm(x), norm.weight * x * torch.rsqrt(
                x.square().mean(-1, keepdim=True) + norm.eps),
            rtol=0, atol=1e-15)


def test_conversion_round_trip_is_exact(pair):
    """JAX params -> state_dict -> JAX params, array for array (the HWIO
    patch kernel through the Conv2d's OIHW and back)."""
    _, p, tm = pair
    assert tuple(tm.vision_model.patch_embedding.weight.shape) == (32, 3, 8,
                                                                   8)
    want, got = flatten_params(p), flatten_params(generator_to_flax(tm))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_reset_parameters_follows_flax_scales(pair):
    """Each parameter's standard deviation within 15 % of flax's init
    (lecun-normal kernels, the conv over its kh * kw * in fan-in, N(0,
    0.02) class and position embeddings and query tokens)."""
    _, p, _ = pair
    tm = Blip2T5(_configs()[1])
    tm.reset_parameters(torch.Generator().manual_seed(0))
    want = {k: float(np.std(v)) for k, v in flatten_params(p).items()}
    got = {k: float(np.std(v))
           for k, v in flatten_params(generator_to_flax(tm)).items()}
    for k, std in want.items():
        if std == 0.0:
            assert got[k] == 0.0, k
        else:
            assert abs(got[k] / std - 1) < 0.15, (k, got[k], std)
