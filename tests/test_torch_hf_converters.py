"""The port's HF converters for the RAG generators against the JAX
package's (ravqa_tpu/models/t5.py:341 convert_hf_t5_params, blip2.py:273
convert_hf_blip2_params): synthetic HF-layout state dicts (the key names
the JAX converters read, random numpy values from a seed; no transformers,
no real weights) through both. The port's state_dict must equal the JAX
tree carried across by models.convert.generator_to_state_dict, key for key
and bit for bit, and load strictly; a tiny forward of each (the JAX module
on its tree, the port's on its state_dict) gives logits within rtol 1e-5
and 1e-5 of the largest logit. Cases: T5 with ReLU and tied embeddings,
gated-GELU with an untied lm_head, a `prefix`, and BLIP-2 (ViT, Q-Former
with cross-attention every other layer, query tokens, projection, T5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.models import blip2 as jblip2
from ravqa_tpu.models import t5 as jt5
from ravqa_tpu_torch.models import blip2, generator_to_state_dict, t5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _r(rng, *shape):
    return rng.normal(size=shape).astype(np.float32) * 0.1


def hf_t5(rng, cfg, prefix=""):
    """An HF T5ForConditionalGeneration state_dict of cfg's shapes."""
    d, inner, f = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    sd = {"shared.weight": _r(rng, cfg.vocab_size, d),
          "encoder.final_layer_norm.weight": 1 + _r(rng, d),
          "decoder.final_layer_norm.weight": 1 + _r(rng, d)}
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = _r(rng, cfg.vocab_size, d)

    def attn(pre, first):
        for w in "qkv":
            sd[f"{pre}.{w}.weight"] = _r(rng, inner, d)
        sd[f"{pre}.o.weight"] = _r(rng, d, inner)
        if first:
            sd[f"{pre}.relative_attention_bias.weight"] = _r(
                rng, cfg.relative_attention_num_buckets, cfg.num_heads)

    def ff(pre):
        names = (("wi_0", "wi_1") if cfg.feed_forward_proj == "gated-gelu"
                 else ("wi",))
        for w in names:
            sd[f"{pre}.DenseReluDense.{w}.weight"] = _r(rng, f, d)
        sd[f"{pre}.DenseReluDense.wo.weight"] = _r(rng, d, f)

    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}.layer"
        attn(f"{b}.0.SelfAttention", i == 0)
        ff(f"{b}.1")
        for j in (0, 1):
            sd[f"{b}.{j}.layer_norm.weight"] = 1 + _r(rng, d)
    for i in range(cfg.n_dec):
        b = f"decoder.block.{i}.layer"
        attn(f"{b}.0.SelfAttention", i == 0)
        attn(f"{b}.1.EncDecAttention", False)
        ff(f"{b}.2")
        for j in (0, 1, 2):
            sd[f"{b}.{j}.layer_norm.weight"] = 1 + _r(rng, d)
    return {prefix + k: v for k, v in sd.items()}


def hf_blip2(rng, cfg):
    """An HF Blip2ForConditionalGeneration (T5) state_dict of cfg's
    shapes."""
    v, q = cfg.vision, cfg.qformer
    h, p = v.hidden_size, v.patch_size
    n_pos = (v.image_size // p) ** 2 + 1
    sd = {"vision_model.embeddings.patch_embedding.weight":
          _r(rng, h, 3, p, p),
          "vision_model.embeddings.patch_embedding.bias": _r(rng, h),
          "vision_model.embeddings.class_embedding": _r(rng, 1, 1, h),
          "vision_model.embeddings.position_embedding":
          _r(rng, 1, n_pos, h),
          "vision_model.post_layernorm.weight": 1 + _r(rng, h),
          "vision_model.post_layernorm.bias": _r(rng, h),
          "query_tokens": _r(rng, 1, cfg.num_query_tokens, q.hidden_size),
          "qformer.layernorm.weight": 1 + _r(rng, q.hidden_size),
          "qformer.layernorm.bias": _r(rng, q.hidden_size),
          "language_projection.weight": _r(rng, cfg.t5.d_model,
                                           q.hidden_size),
          "language_projection.bias": _r(rng, cfg.t5.d_model)}

    def lin(name, out, inp):
        sd[name + ".weight"] = _r(rng, out, inp)
        sd[name + ".bias"] = _r(rng, out)

    def ln(name, n):
        sd[name + ".weight"] = 1 + _r(rng, n)
        sd[name + ".bias"] = _r(rng, n)

    for i in range(v.num_layers):
        pre = f"vision_model.encoder.layers.{i}."
        ln(pre + "layer_norm1", h)
        lin(pre + "self_attn.qkv", 3 * h, h)
        lin(pre + "self_attn.projection", h, h)
        ln(pre + "layer_norm2", h)
        lin(pre + "mlp.fc1", v.intermediate_size, h)
        lin(pre + "mlp.fc2", h, v.intermediate_size)
    qh, qf = q.hidden_size, q.intermediate_size
    for i in range(q.num_layers):
        pre = f"qformer.encoder.layer.{i}."
        for w in ("query", "key", "value"):
            lin(pre + f"attention.attention.{w}", qh, qh)
        lin(pre + "attention.output.dense", qh, qh)
        ln(pre + "attention.output.LayerNorm", qh)
        if i % q.cross_attention_frequency == 0:
            lin(pre + "crossattention.attention.query", qh, qh)
            for w in ("key", "value"):
                lin(pre + f"crossattention.attention.{w}", qh,
                    q.encoder_hidden_size)
            lin(pre + "crossattention.output.dense", qh, qh)
            ln(pre + "crossattention.output.LayerNorm", qh)
        lin(pre + "intermediate_query.dense", qf, qh)
        lin(pre + "output_query.dense", qh, qf)
        ln(pre + "output_query.LayerNorm", qh)
    sd.update(hf_t5(rng, cfg.t5, prefix="language_model."))
    return sd


def _equal_state(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k],
                                                             want[k]), k


T5_CASES = {"relu_tied": dict(),
            "gated_untied": dict(feed_forward_proj="gated-gelu",
                                 tie_word_embeddings=False,
                                 num_decoder_layers=3)}


@pytest.mark.parametrize("prefix", ["", "language_model."])
@pytest.mark.parametrize("case", sorted(T5_CASES))
def test_t5_converter_matches_jax(case, prefix):
    kw = dict(vocab_size=96, **T5_CASES[case])
    jcfg, tcfg = jt5.T5Config.tiny(**kw), t5.T5Config.tiny(**kw)
    sd = hf_t5(np.random.default_rng(0), tcfg, prefix)
    tree = jt5.convert_hf_t5_params(sd, jcfg, prefix=prefix)
    got = t5.convert_hf_t5_params({k: torch.from_numpy(v)
                                   for k, v in sd.items()}, tcfg,
                                  prefix=prefix)
    _equal_state(got, generator_to_state_dict(tree))
    model = t5.T5Model(tcfg)
    model.load_state_dict(got, strict=True)
    rng = np.random.default_rng(1)
    ids = rng.integers(2, 96, (2, 7)).astype(np.int32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 4:] = 0
    dec = rng.integers(2, 96, (2, 5)).astype(np.int32)
    want = np.asarray(jt5.T5Model(jcfg).apply({"params": tree}, ids, mask,
                                              dec))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask).long(),
                    torch.from_numpy(dec).long()).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_blip2_converter_matches_jax():
    t5kw = dict(vocab_size=96)
    jcfg = jblip2.Blip2Config(
        vision=jblip2.Blip2VisionConfig.tiny(),
        qformer=jblip2.QFormerConfig.tiny(),
        t5=jt5.T5Config.tiny(**t5kw), num_query_tokens=3)
    tcfg = blip2.Blip2Config(
        vision=blip2.Blip2VisionConfig.tiny(),
        qformer=blip2.QFormerConfig.tiny(),
        t5=t5.T5Config.tiny(**t5kw), num_query_tokens=3)
    sd = hf_blip2(np.random.default_rng(2), tcfg)
    tree = jblip2.convert_hf_blip2_params(sd, jcfg)
    got = blip2.convert_hf_blip2_params({k: torch.from_numpy(v)
                                         for k, v in sd.items()}, tcfg)
    _equal_state(got, generator_to_state_dict(tree))
    model = blip2.Blip2T5(tcfg)
    model.load_state_dict(got, strict=True)
    rng = np.random.default_rng(3)
    px = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(2, 96, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.int32)
    mask[0, 4:] = 0
    dec = rng.integers(2, 96, (2, 4)).astype(np.int32)
    want = np.asarray(jblip2.Blip2T5(jcfg).apply({"params": tree}, px, ids,
                                                 mask, dec))
    with torch.no_grad():
        out = model(torch.from_numpy(px), torch.from_numpy(ids).long(),
                    torch.from_numpy(mask).long(),
                    torch.from_numpy(dec).long()).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
