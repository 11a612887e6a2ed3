"""ravqa_tpu_torch.models.t5 against ravqa_tpu.models.t5 at tiny width.

JAX parameters from `T5Model.init` come into the port through
models/convert.py (generator_to_state_dict); both sides then get the same
numpy ids and masks, made from a seed. Tolerance: 1e-4 max abs on hidden
states and logits (both run float32; XLA and PyTorch order the matmul,
softmax and RMSNorm reductions differently, a few ulps per layer). The
relative-position buckets are compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.models import t5 as jax_t5
from ravqa_tpu_torch.models import flatten_params
from ravqa_tpu_torch.models.convert import (generator_to_flax,
                                            generator_to_state_dict)
from ravqa_tpu_torch.models.t5 import (T5Config, T5Model,
                                       relative_position_bucket,
                                       shift_right)

ATOL = 1e-4
VARIANTS = [("relu", True), ("relu", False), ("gated-gelu", True),
            ("gated-gelu", False)]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(seed=0, b=3, t=9, td=5, vocab=512):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, 6:] = 0
    mask[2, 3:] = 0
    dec = rng.integers(2, vocab, (b, td)).astype(np.int32)
    return ids, mask, dec


def _pair(ff, tie, **kw):
    """(JAX model, its params, the port's model carrying them)."""
    jm = jax_t5.T5Model(jax_t5.T5Config.tiny(feed_forward_proj=ff,
                                             tie_word_embeddings=tie, **kw))
    ids, mask, dec = _inputs()
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                    jnp.asarray(mask),
                                    jnp.asarray(dec))["params"])
    tm = T5Model(T5Config.tiny(feed_forward_proj=ff, tie_word_embeddings=tie,
                               **kw))
    tm.load_state_dict(generator_to_state_dict(params), strict=True)
    return jm, params, tm.eval()


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b.detach())).max())


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets,max_distance",
                         [(32, 128), (16, 32), (8, 20), (32, 300)])
def test_relative_position_bucket_bit_equal(bidirectional, num_buckets,
                                            max_distance):
    rp = np.arange(-300, 301)
    want = np.asarray(jax_t5.relative_position_bucket(
        jnp.asarray(rp), bidirectional, num_buckets, max_distance))
    got = relative_position_bucket(torch.tensor(rp), bidirectional,
                                   num_buckets, max_distance).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ff,tie", VARIANTS)
def test_encoder_matches_jax(ff, tie):
    jm, p, tm = _pair(ff, tie)
    ids, mask, _ = _inputs(1)
    want = jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                    method=jax_t5.T5Model.encode)
    with torch.no_grad():
        got = tm.encode(torch.tensor(ids), torch.tensor(mask))
    assert _err(want, got) < ATOL


@pytest.mark.parametrize("ff,tie", VARIANTS)
def test_teacher_forced_decode_matches_jax(ff, tie):
    jm, p, tm = _pair(ff, tie)
    ids, mask, dec = _inputs(2)
    dmask = np.ones_like(dec)
    dmask[0, 3:] = 0
    want = jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                    jnp.asarray(dec), jnp.asarray(dmask))
    with torch.no_grad():
        got = tm(torch.tensor(ids), torch.tensor(mask), torch.tensor(dec),
                 torch.tensor(dmask))
    assert got.shape == (3, 5, 512)
    assert _err(want, got) < ATOL


@pytest.mark.parametrize("ff,tie", VARIANTS)
def test_decode_step_matches_jax_step_and_teacher_forcing(ff, tie):
    """Each step with the port's cache (self-attention written at its
    index, cross-attention keys and values computed once) against the JAX
    step (keys and values projected from enc at every step), and against
    the teacher-forced logits at that position."""
    jm, p, tm = _pair(ff, tie)
    ids, mask, dec = _inputs(3)
    enc = jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                   method=jax_t5.T5Model.encode)
    jcache = jm.apply({"params": p}, 3, 5, method=jax_t5.T5Model.init_cache)
    with torch.no_grad():
        tenc = tm.encode(torch.tensor(ids), torch.tensor(mask))
        forced = tm.decode(torch.tensor(dec), tenc, torch.tensor(mask))
        kv = tm.cross_kv(tenc)
        cache = tm.init_cache(3, 5)
        for t in range(5):
            want, jcache = jm.apply(
                {"params": p}, jnp.asarray(dec[:, t:t + 1]), enc,
                jnp.asarray(mask), jcache,
                method=jax_t5.T5Model.decode_step)
            got, cache = tm.decode_step(torch.tensor(dec[:, t:t + 1]), kv,
                                        torch.tensor(mask), cache)
            assert cache[0]["index"] == t + 1
            assert _err(want, got) < ATOL
            assert float((got[:, 0] - forced[:, t]).abs().max()) < ATOL


def test_cached_cross_kv_matches_recomputed_and_beam_rows():
    """decode_step on cross_kv(enc) against decode_step on enc (projected
    on every call), and with g = 2 decoder rows per encoder row (the beams
    of a sequence) against enc repeated twice, as the JAX step takes it."""
    jm, p, tm = _pair("gated-gelu", False)
    ids, mask, dec = _inputs(4)
    with torch.no_grad():
        enc = tm.encode(torch.tensor(ids), torch.tensor(mask))
        m = torch.tensor(mask)
        kv = tm.cross_kv(enc)
        tok = torch.tensor(np.repeat(dec[:, :1], 2, axis=0))
        grouped, _ = tm.decode_step(tok, kv, m, tm.init_cache(6, 4))
        recomputed, _ = tm.decode_step(tok, enc, m, tm.init_cache(6, 4))
        repeated, _ = tm.decode_step(tok, enc.repeat_interleave(2, 0),
                                     m.repeat_interleave(2, 0),
                                     tm.init_cache(6, 4))
    want = jm.apply({"params": p}, jnp.asarray(tok.numpy()),
                    jnp.asarray(enc.numpy()).repeat(2, 0),
                    jnp.asarray(mask).repeat(2, 0),
                    jm.apply({"params": p}, 6, 4,
                             method=jax_t5.T5Model.init_cache),
                    method=jax_t5.T5Model.decode_step)[0]
    for got in (grouped, recomputed, repeated):
        assert _err(want, got) < ATOL
    assert float((grouped - repeated).abs().max()) < 1e-5


@pytest.mark.parametrize("ff,tie", VARIANTS)
def test_conversion_round_trip_is_exact(ff, tie):
    """JAX params -> state_dict -> JAX params, array for array; the relative
    bias table lives in layer 0 of each stack only."""
    _, p, tm = _pair(ff, tie)
    want, got = flatten_params(p), flatten_params(generator_to_flax(tm))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    names = [n for n, _ in tm.named_parameters()
             if "relative_attention_bias" in n]
    assert names == ["encoder.0.self_attn.relative_attention_bias.weight",
                     "decoder.0.self_attn.relative_attention_bias.weight"]
    assert (tm.lm_head is None) == tie


def test_shift_right_matches_jax():
    labels = np.array([[5, 6, 1, -100, -100], [7, -100, -100, -100, -100]],
                      np.int32)
    want = jax_t5.shift_right(jnp.asarray(labels), 0, 0)
    got = shift_right(torch.tensor(labels), 0, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reset_parameters_follows_flax_scales():
    """The port's random init against flax's: each parameter's standard
    deviation within 10 % (lecun-normal kernels, embeddings of std
    d^-1/2, unit norms), and 24 + 24 random layers give finite logits."""
    _, p, _ = _pair("gated-gelu", False, d_model=128, d_ff=256)
    tm = T5Model(T5Config.tiny(feed_forward_proj="gated-gelu",
                               tie_word_embeddings=False, d_model=128,
                               d_ff=256))
    tm.reset_parameters(torch.Generator().manual_seed(3))
    want = {k: float(np.std(v)) for k, v in flatten_params(p).items()}
    got = {k: float(np.std(v))
           for k, v in flatten_params(generator_to_flax(tm)).items()}
    for k, std in want.items():
        if std == 0.0:
            assert got[k] == 0.0, k
        else:
            assert abs(got[k] / std - 1) < 0.1, (k, got[k], std)
    deep = T5Model(T5Config.tiny(feed_forward_proj="gated-gelu",
                                 tie_word_embeddings=False, num_layers=24))
    deep.reset_parameters(torch.Generator().manual_seed(0))
    ids, mask, dec = _inputs(5)
    with torch.no_grad():
        logits = deep(torch.tensor(ids), torch.tensor(mask),
                      torch.tensor(dec))
    assert torch.isfinite(logits).all()
