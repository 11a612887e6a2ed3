"""ravqa_tpu_torch.models against ravqa_tpu.models at tiny width.

JAX parameters from `model.init` are carried into the port through
models/convert.py; both sides then get the same ids, masks and features.
Tolerance: atol 1e-5, rtol 1e-4. Both sides run float32; XLA and PyTorch
order the matmul, softmax and LayerNorm reductions differently, which moves
values by a few float32 ulps per layer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.models import bert as jax_bert
from ravqa_tpu.models import flmr as jax_flmr
from ravqa_tpu.models import mapping as jax_mapping
from ravqa_tpu_torch.models import (BertConfig, BertModel, FLMRModelConfig,
                                    FLMRRetriever, VisionMapping,
                                    flatten_params, flax_to_state_dict,
                                    l2_normalize, load_params_npz,
                                    skiplist_mask)

TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _ids(rng, b, t, vocab, n_valid):
    ids = rng.integers(5, vocab, size=(b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.int32)
    for i, n in enumerate(n_valid):
        mask[i, :n] = 1
        ids[i, n:] = 0                       # pad id
    return ids, mask


def _load(module, params):
    module.load_state_dict(flax_to_state_dict(jax.device_get(params)),
                           strict=True)
    return module.eval()


def test_bert_matches_jax():
    cfg = BertConfig.tiny()
    jcfg = jax_bert.BertConfig.tiny()
    ids, mask = _ids(np.random.default_rng(0), 3, 11, cfg.vocab_size,
                     [11, 7, 3])
    jm = jax_bert.BertModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                     jnp.asarray(mask))["params"]
    want_h, want_p = jm.apply({"params": params}, jnp.asarray(ids),
                              jnp.asarray(mask))
    tm = _load(BertModel(cfg), params)
    with torch.no_grad():
        got_h, got_p = tm(torch.from_numpy(ids).long(),
                          torch.from_numpy(mask))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)


@pytest.mark.parametrize("feat_shape", [(3, 24), (3, 2, 24)])
def test_vision_mapping_matches_jax(feat_shape):
    feats = np.random.default_rng(1).normal(size=feat_shape).astype(
        np.float32)
    jm = jax_mapping.VisionMapping(vision_dim=24, lm_dim=16, prefix_len=4)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(feats))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(feats)))
    tm = _load(VisionMapping(24, lm_dim=16, prefix_len=4), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats))
    assert got.shape == want.shape == feat_shape[:-1] + (4, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@functools.lru_cache(maxsize=None)
def _flmr_pair(separate: bool):
    """JAX FLMRRetriever params (from model.init) and the port's model with
    the same weights, plus inputs."""
    rng = np.random.default_rng(2)
    jcfg = jax_flmr.FLMRModelConfig.tiny(separate_question_encoder=separate)
    cfg = FLMRModelConfig.tiny(separate_question_encoder=separate)
    qi, qm = _ids(rng, 3, 9, cfg.bert.vocab_size, [9, 6, 4])
    di, dm = _ids(rng, 6, 12, cfg.bert.vocab_size, [12, 10, 8, 6, 5, 2])
    feats = rng.normal(size=(3, cfg.vision_dim)).astype(np.float32)
    jm = jax_flmr.FLMRRetriever(jcfg)
    # the query and doc methods together create every parameter (a module's
    # init draws from the key folded with its path, so `linear` agrees)
    key = jax.random.PRNGKey(3)
    params = {**jm.init(key, jnp.asarray(di), jnp.asarray(dm),
                        method=jax_flmr.FLMRRetriever.doc)["params"],
              **jm.init(key, jnp.asarray(qi), jnp.asarray(qm),
                        jnp.asarray(feats),
                        method=jax_flmr.FLMRRetriever.query)["params"]}
    tm = _load(FLMRRetriever(cfg), params)
    return jm, params, tm, (qi, qm, feats, di, dm)


@pytest.mark.parametrize("separate", [False, True])
def test_flmr_query_matches_jax(separate):
    jm, params, tm, (qi, qm, feats, _, _) = _flmr_pair(separate)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(qi),
                               jnp.asarray(qm), jnp.asarray(feats),
                               method=jax_flmr.FLMRRetriever.query))
    with torch.no_grad():
        got = tm.query(torch.from_numpy(qi).long(), torch.from_numpy(qm),
                       torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (3, 9 + 4, 16)
    np.testing.assert_allclose(got, want, **TOL)
    pad_rows = np.concatenate([qi == 0, np.zeros((3, 4), bool)], axis=1)
    assert (got[pad_rows] == 0).all() and pad_rows.any()


@pytest.mark.parametrize("skip", [None, (7, 9, 11)])
def test_flmr_doc_matches_jax(skip):
    jm, params, tm, (_, _, _, di, dm) = _flmr_pair(False)
    jsm = None if skip is None else jax_flmr.skiplist_mask(
        jnp.asarray(di), skip)
    want_d, want_m = jm.apply({"params": params}, jnp.asarray(di),
                              jnp.asarray(dm), jsm,
                              method=jax_flmr.FLMRRetriever.doc)
    sm = None if skip is None else skiplist_mask(torch.from_numpy(di), skip)
    with torch.no_grad():
        got_d, got_m = tm.doc(torch.from_numpy(di).long(),
                              torch.from_numpy(dm), sm)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)
    masked = got_m.numpy() == 0
    assert masked.any() and (got_d.numpy()[masked] == 0).all()


def test_l2_normalize_and_skiplist_match_jax():
    x = np.random.default_rng(4).normal(size=(2, 5, 8)).astype(np.float32)
    x[0, 1] = 0.0                                # exactly zero row
    x[1, 2] = 1e-7                               # squared norm < 1e-12
    got = l2_normalize(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_flmr.l2_normalize(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[0, 1] == 0).all() and (got[1, 2] == 0).all()
    ids = np.array([[5, 7, 0, 9, 7], [0, 0, 11, 3, 2]], np.int32)
    np.testing.assert_array_equal(
        skiplist_mask(torch.from_numpy(ids), [7, 11]).numpy(),
        np.asarray(jax_flmr.skiplist_mask(jnp.asarray(ids), [7, 11])))


def test_params_npz_round_trip(tmp_path):
    """A JAX params tree saved as a flattened-key .npz loads into the port."""
    _, params, tm, (qi, qm, feats, _, _) = _flmr_pair(False)
    path = tmp_path / "params.npz"
    np.savez(path, **flatten_params(jax.device_get(params)))
    fresh = FLMRRetriever(FLMRModelConfig.tiny())
    fresh.load_state_dict(load_params_npz(str(path)), strict=True)
    fresh.eval()
    args = (torch.from_numpy(qi).long(), torch.from_numpy(qm),
            torch.from_numpy(feats))
    with torch.no_grad():
        torch.testing.assert_close(fresh.query(*args), tm.query(*args),
                                   rtol=0, atol=0)


def test_reset_parameters_is_seeded():
    cfg = FLMRModelConfig.tiny()
    a, b, c = (FLMRRetriever(cfg) for _ in range(3))
    a.reset_parameters(torch.Generator().manual_seed(0))
    b.reset_parameters(torch.Generator().manual_seed(0))
    c.reset_parameters(torch.Generator().manual_seed(1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["linear.weight"], sc["linear.weight"])
    assert torch.equal(sa["doc_encoder.embeddings_ln.weight"],
                       torch.ones(cfg.bert.hidden_size))
