"""The port's cross-encoder reranker, its HF converters, its pair
tokenizer and the distillation scorer against the JAX package's
(ravqa_tpu/models/reranker.py, retrieval/distill.py).

- CrossEncoderReranker, both heads (linear_cls = ELECTRA,
  pooler_classifier = BERT sequence classification), with and without
  ELECTRA's factorised embeddings, on the JAX parameters carried by
  models.convert: scores within 1e-5 (rtol and atol), padded rows
  included;
- convert_hf_electra_reranker_params / convert_hf_seqcls_bert_params on
  synthetic HF-layout state dicts: exactly the JAX converters' trees
  carried by flax_to_state_dict;
- RerankerTokenizer: ids, mask and token types identical (longest-first
  truncation, pad_to);
- Scorer: score_pairs within 1e-5 of the JAX Scorer's (which pads rows to
  bsize and lengths to power-of-two buckets), the distillation_scores.json
  lines of the same schema (qids, pids and their order identical, scores
  1e-5), load_distillation_scores round-trips the port's file exactly, and
  kd_triples_from_scores gives identical rows.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.models import reranker as jr
from ravqa_tpu.retrieval import distill as jd
from ravqa_tpu.tokenization import WordPieceTokenizer as JaxWordPiece
from ravqa_tpu.tokenization import make_tiny_vocab as jax_tiny_vocab
from ravqa_tpu_torch.models import flax_to_state_dict
from ravqa_tpu_torch.models import reranker as tr
from ravqa_tpu_torch.retrieval import distill as td
from ravqa_tpu_torch.tokenization import WordPieceTokenizer, make_tiny_vocab

WORDS = ["cat", "dog", "sun", "sky", "tree", "fish", "rock", "bird", "what",
         "is", "a", "facts", "about", "the", "big", "red"]
TOK = WordPieceTokenizer(make_tiny_vocab(WORDS))
JTOK = JaxWordPiece(jax_tiny_vocab(WORDS))
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


CASES = {"electra_factorised": dict(head="linear_cls", embedding_size=32),
         "electra": dict(head="linear_cls", embedding_size=64),
         "bert_seqcls": dict(head="pooler_classifier", embedding_size=64)}


def _models(case):
    kw = CASES[case]
    jcfg = jr.RerankerConfig.tiny(vocab_size=TOK.vocab_size + 8, **kw)
    tcfg = tr.RerankerConfig.tiny(vocab_size=TOK.vocab_size + 8, **kw)
    jm = jr.CrossEncoderReranker(jcfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.ones((2, 8), jnp.int32),
                     jnp.ones((2, 8), jnp.int32))["params"]
    params = jax.device_get(params)
    model = tr.CrossEncoderReranker(tcfg)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return jm, params, model.eval()


def _inputs(rng, b=5, t=19):
    ids = rng.integers(1, TOK.vocab_size, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    tt = np.zeros((b, t), np.int32)
    for i in range(b - 1):
        n = int(rng.integers(3, t + 1))
        mask[i, n:] = 0
        tt[i, n // 2:n] = 1
    mask[-1] = 0                     # an all-pad row (the JAX Scorer's pad)
    return ids, mask, tt


@pytest.mark.parametrize("case", sorted(CASES))
def test_reranker_matches_jax(case):
    jm, params, model = _models(case)
    ids, mask, tt = _inputs(np.random.default_rng(0))
    want = np.asarray(jm.apply({"params": params}, ids, mask, tt))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask).long(),
                    torch.from_numpy(tt).long()).numpy()
        no_types = model(torch.from_numpy(ids).long(),
                         torch.from_numpy(mask).long()).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(
        no_types, np.asarray(jm.apply({"params": params}, ids, mask)),
        rtol=ATOL, atol=ATOL)


def _hf_encoder(rng, prefix, cfg):
    h, f = cfg.hidden_size, cfg.intermediate_size
    r = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    sd = {}
    for i in range(cfg.num_layers):
        pre = f"{prefix}encoder.layer.{i}."
        for name, (o, n) in {"attention.self.query": (h, h),
                             "attention.self.key": (h, h),
                             "attention.self.value": (h, h),
                             "attention.output.dense": (h, h),
                             "intermediate.dense": (f, h),
                             "output.dense": (h, f)}.items():
            sd[pre + name + ".weight"] = r(o, n)
            sd[pre + name + ".bias"] = r(o)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[pre + ln + ".weight"] = r(h)
            sd[pre + ln + ".bias"] = r(h)
    e = cfg.embedding_size
    for name, n in (("word_embeddings", cfg.vocab_size),
                    ("position_embeddings", cfg.max_position_embeddings),
                    ("token_type_embeddings", cfg.type_vocab_size)):
        sd[f"{prefix}embeddings.{name}.weight"] = r(n, e)
    sd[f"{prefix}embeddings.LayerNorm.weight"] = r(e)
    sd[f"{prefix}embeddings.LayerNorm.bias"] = r(e)
    return sd


@pytest.mark.parametrize("case", sorted(CASES))
def test_hf_converters_match_jax(case):
    """The HF state dict as torch tensors for the port, as numpy for the
    JAX converter: the port's state_dict equals the JAX tree carried
    across, key for key and bit for bit, and loads strictly."""
    kw = CASES[case]
    jcfg = jr.RerankerConfig.tiny(vocab_size=40, **kw)
    tcfg = tr.RerankerConfig.tiny(vocab_size=40, **kw)
    rng = np.random.default_rng(2)
    h = tcfg.hidden_size
    if kw["head"] == "linear_cls":
        sd = _hf_encoder(rng, "electra.", tcfg)
        sd["linear.weight"] = rng.normal(size=(1, h)).astype(np.float32)
        sd["linear.bias"] = rng.normal(size=(1,)).astype(np.float32)
        if tcfg.embedding_size != h:
            sd["electra.embeddings_project.weight"] = rng.normal(
                size=(h, tcfg.embedding_size)).astype(np.float32)
            sd["electra.embeddings_project.bias"] = rng.normal(
                size=(h,)).astype(np.float32)
        jconv, tconv = (jr.convert_hf_electra_reranker_params,
                        tr.convert_hf_electra_reranker_params)
    else:
        sd = _hf_encoder(rng, "bert.", tcfg)
        sd["bert.pooler.dense.weight"] = rng.normal(
            size=(h, h)).astype(np.float32)
        sd["bert.pooler.dense.bias"] = rng.normal(size=(h,)).astype(
            np.float32)
        sd["classifier.weight"] = rng.normal(size=(1, h)).astype(np.float32)
        sd["classifier.bias"] = rng.normal(size=(1,)).astype(np.float32)
        jconv, tconv = (jr.convert_hf_seqcls_bert_params,
                        tr.convert_hf_seqcls_bert_params)
    got = tconv({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    want = flax_to_state_dict(jconv(sd, jcfg))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    tr.CrossEncoderReranker(tcfg).load_state_dict(got, strict=True)


@pytest.mark.parametrize("total_maxlen", [6, 9, 16, 64])
def test_pair_tokenizer_identical(total_maxlen):
    rng = np.random.default_rng(total_maxlen)
    qs = [" ".join(rng.choice(WORDS, int(rng.integers(0, 12))))
          for _ in range(9)]
    ps = [" ".join(rng.choice(WORDS, int(rng.integers(0, 20))))
          for _ in range(9)]
    t, j = (tr.RerankerTokenizer(TOK, total_maxlen),
            jr.RerankerTokenizer(JTOK, total_maxlen))
    for pad_to in (None, total_maxlen + 3):
        for a, b in zip(t.tensorize(qs, ps, pad_to), j.tensorize(qs, ps,
                                                                 pad_to)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _scoring_world(rng, n_q=7, n_p=30):
    passages = [" ".join(rng.choice(WORDS, int(rng.integers(2, 30))))
                for _ in range(n_p)]
    queries = {str(i): " ".join(rng.choice(WORDS, int(rng.integers(1, 8))))
               for i in range(n_q)}
    qids, pids = [], []
    for q in queries:
        for p in rng.choice(n_p, int(rng.integers(2, 7)), replace=False):
            qids.append(q)
            pids.append(int(p))
    return passages, queries, qids, pids


@pytest.mark.parametrize("case", ["bert_seqcls", "electra_factorised"])
def test_scorer_matches_jax(tmp_path, case):
    jm, params, model = _models(case)
    passages, queries, qids, pids = _scoring_world(np.random.default_rng(4))
    maxlen, bsize = 24, 8
    scorer = td.Scorer(model, tr.RerankerTokenizer(TOK, maxlen), bsize)
    jscorer = jd.Scorer(jm, params, jr.RerankerTokenizer(JTOK, maxlen),
                        bsize)
    qt = [queries[q] for q in qids]
    pt = [passages[p] for p in pids]
    got, want = scorer.score_pairs(qt, pt), jscorer.score_pairs(qt, pt)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)
    assert scorer.score_pairs([], []).shape == (0,)
    paths = {n: str(tmp_path / f"{n}.json") for n in ("port", "jax")}
    by_qid = scorer.score_ranking(qids, pids, queries, passages,
                                  paths["port"])
    jby_qid = jscorer.score_ranking(qids, pids, queries, passages,
                                    paths["jax"])
    lines = [[json.loads(x) for x in open(paths[n])] for n in paths]
    assert len(lines[0]) == len(lines[1]) == len(queries)
    for a, b in zip(*lines):
        assert a[0] == b[0] and len(a) == len(b) == 2
        assert [p for _, p in a[1]] == [p for _, p in b[1]]
        assert all(type(s) is float for s, _ in a[1])
        np.testing.assert_allclose([s for s, _ in a[1]],
                                   [s for s, _ in b[1]], rtol=ATOL,
                                   atol=ATOL)
    loaded = td.load_distillation_scores(paths["port"])
    assert loaded == by_qid
    assert loaded == jd.load_distillation_scores(paths["port"])
    for nway in (2, 3, 5):
        for seed in (0, 1):
            assert td.kd_triples_from_scores(jby_qid, nway, seed) == \
                jd.kd_triples_from_scores(jby_qid, nway, seed)
            rows = td.kd_triples_from_scores(by_qid, nway, seed)
            assert all(len(r) == nway + 1 and r[1][1] == max(
                s for s, _ in by_qid[r[0]]) for r in rows)
