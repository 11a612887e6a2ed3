"""The port's ColBERT data objects and TriplesExecutor against the JAX
package's (ravqa_tpu/data/colbert_data.py, executors/triples_executor.py).

- Collection / Queries from TSV (titles), Triples from JSONL and TSV,
  Triples.batches (shuffled and not, several epochs, a dropped tail, pids
  by string, an int pid's position fallback, teacher scores),
  docs_to_passages and create_triples_from_ranking: identical output;
- TriplesExecutor.make_batch identical arrays; its loss, metrics and
  grads on carried parameters (models.convert) with and without in-batch
  negatives and distillation, at tests/test_torch_train.py's tolerances:
  values rtol 1e-5, atol 1e-5; grads rtol 1e-4, atol 1e-5 of the largest;
- train_on_triples over 6 steps with and without distillation: each
  step's loss, nway/ib/distill metrics and grad norm rtol 1e-4, atol 1e-5,
  and the parameters after them within 2 lr a step (Adam turns float32
  rounding on near-zero grads into moves of up to lr).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.data import colbert_data as jcd
from ravqa_tpu.executors import TrainConfig as JaxTrainConfig
from ravqa_tpu.executors.triples_executor import \
    TriplesExecutor as JaxTriplesExecutor
from ravqa_tpu.models import flmr as jflmr
from ravqa_tpu.tokenization import DocTokenizer as JaxDocTokenizer
from ravqa_tpu.tokenization import QueryTokenizer as JaxQueryTokenizer
from ravqa_tpu.tokenization import WordPieceTokenizer as JaxWordPiece
from ravqa_tpu.tokenization import make_tiny_vocab as jax_tiny_vocab
from ravqa_tpu_torch.data import colbert_data as cd
from ravqa_tpu_torch.executors import TrainConfig
from ravqa_tpu_torch.executors.triples_executor import TriplesExecutor
from ravqa_tpu_torch.models import (BertConfig, FLMRModelConfig,
                                    FLMRRetriever, flax_to_state_dict)
from ravqa_tpu_torch.tokenization import (DocTokenizer, QueryTokenizer,
                                          WordPieceTokenizer, make_tiny_vocab)

WORDS = ["cat", "dog", "sun", "sky", "tree", "fish", "rock", "bird", "red",
         "blue", "what", "is", "a", "the", "big", "small"]
LR = 3e-3


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _texts(rng, n, lo=2, hi=9):
    return [" ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))
            for _ in range(n)]


def _write_world(tmp_path, seed=0, n_docs=20, n_q=11):
    """collection.tsv (pids P<i>, some rows titled, one malformed line),
    queries.tsv, triples.jsonl (string pids, int pids that are positions,
    scored rows) and triples.tsv."""
    rng = np.random.default_rng(seed)
    passages = _texts(rng, n_docs, 4, 12)
    titles = ["" if i % 3 else f"title {WORDS[i % len(WORDS)]}"
              for i in range(n_docs)]
    col = tmp_path / "collection.tsv"
    col.write_text("".join(f"P{i}\t{p}\t{t}\n" if t else f"P{i}\t{p}\n"
                           for i, (p, t) in enumerate(zip(passages, titles)))
                   + "no tab here\n")
    q = tmp_path / "queries.tsv"
    queries = _texts(rng, n_q)
    q.write_text("".join(f"{i}\t{t}\n" for i, t in enumerate(queries)))
    rows, scored = [], []
    for i in range(n_q):
        pids = rng.choice(n_docs, 3, replace=False)
        rows.append([str(i)] + [f"P{p}" if k % 2 == 0 else int(p)
                                for k, p in enumerate(pids)])
        scored.append([i] + [[f"P{p}", float(rng.normal())] for p in pids])
    for name, rs in (("triples.jsonl", rows), ("scored.jsonl", scored)):
        (tmp_path / name).write_text("".join(json.dumps(r) + "\n"
                                             for r in rs))
    (tmp_path / "triples.tsv").write_text("".join(
        "\t".join([str(i)] + [f"P{p}" for p in rng.choice(n_docs, 2,
                                                          replace=False)])
        + "\n" for i in range(n_q)))
    return {k: str(tmp_path / k) for k in
            ("collection.tsv", "queries.tsv", "triples.jsonl",
             "scored.jsonl", "triples.tsv")}


def _batches_equal(got, want, n):
    for _ in range(n):
        g, w = next(got, None), next(want, None)
        if w is None:
            assert g is None
            return
        assert g["queries"] == w["queries"] and g["docs"] == w["docs"]
        if w["target_scores"] is None:
            assert g["target_scores"] is None
        else:
            assert g["target_scores"].dtype == w["target_scores"].dtype
            np.testing.assert_array_equal(g["target_scores"],
                                          w["target_scores"])


def test_data_objects_identical(tmp_path):
    p = _write_world(tmp_path)
    col, jcol = (m.Collection.from_tsv(p["collection.tsv"])
                 for m in (cd, jcd))
    assert col.passages == jcol.passages and col.pids == jcol.pids
    assert len(col) == len(jcol) and col[3] == jcol[3]
    assert col.passages[0].startswith("title ")
    for bsize, nranks in ((4, 1), (3, 2), (7, 3)):
        for rank in range(nranks):
            assert list(col.enumerate_batches(bsize, rank, nranks)) == \
                list(jcol.enumerate_batches(bsize, rank, nranks))
    qs, jqs = (m.Queries.from_tsv(p["queries.tsv"]) for m in (cd, jcd))
    assert qs.qid2text == jqs.qid2text and list(qs.items()) == \
        list(jqs.items()) and len(qs) == len(jqs)
    for name, reader in (("triples.jsonl", "from_jsonl"),
                         ("scored.jsonl", "from_jsonl"),
                         ("triples.tsv", "from_tsv")):
        tr = getattr(cd.Triples, reader)(p[name])
        jtr = getattr(jcd.Triples, reader)(p[name])
        assert tr.rows == jtr.rows and len(tr) == len(jtr)
        for kw in (dict(bsize=4, nway=2), dict(bsize=3, nway=3, seed=5),
                   dict(bsize=2, nway=2, shuffle=False),
                   dict(bsize=5, nway=2, epochs=2)):
            _batches_equal(tr.batches(qs, col, **kw),
                           jtr.batches(jqs, jcol, **kw), 12)
    # a batch carries target scores (bsize, nway) only with scored rows
    b = next(cd.Triples.from_jsonl(p["scored.jsonl"]).batches(
        qs, col, bsize=4, nway=3))
    assert b["target_scores"].shape == (4, 3)
    assert next(cd.Triples.from_jsonl(p["triples.jsonl"]).batches(
        qs, col, bsize=4))["target_scores"] is None
    # 11 rows at bsize 4: two batches an epoch, the tail dropped
    assert len(list(cd.Triples.from_jsonl(p["triples.jsonl"]).batches(
        qs, col, bsize=4, epochs=1))) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_helpers_identical(seed):
    rng = np.random.default_rng(seed)
    docs = _texts(rng, 6, 0, 30) + [""]
    for max_words, overlap in ((4, 0), (5, 2), (180, 0), (3, 3), (7, 9)):
        assert cd.docs_to_passages(docs, max_words, overlap) == \
            jcd.docs_to_passages(docs, max_words, overlap)
    ids = [f"p{i}" for i in range(30)]
    retrieved = [list(rng.choice(ids, int(rng.integers(0, 12)),
                                 replace=False)) for _ in range(10)]
    pos = [list(rng.choice(ids, int(rng.integers(0, 3)), replace=False))
           for _ in range(10)]
    for n_neg in (1, 2, 5):
        for s in (0, 7):
            assert cd.create_triples_from_ranking(
                retrieved, pos, list(range(10)), n_neg, s) == \
                jcd.create_triples_from_ranking(
                    retrieved, pos, list(range(10)), n_neg, s)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def _tokenizers():
    tok = WordPieceTokenizer(make_tiny_vocab(WORDS))
    jtok = JaxWordPiece(jax_tiny_vocab(WORDS))
    return ((QueryTokenizer(tok, 8), DocTokenizer(tok, 12)),
            (JaxQueryTokenizer(jtok, 8), JaxDocTokenizer(jtok, 12)),
            tok.vocab_size + 8)


def _cfg(vocab, **kw):
    return FLMRModelConfig.tiny(bert=BertConfig.tiny(vocab_size=vocab),
                                query_mode="text_only", dim=16, **kw)


def _jax_cfg(cfg):
    fields = {f.name for f in dataclasses.fields(jflmr.FLMRModelConfig)}
    kw = {k: v for k, v in dataclasses.asdict(cfg).items()
          if k in fields and k != "bert"}
    return jflmr.FLMRModelConfig(
        bert=jflmr.BertConfig(**dataclasses.asdict(cfg.bert)), **kw)


def _executors(cfg, distill, vocab, tokenizers):
    (qt, dt), (jqt, jdt), _ = tokenizers
    jm = jflmr.FLMRRetriever(_jax_cfg(cfg))
    ones = lambda *s: jnp.ones(s, jnp.int32)  # noqa: E731
    params = jm.init(jax.random.PRNGKey(0), query_input_ids=ones(2, 8),
                     query_attention_mask=ones(2, 8),
                     doc_input_ids=ones(2 * cfg.nway, 12),
                     doc_attention_mask=ones(2 * cfg.nway, 12))["params"]
    jex = JaxTriplesExecutor(jm, params, JaxTrainConfig(lr=LR), quiet=True,
                             distill_weight=distill, query_tokenizer=jqt,
                             doc_tokenizer=jdt)
    model = FLMRRetriever(cfg)
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    tex = TriplesExecutor(model, TrainConfig(lr=LR), device="cpu",
                          quiet=True, distill_weight=distill,
                          query_tokenizer=qt, doc_tokenizer=dt)
    return jex, tex


def _world_objects(tmp_path, scored):
    p = _write_world(tmp_path, seed=3)
    pair = []
    for m in (cd, jcd):
        tr = m.Triples.from_jsonl(p["scored.jsonl" if scored
                                    else "triples.jsonl"])
        pair.append((tr, m.Queries.from_tsv(p["queries.tsv"]),
                     m.Collection.from_tsv(p["collection.tsv"])))
    return pair


LOSS_CASES = {"nway": (0.0, False, 2), "nway_ib": (0.0, True, 2),
              "distill": (0.5, False, 3), "distill_ib": (1.0, True, 3)}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_grads_match_jax(tmp_path, case):
    distill, ib, nway = LOSS_CASES[case]
    toks = _tokenizers()
    cfg = _cfg(toks[2], use_ib_negatives=ib, nway=nway)
    jex, tex = _executors(cfg, distill, toks[2], toks)
    (tr, qs, col), (jtr, jqs, jcol) = _world_objects(tmp_path, True)
    raw = next(tr.batches(qs, col, bsize=3, nway=nway))
    jraw = next(jtr.batches(jqs, jcol, bsize=3, nway=nway))
    batch, jbatch = tex.make_batch(raw), jex.make_batch(jraw)
    assert batch.keys() == jbatch.keys()
    for k in batch:
        np.testing.assert_array_equal(batch[k], np.asarray(jbatch[k]),
                                      err_msg=k)

    def jloss(p):
        return jex.loss_fn(p, jbatch, None)

    (jl, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jex.state.params)
    loss, metrics = tex.loss_fn(batch)
    loss.backward()
    assert metrics.keys() == jmetrics.keys()
    assert ("distill_kl" in metrics) == (distill > 0)
    assert ("ib_loss" in metrics) == ib
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5,
                               atol=1e-5)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    want = flax_to_state_dict(jax.device_get(jgrads))
    names = dict(tex.model.named_parameters())
    assert set(want) == set(names)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        got = names[name].grad
        got = torch.zeros_like(g) if got is None else got
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("distill", [0.0, 1.0])
def test_train_on_triples_trajectory_matches_jax(tmp_path, distill):
    """6 train_step calls on the same Triples batches from the same
    parameters, then train_on_triples for 6 more from there."""
    toks = _tokenizers()
    cfg = _cfg(toks[2], use_ib_negatives=True, nway=2)
    jex, tex = _executors(cfg, distill, toks[2], toks)
    (tr, qs, col), (jtr, jqs, jcol) = _world_objects(tmp_path, True)
    batches = tr.batches(qs, col, bsize=3, nway=2)
    jbatches = jtr.batches(jqs, jcol, bsize=3, nway=2)
    keys = ["loss", "nway_loss", "ib_loss", "grad_norm"] + (
        ["distill_kl"] if distill else [])
    for step in range(6):
        tm = tex.train_step(tex.make_batch(next(batches)))
        jm = jex.train_step(jex.make_batch(next(jbatches)))
        assert set(tm) == set(jm), step
        for key in keys:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {step} {key}")
    last = tex.train_on_triples(tr, qs, col, bsize=3, steps=6)
    jlast = jex.train_on_triples(jtr, jqs, jcol, bsize=3, steps=6)
    for key in keys:
        np.testing.assert_allclose(last[key], jlast[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    assert tex.step == 12
    want = flax_to_state_dict(jax.device_get(jex.state.params))
    for name, p in tex.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=12 * 2 * LR, err_msg=name)
