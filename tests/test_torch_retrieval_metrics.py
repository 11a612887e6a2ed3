"""The port's ColBERT ranking and answer metrics against the JAX
package's (ravqa_tpu/metrics/retrieval_metrics.py:88-288): the same
numpy-seeded rankings, answers and files through both; every number equal
and every file byte-equal."""

import numpy as np
import pytest

from ravqa_tpu.metrics import retrieval_metrics as jax_rm
from ravqa_tpu_torch import metrics as port_metrics
from ravqa_tpu_torch.metrics import retrieval_metrics as rm

WORDS = ["cat", "dog", "sun", "sky", "tree", "fish", "red", "blue", "big"]


def _world(seed, n_q=12, n_docs=40, depth=25):
    rng = np.random.default_rng(seed)
    qids = [f"q{i}" for i in range(n_q)]
    ranked = [[f"p{j}" for j in rng.permutation(n_docs)[:depth]]
              for _ in qids]
    scores = [sorted(rng.normal(size=depth).tolist(), reverse=True)
              for _ in qids]
    pos = [[f"p{j}" for j in rng.choice(n_docs, int(rng.integers(0, 3)),
                                        replace=False)] for _ in qids]
    passages = [" ".join(rng.choice(WORDS, 6)) for _ in range(n_docs)]
    answers = {q: [" ".join(rng.choice(WORDS, int(rng.integers(1, 3))))
                   for _ in range(2)] for q in qids}
    return qids, ranked, scores, pos, passages, answers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranking_metrics_equal(seed):
    _, ranked, _, pos, _, _ = _world(seed)
    for k in (1, 5, 10, 50):
        assert rm.mrr_at_k(ranked, pos, k) == jax_rm.mrr_at_k(ranked, pos, k)
        assert rm.success_at_k(ranked, pos, k) == \
            jax_rm.success_at_k(ranked, pos, k)
    assert rm.mrr_at_k([], []) == jax_rm.mrr_at_k([], []) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_ranking_tsv_and_msmarco_evaluation_equal(tmp_path, seed):
    """save_ranking_tsv byte-equal; load_ranking_tsv, the MS MARCO
    evaluation against a qrels file and the answer annotation equal (its
    label file byte-equal); the evaluation's MRR@10 is mrr_at_k's over the
    judged queries."""
    qids, ranked, scores, pos, passages, answers = _world(seed)
    paths = {}
    for name, mod in (("port", rm), ("jax", jax_rm)):
        paths[name] = tmp_path / f"{name}.tsv"
        mod.save_ranking_tsv(str(paths[name]), qids, ranked, scores)
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    ranking = str(paths["port"])
    assert rm.load_ranking_tsv(ranking) == jax_rm.load_ranking_tsv(ranking)
    qrels = tmp_path / "qrels.tsv"
    qrels.write_text("".join(f"{q} 0 {p} 1\n" for q, ps in zip(qids, pos)
                             for p in ps))
    for kw in ({}, {"mrr_depth": 5, "recall_depths": (1, 10, 20)}):
        got = rm.evaluate_msmarco_ranking(ranking, str(qrels), **kw)
        assert got == jax_rm.evaluate_msmarco_ranking(ranking, str(qrels),
                                                      **kw)
    judged = [i for i, p in enumerate(pos) if p]
    got = rm.evaluate_msmarco_ranking(ranking, str(qrels))
    assert got["mrr@10"] == pytest.approx(rm.mrr_at_k(
        [ranked[i] for i in judged], [pos[i] for i in judged], 10),
        rel=1e-12)
    collection = {f"p{j}": t for j, t in enumerate(passages)}
    outs = {}
    for name, mod in (("port", rm), ("jax", jax_rm)):
        outs[name] = tmp_path / f"{name}.labels"
        r = mod.annotate_ranking_with_answers(ranking, collection, answers,
                                              str(outs[name]))
        outs[name + "_r"] = r
    assert outs["port_r"] == outs["jax_r"]
    assert outs["port"].read_bytes() == outs["jax"].read_bytes()
    listed = [t for t in passages]
    renum = tmp_path / "renum.tsv"
    rm.save_ranking_tsv(str(renum), qids,
                        [[int(p[1:]) for p in row] for row in ranked],
                        scores)
    assert rm.annotate_ranking_with_answers(str(renum), listed, answers) \
        == jax_rm.annotate_ranking_with_answers(str(renum), listed, answers)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_answer_metrics_equal(seed):
    """exact_match_with_numeric_ranges (strings, in-range numbers, bad
    numbers, no range) and bleu_score (several references, a short and an
    empty prediction)."""
    rng = np.random.default_rng(seed)
    preds, answers, ranges = [], [], []
    for i in range(20):
        kind = i % 4
        if kind == 0:
            a = str(rng.choice(WORDS))
            preds.append(a.upper() + " ")
            answers.append([a])
            ranges.append(None)
        elif kind == 1:
            v = float(rng.uniform(0, 100))
            preds.append(f"{v:.2f}")
            answers.append(["nope"])
            ranges.append([v - rng.uniform(-1, 1), v + 1.0])
        elif kind == 2:
            preds.append("not a number")
            answers.append(["x"])
            ranges.append([0.0, 1.0])
        else:
            preds.append(str(rng.choice(WORDS)))
            answers.append([str(rng.choice(WORDS))])
            ranges.append(None)
    assert rm.exact_match_with_numeric_ranges(preds, answers, ranges) == \
        jax_rm.exact_match_with_numeric_ranges(preds, answers, ranges)
    hyps = [" ".join(rng.choice(WORDS, int(rng.integers(0, 9))))
            for _ in range(15)]
    refs = [[" ".join(rng.choice(WORDS, int(rng.integers(1, 9))))
             for _ in range(int(rng.integers(1, 4)))] for _ in hyps]
    for n in (1, 2, 4):
        assert rm.bleu_score(hyps, refs, max_n=n) == \
            jax_rm.bleu_score(hyps, refs, max_n=n)
    assert rm.bleu_score(["the cat sat on the mat"],
                         [["the cat sat on the mat"]]) == pytest.approx(1.0)


def test_metrics_exports_match_jax():
    """metrics/__init__ exports what the JAX package's does."""
    from ravqa_tpu import metrics as jax_metrics
    assert set(jax_metrics.__all__) <= set(port_metrics.__all__)
