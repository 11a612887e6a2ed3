"""Retrieval metrics: pseudo-relevance (string match), ground-truth
Recall/Precision@K, and the exact match of generated answers.

The port's own copy of pseudo_relevance_scores, positive_id_scores and
exact_match from ravqa_tpu/metrics/retrieval_metrics.py (:1-86; reference
metrics_processors.py:481-604): a top-K passage "hits" if any answer string
appears (case-insensitive substring) in its content; recall@K is the share
of questions with a hit in the top K, precision@K the hits over K averaged
over questions; gold_* variants use the single gold answer. Ground truth:
a hit iff the retrieved passage id is one of pos_item_ids. exact_match:
the share of predictions equal to one of their answers, both stripped and
lowercased. tests/test_torch_eval.py and tests/test_torch_rag_train.py
hold the copies to the originals.
"""

from __future__ import annotations

from typing import Sequence


def pseudo_relevance_scores(
    retrieved_contents: Sequence[Sequence[str]],
    answers: Sequence[Sequence[str]],
    ks: Sequence[int],
    gold_answers: Sequence[str] | None = None,
    add_null_document: bool = False,
) -> dict[str, float]:
    """retrieved_contents[i] = top-maxK passage texts for question i.

    add_null_document: the reference module flag (metrics_processors.py:225)
    — position 0 holds an inserted null document; drop it before scoring.
    """
    if add_null_document:
        retrieved_contents = [c[1:] for c in retrieved_contents]
    n = len(retrieved_contents)
    out = {f"recall_at_{k}": 0.0 for k in ks}
    out.update({f"precision_at_{k}": 0.0 for k in ks})
    if gold_answers is not None:
        out.update({f"gold_recall_at_{k}": 0.0 for k in ks})
        out.update({f"gold_precision_at_{k}": 0.0 for k in ks})
    for i in range(n):
        contents = [c.lower() for c in retrieved_contents[i]]
        ans = [a.lower() for a in answers[i]]
        hits = [any(a in c for a in ans) for c in contents]
        gold_hits = None
        if gold_answers is not None:
            g = gold_answers[i].lower()
            gold_hits = [g in c for c in contents]
        for k in ks:
            nh = sum(hits[:k])
            out[f"recall_at_{k}"] += float(nh > 0)
            out[f"precision_at_{k}"] += nh / k
            if gold_hits is not None:
                ngh = sum(gold_hits[:k])
                out[f"gold_recall_at_{k}"] += float(ngh > 0)
                out[f"gold_precision_at_{k}"] += ngh / k
    return {name: v / max(n, 1) for name, v in out.items()}


def positive_id_scores(
    retrieved_ids: Sequence[Sequence],
    pos_item_ids: Sequence[Sequence],
    ks: Sequence[int],
    field: str = "pos_item_ids",
) -> dict[str, float]:
    """Ground-truth Recall/Precision@K against positive passage ids."""
    n = len(retrieved_ids)
    out = {f"{field}_recall_at_{k}": 0.0 for k in ks}
    out.update({f"{field}_precision_at_{k}": 0.0 for k in ks})
    for i in range(n):
        pos = set(pos_item_ids[i])
        hits = [rid in pos for rid in retrieved_ids[i]]
        for k in ks:
            nh = sum(hits[:k])
            out[f"{field}_recall_at_{k}"] += float(nh > 0)
            out[f"{field}_precision_at_{k}"] += nh / k
    return {name: v / max(n, 1) for name, v in out.items()}


def exact_match(predictions: Sequence[str], answers: Sequence[Sequence[str]],
                normalize=lambda s: s.strip().lower()) -> float:
    """EM over multiple acceptable answers (reference compute_exact_match)."""
    n = len(predictions)
    hit = sum(
        any(normalize(p) == normalize(a) for a in ans)
        for p, ans in zip(predictions, answers))
    return hit / max(n, 1)
