"""Retrieval metrics: pseudo-relevance (string match), ground-truth
Recall/Precision@K, the exact match of generated answers, and the ColBERT
ranking metrics.

The port's own copy of ravqa_tpu/metrics/retrieval_metrics.py (reference
metrics_processors.py:481-604 and ColBERT's utility/evaluate/):
- pseudo_relevance_scores: a top-K passage "hits" if any answer string
  appears (case-insensitive substring) in its content; recall@K is the
  share of questions with a hit in the top K, precision@K the hits over K
  averaged over questions; gold_* variants use the single gold answer;
- positive_id_scores: a hit iff the retrieved passage id is one of
  pos_item_ids;
- exact_match (stripped, lowercased), exact_match_with_numeric_ranges
  (Infoseek) and bleu_score (corpus BLEU-4);
- mrr_at_k, success_at_k, the ranking TSV (save_ranking_tsv /
  load_ranking_tsv), evaluate_msmarco_ranking against a qrels file, and
  annotate_ranking_with_answers (DPR-style answer containment).
tests/test_torch_eval.py, tests/test_torch_rag_train.py and
tests/test_torch_retrieval_metrics.py hold the copies to the originals.
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


def exact_match_with_numeric_ranges(
    predictions: Sequence[str],
    answers: Sequence[Sequence[str]],
    numeric_ranges: Sequence,
    normalize=lambda s: s.strip().lower(),
) -> float:
    """Infoseek EM (reference compute_exact_match_with_numeric_values,
    metrics_processors.py:128-182): correct if the normalized prediction is
    in the answer list OR parses to a float within [lo, hi]."""
    n = len(predictions)
    hits = 0
    for pred, ans, rng in zip(predictions, answers, numeric_ranges):
        p = normalize(pred)
        correct = p in [normalize(a) for a in ans]
        if not correct and rng is not None:
            try:
                v = float(p)
                correct = rng[0] <= v <= rng[1]
            except ValueError:
                pass
        hits += int(correct)
    return hits / max(n, 1)


def bleu_score(predictions: Sequence[str],
               references: Sequence[Sequence[str]],
               max_n: int = 4) -> float:
    """Corpus BLEU-4 with +0-smoothing and brevity penalty (reference
    compute_BLEU_scores, metrics_processors.py:605; whitespace tokens)."""
    import math
    from collections import Counter

    def ngrams(tokens, n):
        return Counter(tuple(tokens[i:i + n])
                       for i in range(len(tokens) - n + 1))

    clipped = [0] * max_n
    totals = [0] * max_n
    pred_len, ref_len = 0, 0
    for pred, refs in zip(predictions, references):
        pt = pred.lower().split()
        rts = [r.lower().split() for r in refs]
        pred_len += len(pt)
        ref_len += min((abs(len(r) - len(pt)), len(r)) for r in rts)[1]
        for n in range(1, max_n + 1):
            pc = ngrams(pt, n)
            maxr: Counter = Counter()
            for rt in rts:
                rc = ngrams(rt, n)
                for g, c in rc.items():
                    maxr[g] = max(maxr[g], c)
            totals[n - 1] += max(len(pt) - n + 1, 0)
            clipped[n - 1] += sum(min(c, maxr[g]) for g, c in pc.items())
    if min(totals) == 0:
        return 0.0
    # epsilon smoothing so a missing high-order n-gram doesn't zero the score
    log_p = sum(math.log(max(c, 1e-9) / t)
                for c, t in zip(clipped, totals)) / max_n
    bp = 1.0 if pred_len > ref_len else math.exp(1 - ref_len /
                                                 max(pred_len, 1))
    return bp * math.exp(log_p)


def mrr_at_k(retrieved_ids: Sequence[Sequence],
             pos_item_ids: Sequence[Sequence], k: int = 10) -> float:
    """Mean reciprocal rank@k (ColBERT evaluation/metrics.py MRR@10)."""
    total = 0.0
    for row, pos in zip(retrieved_ids, pos_item_ids):
        ps = set(pos)
        for rank, rid in enumerate(row[:k], start=1):
            if rid in ps:
                total += 1.0 / rank
                break
    return total / max(len(retrieved_ids), 1)


def success_at_k(retrieved_ids: Sequence[Sequence],
                 pos_item_ids: Sequence[Sequence], k: int) -> float:
    """Success@k: fraction of queries with >=1 positive in top k."""
    hit = sum(bool(set(row[:k]) & set(pos))
              for row, pos in zip(retrieved_ids, pos_item_ids))
    return hit / max(len(retrieved_ids), 1)


def save_ranking_tsv(path: str, query_ids: Sequence,
                     retrieved_ids: Sequence[Sequence],
                     scores: Sequence[Sequence]) -> None:
    """ColBERT Ranking flat-TSV dump (qid \\t pid \\t rank \\t score)."""
    with open(path, "w") as f:
        for qid, row, ss in zip(query_ids, retrieved_ids, scores):
            for rank, (pid, s) in enumerate(zip(row, ss), start=1):
                f.write(f"{qid}\t{pid}\t{rank}\t{float(s)}\n")


def load_ranking_tsv(path: str) -> dict:
    """qid -> [(rank, pid, score|None)] sorted by rank."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            qid, pid, rank, *score = line.strip().split("\t")
            out.setdefault(qid, []).append(
                (int(rank), pid, float(score[0]) if score else None))
    for rows in out.values():
        rows.sort()
    return out


def evaluate_msmarco_ranking(ranking_path: str, qrels_path: str,
                             mrr_depth: int = 10,
                             recall_depths: Sequence[int] = (50, 200, 1000),
                             ) -> dict:
    """MS-MARCO-style ranking evaluation (reference
    utility/evaluate/msmarco_passages.py): MRR@depth + recall@depths from a
    ColBERT ranking TSV against a qrels file (`qid 0 pid 1` rows)."""
    qid2pos: dict = {}
    with open(qrels_path) as f:
        for line in f:
            qid, _, pid, label = line.split()
            assert int(label) == 1
            qid2pos.setdefault(qid, set()).add(pid)
    qid2ranking = load_ranking_tsv(ranking_path)
    n = len(qid2pos)
    mrr = 0.0
    recall = {d: 0.0 for d in recall_depths}
    for qid, pos in qid2pos.items():
        ranking = qid2ranking.get(qid, [])
        for rank, pid, _ in ranking[:mrr_depth]:
            if pid in pos:
                mrr += 1.0 / rank
                break
        for d in recall_depths:
            found = {pid for rank, pid, _ in ranking[:d]} & pos
            recall[d] += len(found) / max(len(pos), 1)
    out = {f"mrr@{mrr_depth}": mrr / max(n, 1),
           "num_judged_queries": n,
           "num_ranked_queries": len(qid2ranking)}
    out.update({f"recall@{d}": v / max(n, 1) for d, v in recall.items()})
    return out


def _tokens(text: str) -> list[str]:
    return text.lower().split()


def _has_answer(answer_token_lists, passage: str) -> bool:
    """DPR-style containment: any answer's token sequence appears as a
    contiguous sublist of the passage tokens (reference
    utility/utils/dpr.py has_answer via annotate_EM_helpers)."""
    ptoks = _tokens(passage)
    for ans in answer_token_lists:
        if not ans:
            continue
        n = len(ans)
        for s in range(len(ptoks) - n + 1):
            if ptoks[s:s + n] == ans:
                return True
    return False


def annotate_ranking_with_answers(
    ranking_path: str,
    collection: Sequence[str],
    qid2answers: dict,
    output_path: str | None = None,
    cutoffs: Sequence = (1, 5, 10, 20, 30, 50, 100, 1000, "all"),
) -> dict:
    """Annotate a ranking with exact-match answer presence and compute
    Success@k / answer counts (reference utility/evaluate/annotate_EM.py).

    collection: pid -> passage text (list indexed by int pid, or dict).
    Writes `qid \\t pid \\t rank \\t label` when output_path is given.
    Returns {"success": {cutoff: frac}, "counts": {cutoff: mean#hits}}.
    """
    qid2ranking = load_ranking_tsv(ranking_path)
    tok_answers = {qid: [_tokens(a) for a in answers]
                   for qid, answers in qid2answers.items()}

    def passage_of(pid):
        if isinstance(collection, dict):
            return collection[pid]
        return collection[int(pid)]

    success = {c: 0.0 for c in cutoffs}
    counts = {c: 0.0 for c in cutoffs}
    n = len(qid2answers)
    lines = []
    for qid, answers in tok_answers.items():
        ranking = qid2ranking.get(qid, [])
        labels = [_has_answer(answers, passage_of(pid))
                  for _, pid, _ in ranking]
        for (rank, pid, _), lab in zip(ranking, labels):
            lines.append(f"{qid}\t{pid}\t{rank}\t{int(lab)}")
        for c in cutoffs:
            top = labels if c == "all" else labels[:c]
            success[c] += float(any(top))
            counts[c] += float(sum(top))
    if output_path is not None:
        with open(output_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return {"success": {c: v / max(n, 1) for c, v in success.items()},
            "counts": {c: v / max(n, 1) for c, v in counts.items()}}
