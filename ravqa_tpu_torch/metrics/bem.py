"""EVQA answer equivalence (BEM) scoring.

The port's own copy of ravqa_tpu/metrics/bem.py. The reference scores
Encyclopedic-VQA answers with the TF-Hub BEM model (BERT answer
equivalence; src/tools/evaluation_utils.py:282-371): its inputs are

    [CLS] candidate [SEP] reference [SEP] question [SEP]

with segment ids 0/1/2 per segment, padded to 512; the score is
softmax(logits)[1], thresholded at 0.5. A list-type reference has its
'&&' replaced by ',' first.

The parts are injected, so it runs offline: `tokenizer` is any object with
encode(text, add_special_tokens=False) and cls/sep token ids, and
`bem_model` any callable({"input_ids", "segment_ids"}) -> (B, 2) logits: a
numpy function, or a torch module (make_bem_scorer moves the ids to the
module's device and brings the logits back). Without tensorflow_hub (and
the network) initialize_bem_scoring_function falls back to normalized
exact/substring match, as the JAX package does. tests/test_torch_bem.py
holds the copy to the original.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from .vqa import normalize_answer

BEM_MAX_LEN = 512


def _fallback_scoring(question: str, reference: str,
                      candidate: str) -> float:
    r, c = normalize_answer(reference), normalize_answer(candidate)
    if not r or not c:
        return 0.0
    if r == c:
        return 1.0
    if r in c or c in r:
        return 0.5
    return 0.0


def bertify_example(question: str, reference: str, candidate: str,
                    tokenizer, max_len: int = BEM_MAX_LEN):
    """-> (input_ids (max_len,), segment_ids (max_len,)) int32: [CLS]
    candidate [SEP] reference [SEP] question [SEP], segments 0/1/2, cut to
    max_len and zero-padded (evaluation_utils.py:308-335)."""
    cls_id = tokenizer.cls_token_id
    sep_id = tokenizer.sep_token_id
    segs = [tokenizer.encode(t, add_special_tokens=False)
            for t in (candidate, reference, question)]
    ids = [cls_id]
    seg_ids = [0]
    for i, seg in enumerate(segs):
        ids.extend(list(seg) + [sep_id])
        seg_ids.extend([i] * (len(seg) + 1))
    ids = ids[:max_len]
    seg_ids = seg_ids[:max_len]
    out_ids = np.zeros((max_len,), np.int32)
    out_seg = np.zeros((max_len,), np.int32)
    out_ids[:len(ids)] = ids
    out_seg[:len(seg_ids)] = seg_ids
    return out_ids, out_seg


def _as_numpy_model(bem_model) -> Callable:
    """A torch module takes its inputs as int64 tensors on its own device
    and gives numpy logits; any other callable is used as it is."""
    import torch
    if not isinstance(bem_model, torch.nn.Module):
        return bem_model
    param = next(bem_model.parameters(), None)
    device = param.device if param is not None else torch.device("cpu")

    @torch.inference_mode()
    def run(inputs):
        out = bem_model({k: torch.as_tensor(v, dtype=torch.long,
                                            device=device)
                         for k, v in inputs.items()})
        return out.detach().float().cpu().numpy()
    return run


def make_bem_scorer(bem_model: Callable, tokenizer,
                    threshold: Optional[float] = None,
                    max_len: int = BEM_MAX_LEN):
    """scoring_fn(question, reference, candidate) -> [0, 1] from a logits
    model. threshold None returns the softmax probability; a float applies
    the reference's >= threshold binarization (evaluation_utils.py:365)."""
    model = _as_numpy_model(bem_model)

    def score(question: str, reference: str, candidate: str) -> float:
        reference = reference.replace("&&", ",")
        if not reference:
            raise ValueError("Reference answer cannot be empty.")
        ids, segs = bertify_example(question, reference, candidate,
                                    tokenizer, max_len)
        logits = np.asarray(model({
            "input_ids": ids[None], "segment_ids": segs[None]}))
        logits = np.squeeze(logits)
        e = np.exp(logits - logits.max())
        p = float((e / e.sum())[1])
        if threshold is not None:
            return float(p >= threshold)
        return p

    return score


def initialize_bem_scoring_function(
        model_url: str = "https://tfhub.dev/google/answer_equivalence/bem/1",
        tokenizer=None,
        bem_model: Optional[Callable] = None,
        threshold: Optional[float] = None,
) -> Callable[[str, str, str], float]:
    """Returns scoring_fn(question, reference, candidate) -> [0, 1].

    With bem_model and tokenizer: fully offline. Otherwise it tries the
    TF-Hub BEM model (tensorflow_hub and the network), and falls back to
    the normalized-match scoring with a warning."""
    if bem_model is not None and tokenizer is not None:
        return make_bem_scorer(bem_model, tokenizer, threshold=threshold)
    try:  # pragma: no cover - needs tensorflow_hub and the network
        import tensorflow_hub as hub
        hub_model = hub.load(model_url)
        if tokenizer is None:
            raise ValueError(
                "pass a tokenizer built from the BEM vocab "
                "(e.g. WordPieceTokenizer(vocab_path))")

        def tf_model(inputs):
            import tensorflow as tf
            return hub_model({
                "input_ids": tf.convert_to_tensor(inputs["input_ids"]),
                "segment_ids": tf.convert_to_tensor(
                    inputs["segment_ids"])}).numpy()
        return make_bem_scorer(tf_model, tokenizer, threshold=threshold)
    except Exception:
        import logging
        logging.getLogger(__name__).warning(
            "BEM model unavailable; using normalized-match fallback")
        return _fallback_scoring


def evqa_score_example(question: str, references: Sequence[str],
                       candidate: str,
                       bem_scoring_fn: Callable[[str, str, str], float],
                       question_type: str = "single") -> float:
    """Encyclopedic-VQA evaluation (evaluation_utils.py:374+): exact match
    first; BEM only where it fails."""
    norm_c = normalize_answer(candidate)
    for r in references:
        if normalize_answer(r) == norm_c:
            return 1.0
    return max((bem_scoring_fn(question, r, candidate)
                for r in references if r), default=0.0)


def evqa_accuracy(predictions: Sequence[str],
                  answers: Sequence[Sequence[str]],
                  questions: Sequence[str],
                  scoring_fn: Callable | None = None,
                  threshold: float = 0.5) -> float:
    """EVQA accuracy: a prediction counts if its best equivalence score
    over the reference answers reaches `threshold`."""
    fn = scoring_fn or _fallback_scoring
    n = len(predictions)
    hit = 0
    for pred, ans, q in zip(predictions, answers, questions):
        if max((fn(q, a, pred) for a in ans), default=0.0) >= threshold:
            hit += 1
    return hit / max(n, 1)
