"""The port's BEM answer-equivalence scoring against the JAX package's
(ravqa_tpu/metrics/bem.py): the BEM inputs identical, and every score equal
with a mock numpy model, a mock torch module (the same logits) and the
offline fallback; EVQA exact-match-then-BEM and accuracy equal."""

import numpy as np
import pytest
import torch

from ravqa_tpu.metrics import bem as jax_bem
from ravqa_tpu.tokenization import WordPieceTokenizer as JaxTok
from ravqa_tpu.tokenization import make_tiny_vocab as jax_vocab
from ravqa_tpu_torch.metrics import bem
from ravqa_tpu_torch.tokenization import WordPieceTokenizer, make_tiny_vocab

WORDS = ["what", "is", "the", "cat", "a", "big", "feline", "animal", "dog",
         "red", "car", "two", "2"]
TOK = WordPieceTokenizer(make_tiny_vocab(WORDS))
JTOK = JaxTok(jax_vocab(WORDS))


def _weights():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(TOK.vocab_size + 8, 2)).astype(np.float32),
            rng.normal(size=(3, 2)).astype(np.float32))


def numpy_bem(inputs):
    """(B, 2) logits: mean of per-token and per-segment embeddings over the
    non-pad positions."""
    emb, seg = _weights()
    ids, segs = inputs["input_ids"], inputs["segment_ids"]
    keep = (ids != 0)[..., None]
    x = (emb[ids] + seg[segs]) * keep
    return x.sum(1) / keep.sum(1)


class TorchBem(torch.nn.Module):
    """numpy_bem as a torch module: takes {"input_ids", "segment_ids"}
    tensors on its own device."""

    def __init__(self):
        super().__init__()
        emb, seg = _weights()
        self.emb = torch.nn.Parameter(torch.tensor(emb))
        self.seg = torch.nn.Parameter(torch.tensor(seg))

    def forward(self, inputs):
        ids, segs = inputs["input_ids"], inputs["segment_ids"]
        keep = (ids != 0)[..., None].float()
        x = (self.emb[ids] + self.seg[segs]) * keep
        return x.sum(1) / keep.sum(1)


EXAMPLES = [("what is the cat", "a feline", "a cat"),
            ("what is the cat", "feline && animal", "the big cat"),
            ("what is it", "red car", "a red car"),
            ("how many", "2", "two"),
            ("q", "dog", "dog"),
            ("q", "dog", "")]


@pytest.mark.parametrize("max_len", [8, 32, 512])
def test_bertify_identical(max_len):
    for q, r, c in EXAMPLES:
        got = bem.bertify_example(q, r, c, TOK, max_len)
        want = jax_bem.bertify_example(q, r, c, JTOK, max_len)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("threshold", [None, 0.5])
def test_scores_equal_numpy_and_torch_models(threshold):
    want = jax_bem.make_bem_scorer(numpy_bem, JTOK, threshold=threshold)
    for model in (numpy_bem, TorchBem()):
        got = bem.make_bem_scorer(model, TOK, threshold=threshold)
        via_init = bem.initialize_bem_scoring_function(
            bem_model=model, tokenizer=TOK, threshold=threshold)
        for q, r, c in EXAMPLES:
            w = want(q, r, c)
            assert got(q, r, c) == pytest.approx(w, rel=1e-6, abs=1e-7)
            assert via_init(q, r, c) == pytest.approx(w, rel=1e-6, abs=1e-7)
    with pytest.raises(ValueError):
        bem.make_bem_scorer(numpy_bem, TOK)("q", "", "c")


def test_fallback_evqa_and_accuracy():
    """Without tensorflow_hub both packages take the normalized-match
    fallback; EVQA's exact match first, then BEM; accuracy at 0.5 and
    0.6."""
    fb = bem.initialize_bem_scoring_function()
    jfb = jax_bem.initialize_bem_scoring_function()
    for q, r, c in EXAMPLES + [("q", "the cat", "cat"),
                               ("q", "cats", "a cat sat")]:
        assert fb(q, r, c) == jfb(q, r, c) == jax_bem._fallback_scoring(
            q, r, c)
    spy = bem.make_bem_scorer(numpy_bem, TOK)
    jspy = jax_bem.make_bem_scorer(numpy_bem, JTOK)
    for q, r, c in EXAMPLES:
        refs = [r, "", "dog"]
        assert bem.evqa_score_example(q, refs, c, spy) == pytest.approx(
            jax_bem.evqa_score_example(q, refs, c, jspy), rel=1e-6)
    preds = [c for _, _, c in EXAMPLES]
    answers = [[r, "x"] for _, r, _ in EXAMPLES]
    questions = [q for q, _, _ in EXAMPLES]
    for fn, jfn in ((None, None), (spy, jspy)):
        for threshold in (0.5, 0.6):
            assert bem.evqa_accuracy(preds, answers, questions, fn,
                                     threshold) == \
                jax_bem.evqa_accuracy(preds, answers, questions, jfn,
                                      threshold)
