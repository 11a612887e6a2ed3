"""Data transforms for the retrieval serving slice.

Ports of ravqa_tpu/data/transforms.py:
- SyntheticOKVQA (:314-357): the synthetic world (word-bag passages,
  questions repeating words of their positive passage, random image
  features); from the same seed it gives the same corpus, questions and
  features as the JAX package. Patch features and raw pixels come with the
  vision towers (ROADMAP.md A11).
- PrepareDataloaders (:360-394), its tokenizer and corpus part: the
  WordPiece base tokenizer (the tiny synthetic vocab when no vocab_path),
  the ColBERT query and doc tokenizers, and the passages. The question
  items pass through under "items" ({split: [item dict]}); the training
  datasets come with the trainer (ROADMAP.md A8).
"""

from __future__ import annotations

import numpy as np

from ..tokenization import (DocTokenizer, QueryTokenizer,
                            WordPieceTokenizer, make_tiny_vocab)
from .datasets import PassageCorpus
from .pipeline import BaseTransform, register_transform


@register_transform
class SyntheticOKVQA(BaseTransform):
    """setup: n_docs=64, n_questions=32, vision_dim=16, seed=0."""

    WORDS = ["cat", "dog", "sky", "sun", "tree", "fish", "bird", "car",
             "red", "blue", "big", "old", "hot", "wet", "sad", "fast",
             "tall", "round", "green", "small"]

    def __call__(self, *inputs):
        n_docs = getattr(self, "n_docs", 64)
        n_q = getattr(self, "n_questions", 32)
        vdim = getattr(self, "vision_dim", 16)
        rng = np.random.default_rng(getattr(self, "seed", 0))
        contents = [" ".join(rng.choice(self.WORDS, 5, replace=False))
                    for _ in range(n_docs)]
        corpus = PassageCorpus([f"GS_{i}" for i in range(n_docs)], contents)
        items = []
        for i in range(n_q):
            d = i % n_docs
            words = contents[d].split()
            items.append({
                "question_id": str(i),
                "question": " ".join(words[:3]),
                "image_id": i,
                "answers": [words[0]] * 10,
                "gold_answer": words[0],
                "pos_item_ids": [f"GS_{d}"],
                "pos_item_contents": [contents[d]],
                "image_features": rng.normal(size=(vdim,)).astype(np.float32),
            })
        n_train = max(1, int(0.8 * n_q))
        return {"train": items[:n_train], "test": items[n_train:],
                "passages": {"train_passages": corpus,
                             "full_passages": corpus}}


@register_transform
class PrepareDataloaders(BaseTransform):
    """Terminal node: tokenizers + passages (+ question items).

    setup: query_maxlen, doc_maxlen, vocab_path (None -> tiny vocab),
    attend_to_mask_tokens."""

    def __call__(self, data):
        vocab_path = getattr(self, "vocab_path", None)
        base = WordPieceTokenizer(
            vocab_path if vocab_path else
            make_tiny_vocab(SyntheticOKVQA.WORDS))
        qt = QueryTokenizer(base,
                            query_maxlen=getattr(self, "query_maxlen", 32),
                            attend_to_mask_tokens=getattr(
                                self, "attend_to_mask_tokens", False))
        dt = DocTokenizer(base, doc_maxlen=getattr(self, "doc_maxlen", 220))
        items = {split: data[split] for split in ("train", "valid", "test")
                 if split in data}
        return {"tokenizer": base, "query_tokenizer": qt,
                "doc_tokenizer": dt, "passages": data["passages"],
                "items": items}
