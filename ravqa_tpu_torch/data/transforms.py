"""Data transforms for the retrieval slices.

Ports of ravqa_tpu/data/transforms.py:
- SyntheticOKVQA (:314-357): the synthetic world (word-bag passages,
  questions repeating words of their positive passage, random image
  features, and with `n_patches` random patch features, with
  `emit_pixels` random uint8 images in place of the features); from the
  same seed it gives the same corpus, questions, features and images as
  the JAX package.
- PrepareDataloaders (:360-394): the WordPiece base tokenizer (the tiny
  synthetic vocab when no vocab_path), the ColBERT query and doc
  tokenizers, the passages, and one RetrievalDataset per split ("valid"
  falls back to "test"), the JAX package's layout.
- LoadImageFeatures (:297-311): per-image features from an .npz store
  keyed by str(image_id), written into the items in place.
- LoadM2KRData (:397-434): an M2KR-style task from a passages jsonl and
  one queries jsonl per split, with optional per-question features.
"""

from __future__ import annotations

import json

import numpy as np

from ..tokenization import (DocTokenizer, QueryTokenizer,
                            WordPieceTokenizer, make_tiny_vocab)
from .datasets import PassageCorpus, RetrievalDataset
from .pipeline import BaseTransform, register_transform


@register_transform
class SyntheticOKVQA(BaseTransform):
    """setup: n_docs=64, n_questions=32, vision_dim=16, seed=0,
    n_patches=0 (> 0: (n_patches, vision_dim) patch features per question),
    emit_pixels=0 (> 0: an (S, S, 3) uint8 image per question, which then
    carries no image features: an in-graph ViT takes the pixels),
    features_with_pixels=False (True: an item with an image keeps its image
    features too, as the RAVQA-v2 recipe's data carry both: the features
    for FLMR's mapping network, the pixels for BLIP-2; not in the JAX
    package's copy, and off leaves every item as there)."""

    WORDS = ["cat", "dog", "sky", "sun", "tree", "fish", "bird", "car",
             "red", "blue", "big", "old", "hot", "wet", "sad", "fast",
             "tall", "round", "green", "small"]

    def __call__(self, *inputs):
        n_docs = getattr(self, "n_docs", 64)
        n_q = getattr(self, "n_questions", 32)
        vdim = getattr(self, "vision_dim", 16)
        n_patches = getattr(self, "n_patches", 0)
        pixels = getattr(self, "emit_pixels", 0)
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
            if n_patches:
                items[-1]["image_patch_features"] = rng.normal(
                    size=(n_patches, vdim)).astype(np.float32)
            if pixels:
                items[-1]["image"] = rng.integers(
                    0, 255, (pixels, pixels, 3)).astype(np.uint8)
                if not getattr(self, "features_with_pixels", False):
                    del items[-1]["image_features"]
        n_train = max(1, int(0.8 * n_q))
        return {"train": items[:n_train], "test": items[n_train:],
                "passages": {"train_passages": corpus,
                             "full_passages": corpus}}


@register_transform
class PrepareDataloaders(BaseTransform):
    """Terminal node: tokenizers + RetrievalDatasets.

    setup: query_maxlen, doc_maxlen, nway, vocab_path (None -> tiny vocab),
    attend_to_mask_tokens, input_modules (ModuleParser specs),
    use_self_negatives."""

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
        corpus = data["passages"]["full_passages"]
        train_corpus = data["passages"].get("train_passages", corpus)
        out = {"tokenizer": base, "query_tokenizer": qt, "doc_tokenizer": dt,
               "passages": data["passages"]}
        for split in ("train", "valid", "test"):
            items = data.get(split)
            if items is None and split == "valid":
                items = data.get("test")
            if items is None:
                continue
            out[split] = RetrievalDataset(
                items, train_corpus if split == "train" else corpus,
                qt, dt, nway=getattr(self, "nway", 2),
                input_modules=getattr(self, "input_modules", None),
                use_self_negatives=getattr(self, "use_self_negatives",
                                           False))
        return out


@register_transform
class LoadImageFeatures(BaseTransform):
    """Attach per-image features from a .npz store keyed by str(image_id).
    setup: features_path (npz), feature_key='image_features'."""

    def __call__(self, data):
        store = np.load(self.features_path)
        key = getattr(self, "feature_key", "image_features")
        for split, items in data.items():
            if not isinstance(items, list):
                continue
            for it in items:
                it[key] = store[str(it["image_id"])]
        return data


@register_transform
class LoadM2KRData(BaseTransform):
    """An M2KR-style task: a passages jsonl ({passage_id, passage_content})
    and a queries jsonl per split ({question_id, question, instruction?,
    pos_item_ids, answers?}), each row kept whole with its question_id as
    a string.

    setup: queries_path {split: jsonl}, passages_path (jsonl),
    features_path (optional npz keyed by question_id)."""

    def __call__(self, *inputs):
        pids, contents = [], []
        with open(self.passages_path) as f:
            for line in f:
                row = json.loads(line)
                pids.append(row["passage_id"])
                contents.append(row["passage_content"])
        corpus = PassageCorpus(pids, contents)
        feats = None
        if getattr(self, "features_path", None):
            feats = np.load(self.features_path)
        out = {"passages": {"train_passages": corpus,
                            "full_passages": corpus}}
        for split, path in self.queries_path.items():
            items = []
            with open(path) as f:
                for line in f:
                    it = dict(json.loads(line))
                    it["question_id"] = str(it["question_id"])
                    if feats is not None:
                        it["image_features"] = feats[it["question_id"]]
                    items.append(it)
            out[split] = items
        return out
