"""Datasets and batching for retrieval training and evaluation.

The port's own copy of ravqa_tpu/data/datasets.py (:24-161), host-only
numpy code (reference base_datasets.py:29-200, okvqa_datasets.py): each
retrieval sample expands to one sampled positive and nway-1 corpus-random
negatives (rejecting positives; `use_self_negatives` draws them from the
question's own annotated non-positive passages), drawn with the dataset's
own numpy generator; collate gives the fixed-shape numpy batch the model
takes (drop_last always, tokenizers pad to maxlen). tests/test_torch_eval.py
holds the collated batches to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

from ..tokenization import DocTokenizer, QueryTokenizer
from .module_parser import ModuleParser


def _attach_vision(batch: dict, items: Sequence[dict],
                   parsed: Optional[Sequence[dict]] = None) -> None:
    """Attach stacked vision features to a batch. Prefers the ModuleParser's
    VisionInput output (which applies the reference's ROI padding to a fixed
    row count, module_parser.py:154-178) over the raw item field, so
    variable-ROI-count items stack cleanly."""
    if parsed and "vision_features" in parsed[0]:
        batch["image_features"] = np.stack(
            [np.asarray(p["vision_features"], np.float32) for p in parsed])
    elif "image_features" in items[0]:
        batch["image_features"] = np.stack(
            [np.asarray(it["image_features"], np.float32) for it in items])
    if "image_patch_features" in items[0]:
        # PreFLMR transformer mapping input: (P, patch_dim) per item
        batch["image_patch_features"] = np.stack(
            [np.asarray(it["image_patch_features"], np.float32)
             for it in items])
    if "image" in items[0]:
        # raw pixels for in-graph vision encoders (FLMRWithVisionModel)
        batch["pixel_values"] = np.stack(
            [np.asarray(it["image"], np.float32) for it in items])




@dataclasses.dataclass
class PassageCorpus:
    ids: list            # passage ids (e.g. "GS_123")
    contents: list[str]
    id2pos: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.id2pos:
            self.id2pos = {pid: i for i, pid in enumerate(self.ids)}

    def __len__(self):
        return len(self.ids)

    def content_of(self, pid) -> str:
        return self.contents[self.id2pos[pid]]


class RetrievalDataset:
    """Items: dicts with question / image_features / pos_item_ids / answers.

    input_modules drive the query text (ModuleParser); docs come from the
    corpus with negative sampling.
    """

    def __init__(self, items: Sequence[dict], corpus: PassageCorpus,
                 query_tokenizer: QueryTokenizer,
                 doc_tokenizer: DocTokenizer, nway: int = 2,
                 input_modules: Optional[list[dict]] = None,
                 use_self_negatives: bool = False, seed: int = 0):
        self.items = list(items)
        self.corpus = corpus
        self.qt = query_tokenizer
        self.dt = doc_tokenizer
        self.nway = nway
        self.parser = ModuleParser()
        self.input_modules = input_modules or [
            {"type": "QuestionInput", "option": "default"}]
        self.use_self_negatives = use_self_negatives
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.items)

    def query_text(self, item: dict) -> str:
        return self.parser.parse(item, self.input_modules)["text_sequence"]

    def sample_docs(self, item: dict) -> list[str]:
        """1 positive + nway-1 negatives (contents)."""
        pos_ids = list(item["pos_item_ids"])
        pos = pos_ids[self.rng.integers(len(pos_ids))]
        docs = [self.corpus.content_of(pos)]
        pos_set = set(pos_ids)
        if self.use_self_negatives and item.get("neg_item_ids"):
            pool = [p for p in item["neg_item_ids"] if p not in pos_set]
            for _ in range(self.nway - 1):
                docs.append(self.corpus.content_of(
                    pool[self.rng.integers(len(pool))]))
        else:
            n = len(self.corpus)
            for _ in range(self.nway - 1):
                j = int(self.rng.integers(n))
                while self.corpus.ids[j] in pos_set:
                    j = int(self.rng.integers(n))
                docs.append(self.corpus.contents[j])
        return docs

    def collate(self, indices: Sequence[int]) -> dict:
        items = [self.items[i] for i in indices]
        parsed = [self.parser.parse(it, self.input_modules) for it in items]
        qi, qm = self.qt.tensorize([p["text_sequence"] for p in parsed])
        docs: list[str] = []
        for it in items:
            docs.extend(self.sample_docs(it))
        di, dm = self.dt.tensorize(docs)
        batch = {"query_input_ids": qi, "query_attention_mask": qm,
                 "doc_input_ids": di, "doc_attention_mask": dm}
        _attach_vision(batch, items, parsed)
        return batch

    def loader(self, batch_size: int, shuffle: bool = True,
               seed: int = 0, epochs: Optional[int] = None) -> Iterator[dict]:
        """Static-shape batch iterator (drop_last)."""
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self.items)) if shuffle \
                else np.arange(len(self.items))
            for s in range(0, len(order) - batch_size + 1, batch_size):
                yield self.collate(order[s:s + batch_size])
            epoch += 1
            if epochs is None and not shuffle:
                break


def corpus_doc_batches(corpus: PassageCorpus, doc_tokenizer: DocTokenizer,
                       batch_size: int = 128) -> Iterator[dict]:
    """Tokenized corpus batches (numpy) for index building."""
    for s in range(0, len(corpus), batch_size):
        di, dm = doc_tokenizer.tensorize(corpus.contents[s:s + batch_size])
        yield {"doc_input_ids": di, "doc_attention_mask": dm}


def query_eval_batches(dataset: RetrievalDataset,
                       batch_size: int = 64) -> Iterator[dict]:
    """Query-only batches in dataset order (for evaluation)."""
    n = len(dataset.items)
    for s in range(0, n, batch_size):
        items = dataset.items[s:s + batch_size]
        parsed = [dataset.parser.parse(it, dataset.input_modules)
                  for it in items]
        qi, qm = dataset.qt.tensorize([p["text_sequence"] for p in parsed])
        batch = {"query_input_ids": qi, "query_attention_mask": qm}
        _attach_vision(batch, items, parsed)
        yield batch
