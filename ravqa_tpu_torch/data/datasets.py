"""Passage corpus and corpus batching for index building.

Port of PassageCorpus and corpus_doc_batches from
ravqa_tpu/data/datasets.py (:48-62, :141-148). The training datasets come
with the trainer (ROADMAP.md A8).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from ravqa_tpu.tokenization import DocTokenizer


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


def corpus_doc_batches(corpus: PassageCorpus, doc_tokenizer: DocTokenizer,
                       batch_size: int = 128) -> Iterator[dict]:
    """Tokenized corpus batches (numpy) for index building."""
    for s in range(0, len(corpus), batch_size):
        di, dm = doc_tokenizer.tensorize(corpus.contents[s:s + batch_size])
        yield {"doc_input_ids": di, "doc_attention_mask": dm}
