"""ColBERT/FLMR query & doc tokenizers -> fixed-shape numpy batches.

Reproduces the reference's tensorization exactly (TPU needs static shapes,
which the reference already uses via padding='max_length'):

QueryTokenizer (third_party/ColBERT/colbert/modeling/tokenization/
query_tokenization.py:51-99):
  - prepend '. ' placeholder, encode with [CLS] ... [SEP], pad/truncate to
    query_maxlen;
  - position 1 <- [Q] marker ('[unused0]');
  - [MASK]-augmentation: every [PAD] id becomes [MASK];
  - attention_mask covers real tokens only, unless attend_to_mask_tokens.

DocTokenizer (doc_tokenization.py:49-72): '. ' placeholder, [CLS]/[SEP],
position 1 <- [D] marker ('[unused1]'), pad to doc_maxlen.

The base tokenizer can be a WordPieceTokenizer or any HF tokenizer
exposing encode(text, add_special_tokens=False) and *_token_id attributes.

The port's own copy of ravqa_tpu/tokenization/colbert_tokenizers.py; a
base with encode_batch (the port's WordPiece) encodes a batch at once,
natively where the C++ library built. tests/test_torch_host.py holds the
two byte-equal on both routes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


def _marker_id(base, token: str, default: int) -> int:
    vocab = getattr(base, "vocab", None)
    if vocab and token in vocab:
        return vocab[token]
    conv = getattr(base, "convert_tokens_to_ids", None)
    if conv is not None:
        tid = conv([token])[0] if isinstance(conv(token), list) else conv(token)
        if isinstance(tid, int) and tid != getattr(base, "unk_token_id", -1):
            return tid
    return default


def _bodies(base, texts: Sequence[str], maxlen: int) -> list:
    """Each text's first maxlen token ids (a row keeps at most maxlen - 2 of
    them): through the base's encode_batch where it has one (the port's
    WordPiece, native where built; the same ids), else encode per text."""
    if hasattr(base, "encode_batch"):
        ids, lens = base.encode_batch(list(texts), maxlen)
        return [row[:n].tolist() for row, n in zip(ids, lens)]
    return [base.encode(t, add_special_tokens=False) for t in texts]


@dataclasses.dataclass
class QueryTokenizer:
    base: object
    query_maxlen: int = 32
    attend_to_mask_tokens: bool = False
    marker_token: str = "[unused0]"

    def __post_init__(self):
        self.q_marker_id = _marker_id(self.base, self.marker_token, 1)
        self.mask_id = self.base.mask_token_id
        self.pad_id = self.base.pad_token_id
        self.cls_id = self.base.cls_token_id
        self.sep_id = self.base.sep_token_id

    def tensorize(self, texts: Sequence[str]):
        """-> (input_ids (B, query_maxlen) int32, attention_mask int32)."""
        b = len(texts)
        ids = np.full((b, self.query_maxlen), self.pad_id, np.int32)
        mask = np.zeros((b, self.query_maxlen), np.int32)
        for i, body in enumerate(_bodies(self.base, texts,
                                         self.query_maxlen)):
            # [CLS] [Q] body [SEP], truncated to query_maxlen
            row = [self.cls_id, self.q_marker_id] + list(body) + [self.sep_id]
            row = row[:self.query_maxlen]
            if len(row) == self.query_maxlen and row[-1] != self.sep_id:
                row[-1] = self.sep_id
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        # [MASK] augmentation: pads become [MASK]
        ids[ids == self.pad_id] = self.mask_id
        if self.attend_to_mask_tokens:
            mask[:] = 1
        return ids, mask


@dataclasses.dataclass
class DocTokenizer:
    base: object
    doc_maxlen: int = 220
    marker_token: str = "[unused1]"

    def __post_init__(self):
        self.d_marker_id = _marker_id(self.base, self.marker_token, 2)
        self.pad_id = self.base.pad_token_id
        self.cls_id = self.base.cls_token_id
        self.sep_id = self.base.sep_token_id

    def tensorize(self, texts: Sequence[str]):
        """-> (input_ids (B, doc_maxlen) int32, attention_mask int32)."""
        b = len(texts)
        ids = np.full((b, self.doc_maxlen), self.pad_id, np.int32)
        mask = np.zeros((b, self.doc_maxlen), np.int32)
        for i, body in enumerate(_bodies(self.base, texts, self.doc_maxlen)):
            row = [self.cls_id, self.d_marker_id] + list(body) + [self.sep_id]
            row = row[:self.doc_maxlen]
            if len(row) == self.doc_maxlen and row[-1] != self.sep_id:
                row[-1] = self.sep_id
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask
