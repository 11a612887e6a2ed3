"""ColBERT's query and doc tensorisation for texts of whole vocabulary
words (the benchmark's texts: lowercase words that are each one entry of
the vocabulary, so WordPiece keeps every word whole).

Query (ColBERT query_tokenization.py): [CLS] [Q] words [SEP], cut to
maxlen with [SEP] last, padding replaced by [MASK]; the attention mask
covers the real tokens. Doc: [CLS] [D] words [SEP], cut likewise, padded
with [PAD] (0).
"""

from __future__ import annotations

import numpy as np

PAD, Q_MARKER, D_MARKER, UNK, CLS, SEP, MASK = range(7)


def _rows(texts, vocab: dict, maxlen: int, marker: int):
    ids = np.zeros((len(texts), maxlen), np.int64)
    mask = np.zeros((len(texts), maxlen), np.int64)
    for i, text in enumerate(texts):
        body = [vocab.get(word, UNK) for word in text.lower().split()]
        row = [CLS, marker] + body[:maxlen] + [SEP]
        row = row[:maxlen]
        row[-1] = SEP
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask


def queries(texts, vocab: dict, maxlen: int):
    ids, mask = _rows(texts, vocab, maxlen, Q_MARKER)
    ids[ids == PAD] = MASK
    return ids, mask


def docs(texts, vocab: dict, maxlen: int):
    return _rows(texts, vocab, maxlen, D_MARKER)
