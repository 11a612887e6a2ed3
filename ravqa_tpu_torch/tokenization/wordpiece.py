"""Self-contained WordPiece tokenizer (BERT-compatible).

A clean-room implementation of the BERT basic+WordPiece tokenization
algorithm so the framework has no network/tokenizer-download dependency.
Loads standard `vocab.txt` files; behavior matches HF BertTokenizer for
lowercase English text (greedy longest-match-first with '##' continuations,
punctuation splitting, CJK isolation, accent stripping).

A C++ fast path (ravqa_tpu_torch/native) can be plugged in via
`encode_batch`; the Python path is the reference implementation.

The port's own copy of ravqa_tpu/tokenization/wordpiece.py (the port
imports nothing of the JAX package); tests/test_torch_host.py holds the two
byte-equal.
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, Optional


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    def __init__(self, lowercase: bool = True):
        self.lowercase = lowercase

    def tokenize(self, text: str) -> list[str]:
        out = []
        buf = []
        def flush():
            if buf:
                out.append("".join(buf))
                buf.clear()
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_whitespace(ch):
                flush()
            elif _is_cjk(cp) or _is_punctuation(ch):
                flush()
                out.append(ch)
            else:
                buf.append(ch)
        flush()
        if self.lowercase:
            out = [self._strip_accents(t.lower()) for t in out]
        return [t for t in out if t]

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")


class WordPieceTokenizer:
    """vocab: token -> id mapping (or path to a vocab.txt)."""

    def __init__(self, vocab, lowercase: bool = True, unk_token="[UNK]",
                 max_chars_per_word: int = 100, use_native: bool = True):
        self._fast = None
        if isinstance(vocab, str):
            if use_native and lowercase:
                try:
                    from ..native import FastWordPiece
                    vmap = load_vocab(vocab)
                    self._fast = FastWordPiece(
                        vocab, unk_id=vmap.get(unk_token, 100))
                except (RuntimeError, FileNotFoundError, OSError):
                    self._fast = None
            vocab = load_vocab(vocab)
        self.vocab: dict[str, int] = dict(vocab)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.basic = BasicTokenizer(lowercase)
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word
        # standard BERT special ids
        self.pad_token_id = self.vocab.get("[PAD]", 0)
        self.unk_token_id = self.vocab.get("[UNK]", 100)
        self.cls_token_id = self.vocab.get("[CLS]", 101)
        self.sep_token_id = self.vocab.get("[SEP]", 102)
        self.mask_token_id = self.vocab.get("[MASK]", 103)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> list[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
        return ids

    def encode_batch(self, texts: list[str], maxlen: int):
        """Batched encode -> (ids (n, maxlen) int32 zero-padded, lens (n,)).

        C++ fast path when available (ASCII + CJK + common fullwidth
        punctuation handled natively, threaded over rows on multi-core
        hosts); rows the native encoder flags (len -1: accents, exotic
        Unicode) are re-encoded here with the Python reference path.
        """
        import numpy as np
        if self._fast is not None:
            ids, lens = self._fast.encode_batch(texts, maxlen)
            for i in np.nonzero(lens < 0)[0]:
                row = self.encode(texts[int(i)])[:maxlen]
                ids[i] = 0
                ids[i, :len(row)] = row
                lens[i] = len(row)
            return ids, lens
        ids = np.zeros((len(texts), maxlen), np.int32)
        lens = np.zeros(len(texts), np.int32)
        for i, t in enumerate(texts):
            row = self.encode(t)[:maxlen]
            ids[i, :len(row)] = row
            lens[i] = len(row)
        return ids, lens

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        toks = []
        special = {self.pad_token_id, self.cls_token_id, self.sep_token_id,
                   self.mask_token_id}
        for i in ids:
            if skip_special and int(i) in special:
                continue
            toks.append(self.ids_to_tokens.get(int(i), self.unk_token))
        text = ""
        for t in toks:
            if t.startswith("##"):
                text += t[2:]
            else:
                text += (" " if text else "") + t
        return text


def load_vocab(path: str) -> dict[str, int]:
    vocab = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def make_tiny_vocab(words: Iterable[str] = ()) -> dict[str, int]:
    """Deterministic small vocab for tests: specials + [unused0/1] markers +
    single letters + ## continuations + provided whole words."""
    toks = ["[PAD]", "[unused0]", "[unused1]", "[UNK]", "[CLS]", "[SEP]",
            "[MASK]"]
    toks += list("abcdefghijklmnopqrstuvwxyz0123456789")
    toks += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    toks += [".", ",", "?", "!", "'"]
    for w in words:
        if w not in toks:
            toks.append(w)
    return {t: i for i, t in enumerate(toks)}
