"""The benchmark's inputs, made from the seed: the vocabulary, texts, the
token index, query images and features, and the training corpus. Both the
program and the reference are handed these; neither makes them.

The token index follows the root `bench.py`'s synthetic index, rewritten
in torch and made on the device: every doc's tokens scatter around one of
`n_topics` seeded unit topics (topic + noise * N(0, 1), L2-normalised), and
docs are sorted by topic, as an index built in cluster order is. Each
doc's valid length is its passage's token count (`passage_words` drawn
uniformly, plus [CLS] [D] [SEP], cut to doc_maxlen); padded token rows are
zero, as the doc tower leaves them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

SPECIALS = ["[PAD]", "[unused0]", "[unused1]", "[UNK]", "[CLS]", "[SEP]",
            "[MASK]"]


def vocab_words(size: int) -> list:
    """`size` - 7 distinct four-letter lowercase words."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    i = np.arange(size - len(SPECIALS))
    digits = [(i // 26 ** p) % 26 for p in (3, 2, 1, 0)]
    return ["".join(t) for t in zip(*(letters[d] for d in digits))]


def vocab(size: int) -> dict:
    return {w: i for i, w in enumerate(SPECIALS + vocab_words(size))}


def vocab_file(size: int, cache_dir: str) -> str:
    """The vocabulary as a vocab.txt (one token a line) in cache_dir, at a
    fixed path, written once."""
    path = os.path.join(cache_dir, f"vocab_{size}.txt")
    if not os.path.exists(path):
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".part"
        with open(tmp, "w") as f:
            f.write("\n".join(SPECIALS + vocab_words(size)) + "\n")
        os.replace(tmp, path)
    return path


class Texts:
    """A sequence of seeded texts of vocabulary words, made on demand: text
    i is words[ids[i, :lens[i]]]."""

    def __init__(self, rng: np.random.Generator, n: int, lengths,
                 words: list):
        lo, hi = lengths
        self.lens = rng.integers(lo, hi + 1, n)
        self.ids = rng.integers(0, len(words), (n, hi), dtype=np.int32)
        self.words = np.asarray(words)

    def __len__(self):
        return len(self.lens)

    def __getitem__(self, i: int) -> str:
        return " ".join(self.words[self.ids[i, :self.lens[i]]])


def balanced(rng: np.random.Generator, n: int, lo: int, hi: int):
    """n integers in [lo, hi], each value as often as the others (to
    within one), in seeded order: every seed gets the same multiset."""
    vals = lo + np.arange(n) % (hi - lo + 1)
    return rng.permutation(vals)


def make_index(cfg: dict, seed: int, device) -> tuple:
    """(tokens (N_pad, Ld, dim) float32, mask (N_pad, Ld) int8, n_docs)."""
    ix = cfg["index"]
    n, ld, dim = ix["n_docs"], cfg["doc_maxlen"], cfg["model_config"]["dim"]
    n_pad = -(-n // ix["pad_multiple"]) * ix["pad_multiple"]
    g = torch.Generator(device=device).manual_seed(seed)
    topics = torch.randn((ix["n_topics"], dim), generator=g, device=device)
    topics /= topics.norm(dim=-1, keepdim=True)
    assign = torch.sort(torch.randint(0, ix["n_topics"], (n,), generator=g,
                                      device=device)).values
    lo, hi = cfg["passage_words"]
    lens = torch.randint(lo, hi + 1, (n,), generator=g, device=device)
    lens = (lens + 3).clamp_max(ld)
    tokens = torch.zeros((n_pad, ld, dim), dtype=torch.float32,
                         device=device)
    mask = torch.zeros((n_pad, ld), dtype=torch.int8, device=device)
    pos = torch.arange(ld, device=device)
    step = 4096
    for s in range(0, n, step):
        e = min(n, s + step)
        t = tokens[s:e]
        torch.randn(t.shape, generator=g, device=device, out=t)
        t.mul_(ix["noise"]).add_(topics[assign[s:e]][:, None, :])
        t.div_(t.norm(dim=-1, keepdim=True))
        m = pos[None, :] < lens[s:e, None]
        t.mul_(m[..., None])
        mask[s:e] = m.to(torch.int8)
    return tokens, mask, n


def make_weights(specs, seed: int, device, std: float = 0.02) -> dict:
    """{name: tensor} from one seeded N(0, std) draw on the device: each
    parameter is a view of it, a "scale" parameter (a LayerNorm's weight)
    with 1 added, so that no bias or scale is the same in every seed."""
    g = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    total = sum(int(np.prod(s)) for _, s, _ in specs)
    flat = torch.randn((total,), generator=g, device=device).mul_(std)
    out, at = {}, 0
    for name, shape, kind in specs:
        size = int(np.prod(shape))
        out[name] = flat[at:at + size].view(shape)
        if kind == "scale":
            out[name].add_(1.0)
        at += size
    return out


class Requests:
    """A serve cell's request pool, from the seed: `pool` questions of
    `question_words` words (each length equally often), and per request a
    seeded image: a vision_dim feature vector, or one of `image_pool`
    seeded (S, S, 3) images (normalised pixel values) for an in-graph ViT.
    Request i of the traffic is pool entry order[i % pool]."""

    def __init__(self, traffic: dict, seed: int, words: list,
                 feature_dim: int = 0, pixel_shape=None, device="cpu"):
        rng = np.random.default_rng([seed, 1])
        n = traffic["pool"]
        lo, hi = traffic["question_words"]
        lens = balanced(rng, n, lo, hi)
        ids = rng.integers(0, len(words), (n, hi))
        w = np.asarray(words)
        self.texts = [" ".join(w[ids[i, :lens[i]]]) for i in range(n)]
        self.features = self.images = self.image_of = None
        if feature_dim:
            self.features = rng.standard_normal(
                (n, feature_dim)).astype(np.float32)
        if pixel_shape is not None:
            g = torch.Generator(device=device).manual_seed(seed ^ 0x1A6E)
            imgs = torch.randn((traffic["image_pool"], *pixel_shape),
                               generator=g, device=device)
            self.images = imgs.cpu().numpy()
            self.image_of = rng.integers(0, traffic["image_pool"], n)
        self.order = rng.permutation(n)

    def entry(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def image(self, e: int) -> dict:
        if self.features is not None:
            return {"image_features": self.features[e]}
        if self.images is not None:
            return {"pixel_values": self.images[self.image_of[e]]}
        return {}


class TrainWorld:
    """The training data: a corpus of `n_passages` seeded passages and
    `n_questions` questions, each with 1-3 positive passages (drawn from
    the seed) and a seeded vision_dim feature vector."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, words: list):
        tr = cfg["train"]
        rng = np.random.default_rng([seed, 2])
        self.passages = Texts(rng, tr["n_passages"], cfg["passage_words"],
                              words)
        nq = tr["n_questions"]
        self.questions = Texts(rng, nq, traffic["question_words"], words)
        lo, hi = tr["positives"]
        n_pos = rng.integers(lo, hi + 1, nq)
        pos = rng.integers(0, tr["n_passages"], (nq, hi))
        self.pos_ids = [[f"GS_{p}" for p in dict.fromkeys(pos[i, :n_pos[i]])]
                        for i in range(nq)]
        self.features = rng.standard_normal(
            (nq, cfg["model_config"].get("vision_embedding_size", 768))
        ).astype(np.float32)
        self.pids = [f"GS_{i}" for i in range(tr["n_passages"])]

    def items(self) -> list:
        return [{"question_id": str(i), "question": self.questions[i],
                 "pos_item_ids": self.pos_ids[i],
                 "image_features": self.features[i]}
                for i in range(len(self.questions))]
