"""The port's own host modules against the JAX package's.

ravqa_tpu_torch keeps copies of the jax-free host modules it needs (config,
tokenization and the native WordPiece encoder), so that it imports nothing
of ravqa_tpu. These tests hold the copies to the originals:
- load_config + apply_overrides give equal dicts for every file under
  configs/;
- QueryTokenizer / DocTokenizer give byte-equal ids and masks on the tiny
  vocab, on ASCII, CJK and accented text, through the C++ WordPiece path
  and the Python path.
"""

import glob
import os

import numpy as np
import pytest

from ravqa_tpu import config as jax_config
from ravqa_tpu import tokenization as jax_tok
from ravqa_tpu_torch import config as torch_config
from ravqa_tpu_torch import tokenization as torch_tok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "configs", "**", "*.json"), recursive=True))
OVERRIDES = ["serve.k=5", "model_config.search_mode=hierarchical",
             "train.load_model_path=/tmp/params.npz", "new.branch.leaf=[1, 2]",
             "seed=7"]

WORDS = ["cat", "dog", "sky", "café", "naïve", "猫", "狗", "天"]
TEXTS = {
    "ascii": ["cat dog sky", "What colour is the sky?", "", "a" * 300,
              "dogs, cats... and SKY!"],
    "cjk_accents": ["猫 and 狗 under the 天", "Café NAÏVE façade",
                    "猫狗天猫", "résumé of the 猫", "été 一"],
}


def test_every_config_file_is_found():
    assert len(CONFIGS) >= 10
    assert "configs/synthetic_flmr.json" in CONFIGS


@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_matches_jax(path):
    full = os.path.join(REPO, path)
    want = jax_config.load_config(full)
    got = torch_config.load_config(full)
    assert type(got) is torch_config.Config
    assert got.to_dict() == want.to_dict()
    got_o = torch_config.apply_overrides(got, OVERRIDES)
    want_o = jax_config.apply_overrides(want, OVERRIDES)
    assert got_o.to_dict() == want_o.to_dict()
    assert got_o.new.branch.leaf == [1, 2]
    assert got.to_dict() == want.to_dict()        # overrides copy the config


def test_merge_patch_matches_jax():
    base = {"a": {"b": 1, "c": [1, 2]}, "d": 2, "e": {"f": None}}
    patch = {"a": {"b": None, "g": 3}, "d": {"x": 1}, "e": None}
    assert torch_config.merge_patch(base, patch) == \
        jax_config.merge_patch(base, patch)


def _vocab_file(tmp_path):
    vocab = jax_tok.make_tiny_vocab(WORDS)
    assert vocab == torch_tok.make_tiny_vocab(WORDS)
    path = tmp_path / "vocab.txt"
    path.write_text("".join(t + "\n" for t, _ in sorted(
        vocab.items(), key=lambda kv: kv[1])), encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    return _vocab_file(tmp_path_factory.mktemp("vocab"))


def _bases(vocab_path, route):
    if route == "python":
        return (jax_tok.WordPieceTokenizer(vocab_path, use_native=False),
                torch_tok.WordPieceTokenizer(vocab_path, use_native=False))
    jb = jax_tok.WordPieceTokenizer(vocab_path)
    tb = torch_tok.WordPieceTokenizer(vocab_path)
    # the C++ path is live on both sides (a compiler is on this machine)
    assert jb._fast is not None and tb._fast is not None
    return jb, tb


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("texts", sorted(TEXTS))
@pytest.mark.parametrize("kind,maxlen", [("query", 12), ("query", 32),
                                         ("doc", 16), ("doc", 64)])
def test_tokenizers_byte_equal(vocab_path, route, texts, kind, maxlen):
    jb, tb = _bases(vocab_path, route)
    if kind == "query":
        j = jax_tok.QueryTokenizer(jb, query_maxlen=maxlen)
        t = torch_tok.QueryTokenizer(tb, query_maxlen=maxlen)
    else:
        j = jax_tok.DocTokenizer(jb, doc_maxlen=maxlen)
        t = torch_tok.DocTokenizer(tb, doc_maxlen=maxlen)
    want_ids, want_mask = j.tensorize(TEXTS[texts])
    got_ids, got_mask = t.tensorize(TEXTS[texts])
    assert got_ids.dtype == want_ids.dtype and got_mask.dtype == \
        want_mask.dtype
    assert got_ids.tobytes() == want_ids.tobytes()
    assert got_mask.tobytes() == want_mask.tobytes()


@pytest.mark.parametrize("route", ["native", "python"])
def test_encode_batch_matches_jax(vocab_path, route):
    """The batched encoder: native rows the C++ path flags (accents) are
    re-encoded in Python on both sides."""
    jb, tb = _bases(vocab_path, route)
    texts = TEXTS["ascii"] + TEXTS["cjk_accents"]
    for got, want in zip(tb.encode_batch(texts, 20),
                         jb.encode_batch(texts, 20)):
        np.testing.assert_array_equal(got, want)


def test_tiny_vocab_tokenizers_match_jax():
    """The serving pipeline's tokenizers: the tiny vocab as a dict (the
    Python path), with [MASK] augmentation and attention to mask tokens."""
    words = ["cat", "dog", "sky"]
    jb = jax_tok.WordPieceTokenizer(jax_tok.make_tiny_vocab(words))
    tb = torch_tok.WordPieceTokenizer(torch_tok.make_tiny_vocab(words))
    texts = TEXTS["ascii"] + TEXTS["cjk_accents"]
    for attend in (False, True):
        j = jax_tok.QueryTokenizer(jb, 16, attend_to_mask_tokens=attend)
        t = torch_tok.QueryTokenizer(tb, 16, attend_to_mask_tokens=attend)
        for got, want in zip(t.tensorize(texts), j.tensorize(texts)):
            assert got.tobytes() == want.tobytes()
    assert tb.decode(tb.encode("cat dog")) == jb.decode(jb.encode("cat dog"))


def test_native_library_builds_into_the_port_build_dir():
    from ravqa_tpu_torch import native
    lib = native.get_lib()
    assert lib is not None
    assert os.path.exists(os.path.join(native.BUILD_DIR,
                                       "libravqa_native.so"))
    assert native.BUILD_DIR.startswith(os.path.join(REPO, "ravqa_tpu_torch",
                                                    "_build"))
