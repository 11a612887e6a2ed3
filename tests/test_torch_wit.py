"""The port's WIT and M2KR data nodes and its pipeline node cache against
the JAX package's.

- LoadWITData, TruncateWITPassages, ReduceWITPassagesSize,
  SplitWITPassagesForLargeScaleTraining, PrepareImagesForWITData (its
  injected fetcher), LoadImageFeatures and LoadM2KRData on small files
  the tests write: equal items and corpora (one process, so Python's
  salted hash gives LoadWITData's passage ids alike in both packages);
- the cache key equals JAX's _cache_key (callables in the setup kwargs
  keyed by their type); a cached node is read back without running its
  transform, `regenerate` runs it again; the port's files are
  `<node>.<key>.torch.pkl` and name no module of the JAX package, and a
  JAX pickle in the same directory is never read.
"""

import csv
import json
import os
import pickle
import pickletools

import numpy as np
import pytest

from ravqa_tpu.data import DataPipeline as JaxPipeline
from ravqa_tpu_torch.data import DataPipeline, PassageCorpus
from ravqa_tpu_torch.data.pipeline import (BaseTransform, TRANSFORM_REGISTRY,
                                           register_transform)
from ravqa_tpu_torch.scripts.synthetic_wit import write_synthetic_wit


def make_wit_tsv(path, n=10, offset=0):
    cols = ["image_url", "page_title", "section_title",
            "context_page_description", "caption_reference_description"]
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=cols, delimiter="\t")
        w.writeheader()
        for i in range(offset, offset + n):
            w.writerow({"image_url": f"img_{i}",
                        "page_title": f"Page {i % 7}",
                        "section_title": "Intro" if i % 3 else "",
                        "context_page_description":
                            f"description words for page {i % 7} " * 30,
                        "caption_reference_description": f"caption {i}"})


def _same(got, want):
    """Equal node outputs: corpora by ids and contents, arrays exactly."""
    if hasattr(want, "ids") and hasattr(want, "contents"):
        assert type(got) is PassageCorpus
        assert list(got.ids) == list(want.ids)
        assert list(got.contents) == list(want.contents)
        assert got.id2pos == want.id2pos
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.fixture
def wit_files(tmp_path):
    make_wit_tsv(tmp_path / "train.tsv", 14)
    make_wit_tsv(tmp_path / "test.tsv", 6, offset=20)
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "feats.npz", **{
        f"img_{i}": rng.normal(size=8).astype(np.float32)
        for i in list(range(14)) + list(range(20, 26))})
    return tmp_path


def _wit_nodes(d, tail):
    nodes = {"wit": {"transform_name": "LoadWITData", "setup_kwargs": {
        "tsv_path": {"train": str(d / "train.tsv"),
                     "test": str(d / "test.tsv")},
        "iglue_ids": ["img_20", "img_22", "img_23"]}}}
    prev = "wit"
    for i, (name, kw) in enumerate(tail):
        nodes[f"n{i}"] = {"transform_name": name, "input_node": prev,
                          "setup_kwargs": kw}
        prev = f"n{i}"
    return nodes, prev


WIT_CHAINS = {
    "load": [],
    "truncate": [("TruncateWITPassages", {"max_words": 12})],
    "reduce": [("TruncateWITPassages", {"max_words": 12}),
               ("ReduceWITPassagesSize", {"n_passages": 9, "seed": 3})],
    "split": [("SplitWITPassagesForLargeScaleTraining", {})],
    "features": [("TruncateWITPassages", {}),
                 ("LoadImageFeatures", {"features_path": "FEATS"})],
}


@pytest.mark.parametrize("chain", sorted(WIT_CHAINS))
def test_wit_nodes_match_jax(wit_files, chain):
    tail = [(n, {k: (str(wit_files / "feats.npz") if v == "FEATS" else v)
                 for k, v in kw.items()}) for n, kw in WIT_CHAINS[chain]]
    nodes, out = _wit_nodes(wit_files, tail)
    want = JaxPipeline(nodes).get_data(out, explode=True)
    got = DataPipeline(nodes).get_data(out, explode=True)
    _same(got, want)
    # iglue keeps 3 of the 6 test rows; 7 distinct pages x 2 sections
    assert [it["image_id"] for it in got["test"]] == \
        ["img_20", "img_22", "img_23"]
    assert all(it["question"] is None for it in got["train"])
    if chain == "split":
        assert set(got["passages"]["full_passages"].ids) == {
            p for it in got["test"] for p in it["pos_item_ids"]}
    if chain == "features":
        assert got["train"][3]["image_features"].shape == (8,)


def test_prepare_images_matches_jax(tmp_path):
    """Items whose image is on disk are kept (with img_path); a missing one
    comes only through the injected fetcher."""
    from ravqa_tpu.data.wit_transforms import \
        PrepareImagesForWITData as JaxPrepare
    from ravqa_tpu_torch.data.wit_transforms import PrepareImagesForWITData
    (tmp_path / "a.jpg").write_bytes(b"x")
    fetched = []

    def fetcher(image_id, path):
        fetched.append(image_id)
        if image_id == "b":
            open(path, "wb").write(b"y")
            return True
        return False

    def data():
        return {"train": [{"question_id": str(i), "image_id": x,
                           "pos_item_ids": [f"P_{i}"]}
                          for i, x in enumerate("abc")],
                "passages": {"full_passages": None}}

    outs = []
    for cls, fetch in ((JaxPrepare, False), (PrepareImagesForWITData, False),
                       (JaxPrepare, True), (PrepareImagesForWITData, True)):
        for f in ("b.jpg",):
            if os.path.exists(tmp_path / f):
                os.remove(tmp_path / f)
        t = cls()
        t.setup(image_data_path=str(tmp_path), fetch_images=fetch,
                image_name=lambda it: f"{it['image_id']}.jpg",
                fetcher=fetcher)
        outs.append(t(data()))
    _same(outs[1], outs[0])
    _same(outs[3], outs[2])
    assert [it["image_id"] for it in outs[1]["train"]] == ["a"]
    assert [it["image_id"] for it in outs[3]["train"]] == ["a", "b"]
    assert fetched == ["b", "c", "b", "c"]
    # the default name: the md5 of the image id
    t = PrepareImagesForWITData()
    t.setup(image_data_path=str(tmp_path))
    assert t(data())["train"] == []


def test_load_m2kr_data_matches_jax(tmp_path):
    qf = {s: tmp_path / f"{s}.jsonl" for s in ("train", "test")}
    with open(tmp_path / "p.jsonl", "w") as f:
        for i in range(5):
            f.write(json.dumps({"passage_id": f"P{i}",
                                "passage_content": f"text {i}"}) + "\n")
    rng = np.random.default_rng(1)
    feats = {}
    for s, path in qf.items():
        with open(path, "w") as f:
            for i in range(3):
                qid = 10 * (s == "test") + i
                feats[str(qid)] = rng.normal(size=4).astype(np.float32)
                f.write(json.dumps({"question_id": qid,
                                    "question": f"q {qid}",
                                    "instruction": "find it",
                                    "pos_item_ids": [f"P{i}"],
                                    "answers": ["a"]}) + "\n")
    np.savez(tmp_path / "f.npz", **feats)
    for kw in ({}, {"features_path": str(tmp_path / "f.npz")}):
        nodes = {"m2kr": {"transform_name": "LoadM2KRData", "setup_kwargs": {
            "queries_path": {s: str(p) for s, p in qf.items()},
            "passages_path": str(tmp_path / "p.jsonl"), **kw}}}
        want = JaxPipeline(nodes).get_data("m2kr", explode=True)
        got = DataPipeline(nodes).get_data("m2kr", explode=True)
        _same(got, want)
        assert got["test"][0]["question_id"] == "10"
        assert ("image_features" in got["train"][0]) == bool(kw)


def test_synthetic_wit_writer(tmp_path):
    """The synthetic dump reads in both packages: one passage a row,
    truncated to 100 words, features for every image."""
    paths = write_synthetic_wit(str(tmp_path), n_train=30, n_test=8,
                                vision_dim=6, seed=2)
    nodes = {"wit": {"transform_name": "LoadWITData", "setup_kwargs": {
                 "tsv_path": {"train": paths["train"],
                              "test": paths["test"]}}},
             "trunc": {"transform_name": "TruncateWITPassages",
                       "input_node": "wit",
                       "setup_kwargs": {"max_words": 100}},
             "features": {"transform_name": "LoadImageFeatures",
                          "input_node": "trunc",
                          "setup_kwargs": {"features_path":
                                           paths["features"]}}}
    got = DataPipeline(nodes).get_data("features", explode=True)
    _same(got, JaxPipeline(nodes).get_data("features", explode=True))
    corpus = got["passages"]["full_passages"]
    assert len(corpus) == 38 and len(got["train"]) == 30
    assert max(len(c.split()) for c in corpus.contents) == 100
    assert got["test"][0]["image_features"].shape == (6,)


# ---------------------------------------------------------------------------
# the node cache
# ---------------------------------------------------------------------------

CALLS = []


@register_transform
class _CountingNode(BaseTransform):
    """Returns a PassageCorpus of `n` passages; counts its runs."""

    def __call__(self, *inputs):
        CALLS.append(self.n)
        corpus = PassageCorpus([f"P{i}" for i in range(self.n)],
                               ["x y"] * self.n)
        return {"passages": {"full_passages": corpus},
                "global": self.global_config["tag"]}


def _cache_config(**flags):
    return {"src": {"transform_name": "_CountingNode",
                    "setup_kwargs": {"n": 3, "fn": len,
                                     "nested": {"b": [1, (2, 3)], "a": "s"}},
                    **flags},
            "trunc": {"transform_name": "TruncateWITPassages",
                      "input_node": "src", "setup_kwargs": {"max_words": 4}}}


def test_cache_key_matches_jax():
    cfg = _cache_config(cache=True)
    cfg["wit"] = {"transform_name": "LoadWITData", "cache": True,
                  "setup_kwargs": {"tsv_path": {"train": "a.tsv"},
                                   "max_rows": 5}}
    got, want = DataPipeline(cfg), JaxPipeline(cfg)
    for node in cfg:
        assert got._cache_key(node) == want._cache_key(node)
    # a callable is keyed by its type, so the key holds across processes
    other = _cache_config(cache=True)
    other["src"]["setup_kwargs"]["fn"] = sorted
    assert DataPipeline(other)._cache_key("src") == got._cache_key("src")
    other["src"]["setup_kwargs"]["n"] = 4
    assert DataPipeline(other)._cache_key("src") != got._cache_key("src")
    assert DataPipeline(other)._cache_key("trunc") != \
        got._cache_key("trunc")
    assert DataPipeline(cfg)._cache_path("src") is None


def test_cache_hit_skips_the_transform_and_regenerate_runs_it(tmp_path):
    CALLS.clear()
    cache = str(tmp_path / "cache")
    first = DataPipeline(_cache_config(cache=True), cache_dir=cache,
                         global_config={"tag": "a"})
    out = first.get_data("trunc", explode=True)
    key = first._cache_key("src")
    assert os.listdir(cache) == [f"src.{key}.torch.pkl"]
    assert CALLS == [3] and out["global"] == "a"
    # a new pipeline (a later run) reads the node back
    again = DataPipeline(_cache_config(cache=True), cache_dir=cache,
                         global_config={"tag": "b"})
    out2 = again.get_data("trunc", explode=True)
    assert CALLS == [3] and out2["global"] == "a"
    assert list(out2["passages"]["full_passages"].ids) == ["P0", "P1", "P2"]
    assert out2["passages"]["full_passages"].contents == ["x y"] * 3
    # regenerate runs it again and rewrites the file
    regen = DataPipeline(_cache_config(cache=True, regenerate=True),
                         cache_dir=cache, global_config={"tag": "c"})
    assert regen.get_data("src", explode=True)["global"] == "c"
    assert CALLS == [3, 3]
    with open(os.path.join(cache, f"src.{key}.torch.pkl"), "rb") as f:
        assert pickle.load(f)["global"] == "c"
    # cache off: nothing read, nothing written
    DataPipeline(_cache_config(), cache_dir=str(tmp_path / "off"),
                 global_config={"tag": "d"}).get_data("trunc")
    assert CALLS == [3, 3, 3] and not os.path.exists(tmp_path / "off")


def test_cache_files_are_the_ports_own(wit_files, tmp_path):
    """The port's pickle imports only ravqa_tpu_torch classes; a JAX
    package cache of the same node and key beside it is never read."""
    nodes, _ = _wit_nodes(wit_files, [])
    nodes["wit"]["cache"] = True
    cache = str(tmp_path / "cache")
    JaxPipeline(nodes, cache_dir=cache).get_data("wit")
    port = DataPipeline(nodes, cache_dir=cache)
    key = port._cache_key("wit")
    assert os.listdir(cache) == [f"wit.{key}.pkl"]          # JAX's file
    out = port.get_data("wit", explode=True)
    assert type(out["passages"]["full_passages"]) is PassageCorpus
    assert sorted(os.listdir(cache)) == [f"wit.{key}.pkl",
                                         f"wit.{key}.torch.pkl"]
    with open(os.path.join(cache, f"wit.{key}.torch.pkl"), "rb") as f:
        raw = f.read()
    modules = {arg.split(" ")[0] for op, arg, _ in pickletools.genops(raw)
               if op.name in ("GLOBAL", "STACK_GLOBAL", "SHORT_BINUNICODE",
                              "BINUNICODE") and isinstance(arg, str)
               and arg.startswith("ravqa_tpu")}
    assert modules and all(m.startswith("ravqa_tpu_torch.") for m in modules)
    assert not any(m == "ravqa_tpu" or m.startswith("ravqa_tpu.")
                   for m in modules)
    # a later run reads the port's own file back
    again = DataPipeline(nodes, cache_dir=cache).get_data("wit", explode=True)
    _same(again, out)


def test_registry_holds_the_slice_nodes():
    for name in ("LoadWITData", "PrepareImagesForWITData",
                 "SplitWITPassagesForLargeScaleTraining",
                 "TruncateWITPassages", "ReduceWITPassagesSize",
                 "LoadImageFeatures", "LoadM2KRData"):
        assert name in TRANSFORM_REGISTRY
