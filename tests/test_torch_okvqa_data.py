"""The OK-VQA data nodes of ravqa_tpu_torch against ravqa_tpu on the CPU:
LoadGoogleSearchPassages, LoadOKVQAData, LoadGoogleSearchAnnotations,
LoadVinVLFeatures, LoadOscarCaptionFeatures and LoadGoogleOCRFeatures on
small files in the real formats (the VQA question and annotation JSONs,
the GoogleSearch CSV across the 112724 boundary, the DPR-style annotation
JSONs, a VinVL predictions.tsv, a caption JSON and *_ocr.json files), then
`--mode prepare_data` on configs/okvqa/flmr_base.json and
flmr_with_roi.json, and `--use_dummy_data`.

Every comparison is exact: the nodes are host code, the same JSON, CSV and
numpy in both packages, so each node's output equals the JAX node's item
for item (the image features of flmr_with_roi.json come from one feature
cache that both pipelines read).
"""

import base64
import copy
import json
import os

import numpy as np
import pytest

from ravqa_tpu import main as jax_main
from ravqa_tpu.config import apply_overrides as jax_apply_overrides
from ravqa_tpu.config import load_config as jax_load_config
from ravqa_tpu.data import transforms as jt
from ravqa_tpu_torch import main as port_main
from ravqa_tpu_torch.config import apply_overrides, load_config
from ravqa_tpu_torch.data import transforms as tt
from ravqa_tpu_torch.scripts.synthetic_okvqa import (config_opts,
                                                     write_synthetic_okvqa)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_CONFIG = os.path.join(REPO, "configs", "okvqa", "flmr_base.json")
ROI_CONFIG = os.path.join(REPO, "configs", "okvqa", "flmr_with_roi.json")


def _node(mod, name, **kw):
    t = getattr(mod, name)()
    t.setup(**kw)
    return t


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A world of 30 train and 24 test questions over 8 images of 90 x 120,
    64 passages (the 112724 row among them); a VinVL TSV per split written
    here (objects of 3 classes, attributes with scores on both sides of
    0.05, base64 features, boxes that hold some of the OCR boxes), the
    caption JSON keyed str(image_id), and a CLIP feature store for
    flmr_base.json's LoadImageFeatures."""
    root = tmp_path_factory.mktemp("okvqa")
    p = write_synthetic_okvqa(str(root), n_images=8, n_train=30, n_test=24,
                              n_passages=64, image_hw=(90, 120))
    rng = np.random.default_rng(5)
    for s in ("train", "test"):
        rows = []
        for i in p["splits"][s]:
            objs = [{"class": c, "rect": rect, "conf": 0.5,
                     "attributes": ["red", "old"],
                     "attr_scores": [0.3, 0.02],
                     "feature": base64.b64encode(rng.normal(size=4).astype(
                         np.float32).tobytes()).decode()}
                    for c, rect in (("cat", [0.0, 0.0, 120.0, 90.0]),
                                    ("sign", [10.5, 5.25, 70.0, 60.0]),
                                    ("tree", [80.0, 40.0, 119.0, 89.0]))]
            rows.append(f"{str(i).zfill(12)}\t"
                        f"{json.dumps({'objects': objs, 'num_boxes': 3})}")
        with open(p[f"vinvl_{s}"], "w") as f:
            f.write("\n".join(rows) + "\n")
        with open(p[f"captions_{s}"], "w") as f:
            json.dump({str(i): [f"a photo of image {i}"]
                       for i in p["splits"][s]}, f)
    p["clip_features"] = str(root / "clip_features.npz")
    np.savez(p["clip_features"], **{str(i): rng.normal(size=768).astype(
        np.float32) for i in p["image_ids"]})
    return p


@pytest.mark.parametrize("full", [True, False])
def test_google_search_passages_match_jax(world, full):
    """The GoogleSearch CSV: GS_ ids, the train split ending before kid
    112724 (use_full_split False stops reading there)."""
    kw = dict(passage_data_path=world["corpus"], use_full_split=full)
    got = _node(tt, "LoadGoogleSearchPassages", **kw)()
    want = _node(jt, "LoadGoogleSearchPassages", **kw)()
    for key in ("train_passages", "full_passages"):
        assert got[key].ids == want[key].ids
        assert got[key].contents == want[key].contents
    assert "GS_112724" not in got["train_passages"].ids
    assert ("GS_112724" in got["full_passages"].ids) == full
    assert got["train_passages"].ids[-1] == "GS_112723"


def test_feature_loaders_match_jax(world):
    """LoadVinVLFeatures (each object's base64 feature dropped) and
    LoadOscarCaptionFeatures (merged across files)."""
    kw = dict(features_path={s: world[f"vinvl_{s}"]
                             for s in ("train", "test")})
    got = _node(tt, "LoadVinVLFeatures", **kw)()
    assert got == _node(jt, "LoadVinVLFeatures", **kw)()
    first = next(iter(got["vinvl_features"].values()))
    assert "feature" not in first["objects"][0]
    kw = dict(caption_features={s: world[f"captions_{s}"]
                                for s in ("train", "test")})
    assert _node(tt, "LoadOscarCaptionFeatures", **kw)() == \
        _node(jt, "LoadOscarCaptionFeatures", **kw)()


@pytest.mark.parametrize("combine", [True, False])
def test_ocr_features_match_jax(world, combine):
    """LoadGoogleOCRFeatures: the per-image JSONs, and with
    combine_with_vinvl each annotation on the objects whose box holds it,
    scored text-area / object-area, and each prediction's count."""
    vinvl = _node(tt, "LoadVinVLFeatures", features_path={
        s: world[f"vinvl_{s}"] for s in ("train", "test")})()
    kw = dict(ocr_features={"train": world["ocr_train"],
                            "test": world["ocr_test"],
                            "combine_with_vinvl": combine})
    got = _node(tt, "LoadGoogleOCRFeatures", **kw)(copy.deepcopy(vinvl))
    want = _node(jt, "LoadGoogleOCRFeatures", **kw)(copy.deepcopy(vinvl))
    assert got == want
    if combine:
        assert any(o.get("ocr") for pred in got["vinvl_features"].values()
                   for o in pred["objects"])


@pytest.mark.parametrize("flags", ["all", "none", "missing"])
def test_okvqa_data_matches_jax(world, flags):
    """LoadOKVQAData: the questions joined to their annotations, the
    caption (key str(image_id)), the VinVL objects and the OCR (key
    zfill(12)); a question whose image has no VinVL row raises KeyError in
    both."""
    vinvl = _node(tt, "LoadVinVLFeatures", features_path={
        s: world[f"vinvl_{s}"] for s in ("train", "test")})()
    feats = _node(tt, "LoadGoogleOCRFeatures", ocr_features={
        "train": world["ocr_train"], "test": world["ocr_test"],
        "combine_with_vinvl": True})(vinvl)
    caps = _node(tt, "LoadOscarCaptionFeatures", caption_features={
        s: world[f"captions_{s}"] for s in ("train", "test")})()
    kw = dict(questions_path={s: world[f"questions_{s}"]
                              for s in ("train", "test")},
              annotations_path={s: world[f"annotations_{s}"]
                                for s in ("train", "test")})
    if flags != "none":
        kw.update(add_caption_features=True, add_VinVL_features=True,
                  add_OCR_features=True)
    if flags == "missing":
        feats = copy.deepcopy(feats)
        feats["vinvl_features"].popitem()
        for mod in (tt, jt):
            with pytest.raises(KeyError):
                _node(mod, "LoadOKVQAData", **kw)(copy.deepcopy(feats),
                                                  caps)
        return
    got = _node(tt, "LoadOKVQAData", **kw)(copy.deepcopy(feats), caps)
    want = _node(jt, "LoadOKVQAData", **kw)(copy.deepcopy(feats), caps)
    assert got == want
    assert len(got["train"]) == 30 and len(got["test"]) == 24
    if flags == "all":
        it = got["train"][0]
        assert it["img_caption"].startswith("a photo of image")
        assert [o["class"] for o in it["objects"]] == ["cat", "sign", "tree"]


@pytest.mark.parametrize("use_all", [False, True])
def test_google_search_annotations_match_jax(world, use_all, tmp_path):
    """LoadGoogleSearchAnnotations: pos_item_ids and their contents; a
    question without annotations is dropped, or gets GS_0 with
    use_all_samples."""
    okvqa = _node(tt, "LoadOKVQAData", questions_path={
        s: world[f"questions_{s}"] for s in ("train", "test")},
        annotations_path={s: world[f"annotations_{s}"]
                          for s in ("train", "test")})()
    passages = _node(tt, "LoadGoogleSearchPassages",
                     passage_data_path=world["corpus"])()
    with open(world["gs_test"]) as f:
        partial = json.load(f)[:-3]           # three test questions bare
    path = tmp_path / "gs_test.json"
    path.write_text(json.dumps(partial))
    kw = dict(annotations_path={"train": world["gs_train"],
                                "test": str(path)},
              use_all_samples=use_all)
    got = _node(tt, "LoadGoogleSearchAnnotations", **kw)(okvqa, passages)
    want = _node(jt, "LoadGoogleSearchAnnotations", **kw)(okvqa, passages)
    for s in ("train", "test"):
        assert got[s] == want[s]
    assert len(got["test"]) == (24 if use_all else 21)


def _pipelines(config, opts, tmp_path):
    """Both packages' `--mode prepare_data` on the config with opts, then
    each pipeline's loaders (the port reads the nodes its prepare_data
    cached; the JAX package's from its own cache)."""
    out = {}
    for name, main, load, apply, build in (
            ("jax", jax_main.main, jax_load_config, jax_apply_overrides,
             lambda c, d: jax_main.build_pipeline(c, cache_dir=d)),
            ("port", port_main.main, load_config, apply_overrides,
             lambda c, d: port_main.build_pipeline(c, d, "cpu"))):
        log = str(tmp_path / name)
        argv = ["--config", config, "--mode", "prepare_data", "--log_dir",
                log, "--opts"] + opts
        if name == "port":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        cfg = apply(load(config), opts)
        out[name] = build(cfg, os.path.join(log, "default", "cache")) \
            .get_data(cfg.data_pipeline_output_node, explode=True)
    return out["port"], out["jax"]


def _same_items(got, want, keys):
    for s in ("train", "valid", "test"):
        assert len(got[s].items) == len(want[s].items)
        for g, w in zip(got[s].items, want[s].items):
            for k in keys:
                if k == "image_features":
                    np.testing.assert_array_equal(g[k], w[k])
                else:
                    assert g.get(k) == w.get(k), k


@pytest.mark.parametrize("config", ["flmr_base", "flmr_with_roi"])
def test_prepare_data_matches_jax(world, config, tmp_path):
    """`--mode prepare_data` on the published OK-VQA configs over the
    world's files: the loaders' items (question, pos_item_ids, ROIs,
    image_features and the rest) equal the JAX package's, and the
    passages. flmr_with_roi.json's ViT features come from the JAX run's
    feature cache, which the port's run then reads."""
    opts = config_opts(world)
    if config == "flmr_base":
        path = BASE_CONFIG
        opts = [o for o in opts if ".okvqa." in o or ".corpus." in o
                or ".annotations." in o or ".loaders." in o] + [
            "data_pipeline.features.setup_kwargs.features_path="
            + world["clip_features"]]
        keys = ("question_id", "question", "image_id", "answers",
                "pos_item_ids", "pos_item_contents", "image_features")
    else:
        path = ROI_CONFIG
        opts = opts + ["data_pipeline.features.setup_kwargs.cache_path="
                       + str(tmp_path / "vit.npz")]
        keys = ("question_id", "question", "img_caption", "objects",
                "img_ocr", "pos_item_ids", "ROIs", "image_features")
    got, want = _pipelines(path, opts, tmp_path)
    _same_items(got, want, keys)
    assert got["passages"]["full_passages"].ids == \
        want["passages"]["full_passages"].ids
    assert len(got["train"].items) == 30
    if config == "flmr_with_roi":
        assert got["train"].items[0]["image_features"].shape == (10, 64)
        assert any(it["ROIs"] for it in got["train"].items)


def test_use_dummy_data_keeps_20_items(world, tmp_path):
    """`--use_dummy_data` sets use_dummy_data on every node: LoadOKVQAData
    keeps each split's first 20 questions, in both packages, item for
    item."""
    opts = [o for o in config_opts(world) if ".okvqa." in o
            or ".corpus." in o or ".annotations." in o
            or ".loaders." in o] + [
        "data_pipeline.features.setup_kwargs.features_path="
        + world["clip_features"]]
    out = {}
    for name, main, load, apply, build in (
            ("jax", jax_main.main, jax_load_config, jax_apply_overrides,
             lambda c, d: jax_main.build_pipeline(c, cache_dir=d)),
            ("port", port_main.main, load_config, apply_overrides,
             lambda c, d: port_main.build_pipeline(c, d, "cpu"))):
        log = str(tmp_path / name)
        argv = ["--config", BASE_CONFIG, "--mode", "prepare_data",
                "--use_dummy_data", "--log_dir", log, "--opts"] + opts
        assert main(argv) == 0
        cfg = apply(load(BASE_CONFIG), opts + [
            f"data_pipeline.{n}.setup_kwargs.use_dummy_data=True"
            for n in ("okvqa", "corpus", "annotations", "features",
                      "loaders")])
        out[name] = build(cfg, os.path.join(log, "default", "cache")) \
            .get_data(cfg.data_pipeline_output_node, explode=True)
    for s in ("train", "test"):
        assert len(out["port"][s].items) == 20
    _same_items(out["port"], out["jax"], ("question_id", "question",
                                          "pos_item_ids", "image_features"))
    cached = os.listdir(os.path.join(tmp_path, "port", "default", "cache"))
    assert cached and all(f.endswith(".torch.pkl") for f in cached)


def test_vinvl_rows_past_the_csv_field_limit(tmp_path):
    """A real VinVL row (here 30 objects with 2,048-d base64 features,
    ~330 KB) is past csv's default field limit of 131,072 characters: the
    port's LoadVinVLFeatures lifts the limit and reads it, its features
    dropped. The JAX node keeps the limit (ROADMAP C24); the port's call,
    first, lifts it for the process, after which the JAX node reads the
    same row to the same output."""
    rng = np.random.default_rng(0)
    objs = [{"class": "cat", "rect": [1.0, 2.0, 30.0, 40.0], "conf": 0.3,
             "attributes": [], "attr_scores": [],
             "feature": base64.b64encode(rng.normal(size=2048).astype(
                 np.float32).tobytes()).decode()} for _ in range(30)]
    row = json.dumps({"objects": objs, "num_boxes": 30})
    assert len(row) > 131072
    path = tmp_path / "predictions.tsv"
    path.write_text(f"000000000042\t{row}\n")
    got = _node(tt, "LoadVinVLFeatures",
                features_path={"test": str(path)})()
    assert len(got["vinvl_features"]["000000000042"]["objects"]) == 30
    assert "feature" not in got["vinvl_features"]["000000000042"][
        "objects"][0]
    assert got == _node(jt, "LoadVinVLFeatures",
                        features_path={"test": str(path)})()
