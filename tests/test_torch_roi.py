"""The ROI half of FLMR-with-ROI in ravqa_tpu_torch against ravqa_tpu on
the CPU: select_rois, both crop nodes, the host resize,
ExtractImageFeaturesWithViT, the ROI query, and the slice as a whole
(the port's extractors, then `main --mode train` and `--mode test` on
configs/okvqa/flmr_with_roi.json at tiny widths, held to the JAX
package's run_eval on the port's checkpoint).

Tolerances: select_rois, the crop records and _resize_host exactly (the
same Python and numpy arithmetic); the ViT features 1e-5 (the tiny ViT's
JAX parameters carried across; XLA and PyTorch order the reductions
differently); the ROI query 1e-5 (atol, rtol 1e-4); the CLI's metrics
equal.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu import main as jax_main
from ravqa_tpu.config import apply_overrides as jax_apply_overrides
from ravqa_tpu.config import load_config as jax_load_config
from ravqa_tpu.data import transforms as jt
from ravqa_tpu.models import flmr as jax_flmr
from ravqa_tpu.models import vit as jax_vit
from ravqa_tpu_torch.data import transforms as tt
from ravqa_tpu_torch.models import (FLMRModelConfig, FLMRRetriever,
                                    ViTConfig, flax_to_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROI_CONFIG = os.path.join(REPO, "configs", "okvqa", "flmr_with_roi.json")
CLASSES = ["cat", "dog", "sign", "tree", "car"]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _objects(rng, n, w=120, h=90):
    objs = []
    for _ in range(n):
        x0, y0 = rng.uniform(0, w - 10), rng.uniform(0, h - 10)
        objs.append({"class": str(rng.choice(CLASSES)),
                     "rect": [x0, y0, min(w, x0 + rng.uniform(3, 60)),
                              min(h, y0 + rng.uniform(3, 60))]})
    # a box inside an earlier one of the same class
    if objs:
        x0, y0, x1, y1 = objs[0]["rect"]
        objs.append({"class": objs[0]["class"],
                     "rect": [x0 + 1, y0 + 1, max(x0 + 1, x1 - 1),
                              max(y0 + 1, y1 - 1)]})
    return objs


def _items(rng, n, with_size=False):
    out = []
    for i in range(n):
        it = {"question_id": str(i), "image_id": 100 + i % 3,
              "question": f"what is the {rng.choice(CLASSES)} near it",
              "objects": _objects(rng, int(rng.integers(0, 12)))}
        if with_size and i % 2:
            it["img_size"] = (120, 90)
        out.append(it)
    return out


@pytest.mark.parametrize("seed,max_objects", [(0, 9), (1, 3), (2, 1),
                                              (3, 9)])
def test_select_rois_matches_jax(seed, max_objects):
    rng = np.random.default_rng(seed)
    for it in _items(rng, 8):
        assert tt.select_rois(it["objects"], it["question"], max_objects) \
            == jt.select_rois(it["objects"], it["question"], max_objects)


@pytest.mark.parametrize("kind", ["roi", "random", "even"])
def test_crop_nodes_match_jax(kind):
    """CropRegionOfInterestImages, and CropRandomRegionOfInterestImages with
    its seeded random boxes (numpy default_rng, the same draw order) and
    its even grid: the same ROIs per item and the same crop records."""
    rng = np.random.default_rng(7)
    data = {"train": _items(rng, 6, True), "test": _items(rng, 3, True),
            "passages": {"note": "not a split"}}
    name, kw = {"roi": ("CropRegionOfInterestImages", {"max_objects": 4}),
                "random": ("CropRandomRegionOfInterestImages",
                           {"max_objects": 5, "seed": 3,
                            "image_size": (64, 48)}),
                "even": ("CropRandomRegionOfInterestImages",
                         {"max_objects": 4, "even_split": True})}[kind]
    got, want = (getattr(mod, name)() for mod in (tt, jt))
    got.setup(**kw)
    want.setup(**kw)
    out_p, out_j = got(copy.deepcopy(data)), want(copy.deepcopy(data))
    assert out_p == out_j
    assert out_p["roi_crops"] and all(it["ROIs"] for it in out_p["train"]
                                      if kind != "roi")


def test_resize_host_matches_jax():
    rng = np.random.default_rng(0)
    for shape, size in (((50, 70, 3), 32), ((13, 9, 3), (20, 33)),
                        ((40, 40), 224), ((1, 5, 3), 7)):
        im = rng.integers(0, 255, shape).astype(np.uint8)
        np.testing.assert_array_equal(tt._resize_host(im, size),
                                      jt._resize_host(im, size))


@pytest.fixture(scope="module")
def vit_params():
    cfg = jax_vit.ViTConfig.tiny()
    return jax.device_get(jax.jit(jax_vit.CLIPVisionModel(cfg).init)(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32)))[
            "params"]


@pytest.mark.parametrize("source", ["image_loader", "image_store"])
def test_vit_features_match_jax(vit_params, source, tmp_path):
    """ExtractImageFeaturesWithViT on images and their ROI crops with the
    tiny ViT's JAX parameters: features 1e-5, the num_rois padding (a
    repeated last ROI, the global row for an item with none), and the same
    cache keys; a second run reads its cache and builds no model."""
    rng = np.random.default_rng(0)
    images = {str(100 + i): rng.integers(0, 255, (90, 120, 3)).astype(
        np.uint8) for i in range(3)}
    store = str(tmp_path / "images.npz")
    np.savez(store, **images)
    data = {"train": _items(np.random.default_rng(1), 5)}
    data["train"][1]["objects"] = []
    crop = jt.CropRegionOfInterestImages()
    crop.setup(max_objects=4)
    data = crop(data)
    src = ({"image_loader": images.__getitem__} if source == "image_loader"
           else {"image_store": store})
    out = {}
    for name, mod, cfg in (("jax", jt, jax_vit.ViTConfig.tiny()),
                           ("port", tt, ViTConfig.tiny())):
        node = mod.ExtractImageFeaturesWithViT()
        node.setup(vit_config=cfg, vit_params=vit_params, image_size=32,
                   num_rois=3, batch_size=4,
                   cache_path=str(tmp_path / f"{name}.npz"),
                   **src, **({"device": "cpu"} if mod is tt else {}))
        out[name] = node(copy.deepcopy(data))
    for g, w in zip(out["port"]["train"], out["jax"]["train"]):
        assert g["image_features"].shape == (4, 64)
        np.testing.assert_allclose(g["image_features"], w["image_features"],
                                   rtol=0, atol=1e-5)
    assert (out["port"]["train"][1]["image_features"] ==
            out["port"]["train"][1]["image_features"][0]).all()
    keys = {n: sorted(np.load(str(tmp_path / f"{n}.npz")).files)
            for n in out}
    assert keys["port"] == keys["jax"]
    # the cache holds every id: no model is built the second time
    node = tt.ExtractImageFeaturesWithViT()
    node.setup(vit={"tiny": True}, image_size=32, num_rois=3, device="cpu",
               cache_path=str(tmp_path / "port.npz"), **src)
    node._model = None
    again = node(copy.deepcopy(data))
    for g, w in zip(again["train"], out["port"]["train"]):
        np.testing.assert_array_equal(g["image_features"],
                                      w["image_features"])


def test_flmr_roi_query_matches_jax():
    """The FLMR query over (1 + 9) image features: Lq = text + 10 x prefix
    tokens, against the JAX model's with its parameters carried across."""
    rng = np.random.default_rng(2)
    jcfg = jax_flmr.FLMRModelConfig.tiny()
    cfg = FLMRModelConfig.tiny()
    qi = rng.integers(5, cfg.bert.vocab_size, (3, 9)).astype(np.int32)
    qm = np.ones((3, 9), np.int32)
    qm[1, 6:] = 0
    qi[1, 6:] = 0
    feats = rng.normal(size=(3, 10, cfg.vision_dim)).astype(np.float32)
    jm = jax_flmr.FLMRRetriever(jcfg)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(qi), jnp.asarray(qm),
                     jnp.asarray(feats),
                     method=jax_flmr.FLMRRetriever.query)["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(qi),
                               jnp.asarray(qm), jnp.asarray(feats),
                               method=jax_flmr.FLMRRetriever.query))
    tm = FLMRRetriever(cfg)
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)),
                       strict=False)
    with torch.no_grad():
        got = tm.eval().query(torch.from_numpy(qi).long(),
                              torch.from_numpy(qm),
                              torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (3, 9 + 10 * cfg.prefix_len, cfg.dim)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


TINY_OPTS = [
    "data_pipeline.loaders.setup_kwargs.doc_maxlen=16",
    "data_pipeline.loaders.setup_kwargs.nway=2",
    "model_config.bert={'vocab_size': 30522, 'hidden_size': 64, "
    "'num_layers': 1, 'num_heads': 4, 'intermediate_size': 128, "
    "'max_position_embeddings': 64}",
    "model_config.mapping_network_prefix_length=2",
    "model_config.num_negative_samples=1",
    "train.batch_size=4", "train.total_steps=3", "train.log_every=1",
    "train.val_every=3", "metrics.Ks=[1, 5]"]


def test_cli_roi_train_test_matches_jax(tmp_path):
    """The slice on the CPU: a synthetic OK-VQA world, the port's tiny
    VinVL detector and Oscar captioner over its images (extract_synthetic),
    then `main --mode train` and `--mode test` on flmr_with_roi.json
    (the ViT features cached); the test metrics equal the final
    validation's and the JAX package's run_eval on the port's checkpoint
    over the same files (the JAX pipeline reads the port's feature cache),
    whose batches carry 32 text tokens and 1 + 9 image rows a query."""
    from ravqa_tpu_torch.main import main
    from ravqa_tpu_torch.models import BertConfig
    from ravqa_tpu_torch.models.captioner import CaptionerConfig
    from ravqa_tpu_torch.models.detection import DetectorConfig
    from ravqa_tpu_torch.scripts.synthetic_okvqa import (
        VOCAB_SIZE, config_opts, extract_synthetic, write_synthetic_okvqa)
    p = write_synthetic_okvqa(str(tmp_path / "world"), n_images=6,
                              n_train=12, n_test=6, n_passages=64,
                              image_hw=(48, 64))
    det = DetectorConfig.tiny()
    extract_synthetic(p, det, CaptionerConfig.tiny(
        img_feature_dim=det.res5_out_channels + 6,
        bert=BertConfig.tiny(vocab_size=VOCAB_SIZE)), "cpu",
        canvas=(64, 64), batch=4, min_size=48, max_size=64,
        log=lambda m: None)
    with open(p["captions_train"]) as f:
        assert set(json.load(f)) == {str(i) for i in p["splits"]["train"]}
    opts = config_opts(p) + TINY_OPTS + [
        "data_pipeline.features.setup_kwargs.cache_path="
        + str(tmp_path / "vit.npz")]
    log = str(tmp_path / "exp")
    common = ["--config", ROI_CONFIG, "--device", "cpu", "--log_dir", log,
              "--experiment_name", "roi", "--opts"] + opts
    assert main(["--mode", "train"] + common) == 0
    assert main(["--mode", "test"] + common) == 0
    exp = os.path.join(log, "roi")
    hist = [json.loads(line) for line in open(os.path.join(exp,
                                                           "metrics.jsonl"))]
    assert all(np.isfinite(h["train/loss"]) for h in hist
               if "train/loss" in h)
    final = {k[len("valid/"):]: v for h in hist if h["step"] == 3
             for k, v in h.items() if k.startswith("valid/")}
    with open(os.path.join(exp, "test_metrics.json")) as f:
        got = json.load(f)
    assert got == final and "pos_item_ids_recall_at_5" in got
    jcfg = jax_apply_overrides(jax_load_config(ROI_CONFIG), opts)
    jdata = jax_main.build_pipeline(jcfg, cache_dir=None).get_data(
        jcfg.data_pipeline_output_node, explode=True)
    jex = jax_main.build_executor(jcfg, jdata, None, str(tmp_path / "j"),
                                  quiet=True)
    jex.load_checkpoint(os.path.join(exp, "ckpt"))
    assert jax_main.run_eval(jcfg, jex, jdata, str(tmp_path / "j"),
                             "test") == got
    batch = jdata["test"].collate([0, 1])
    assert batch["image_features"].shape == (2, 10, 64)
    assert batch["query_input_ids"].shape == (2, 32)
