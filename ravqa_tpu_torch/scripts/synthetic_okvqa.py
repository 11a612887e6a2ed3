"""Write a synthetic OK-VQA world in the formats configs/okvqa/ reads.

    python -m ravqa_tpu_torch.scripts.synthetic_okvqa [OUT_DIR] \\
        [--images 128] [--train 256] [--test 64] [--passages 16384] \\
        [--image-hw 480 640] [--seed 0]

writes OUT_DIR (default data/okvqa/synthetic, which
configs/synthetic_flmr_roi_train.json reads):

- images.npz: one RGB uint8 image a COCO-style image id (key
  str(image_id)), smooth random blobs over noise;
- questions_{train,test}.json / annotations_{train,test}.json: the
  official VQA formats ({"questions": [{question_id, image_id,
  question}]}, {"annotations": [{question_id, answers: 10 x {answer},
  multiple_choice_answer, question_type, answer_type}]});
- full_corpus.csv: the GoogleSearch corpus `kid,content`, its kids
  running across the train split's boundary at 112724 (the first three
  quarters before it); gs_{train,test}.json: the DPR-style annotations
  [{question_id, ctxs: [{id, has_answer}]}], a train question's positive
  always before the boundary;
- ocr/{train,test}/<zfill(12) id>_ocr.json: Google-OCR
  `filtered_text_annotations` ({description, vertices});
- labelmap.json (VG-SGG-dicts layout: idx_to_label for 1,594 classes,
  idx_to_attribute for 524 attributes) and vocab.txt, a BERT-base-layout
  vocabulary (30,522 lines: [PAD] 0, [unused0..98], [UNK] 100, [CLS]
  101, [SEP] 102, [MASK] 103, then every word these files use, the
  letters and their ## pieces, then filler words w0, w1, ...) standing
  in for bert-base-uncased's.

A question repeats words of its positive passage and names a class;
its answer is a word of the passage. The VinVL predictions.tsv and the
caption JSON are what the extractors write from these images
(`extract_vinvl_features`, `run_captioning`); `paths()` names where the
config expects them, and `--extract tiny|full` writes them with the
extractors' loops and random weights from the seed (`extract_synthetic`;
`--device cpu` runs them on the CPU). Nothing is downloaded.
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

from ..data.transforms import GS_TRAIN_BOUNDARY

DEFAULT_DIR = os.path.join("data", "okvqa", "synthetic")
WORDS = ("cat dog sky sun tree fish bird car red blue big old hot wet sad "
         "fast tall round green small boat train horse kite pizza clock "
         "snow beach river road bus plate cake bench shirt table window "
         "grass water field street").split()
QUESTION = "what is the {} {} near the {}"
VOCAB_SIZE = 30522                       # bert-base-uncased's


def class_names(n: int = 1594) -> list[str]:
    """Names of the detector's classes 1..n (index 0 is background)."""
    return [WORDS[i] if i < len(WORDS) else f"thing{i}" for i in range(n)]


def attribute_names(n: int = 524) -> list[str]:
    return [f"attr{i}" for i in range(n)]


def paths(out_dir: str = DEFAULT_DIR) -> dict:
    """Where each file of the world lives (the extractors' outputs too)."""
    j = lambda *p: os.path.join(out_dir, *p)  # noqa: E731
    out = {"images": j("images.npz"), "corpus": j("full_corpus.csv"),
           "labelmap": j("labelmap.json"), "vocab": j("vocab.txt")}
    for s in ("train", "test"):
        out.update({f"questions_{s}": j(f"questions_{s}.json"),
                    f"annotations_{s}": j(f"annotations_{s}.json"),
                    f"gs_{s}": j(f"gs_{s}.json"), f"ocr_{s}": j("ocr", s),
                    f"vinvl_{s}": j("vinvl", s, "predictions.tsv"),
                    f"captions_{s}": j("captions",
                                       f"{s}_predictions.json")})
    return out


def config_opts(p: dict) -> list[str]:
    """--opts pointing configs/okvqa/flmr_with_roi.json's data nodes (and
    configs/synthetic_flmr_roi_train.json's) at the world in p."""
    dp = "data_pipeline"
    split = lambda k: {s: p[f"{k}_{s}"] for s in ("train", "test")}  # noqa
    return [
        f"{dp}.okvqa.setup_kwargs.questions_path={split('questions')}",
        f"{dp}.okvqa.setup_kwargs.annotations_path="
        f"{split('annotations')}",
        f"{dp}.corpus.setup_kwargs.passage_data_path={p['corpus']}",
        f"{dp}.annotations.setup_kwargs.annotations_path={split('gs')}",
        f"{dp}.vinvl.setup_kwargs.features_path={split('vinvl')}",
        f"{dp}.captions.setup_kwargs.caption_features="
        f"{split('captions')}",
        f"{dp}.ocr.setup_kwargs.ocr_features="
        f"{dict(split('ocr'), combine_with_vinvl=True)}",
        f"{dp}.features.setup_kwargs.image_store={p['images']}",
        f"{dp}.loaders.setup_kwargs.vocab_path={p['vocab']}"]


def write_vocab(path: str, words) -> None:
    toks = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + \
        ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    toks += list("abcdefghijklmnopqrstuvwxyz0123456789<>?.,!'")
    toks += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    seen = set(toks)
    for w in words:
        if w not in seen:
            seen.add(w)
            toks.append(w)
    toks += [f"w{i}" for i in range(VOCAB_SIZE - len(toks))]
    with open(path, "w") as f:
        f.write("\n".join(toks[:VOCAB_SIZE]) + "\n")


def _image(rng, h: int, w: int) -> np.ndarray:
    """Noise under a few smooth colour blobs (something for a detector's
    and a ViT's filters to respond to)."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    img = rng.normal(110, 30, (h, w, 3)).astype(np.float32)
    for _ in range(4):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.1, 0.3) * min(h, w)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        img += blob[..., None] * rng.uniform(-120, 120, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_synthetic_okvqa(out_dir: str = DEFAULT_DIR, n_images: int = 128,
                          n_train: int = 256, n_test: int = 64,
                          n_passages: int = 16384, image_hw=(480, 640),
                          seed: int = 0) -> dict:
    """-> paths(out_dir) plus "image_ids" (the images' COCO-style ids) and
    "splits" ({split: the image ids its questions use})."""
    rng = np.random.default_rng(seed)
    p = paths(out_dir)
    for s in ("train", "test"):
        os.makedirs(p[f"ocr_{s}"], exist_ok=True)
        os.makedirs(os.path.dirname(p[f"vinvl_{s}"]), exist_ok=True)
        os.makedirs(os.path.dirname(p[f"captions_{s}"]), exist_ok=True)
    image_ids = sorted(int(i) for i in rng.choice(
        np.arange(1, 600_000), n_images, replace=False))
    h, w = image_hw
    np.savez(p["images"], **{str(i): _image(rng, h, w) for i in image_ids})

    # the corpus: the first three quarters before the train boundary
    first = int(GS_TRAIN_BOUNDARY) - (3 * n_passages) // 4
    kids = list(range(first, first + n_passages))
    contents = [" ".join(rng.choice(WORDS, int(rng.integers(12, 31))))
                for _ in kids]
    with open(p["corpus"], "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["kid", "content"])
        wr.writerows(zip(kids, contents))
    n_before = int(GS_TRAIN_BOUNDARY) - first

    classes = class_names()
    splits = {}
    qid = 1
    for s, n in (("train", n_train), ("test", n_test)):
        qs, anns, gs = [], [], []
        for j in range(n):
            image_id = image_ids[int(rng.integers(n_images))]
            d = int(rng.integers(n_before if s == "train" else n_passages))
            words = contents[d].split()
            qs.append({"question_id": qid, "image_id": image_id,
                       "question": QUESTION.format(
                           words[0], words[1],
                           classes[int(rng.integers(len(WORDS)))])})
            answer = words[int(rng.integers(len(words)))]
            anns.append({"question_id": qid,
                         "answers": [{"answer": answer}] * 10,
                         "multiple_choice_answer": answer,
                         "question_type": "what is the",
                         "answer_type": "other"})
            gs.append({"question_id": qid,
                       "ctxs": [{"id": str(kids[d]), "has_answer": True}]})
            qid += 1
        for key, obj in ((f"questions_{s}", {"questions": qs}),
                         (f"annotations_{s}", {"annotations": anns}),
                         (f"gs_{s}", gs)):
            with open(p[key], "w") as f:
                json.dump(obj, f)
        splits[s] = sorted({q["image_id"] for q in qs})
        for image_id in splits[s]:
            texts = []
            for _ in range(int(rng.integers(0, 4))):
                x0, y0 = rng.uniform(0, 0.8 * w), rng.uniform(0, 0.9 * h)
                x1 = x0 + rng.uniform(0.02, 0.2) * w
                y1 = y0 + rng.uniform(0.02, 0.1) * h
                texts.append({"description": str(rng.choice(WORDS)),
                              "vertices": [[x0, y0], [x1, y0], [x1, y1],
                                           [x0, y1]]})
            with open(os.path.join(p[f"ocr_{s}"],
                                   f"{str(image_id).zfill(12)}_ocr.json"),
                      "w") as f:
                json.dump({"filtered_text_annotations": texts}, f)
    with open(p["labelmap"], "w") as f:
        json.dump({"idx_to_label": {str(i + 1): c
                                    for i, c in enumerate(classes)},
                   "idx_to_attribute": {
                       str(i + 1): a
                       for i, a in enumerate(attribute_names())}}, f)
    write_vocab(p["vocab"], WORDS + ["what", "is", "the", "near", "a", "of",
                                     "boq", "eoq", "boc", "eoc", "bov",
                                     "sov", "eov"]
                + classes[len(WORDS):] + attribute_names())
    return dict(p, image_ids=image_ids, splits=splits)


def synthetic_vinvl_state_dict(cfg, seed: int = 0,
                               branch_scale: float = 0.2) -> dict:
    """A maskrcnn-layout VinVL state dict (scene_graph_benchmark's module
    names, as convert_vinvl_params reads them) with random weights from a
    CPU generator seeded with `seed`: convolutions by maskrcnn's
    c2_msra_fill (He normal over fan-out), the RPN and the predictors by
    its normal(0.01) / normal(0.001) (bbox_pred) rules, zero biases, and
    FrozenBN statistics of identity (weight 1, mean 0, var 1) except each
    bottleneck's last BN, whose weight `branch_scale` keeps the residual
    stream near unit scale through layer3's 36 blocks (a choice of test
    weights: with 1 the activations grow block by block)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def normal(shape, std):
        return torch.randn(shape, generator=g) * std

    def conv(name, cout, cin, k, bias=False, groups=1, std=None):
        fan_out = cout * k * k
        sd[f"{name}.weight"] = normal(
            (cout, cin // groups, k, k),
            std if std is not None else (2.0 / fan_out) ** 0.5)
        if bias:
            sd[f"{name}.bias"] = torch.zeros(cout)

    def bn(name, c, weight=1.0):
        sd[f"{name}.weight"] = torch.full((c,), weight)
        sd[f"{name}.bias"] = torch.zeros(c)
        sd[f"{name}.running_mean"] = torch.zeros(c)
        sd[f"{name}.running_var"] = torch.ones(c)

    def stage(prefix, n, cin, cmid, cout):
        for i in range(n):
            pre = f"{prefix}.{i}"
            conv(f"{pre}.conv1", cmid, cin if i == 0 else cout, 1)
            bn(f"{pre}.bn1", cmid)
            conv(f"{pre}.conv2", cmid, cmid, 3, groups=cfg.num_groups)
            bn(f"{pre}.bn2", cmid)
            conv(f"{pre}.conv3", cout, cmid, 1)
            bn(f"{pre}.bn3", cout, branch_scale)
            if i == 0:
                conv(f"{pre}.downsample.0", cout, cin, 1)
                bn(f"{pre}.downsample.1", cout)

    conv("backbone.body.stem.conv1", cfg.stem_channels, 3, 7)
    bn("backbone.body.stem.bn1", cfg.stem_channels)
    cin = cfg.stem_channels
    for si, n in enumerate(cfg.stage_blocks):
        stage(f"backbone.body.layer{si + 1}", n, cin,
              cfg.bottleneck_channels[si], cfg.stage_out_channels[si])
        cin = cfg.stage_out_channels[si]
    c4, r5 = cfg.backbone_out_channels, cfg.res5_out_channels
    conv("rpn.head.conv", c4, c4, 3, bias=True, std=0.01)
    conv("rpn.head.cls_logits", cfg.num_anchors, c4, 1, bias=True,
         std=0.01)
    conv("rpn.head.bbox_pred", cfg.num_anchors * 4, c4, 1, bias=True,
         std=0.01)
    stage("roi_heads.box.feature_extractor.head.layer4", cfg.res5_blocks,
          c4, cfg.num_groups * cfg.width_per_group
          * 2 ** len(cfg.stage_blocks), r5)
    for name, cout, cin, std in (
            ("roi_heads.box.predictor.cls_score", cfg.num_classes, r5,
             0.01),
            ("roi_heads.box.predictor.bbox_pred", cfg.num_classes * 4, r5,
             0.001),
            ("attribute.predictor.fc_attr", cfg.attr_emd_dim,
             r5 + cfg.cls_emd_dim, 0.01),
            ("attribute.predictor.attr_score", cfg.num_attributes,
             cfg.attr_emd_dim, 0.01)):
        sd[f"{name}.weight"] = normal((cout, cin), std)
        sd[f"{name}.bias"] = torch.zeros(cout)
    sd["attribute.predictor.cls_embedding.weight"] = normal(
        (cfg.num_classes, cfg.cls_emd_dim), 0.01)
    return sd


def synthetic_oscar_state_dict(cfg, seed: int = 0) -> dict:
    """An Oscar BertForImageCaptioning-layout state dict (HF BERT names
    under bert., bert.img_embedding, cls.predictions.*) with BERT's
    normal(0.02) weights from a CPU generator seeded with `seed`, zero
    biases and unit LayerNorm scales."""
    import torch
    from ..models.convert_flmr import _bert_names
    b = cfg.bert
    h, inter = b.hidden_size, b.intermediate_size
    g = torch.Generator().manual_seed(seed)
    shapes = {"embeddings.word_embeddings": (b.vocab_size, h),
              "embeddings.position_embeddings": (b.max_position_embeddings,
                                                 h),
              "embeddings.token_type_embeddings": (b.type_vocab_size, h),
              "pooler.dense": (h, h)}
    sd = {}
    for hf in _bert_names(b.num_layers):
        if hf.endswith("LayerNorm"):
            sd[f"bert.{hf}.weight"] = torch.ones(h)
            sd[f"bert.{hf}.bias"] = torch.zeros(h)
            continue
        shape = shapes.get(hf) or ((inter, h) if "intermediate" in hf else
                                   (h, inter) if hf.endswith("output.dense")
                                   and "attention" not in hf else (h, h))
        sd[f"bert.{hf}.weight"] = torch.randn(shape, generator=g) * 0.02
        if "embeddings" not in hf:
            sd[f"bert.{hf}.bias"] = torch.zeros(shape[0])
    sd["bert.img_embedding.weight"] = torch.randn(
        (h, cfg.img_feature_dim), generator=g) * 0.02
    sd["bert.img_embedding.bias"] = torch.zeros(h)
    pre = "cls.predictions"
    sd[f"{pre}.transform.dense.weight"] = torch.randn((h, h),
                                                      generator=g) * 0.02
    sd[f"{pre}.transform.dense.bias"] = torch.zeros(h)
    sd[f"{pre}.transform.LayerNorm.weight"] = torch.ones(h)
    sd[f"{pre}.transform.LayerNorm.bias"] = torch.zeros(h)
    sd[f"{pre}.bias"] = torch.zeros(b.vocab_size)
    return sd


def extract_synthetic(p: dict, det_cfg, cap_cfg, device="cuda",
                      canvas=(1024, 1024), batch: int = 8,
                      min_size: int = 600, max_size: int = 1000,
                      seed: int = 0, log=print) -> None:
    """Run the extractors over the world in p with random weights from the
    seed (synthetic_vinvl_state_dict / synthetic_oscar_state_dict through
    convert_vinvl_params / convert_oscar_captioner_params), through the
    scripts' own loops: predictions.tsv per split, keyed by the zero-padded
    image id, and the caption JSON per split, keyed str(image_id) as
    LoadOKVQAData reads it (the captioning script keys it by the TSV's key:
    ROADMAP C23)."""
    from ..data.extraction import (VinVLFeatureExtractor, load_vg_labelmap,
                                   write_predictions_tsv)
    from ..models.captioner import (OscarCaptioner,
                                    convert_oscar_captioner_params,
                                    write_caption_predictions)
    from ..models.detection import convert_vinvl_params
    from ..tokenization import WordPieceTokenizer
    from .extract_vinvl_features import extract
    from .run_captioning import caption_rows
    lab, attr = load_vg_labelmap(p["labelmap"])
    ex = VinVLFeatureExtractor(
        det_cfg, convert_vinvl_params(synthetic_vinvl_state_dict(
            det_cfg, seed), det_cfg), lab, attr, canvas_hw=canvas,
        batch_size=batch, min_size=min_size, max_size=max_size,
        device=device)
    store = np.load(p["images"])
    keys = [str(i) for i in p["image_ids"]]
    preds = dict(zip(keys, extract(ex, keys, lambda k: store[k], log)))
    del ex
    model = OscarCaptioner(cap_cfg, device="meta")
    model.load_state_dict(convert_oscar_captioner_params(
        synthetic_oscar_state_dict(cap_cfg, seed), cap_cfg), assign=True)
    model = model.to(device).eval()
    tok = WordPieceTokenizer(p["vocab"])
    for s in ("train", "test"):
        ks = [str(i) for i in p["splits"][s]]
        rows = [(k.zfill(12), preds[k]) for k in ks]
        write_predictions_tsv(p[f"vinvl_{s}"], [r[0] for r in rows],
                              [r[1] for r in rows])
        caps = caption_rows(model, tok, rows, 16, log)
        write_caption_predictions(p[f"captions_{s}"], {
            k: caps[k.zfill(12)] for k in ks})


def main(argv=None):
    ap = argparse.ArgumentParser("synthetic_okvqa")
    ap.add_argument("out_dir", nargs="?", default=DEFAULT_DIR)
    ap.add_argument("--images", type=int, default=128)
    ap.add_argument("--train", type=int, default=256)
    ap.add_argument("--test", type=int, default=64)
    ap.add_argument("--passages", type=int, default=16384)
    ap.add_argument("--image-hw", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--extract", choices=["none", "tiny", "full"],
                    default="none",
                    help="also run the VinVL detector and the Oscar "
                         "captioner with random weights: at the tiny test "
                         "widths, or the full ones (vinvl_x152c4, "
                         "Oscar-base)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = write_synthetic_okvqa(a.out_dir, a.images, a.train, a.test,
                                a.passages, tuple(a.image_hw), a.seed)
    if a.extract != "none":
        from ..models.bert import BertConfig
        from ..models.captioner import CaptionerConfig
        from ..models.detection import DetectorConfig
        det = (DetectorConfig.tiny() if a.extract == "tiny"
               else DetectorConfig.vinvl_x152c4())
        cap = (CaptionerConfig.tiny(
            img_feature_dim=det.res5_out_channels + 6,
            bert=BertConfig.tiny(vocab_size=VOCAB_SIZE))
            if a.extract == "tiny" else CaptionerConfig())
        extract_synthetic(out, det, cap, a.device, seed=a.seed)
    print({k: v for k, v in out.items() if k not in ("image_ids",
                                                     "splits")})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
