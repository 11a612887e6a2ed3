"""Data transforms for the retrieval slices.

Ports of ravqa_tpu/data/transforms.py:
- SyntheticOKVQA (:314-357): the synthetic world (word-bag passages,
  questions repeating words of their positive passage, random image
  features, and with `n_patches` random patch features, with
  `emit_pixels` random uint8 images in place of the features); from the
  same seed it gives the same corpus, questions, features and images as
  the JAX package.
- PrepareDataloaders (:360-394): the WordPiece base tokenizer (the tiny
  synthetic vocab when no vocab_path), the ColBERT query and doc
  tokenizers, the passages, and one RetrievalDataset per split ("valid"
  falls back to "test"), the JAX package's layout.
- LoadImageFeatures (:297-311): per-image features from an .npz store
  keyed by str(image_id), written into the items in place.
- LoadM2KRData (:397-434): an M2KR-style task from a passages jsonl and
  one queries jsonl per split, with optional per-question features.
- The OK-VQA loaders: LoadGoogleSearchPassages (:39-62; the GoogleSearch
  CSV with the train split ending before kid 112724, ids "GS_<kid>"),
  LoadOKVQAData (:191-259; the VQA-format questions and annotations,
  caption key str(image_id), VinVL/OCR key zfill(12), a KeyError on
  missing VinVL features, the use_dummy_data 20-item cut) and
  LoadGoogleSearchAnnotations (:262-295, with use_all_samples).
- The offline features: LoadVinVLFeatures (:65-87; each object's base64
  `feature` dropped), LoadOscarCaptionFeatures (:90-104) and
  LoadGoogleOCRFeatures (:133-188, with combine_with_vinvl's text-area /
  object-area score).
- The ROIs: select_rois (:435-460), CropRegionOfInterestImages (:463-490),
  CropRandomRegionOfInterestImages (:493-555; numpy default_rng(seed) in
  the same draw order) and ExtractImageFeaturesWithViT (:558-691): the
  port's CLIP ViT on the run's device over the images and their ROI
  crops, each resized on the host by `_resize_host` (:107-130).
"""

from __future__ import annotations

import csv
import json
import math
import os
import sys

import numpy as np

from ..tokenization import (DocTokenizer, QueryTokenizer,
                            WordPieceTokenizer, make_tiny_vocab)
from .datasets import PassageCorpus, RetrievalDataset
from .pipeline import BaseTransform, register_transform


@register_transform
class SyntheticOKVQA(BaseTransform):
    """setup: n_docs=64, n_questions=32, vision_dim=16, seed=0,
    n_patches=0 (> 0: (n_patches, vision_dim) patch features per question),
    emit_pixels=0 (> 0: an (S, S, 3) uint8 image per question, which then
    carries no image features: an in-graph ViT takes the pixels),
    features_with_pixels=False (True: an item with an image keeps its image
    features too, as the RAVQA-v2 recipe's data carry both: the features
    for FLMR's mapping network, the pixels for BLIP-2; not in the JAX
    package's copy, and off leaves every item as there)."""

    WORDS = ["cat", "dog", "sky", "sun", "tree", "fish", "bird", "car",
             "red", "blue", "big", "old", "hot", "wet", "sad", "fast",
             "tall", "round", "green", "small"]

    def __call__(self, *inputs):
        n_docs = getattr(self, "n_docs", 64)
        n_q = getattr(self, "n_questions", 32)
        vdim = getattr(self, "vision_dim", 16)
        n_patches = getattr(self, "n_patches", 0)
        pixels = getattr(self, "emit_pixels", 0)
        rng = np.random.default_rng(getattr(self, "seed", 0))
        contents = [" ".join(rng.choice(self.WORDS, 5, replace=False))
                    for _ in range(n_docs)]
        corpus = PassageCorpus([f"GS_{i}" for i in range(n_docs)], contents)
        items = []
        for i in range(n_q):
            d = i % n_docs
            words = contents[d].split()
            items.append({
                "question_id": str(i),
                "question": " ".join(words[:3]),
                "image_id": i,
                "answers": [words[0]] * 10,
                "gold_answer": words[0],
                "pos_item_ids": [f"GS_{d}"],
                "pos_item_contents": [contents[d]],
                "image_features": rng.normal(size=(vdim,)).astype(np.float32),
            })
            if n_patches:
                items[-1]["image_patch_features"] = rng.normal(
                    size=(n_patches, vdim)).astype(np.float32)
            if pixels:
                items[-1]["image"] = rng.integers(
                    0, 255, (pixels, pixels, 3)).astype(np.uint8)
                if not getattr(self, "features_with_pixels", False):
                    del items[-1]["image_features"]
        n_train = max(1, int(0.8 * n_q))
        return {"train": items[:n_train], "test": items[n_train:],
                "passages": {"train_passages": corpus,
                             "full_passages": corpus}}


@register_transform
class PrepareDataloaders(BaseTransform):
    """Terminal node: tokenizers + RetrievalDatasets.

    setup: query_maxlen, doc_maxlen, nway, vocab_path (None -> tiny vocab),
    attend_to_mask_tokens, input_modules (ModuleParser specs),
    use_self_negatives."""

    def __call__(self, data):
        vocab_path = getattr(self, "vocab_path", None)
        base = WordPieceTokenizer(
            vocab_path if vocab_path else
            make_tiny_vocab(SyntheticOKVQA.WORDS))
        qt = QueryTokenizer(base,
                            query_maxlen=getattr(self, "query_maxlen", 32),
                            attend_to_mask_tokens=getattr(
                                self, "attend_to_mask_tokens", False))
        dt = DocTokenizer(base, doc_maxlen=getattr(self, "doc_maxlen", 220))
        corpus = data["passages"]["full_passages"]
        train_corpus = data["passages"].get("train_passages", corpus)
        out = {"tokenizer": base, "query_tokenizer": qt, "doc_tokenizer": dt,
               "passages": data["passages"]}
        for split in ("train", "valid", "test"):
            items = data.get(split)
            if items is None and split == "valid":
                items = data.get("test")
            if items is None:
                continue
            out[split] = RetrievalDataset(
                items, train_corpus if split == "train" else corpus,
                qt, dt, nway=getattr(self, "nway", 2),
                input_modules=getattr(self, "input_modules", None),
                use_self_negatives=getattr(self, "use_self_negatives",
                                           False))
        return out


@register_transform
class LoadImageFeatures(BaseTransform):
    """Attach per-image features from a .npz store keyed by str(image_id).
    setup: features_path (npz), feature_key='image_features'."""

    def __call__(self, data):
        store = np.load(self.features_path)
        key = getattr(self, "feature_key", "image_features")
        for split, items in data.items():
            if not isinstance(items, list):
                continue
            for it in items:
                it[key] = store[str(it["image_id"])]
        return data


@register_transform
class LoadM2KRData(BaseTransform):
    """An M2KR-style task: a passages jsonl ({passage_id, passage_content})
    and a queries jsonl per split ({question_id, question, instruction?,
    pos_item_ids, answers?}), each row kept whole with its question_id as
    a string.

    setup: queries_path {split: jsonl}, passages_path (jsonl),
    features_path (optional npz keyed by question_id)."""

    def __call__(self, *inputs):
        pids, contents = [], []
        with open(self.passages_path) as f:
            for line in f:
                row = json.loads(line)
                pids.append(row["passage_id"])
                contents.append(row["passage_content"])
        corpus = PassageCorpus(pids, contents)
        feats = None
        if getattr(self, "features_path", None):
            feats = np.load(self.features_path)
        out = {"passages": {"train_passages": corpus,
                            "full_passages": corpus}}
        for split, path in self.queries_path.items():
            items = []
            with open(path) as f:
                for line in f:
                    it = dict(json.loads(line))
                    it["question_id"] = str(it["question_id"])
                    if feats is not None:
                        it["image_features"] = feats[it["question_id"]]
                    items.append(it)
            out[split] = items
        return out


# ---------------------------------------------------------------------------
# OK-VQA and GoogleSearch loaders (reference vqa_data_ops.py:230-833)
# ---------------------------------------------------------------------------

GS_TRAIN_BOUNDARY = "112724"  # first kid NOT in the train split


@register_transform
class LoadGoogleSearchPassages(BaseTransform):
    """The GoogleSearch corpus CSV `kid,content`: ids "GS_<kid>"; the train
    split stops before kid 112724. setup: passage_data_path (csv),
    use_full_split=True (False: stop reading at the boundary)."""

    def __call__(self, *inputs):
        id2doc: dict[str, str] = {}
        id2doc_train: dict[str, str] = {}
        end_of_train = False
        with open(self.passage_data_path, newline="") as f:
            for row in csv.reader(f):
                if not row or row[0] == "kid":
                    continue
                kid, content = row[0], row[1]
                if kid == GS_TRAIN_BOUNDARY:
                    end_of_train = True
                    if not getattr(self, "use_full_split", True):
                        break
                pid = f"GS_{kid}"
                if not end_of_train:
                    id2doc_train[pid] = content
                id2doc[pid] = content
        full = PassageCorpus(list(id2doc), list(id2doc.values()))
        train = PassageCorpus(list(id2doc_train), list(id2doc_train.values()))
        return {"train_passages": train, "full_passages": full}


@register_transform
class LoadVinVLFeatures(BaseTransform):
    """Offline VinVL detection dumps (TSV: image_key \\t json), the
    reference schema (vqa_data_ops.py:54-105): each prediction's `objects`
    [{class, rect [xmin, ymin, xmax, ymax], conf, attributes, attr_scores,
    feature}], the base64 `feature` dropped (as the reference does at
    :89). setup: features_path {split: tsv}. Returns {"vinvl_features":
    {image_key: prediction}} keyed by the TSV's zero-padded image key.
    A row holds each object's 2,048-d feature in base64 (~11 KB an
    object), past csv's default field limit of 131,072 characters from
    about a dozen objects, so the limit is lifted first (the JAX
    package's node keeps it and raises on such rows: ROADMAP C24)."""

    def __call__(self, *inputs):
        csv.field_size_limit(sys.maxsize)
        vinvl: dict[str, dict] = {}
        for path in self.features_path.values():
            with open(path, newline="") as f:
                for row in csv.reader(f, delimiter="\t"):
                    if len(row) < 2:
                        continue
                    image_key, prediction = row[0], json.loads(row[1])
                    for obj in prediction.get("objects", []):
                        obj.pop("feature", None)
                    vinvl[image_key] = prediction
        return {"vinvl_features": vinvl}


@register_transform
class LoadOscarCaptionFeatures(BaseTransform):
    """Oscar captioning outputs (JSON {image_key: [caption, ...]}) merged
    across files (reference vqa_data_ops.py:108-129). setup:
    caption_features {name: json_path}."""

    def __call__(self, *inputs):
        captions: dict = {}
        for path in self.caption_features.values():
            with open(path) as f:
                captions.update(json.load(f))
        return {"caption_features": captions}


def _resize_host(im: np.ndarray, size) -> np.ndarray:
    """Host-side bilinear resize to (size, size, 3), or (h, w, 3) when
    `size` is an (h, w) pair, with half-pixel centers: the JAX package's
    numpy resize, so each crop's own shape stays on the host and the
    device sees one batch shape."""
    im = np.asarray(im, np.float32)
    if im.ndim == 2:
        im = np.repeat(im[:, :, None], 3, axis=2)
    th, tw = (size, size) if isinstance(size, int) else size
    h, w = im.shape[:2]
    ys = np.clip((np.arange(th) + 0.5) * h / th - 0.5, 0, h - 1)
    xs = np.clip((np.arange(tw) + 0.5) * w / tw - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _poly_area(xs, ys) -> float:
    """Shoelace area of a polygon (reference PolyArea,
    vqa_data_ops.py:182-183)."""
    xs, ys = np.asarray(xs, float), np.asarray(ys, float)
    return 0.5 * abs(np.dot(xs, np.roll(ys, 1)) - np.dot(ys, np.roll(xs, 1)))


@register_transform
class LoadGoogleOCRFeatures(BaseTransform):
    """Per-image Google-OCR JSONs ({image_key}_ocr.json with
    `filtered_text_annotations`: [{description, vertices}]), and with
    combine_with_vinvl each annotation attached to the VinVL objects that
    contain it, scored text-area / object-area (reference
    vqa_data_ops.py:131-227). setup: ocr_features {train/test: dir,
    combine_with_vinvl: bool}. Input: a dict carrying "vinvl_features"."""

    def __call__(self, data):
        vinvl = data["vinvl_features"]
        ocr: dict[str, dict] = {}
        dirs = [v for k, v in self.ocr_features.items()
                if k != "combine_with_vinvl"]
        for d in dirs:
            for image_key in vinvl:
                p = os.path.join(d, f"{image_key}_ocr.json")
                if os.path.exists(p):
                    with open(p) as f:
                        ocr[image_key] = json.load(f)
        if self.ocr_features.get("combine_with_vinvl"):
            first = next(iter(vinvl.values()), {})
            if "ocr" not in first:
                for image_key, prediction in vinvl.items():
                    prediction["ocr"] = _attach_ocr(
                        prediction, ocr.get(image_key, {}).get(
                            "filtered_text_annotations", []))
        return {"vinvl_features": vinvl, "ocr_features": ocr}


def _attach_ocr(prediction: dict, annotations: list) -> int:
    """Append each OCR annotation to the objects whose box holds all its
    vertices, scored text-area / object-area; returns how many were
    attached."""
    count = 0
    for ann in annotations:
        desc = ann["description"].replace("\n", " ")
        xs, ys = zip(*ann["vertices"])
        area = _poly_area(xs, ys)
        v = np.asarray(ann["vertices"], float)
        for obj in prediction.get("objects", []):
            xmin, ymin, xmax, ymax = obj["rect"]
            obj_area = (ymax - ymin) * (xmax - xmin)
            within = (v[:, 0] >= xmin).all() and (v[:, 0] <= xmax).all() \
                and (v[:, 1] >= ymin).all() and (v[:, 1] <= ymax).all()
            score = area / obj_area if within else 0.0
            if score > 0:
                count += 1
                obj.setdefault("ocr", []).append({"text": desc,
                                                  "score": score})
    return count


@register_transform
class LoadOKVQAData(BaseTransform):
    """The official VQA-format question and annotation JSONs
    (OpenEnded_mscoco_*_questions.json, mscoco_*_annotations.json), joined
    per question (reference vqa_data_ops.py:230-431). setup:
    questions_path / annotations_path {split: json}, and the reference's
    flags: add_caption_features (img_caption from
    caption_features[str(image_id)]), add_VinVL_features (objects from
    vinvl_features[zfill(12) key]; a missing key raises, as the reference
    does at :372), add_OCR_features (img_ocr from ocr_features[zfill(12)
    key]); use_dummy_data keeps each split's first 20 items. Inputs: zero
    or more dicts carrying vinvl_features / caption_features /
    ocr_features."""

    def __call__(self, *inputs):
        feats: dict = {}
        for d in inputs:
            if isinstance(d, dict):
                feats.update({k: v for k, v in d.items()
                              if k in ("vinvl_features", "caption_features",
                                       "ocr_features")})
        add_cap = getattr(self, "add_caption_features", False)
        add_vinvl = getattr(self, "add_VinVL_features", False)
        add_ocr = getattr(self, "add_OCR_features", False)
        out = {}
        for split in self.questions_path:
            with open(self.questions_path[split]) as f:
                questions = json.load(f)["questions"]
            with open(self.annotations_path[split]) as f:
                annotations = json.load(f)["annotations"]
            ann_by_qid = {a["question_id"]: a for a in annotations}
            items = []
            for q in questions:
                a = ann_by_qid[q["question_id"]]
                answers = [x["answer"] for x in a["answers"]]
                item = {
                    "question_id": str(q["question_id"]),
                    "question": q["question"],
                    "image_id": q["image_id"],
                    "answers": answers,
                    "gold_answer": a.get("multiple_choice_answer",
                                         answers[0] if answers else ""),
                    "question_type": a.get("question_type", ""),
                    "answer_type": a.get("answer_type", ""),
                }
                img_key = str(q["image_id"])          # caption key (:298)
                img_key_full = img_key.zfill(12)      # vinvl/ocr key (:304)
                if add_cap:
                    cap = feats.get("caption_features", {}).get(img_key)
                    item["img_caption"] = cap[0] if cap else None
                if add_vinvl:
                    pred = feats.get("vinvl_features", {}).get(img_key_full)
                    if pred is None:
                        raise KeyError(
                            f"Image {img_key_full} has no VinVL features")
                    item["objects"] = [
                        {"class": o["class"], "rect": o["rect"],
                         "attributes": o.get("attributes", []),
                         "attribute_scores": o.get("attr_scores", []),
                         "ocr": o.get("ocr", [])}
                        for o in pred.get("objects", [])]
                if add_ocr:
                    item["img_ocr"] = feats.get("ocr_features", {}).get(
                        img_key_full, {}).get("filtered_text_annotations",
                                              [])
                items.append(item)
            if getattr(self, "use_dummy_data", False):
                items = items[:20]   # the reference's --use_dummy_data cut
            out[split] = items
        return out


@register_transform
class LoadGoogleSearchAnnotations(BaseTransform):
    """DPR-style annotation JSONs [{question_id, ctxs: [{id}, ...]}] ->
    pos_item_ids ("GS_<id>") and their contents per question (reference
    vqa_data_ops.py:707-833); a question without annotations is dropped,
    or with use_all_samples gets the dummy positive "GS_0". inputs: (the
    OK-VQA split dict, the passages dict). setup: annotations_path
    {split: json}, use_all_samples=False."""

    def __call__(self, okvqa, passages):
        full = passages["full_passages"]
        out = {}
        for split, ann_path in self.annotations_path.items():
            with open(ann_path) as f:
                annotations = json.load(f)
            qid2pos: dict[str, list] = {}
            for ann in annotations:
                qid2pos.setdefault(str(ann["question_id"]),
                                   [f"GS_{p['id']}" for p in ann["ctxs"]])
            items = []
            for item in okvqa[split]:
                pos = qid2pos.get(str(item["question_id"]))
                if not pos:
                    if not getattr(self, "use_all_samples", False):
                        continue
                    pos = ["GS_0"]
                it = dict(item)
                it["pos_item_ids"] = pos
                it["pos_item_contents"] = [full.content_of(p) for p in pos
                                           if p in full.id2pos]
                items.append(it)
            out[split] = items
        out["passages"] = passages
        return out


# ---------------------------------------------------------------------------
# Regions of interest and their CLIP features (vqa_data_ops.py:434-1444)
# ---------------------------------------------------------------------------

def select_rois(objects: list[dict], question: str,
                max_objects: int = 9) -> list[dict]:
    """ROI selection (reference CropRegionOfInterestImages,
    vqa_data_ops.py:434-523): question-mentioned classes first, then by
    area; a box inside an already-selected box of the same class is
    dropped; at most max_objects."""
    selected = [obj for obj in objects
                if obj["class"].lower().strip() in question.lower()]
    by_area = sorted(
        objects,
        key=lambda o: (o["rect"][3] - o["rect"][1])
        * (o["rect"][2] - o["rect"][0]),
        reverse=True)
    for obj in by_area:
        if len(selected) >= max_objects:
            break
        xmin, ymin, xmax, ymax = obj["rect"]
        valid = True
        for ex in selected:
            if ex["class"] == obj["class"]:
                e0, e1, e2, e3 = ex["rect"]
                if xmin >= e0 and ymin >= e1 and xmax <= e2 and ymax <= e3:
                    valid = False
        if valid:
            selected.append(obj)
    return selected


def _crop_records(data: dict, crops: dict, choose) -> dict:
    """Give each item of each split its "ROIs" (crop ids) from
    choose(item) -> [{class, rect}], recording each crop in `crops`
    (id -> {id, img_path, image_id, obj, crop}); data["roi_crops"] =
    crops."""
    for items in data.values():
        if not isinstance(items, list):
            continue
        for it in items:
            rois = []
            for obj in choose(it):
                xmin, ymin, xmax, ymax = [round(v, 2) for v in obj["rect"]]
                rid = (f"{it.get('img_path', it.get('image_id'))}"
                       f"|||{obj['class']}_{xmin}_{ymin}_{xmax}_{ymax}")
                crops[rid] = {"id": rid, "img_path": it.get("img_path"),
                              "image_id": it.get("image_id"), "obj": obj,
                              "crop": [xmin, ymin, xmax, ymax]}
                rois.append(rid)
            it["ROIs"] = rois
    data["roi_crops"] = crops
    return data


@register_transform
class CropRegionOfInterestImages(BaseTransform):
    """Each item's ROI crop records (id, img_path / image_id, crop box)
    from its `objects` ([{class, rect}, ...]) by select_rois. setup:
    max_objects=9."""

    def __call__(self, data):
        n = getattr(self, "max_objects", 9)
        return _crop_records(data, {}, lambda it: select_rois(
            it.get("objects", []), it.get("question", ""), n))


@register_transform
class CropRandomRegionOfInterestImages(BaseTransform):
    """Random or even-grid ROI crops, the reference's ablation variant
    (vqa_data_ops.py:524-596): even_split tiles the image into a
    sqrt(max_objects)^2 grid; otherwise max_objects random boxes with a
    10 px minimum margin, drawn from numpy default_rng(seed) in the JAX
    package's order. setup: max_objects=9, even_split=False, seed=0,
    image_size=(512, 512) (the (w, h) of an item without "img_size")."""

    def __call__(self, data):
        rng = np.random.default_rng(getattr(self, "seed", 0))
        max_objects = getattr(self, "max_objects", 9)
        even = getattr(self, "even_split", False)

        def choose(it):
            w, h = it.get("img_size",
                          getattr(self, "image_size", (512, 512)))
            selected = []
            if even:
                size = math.isqrt(max_objects)
                assert size * size == max_objects, \
                    "even_split needs a square max_objects"
                for i in range(size):
                    for j in range(size):
                        selected.append({
                            "class": "even_split",
                            "rect": [w / size * i, h / size * j,
                                     min(w, w / size * (i + 1)),
                                     min(h, h / size * (j + 1))]})
                return selected
            m = 10
            for _ in range(max_objects):
                xmin = m + rng.random() * (w - 2 * m)
                xmax = min(w, xmin + m + (w - xmin - m) * rng.random())
                ymin = m + rng.random() * (h - 2 * m)
                ymax = min(h, ymin + m + (h - ymin - m) * rng.random())
                selected.append({"class": "random",
                                 "rect": [xmin, ymin, xmax, ymax]})
            return selected
        return _crop_records(data, dict(data.get("roi_crops", {})), choose)


@register_transform
class ExtractImageFeaturesWithViT(BaseTransform):
    """Encode each item's image and its ROI crops with the port's CLIP ViT
    (the pooled CLS embedding), on the run's device, with an optional .npz
    cache; item["image_features"] = (1 + ROIs, dim) rows, the global
    image first (replaces the reference's ElasticSearch cache,
    vqa_data_ops.py:834-1444). A ROI id's source image is loaded and
    sliced to its crop box here.

    setup:
      image source (one of): image_loader (callable image key -> H x W x 3
        uint8 array), image_store (npz keyed by str(image_id)),
        synthetic_images=True (noise seeded by Python's per-process salted
        hash of the key, as the JAX package's: ROADMAP C22);
      model: vit_config (the port's ViTConfig) + vit_params (the JAX
        package's CLIPVisionModel params tree, or the port's state_dict),
        OR vit ({"tiny": true} or ViTConfig fields; weights by
        models.flmr.init_normal_ from a CPU generator seeded with `seed`);
      num_rois (optional): pad each item's ROI rows to exactly this many
        by repeating the last ROI (the global feature when it has none),
        or cut them (module_parser.py:164-166);
      batch_size=64, cache_path (npz, optional), image_size=224, seed=0;
      device (default: the pipeline's global_config "device", which
        main.py sets from --device, else "cuda")."""

    def _image_source(self):
        if getattr(self, "image_loader", None) is not None:
            return self.image_loader
        if getattr(self, "image_store", None) is not None:
            store = np.load(self.image_store)
            return lambda key: store[str(key)]
        if getattr(self, "synthetic_images", False):
            size = getattr(self, "image_size", 224)

            def synth(key):
                rng = np.random.default_rng(abs(hash(str(key))) % (2**32))
                return rng.integers(0, 255, (size, size, 3)).astype(np.uint8)
            return synth
        raise ValueError("ExtractImageFeaturesWithViT needs image_loader, "
                         "image_store, or synthetic_images")

    def _load(self, key, roi_crops, source):
        """An image, or an ROI crop of it (a crop record's image_id may be
        None: then its img_path names the image)."""
        rec = roi_crops.get(key)
        if rec is None:
            return np.asarray(source(key))
        img_key = rec.get("image_id")
        if img_key is None:
            img_key = rec.get("img_path")
        img = np.asarray(source(str(img_key)))
        xmin, ymin, xmax, ymax = rec["crop"]
        h, w = img.shape[:2]
        y0, y1 = max(0, int(ymin)), min(h, max(int(ymin) + 1, int(ymax)))
        x0, x1 = max(0, int(xmin)), min(w, max(int(xmin) + 1, int(xmax)))
        return img[y0:y1, x0:x1]

    def _device(self):
        dev = getattr(self, "device", None)
        gc = getattr(self, "global_config", None)
        if dev is None and gc is not None:
            dev = gc.get("device")
        return dev or "cuda"

    def _model(self, device):
        import torch
        from ..models import CLIPVisionModel, ViTConfig, flax_to_state_dict
        from ..models.flmr import init_normal_
        cfg = getattr(self, "vit_config", None)
        params = getattr(self, "vit_params", None)
        if cfg is None:
            spec = dict(getattr(self, "vit", {}))
            cfg = ViTConfig.tiny() if spec.pop("tiny", False) \
                else ViTConfig(**spec)
        model = CLIPVisionModel(cfg)
        if params is None:
            init_normal_(model, torch.Generator().manual_seed(
                getattr(self, "seed", 0)))
        else:
            if any(isinstance(v, dict) for v in params.values()):
                params = flax_to_state_dict(params)
            model.load_state_dict(params)
        return model.to(device).eval()

    def __call__(self, data):
        import torch
        from ..models import clip_preprocess

        cache_path = getattr(self, "cache_path", None)
        cache = {}
        if cache_path and os.path.exists(cache_path):
            cache = dict(np.load(cache_path))
        roi_crops = data.get("roi_crops", {})
        ids = []
        for items in data.values():
            if not isinstance(items, list):
                continue
            for it in items:
                ids.append(str(it.get("image_id")))
                ids += it.get("ROIs", [])
        # first occurrence order, as the JAX package's quadratic dedup
        ids = [i for i in dict.fromkeys(ids) if i not in cache]

        if ids:
            device = torch.device(self._device())
            model = self._model(device)
            size = getattr(self, "image_size", 224)
            bs = getattr(self, "batch_size", 64)
            source = self._image_source()
            with torch.inference_mode():
                for s in range(0, len(ids), bs):
                    chunk = ids[s:s + bs]
                    # one shape a batch: each crop resized on the host
                    px = np.stack([_resize_host(
                        self._load(i, roi_crops, source), size)
                        for i in chunk])
                    _, cls = model(clip_preprocess(
                        torch.from_numpy(px).to(device), size))
                    for key, feat in zip(chunk, cls.cpu().numpy()):
                        cache[key] = feat
        if cache_path:
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            np.savez(cache_path, **cache)

        num_rois = getattr(self, "num_rois", None)
        for items in data.values():
            if not isinstance(items, list):
                continue
            for it in items:
                glob = cache[str(it.get("image_id"))]
                rois = [cache[r] for r in it.get("ROIs", [])]
                if num_rois is not None:
                    pad = rois[-1] if rois else glob
                    rois = (rois + [pad] * (num_rois - len(rois)))[:num_rois]
                it["image_features"] = np.stack([glob] + rois)
        return data

