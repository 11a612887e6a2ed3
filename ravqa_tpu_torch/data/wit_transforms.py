"""WIT (Wikipedia Image-Text) transforms: the data of FLMR's stage-1
mapping-network pretraining.

The port's own copy of ravqa_tpu/data/wit_transforms.py (:35-181), host
code (the reference's wit_data_ops.py chain):

- LoadWITData: parse the WIT .tsv (page_title / section_title /
  context_page_description / caption columns) into a deduplicated passage
  corpus (title + section + description) and per-image items whose
  positive is their own row's passage; an optional IGLUE id filter on the
  test split; vision-only queries (question None). A passage's id is
  "WIT_" and Python's hash of its text: equal in both packages within one
  process, but salted per process, so two runs without the node cache
  give one passage two ids (ROADMAP.md C19, kept for parity).
- PrepareImagesForWITData: keep the items whose image is on disk; a
  missing one is fetched only through an injected callable.
- SplitWITPassagesForLargeScaleTraining: train against the full corpus,
  evaluate against the valid/test positives.
- TruncateWITPassages: cap each passage's words.
- ReduceWITPassagesSize: subsample the corpus, keeping every positive.
"""

from __future__ import annotations

import csv
import hashlib
import os

import numpy as np

from .datasets import PassageCorpus
from .pipeline import BaseTransform, register_transform


@register_transform
class LoadWITData(BaseTransform):
    """setup: tsv_path {split: path}, iglue_ids (optional list of image ids
    to keep in test), max_rows (optional)."""

    def __call__(self, *inputs):
        out = {}
        passages: dict[str, str] = {}

        def passage_text(row):
            parts = [row.get("page_title", ""),
                     row.get("section_title", "") or
                     row.get("hierarchical_section_title", ""),
                     row.get("context_page_description", "") or
                     row.get("context_section_description", "")]
            return " ".join(p for p in parts if p).strip()

        iglue = set(getattr(self, "iglue_ids", []) or [])
        max_rows = getattr(self, "max_rows", None)
        for split, path in self.tsv_path.items():
            items = []
            with open(path, newline="", encoding="utf-8") as f:
                reader = csv.DictReader(f, delimiter="\t")
                for i, row in enumerate(reader):
                    if max_rows and i >= max_rows:
                        break
                    text = passage_text(row)
                    if not text:
                        continue
                    pid = f"WIT_{abs(hash(text)) % (10 ** 12)}"
                    passages.setdefault(pid, text)
                    image_id = row.get("image_url", str(i))
                    if split == "test" and iglue and image_id not in iglue:
                        continue
                    items.append({
                        "question_id": f"{split}_{i}",
                        "question": None,          # vision-only query
                        "image_id": image_id,
                        "img_caption": row.get(
                            "caption_reference_description", ""),
                        "pos_item_ids": [pid],
                    })
            out[split] = items
        corpus = PassageCorpus(list(passages), list(passages.values()))
        out["passages"] = {"train_passages": corpus,
                           "full_passages": corpus}
        return out


@register_transform
class PrepareImagesForWITData(BaseTransform):
    """Keep the WIT items whose image exists on disk, with its path as
    img_path.

    setup: image_data_path (directory of the images), image_name (callable
    item -> file name; default the md5 of image_id + '.jpg'), fetcher
    (optional callable (image_id, image_path) -> bool that puts a missing
    image there; the port never fetches one itself), fetch_images=False.
    """

    def __call__(self, data):
        root = getattr(self, "image_data_path", ".")
        name_fn = getattr(self, "image_name", None) or (
            lambda it: hashlib.md5(
                str(it["image_id"]).encode()).hexdigest() + ".jpg")
        fetcher = getattr(self, "fetcher", None)
        do_fetch = getattr(self, "fetch_images", False)
        for split, items in list(data.items()):
            if not isinstance(items, list):
                continue
            kept = []
            for it in items:
                path = os.path.join(root, name_fn(it))
                ok = os.path.exists(path)
                if not ok and do_fetch and fetcher is not None:
                    ok = bool(fetcher(it["image_id"], path))
                if ok:
                    it = dict(it)
                    it["img_path"] = path
                    kept.append(it)
            data[split] = kept
        return data


@register_transform
class SplitWITPassagesForLargeScaleTraining(BaseTransform):
    """Training retrieves against the full corpus; validation and test
    against the passages that are positives of a valid or test item."""

    def __call__(self, data):
        corpus = data["passages"]["full_passages"]
        keep = set()
        for split in ("valid", "test"):
            for it in data.get(split) or []:
                keep.update(it.get("pos_item_ids", []))
        ids = [pid for pid in corpus.ids if pid in keep]
        id2c = dict(zip(corpus.ids, corpus.contents))
        eval_corpus = PassageCorpus(ids, [id2c[p] for p in ids])
        data["passages"] = {"train_passages": corpus,
                            "full_passages": eval_corpus,
                            "valid_passages": eval_corpus,
                            "test_passages": eval_corpus}
        return data


@register_transform
class TruncateWITPassages(BaseTransform):
    """setup: max_words=100."""

    def __call__(self, data):
        corpus = data["passages"]["full_passages"]
        mw = getattr(self, "max_words", 100)
        contents = [" ".join(c.split()[:mw]) for c in corpus.contents]
        new = PassageCorpus(corpus.ids, contents)
        data["passages"] = {"train_passages": new, "full_passages": new}
        return data


@register_transform
class ReduceWITPassagesSize(BaseTransform):
    """Subsample the corpus to n_passages, always keeping positives.
    setup: n_passages, seed=0."""

    def __call__(self, data):
        corpus = data["passages"]["full_passages"]
        keep = set()
        for split, items in data.items():
            if isinstance(items, list):
                for it in items:
                    keep.update(it.get("pos_item_ids", []))
        n = getattr(self, "n_passages", len(corpus))
        rng = np.random.default_rng(getattr(self, "seed", 0))
        extra = [pid for pid in corpus.ids if pid not in keep]
        rng.shuffle(extra)
        chosen = list(keep) + extra[:max(0, n - len(keep))]
        id2c = dict(zip(corpus.ids, corpus.contents))
        new = PassageCorpus(chosen, [id2c[p] for p in chosen])
        data["passages"] = {"train_passages": new, "full_passages": new}
        return data
