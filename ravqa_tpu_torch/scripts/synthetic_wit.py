"""Write a synthetic WIT dump in the formats configs/wit/ reads.

    python -m ravqa_tpu_torch.scripts.synthetic_wit [OUT_DIR] \
        [--train 15360] [--test 1024] [--vision-dim 768] [--seed 0]

writes OUT_DIR (default data/wit/synthetic, which
configs/synthetic_flmr_wit_pretrain.json reads) /wit.train.tsv,
/wit.test.tsv and /clip_cls_features.npz: the WIT .tsv columns
LoadWITData reads (image_url, page_title, section_title,
context_page_description, caption_reference_description), each row a
passage of 64-134 words of SyntheticOKVQA's vocabulary (so the tiny
tokenizer covers them and TruncateWITPassages' 100 words cut some), and a
float32 feature per image_url in place of its CLIP CLS embedding: a fixed
random projection of its passage's first 100 words' counts plus noise,
so a mapping network can learn the pairing. Every row's passage differs,
so the corpus holds one passage a row. Nothing is downloaded.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from ..data.transforms import SyntheticOKVQA

COLUMNS = ("image_url", "page_title", "section_title",
           "context_page_description", "caption_reference_description")
DEFAULT_DIR = os.path.join("data", "wit", "synthetic")


def write_synthetic_wit(out_dir: str = DEFAULT_DIR, n_train: int = 15360,
                        n_test: int = 1024, vision_dim: int = 768,
                        seed: int = 0) -> dict:
    """-> {"train": tsv path, "test": tsv path, "features": npz path}."""
    words = np.array(SyntheticOKVQA.WORDS)
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(len(words), vision_dim)).astype(np.float32)
    os.makedirs(out_dir, exist_ok=True)
    paths = {"features": os.path.join(out_dir, "clip_cls_features.npz")}
    feats = {}
    for split, n in (("train", n_train), ("test", n_test)):
        paths[split] = os.path.join(out_dir, f"wit.{split}.tsv")
        with open(paths[split], "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f, delimiter="\t")
            w.writerow(COLUMNS)
            for i in range(n):
                ids = rng.integers(len(words), size=int(rng.integers(64,
                                                                     135)))
                text = words[ids]
                url = f"wit_{split}_{i}.jpg"
                w.writerow((url, " ".join(text[:2]), text[2],
                            " ".join(text[3:]),
                            " ".join(rng.choice(words, 5))))
                counts = np.bincount(ids[:100], minlength=len(words))
                feats[url] = (counts @ proj / 10.0 + 0.5 * rng.normal(
                    size=vision_dim)).astype(np.float32)
    np.savez(paths["features"], **feats)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser("synthetic_wit")
    p.add_argument("out_dir", nargs="?", default=DEFAULT_DIR)
    p.add_argument("--train", type=int, default=15360)
    p.add_argument("--test", type=int, default=1024)
    p.add_argument("--vision-dim", type=int, default=768)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    paths = write_synthetic_wit(a.out_dir, a.train, a.test, a.vision_dim,
                                a.seed)
    print(paths)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
