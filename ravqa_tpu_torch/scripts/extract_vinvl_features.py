"""Offline VinVL object/attribute feature extraction on the card.

The port's twin of scripts/extract_vinvl_features.py, which replaces the
reference's scene_graph_benchmark run (tools/test_sg_net.py +
prepare_data_for_okvqa.py): loads the VinVL X152-C4 checkpoint, runs
AttrRCNN over a directory (or a list file) of images, and writes
predictions.tsv in the schema LoadVinVLFeatures reads.

    python -m ravqa_tpu_torch.scripts.extract_vinvl_features \\
        --checkpoint vinvl_vg_x152c4.pth \\
        --labelmap VG-SGG-dicts-vgoi6-clipped.json \\
        --images path/to/coco/val2014 --output test_predictions.tsv \\
        [--batch 8] [--canvas 1024 1024] [--limit N] [--device cuda]

Image keys are the zero-padded COCO ids in the file names
(COCO_val2014_000000000042.jpg -> 000000000042), the reference's TSV keys
(vqa_data_ops.py:78-91). `--device cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import re
import time

import numpy as np


def image_key(path: str) -> str:
    stem = os.path.splitext(os.path.basename(path))[0]
    m = re.search(r"(\d+)$", stem)
    return m.group(1).zfill(12) if m else stem


def iter_images(images_arg: str) -> list[str]:
    if os.path.isdir(images_arg):
        names = sorted(os.listdir(images_arg))
        return [os.path.join(images_arg, n) for n in names
                if n.lower().endswith((".jpg", ".jpeg", ".png"))]
    with open(images_arg) as f:
        return [line.strip() for line in f if line.strip()]


def extract(extractor, keys: list, load, log=print) -> list[dict]:
    """The predictions of the images load(key) for each key, a batch of
    the extractor's size at a time, with the progress printed."""
    preds = []
    bs = extractor.batch_size
    for start in range(0, len(keys), bs):
        t0 = time.perf_counter()
        chunk = keys[start:start + bs]
        preds.extend(extractor.predict([load(k) for k in chunk]))
        log(f"{min(start + bs, len(keys))}/{len(keys)} "
            f"({time.perf_counter() - t0:.2f} s)")
    return preds


def main(argv=None):
    ap = argparse.ArgumentParser("extract_vinvl_features")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--labelmap", required=True)
    ap.add_argument("--images", required=True,
                    help="image directory or a file listing image paths")
    ap.add_argument("--output", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--canvas", type=int, nargs=2, default=(1024, 1024))
    ap.add_argument("--min-size", type=int, default=600)
    ap.add_argument("--max-size", type=int, default=1000)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from PIL import Image

    from ..data.extraction import (VinVLFeatureExtractor, load_vg_labelmap,
                                   write_predictions_tsv)
    from ..models.detection import DetectorConfig, convert_vinvl_params

    cfg = DetectorConfig.vinvl_x152c4()
    sd = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    sd = sd.get("model", sd)
    labelmap, attrmap = load_vg_labelmap(args.labelmap)
    ex = VinVLFeatureExtractor(
        cfg, convert_vinvl_params(sd, cfg), labelmap, attrmap,
        canvas_hw=tuple(args.canvas), batch_size=args.batch,
        min_size=args.min_size, max_size=args.max_size, device=args.device)
    paths = iter_images(args.images)
    if args.limit:
        paths = paths[:args.limit]
    preds = extract(ex, paths, lambda p: np.asarray(
        Image.open(p).convert("RGB")))
    write_predictions_tsv(args.output, [image_key(p) for p in paths], preds)
    print(f"wrote {len(preds)} predictions to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
