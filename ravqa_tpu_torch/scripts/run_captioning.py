"""Offline Oscar-style caption generation on the card.

The port's twin of scripts/run_captioning.py, which replaces the
reference's Oscar run (oscar/run_captioning.py): reads a VinVL
predictions.tsv (region features and object tags, as
`extract_vinvl_features` writes it), greedy-decodes captions with
OscarCaptioner, and writes the {image_key: [caption]} JSON
LoadOscarCaptionFeatures reads.

    python -m ravqa_tpu_torch.scripts.run_captioning \\
        --checkpoint coco_captioning_large_scst/pytorch_model.bin \\
        --vocab bert-base-uncased-vocab.txt \\
        --predictions test_predictions.tsv --output captions.json \\
        [--large] [--batch 16] [--limit N] [--device cuda]
"""

from __future__ import annotations

import argparse
import base64
import json
import time

import numpy as np

from ..data.extraction import oscar_region_features
from ..models.bert import BertConfig
from ..models.captioner import (CaptionerConfig, OscarCaptioner,
                                convert_oscar_captioner_params,
                                decode_captions, greedy_caption,
                                write_caption_predictions)


def load_tsv(path: str, limit: int = 0) -> list:
    rows = []
    with open(path) as f:
        for line in f:
            key, pred = line.rstrip("\n").split("\t", 1)
            rows.append((key, json.loads(pred)))
            if limit and len(rows) >= limit:
                break
    return rows


def region_inputs(pred: dict, cfg: CaptionerConfig):
    """One TSV prediction -> (img_feats, img_mask, tag string)."""
    feats, tags = [], []
    for obj in pred.get("objects", [])[:cfg.max_img_seq_len]:
        f = np.frombuffer(base64.b64decode(obj["feature"]), np.float32)
        if f.size + 6 == cfg.img_feature_dim:      # raw 2048: add geometry
            x1, y1, x2, y2 = obj["rect"]
            w = max(x2, 1e-3)
            h = max(y2, 1e-3)
            f = oscar_region_features(f[None], np.array(
                [[x1, y1, x2, y2]], np.float32), (h, w))[0]
        feats.append(f[:cfg.img_feature_dim])
        tags.append(obj["class"])
    n = len(feats)
    img = np.zeros((cfg.max_img_seq_len, cfg.img_feature_dim), np.float32)
    if n:
        img[:n] = np.stack(feats)
    mask = np.zeros(cfg.max_img_seq_len, np.int32)
    mask[:n] = 1
    return img, mask, " ".join(tags)


def caption_inputs(rows: list, tokenizer, cfg: CaptionerConfig,
                   batch: int) -> dict:
    """TSV rows (at most `batch`) -> the greedy decode's numpy inputs
    (tag_ids, tag_mask, img_feats, img_mask), padded to `batch` rows."""
    tag_budget = cfg.max_seq_len - cfg.max_seq_a_len
    cols = {"tag_ids": [], "tag_mask": [], "img_feats": [], "img_mask": []}
    for _, pred in rows:
        img, imask, tag_str = region_inputs(pred, cfg)
        ids = tokenizer.encode(tag_str)[:tag_budget]
        tids = np.zeros(tag_budget, np.int32)
        tids[:len(ids)] = ids
        tmask = np.zeros(tag_budget, np.int32)
        tmask[:len(ids)] = 1
        for k, v in zip(cols, (tids, tmask, img, imask)):
            cols[k].append(v)
    for k in cols:
        cols[k] += [np.zeros_like(cols[k][0])] * (batch - len(rows))
    return {k: np.stack(v) for k, v in cols.items()}


def caption_rows(model: OscarCaptioner, tokenizer, rows: list,
                 batch: int = 16, log=print) -> dict:
    """{image key: caption} for the TSV rows, greedy-decoded a batch at a
    time on the model's device."""
    import torch
    dev = next(model.parameters()).device
    out = {}
    for start in range(0, len(rows), batch):
        t0 = time.perf_counter()
        chunk = rows[start:start + batch]
        x = {k: torch.from_numpy(v).to(dev) for k, v in caption_inputs(
            chunk, tokenizer, model.cfg, batch).items()}
        cap, lengths = greedy_caption(model, x["tag_ids"], x["tag_mask"],
                                      x["img_feats"], x["img_mask"])
        captions = decode_captions(
            cap[:len(chunk)].cpu().numpy(), lengths[:len(chunk)].cpu()
            .numpy(), lambda i: tokenizer.ids_to_tokens.get(i, "[UNK]"))
        out.update(zip((k for k, _ in chunk), captions))
        log(f"{min(start + batch, len(rows))}/{len(rows)} "
            f"({time.perf_counter() - t0:.2f} s)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser("run_captioning")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--vocab", required=True)
    ap.add_argument("--predictions", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--large", action="store_true",
                    help="bert-large geometry (coco_captioning_large_*)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..tokenization import WordPieceTokenizer

    bert = BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                      intermediate_size=4096) if args.large else BertConfig()
    cfg = CaptionerConfig(bert=bert)
    sd = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    sd = sd.get("model", sd) if isinstance(sd, dict) else sd
    model = OscarCaptioner(cfg, device="meta")
    model.load_state_dict(convert_oscar_captioner_params(sd, cfg),
                          assign=True)
    model = model.to(args.device).eval()
    tok = WordPieceTokenizer(args.vocab, lowercase=True)
    out = caption_rows(model, tok, load_tsv(args.predictions, args.limit),
                       args.batch)
    write_caption_predictions(args.output, out)
    print(f"wrote {len(out)} captions to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
