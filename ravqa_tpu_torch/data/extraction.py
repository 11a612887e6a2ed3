"""Offline VinVL-style feature extraction: images -> predictions.tsv.

Port of ravqa_tpu/data/extraction.py (:37-185), which replaces the
reference's scene_graph_benchmark run (tools/test_sg_net.py, writing
predictions.tsv with TSV_SAVE_SUBSET ['rect', 'class', 'conf', 'feature',
'attr_labels', 'attr_scores']). Rows are what LoadVinVLFeatures and the
reference's own loader (src/data_ops/vqa_data_ops.py:54-105) parse:
`image_key \\t json`, json = {"objects": [{"class", "rect", "conf",
"attributes", "attr_scores", "feature"}], "num_boxes"}.

As in the JAX package, each image is resized on the host by the
min/max-size rule (INPUT.MIN_SIZE_TEST / MAX_SIZE_TEST) with the JAX
package's numpy resize, padded into one fixed canvas, and every batch is
padded to `batch_size`; the detector (models/detection.py) runs on the
extractor's device, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import base64
import json
from typing import Iterable, Sequence

import numpy as np
import torch

from ..models.detection import AttrRCNN, DetectorConfig
from .transforms import _resize_host

# vinvl_x152c4.yaml INPUT.PIXEL_MEAN (BGR order, Caffe-style)
VINVL_PIXEL_MEAN = (103.530, 116.280, 123.675)


def scale_for_detection(h: int, w: int, min_size: int = 600,
                        max_size: int = 1000) -> float:
    """maskrcnn Resize rule: scale the shorter side to min_size unless the
    longer side would exceed max_size."""
    scale = min_size / min(h, w)
    if scale * max(h, w) > max_size:
        scale = max_size / max(h, w)
    return scale


def preprocess_for_detection(image: np.ndarray, canvas_hw=(1024, 1024),
                             min_size: int = 600, max_size: int = 1000,
                             pixel_mean=VINVL_PIXEL_MEAN):
    """RGB uint8/float (H, W, 3) -> (canvas BGR mean-subtracted float32,
    (resized_h, resized_w), scale)."""
    im = np.asarray(image)
    h, w = im.shape[:2]
    scale = scale_for_detection(h, w, min_size, max_size)
    th = min(canvas_hw[0], max(1, int(round(h * scale))))
    tw = min(canvas_hw[1], max(1, int(round(w * scale))))
    resized = _resize_host(im, (th, tw))
    bgr = resized[..., ::-1] - np.asarray(pixel_mean, np.float32)
    canvas = np.zeros((canvas_hw[0], canvas_hw[1], 3), np.float32)
    canvas[:th, :tw] = bgr
    return canvas, (th, tw), scale


class VinVLFeatureExtractor:
    """Runs the detector over images in batches, producing the TSV rows.

    state_dict: AttrRCNN's (convert_vinvl_params of a maskrcnn checkpoint,
    or models.convert.detector_to_state_dict of the JAX package's tree).
    labelmap / attr_labelmap mirror the VG-SGG-dicts label files the
    reference loads (DATASETS.LABELMAP_FILE): class / attribute index
    (1-based, 0 = background) -> name."""

    def __init__(self, cfg: DetectorConfig, state_dict: dict, labelmap: dict,
                 attr_labelmap: dict, canvas_hw=(1024, 1024),
                 batch_size: int = 8, min_size: int = 600,
                 max_size: int = 1000, device="cuda"):
        self.cfg = cfg
        self.labelmap = {int(k): v for k, v in labelmap.items()}
        self.attr_labelmap = {int(k): v for k, v in attr_labelmap.items()}
        self.canvas_hw = tuple(canvas_hw)
        self.batch_size = batch_size
        self.min_size = min_size
        self.max_size = max_size
        self.device = torch.device(device)
        model = AttrRCNN(cfg, device="meta")
        model.load_state_dict(state_dict, assign=True)
        self.model = model.to(self.device).eval()

    def predict_batch(self, canvases: np.ndarray, hws: np.ndarray) -> dict:
        """One padded batch through the detector -> its outputs as numpy."""
        with torch.inference_mode():
            out = self.model(
                torch.from_numpy(canvases).to(self.device),
                torch.from_numpy(np.asarray(hws, np.int32)).to(self.device))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def prepare(self, images: Sequence[np.ndarray]):
        """Images -> (canvases (batch_size, H, W, 3), valid hws, scales),
        padded to the batch size with blank canvases of hw (1, 1)."""
        pre = [preprocess_for_detection(im, self.canvas_hw, self.min_size,
                                        self.max_size) for im in images]
        canvases = np.stack([p[0] for p in pre])
        hws = np.array([p[1] for p in pre], np.int32)
        pad = self.batch_size - len(images)
        if pad > 0:
            canvases = np.concatenate(
                [canvases, np.zeros((pad,) + canvases.shape[1:],
                                    np.float32)])
            hws = np.concatenate([hws, np.ones((pad, 2), np.int32)])
        return canvases, hws, [p[2] for p in pre]

    def predict(self, images: Sequence[np.ndarray]) -> list[dict]:
        """RGB images (any sizes) -> per-image prediction dicts
        ({"objects": [...], "num_boxes": N}), boxes in the ORIGINAL
        image's coordinates."""
        results = []
        for start in range(0, len(images), self.batch_size):
            canvases, hws, scales = self.prepare(
                images[start:start + self.batch_size])
            out = self.predict_batch(canvases, hws)
            for i, scale in enumerate(scales):
                results.append(self._to_objects(out, i, scale))
        return results

    def _to_objects(self, out: dict, i: int, scale: float) -> dict:
        objects = []
        n = int(out["num_detections"][i])
        for j in range(out["boxes"].shape[1]):
            if not out["valid"][i, j]:
                continue
            label = int(out["labels"][i, j])
            attrs, ascores = [], []
            for k in range(out["attr_labels"].shape[2]):
                s = float(out["attr_scores"][i, j, k])
                if s <= 0.0:
                    continue
                aid = int(out["attr_labels"][i, j, k])
                attrs.append(self.attr_labelmap.get(aid, str(aid)))
                ascores.append(round(s, 4))
            feat = np.asarray(out["features"][i, j], np.float32)
            x1, y1, x2, y2 = (float(v) / scale for v in out["boxes"][i, j])
            # the legacy +1 box decode can emit x2 = x1 - eps on degenerate
            # boxes; the TSV contract wants monotone corners
            rect = [round(x1, 2), round(y1, 2),
                    round(max(x2, x1), 2), round(max(y2, y1), 2)]
            objects.append({
                "class": self.labelmap.get(label, str(label)),
                "rect": rect,
                "conf": round(float(out["scores"][i, j]), 4),
                "attributes": attrs,
                "attr_scores": ascores,
                "feature": base64.b64encode(feat.tobytes()).decode(),
            })
        return {"objects": objects, "num_boxes": n}


def oscar_region_features(features: np.ndarray, boxes: np.ndarray,
                          image_hw) -> np.ndarray:
    """(D, 2048) pooled features + (D, 4) xyxy boxes -> the 2054-d region
    features Oscar-style consumers use: features + [x1/w, y1/h, x2/w,
    y2/h, (x2-x1)/w, (y2-y1)/h]."""
    h, w = float(image_hw[0]), float(image_hw[1])
    x1, y1, x2, y2 = (boxes[:, 0] / w, boxes[:, 1] / h,
                      boxes[:, 2] / w, boxes[:, 3] / h)
    pos = np.stack([x1, y1, x2, y2, x2 - x1, y2 - y1], -1)
    return np.concatenate([features, pos.astype(features.dtype)], -1)


def write_predictions_tsv(path: str, keys: Iterable[str],
                          predictions: Iterable[dict]) -> None:
    """Write the predictions.tsv file LoadVinVLFeatures reads."""
    with open(path, "w") as f:
        for key, pred in zip(keys, predictions):
            f.write(f"{key}\t{json.dumps(pred)}\n")


def load_vg_labelmap(path: str) -> tuple[dict, dict]:
    """Parse a VG-SGG-dicts-style labelmap JSON (DATASETS.LABELMAP_FILE):
    returns (idx -> class, idx -> attribute). Takes either the
    {label_to_idx, attribute_to_idx} or the inverted {idx_to_label,
    idx_to_attribute} layout."""
    with open(path) as f:
        d = json.load(f)
    if "idx_to_label" in d:
        lab = {int(k): v for k, v in d["idx_to_label"].items()}
    else:
        lab = {int(v): k for k, v in d.get("label_to_idx", {}).items()}
    if "idx_to_attribute" in d:
        attr = {int(k): v for k, v in d["idx_to_attribute"].items()}
    else:
        attr = {int(v): k
                for k, v in d.get("attribute_to_idx", {}).items()}
    return lab, attr
