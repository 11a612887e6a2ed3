"""Detector ops in plain PyTorch: box IoU, greedy NMS and ROIAlign.

Port of ravqa_tpu/ops/vision.py (:18-106), which is XLA in the JAX package
(no Pallas kernel), so it is plain PyTorch here:

- `box_iou`: the same arithmetic, over any leading batch dimensions;
- `nms`: the greedy loop of `max_outputs` steps, batched over images, with
  no host sync per step (each step is a few device ops on every image at
  once); like `jnp.argmax`, `torch.argmax` keeps the first index on equal
  scores, so the picks are the JAX function's;
- `roi_align`: the JAX sampling (torchvision's aligned=False grid; a
  sample is clamped to the map's edge and its weights clipped to [0, 1],
  where torchvision reads zero outside [-1, H]). The four corners of each
  sample point are gathered from the (H * W, C) rows one at a time and
  accumulated in place, so the peak is the output plus one gather.
"""

from __future__ import annotations

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) [x1, y1, x2, y2] -> (..., N, M) IoU."""
    area_a = ((a[..., 2] - a[..., 0]).clamp_min(0)
              * (a[..., 3] - a[..., 1]).clamp_min(0))
    area_b = ((b[..., 2] - b[..., 0]).clamp_min(0)
              * (b[..., 3] - b[..., 1]).clamp_min(0))
    ai, bj = a[..., :, None, :], b[..., None, :, :]
    w = (torch.minimum(ai[..., 2], bj[..., 2])
         - torch.maximum(ai[..., 0], bj[..., 0])).clamp_min(0)
    h = (torch.minimum(ai[..., 3], bj[..., 3])
         - torch.maximum(ai[..., 1], bj[..., 1])).clamp_min(0)
    inter = w * h
    return inter / (area_a[..., :, None] + area_b[..., None, :]
                    - inter).clamp_min(1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.5, max_outputs: int = 100):
    """Greedy NMS: keep the highest score, suppress IoU > threshold.
    boxes (N, 4) and scores (N,), or a batch (B, N, 4) and (B, N). Returns
    (indices (max_outputs,) or (B, max_outputs) int32 padded with -1,
    count () or (B,) int32)."""
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    b, n = scores.shape
    iou = box_iou(boxes, boxes)
    rows = torch.arange(b, device=scores.device)
    alive = torch.ones(b, n, dtype=torch.bool, device=scores.device)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    none = torch.full((b,), -1, dtype=torch.int32, device=scores.device)
    picks = []
    for _ in range(max_outputs):
        masked = torch.where(alive, scores, neg_inf)
        best = masked.argmax(dim=1)
        valid = masked[rows, best] > neg_inf
        alive = alive & ~(iou[rows, best] > iou_threshold)
        alive[rows, best] = False
        picks.append(torch.where(valid, best.to(torch.int32), none))
    idx = torch.stack(picks, dim=1)
    count = (idx >= 0).sum(dim=1, dtype=torch.int32)
    return (idx[0], count[0]) if single else (idx, count)


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              output_size: int = 7, sampling_ratio: int = 2,
              spatial_scale: float = 1.0) -> torch.Tensor:
    """ROIAlign (bilinear, aligned=False torchvision semantics).

    features (H, W, C); boxes (N, 4) [x1, y1, x2, y2] in input coordinates.
    Returns (N, output_size, output_size, C)."""
    h, w, c = features.shape
    rows = features.reshape(h * w, c)
    box = boxes.float() * spatial_scale
    x1, y1, x2, y2 = box.unbind(-1)
    bin_w = (x2 - x1).clamp_min(1e-6) / output_size
    bin_h = (y2 - y1).clamp_min(1e-6) / output_size
    grid = torch.arange(output_size, dtype=torch.float32,
                        device=features.device)
    out = torch.zeros(box.shape[0], output_size, output_size, c,
                      dtype=features.dtype, device=features.device)
    sr = sampling_ratio
    for iy in range(sr):
        gy = y1[:, None] + (grid + (iy + 0.5) / sr)[None] * bin_h[:, None]
        for ix in range(sr):
            gx = x1[:, None] + (grid + (ix + 0.5) / sr)[None] \
                * bin_w[:, None]
            _accumulate_sample(out, rows, gy[:, :, None], gx[:, None, :],
                               h, w)
    return out / (sr * sr)


def _accumulate_sample(out, rows, y, x, h, w):
    """out += the bilinear sample of rows (H * W, C) at (y, x), clamped to
    the map's edge as the JAX function's sample()."""
    y0 = y.floor().clamp(0, h - 1)
    x0 = x.floor().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (y - y0).clamp(0, 1)
    wx = (x - x0).clamp(0, 1)
    y0, y1, x0, x1 = (t.long() for t in (y0, y1, x0, x1))
    for yi, xi, weight in ((y0, x0, (1 - wy) * (1 - wx)),
                           (y0, x1, (1 - wy) * wx),
                           (y1, x0, wy * (1 - wx)),
                           (y1, x1, wy * wx)):
        out.addcmul_(rows[yi * w + xi], weight[..., None].to(out.dtype))
