"""VinVL-style AttrRCNN object + attribute detector (X152-C4) in PyTorch.

Port of ravqa_tpu/models/detection.py (:54-541): `DetectorConfig` (with
`tiny` and `vinvl_x152c4`), the legacy anchors and box math, the greedy
proposal and detection selection, `AttrRCNN` and `convert_vinvl_params`.
The reference is scene_graph_benchmark's AttrRCNN on maskrcnn-benchmark's
C4 pieces (ResNeXt-152 32x8d C4 backbone, RPN pre-NMS 6,000 / post-NMS
300 at IoU 0.7, ROIAlign 14 x 14 at 1/16 into the stride-2 res5 head,
FastRCNN predictor with score 0.2, class NMS 0.5, 100 detections and a
floor of 10, and the attribute head over the final boxes).

The layout is NCHW for the convolutions (plain cuDNN through
`nn.Conv2d`, as they are XLA in the JAX package); the model takes and
returns what the Flax model does: NHWC images on a fixed canvas with each
image's valid (h, w), and fixed detection counts with validity masks. The
outputs match the Flax model's output for output:

- every top-k is a stable descending sort, so equal keys come out lowest
  index first, as `jax.lax.top_k` gives them (with random weights every
  attribute probability is thresholded to 0 and the attributes' top-16 is
  a tie over all of them; the RPN's and the pair pool's zero keys too);
- NMS keeps the first index on equal scores, as `jnp.argmax` does;
- `forward` runs its convolutions and linears in full float32 whatever
  the caller set (`full_float32`): cuDNN's TF32 (on by default in
  PyTorch) would move the 150-odd convolutions' numbers by ~1e-3.

Module and parameter names follow the Flax tree (`backbone.layer3.block35
.conv2.weight` for `backbone/layer3/block35/conv2/kernel`; FrozenBN keeps
`scale` and `bias`), so `models.convert.detector_to_state_dict` carries a
JAX params tree across by rule. The ROI head runs its ROIs in chunks of
`roi_chunk` (each res5 activation of 14 x 14 x 2,048 float32 is 1.6 MB a
ROI), and ROIAlign goes image by image.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.vision import nms, roi_align

BBOX_XFORM_CLIP = float(np.log(1000.0 / 16.0))


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    # backbone (vinvl_x152c4.yaml MODEL.RESNETS)
    stem_channels: int = 64
    stage_blocks: tuple = (3, 8, 36)      # layer1..layer3 (C2..C4)
    res5_blocks: int = 3                  # ROI head stage (layer4)
    num_groups: int = 32
    width_per_group: int = 8
    res2_out_channels: int = 256
    # rpn
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    aspect_ratios: tuple = (0.5, 1.0, 2.0)
    anchor_stride: int = 16
    rpn_pre_nms_top_n: int = 6000
    rpn_post_nms_top_n: int = 300
    rpn_nms_thresh: float = 0.7
    # roi heads
    num_classes: int = 1595               # incl. background at index 0
    pooler_resolution: int = 14
    pooler_sampling_ratio: int = 2
    box_score_thresh: float = 0.2
    box_nms_thresh: float = 0.5
    detections_per_img: int = 100
    min_detections_per_img: int = 10
    bbox_reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    box_candidate_pool: int = 400         # pairs entering the final NMS
    # attribute head (sg_defaults.py:18-30)
    num_attributes: int = 525
    cls_emd_dim: int = 256
    attr_emd_dim: int = 512
    attr_thresh: float = 0.05
    max_attr_per_obj: int = 16
    roi_chunk: int = 512                  # ROIs per res5 pass (memory)

    @property
    def bottleneck_channels(self) -> tuple:
        base = self.num_groups * self.width_per_group
        return tuple(base * 2 ** i for i in range(len(self.stage_blocks)))

    @property
    def stage_out_channels(self) -> tuple:
        return tuple(self.res2_out_channels * 2 ** i
                     for i in range(len(self.stage_blocks)))

    @property
    def backbone_out_channels(self) -> int:
        return self.stage_out_channels[-1]

    @property
    def res5_out_channels(self) -> int:
        return self.res2_out_channels * 2 ** len(self.stage_blocks)

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_sizes) * len(self.aspect_ratios)

    @staticmethod
    def tiny(**kw) -> "DetectorConfig":
        base = dict(stem_channels=8, stage_blocks=(1, 1, 1), res5_blocks=1,
                    num_groups=2, width_per_group=4, res2_out_channels=16,
                    anchor_sizes=(16, 32), aspect_ratios=(0.5, 1.0, 2.0),
                    rpn_pre_nms_top_n=64, rpn_post_nms_top_n=16,
                    num_classes=7, pooler_resolution=7,
                    detections_per_img=8, min_detections_per_img=2,
                    box_candidate_pool=32, num_attributes=5,
                    cls_emd_dim=8, attr_emd_dim=16, max_attr_per_obj=3)
        base.update(kw)
        return DetectorConfig(**base)

    @staticmethod
    def vinvl_x152c4(**kw) -> "DetectorConfig":
        """The published VinVL extraction config (vinvl_x152c4.yaml)."""
        return DetectorConfig(**kw)


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions and cuBLAS matmuls in full float32 (no TF32)
    inside, whatever the caller set; the caller's flags come back after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = matmul.allow_tf32
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        matmul.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32 = before


class FrozenBN(nn.Module):
    """FrozenBatchNorm2d folded to y = x * scale + bias (per channel of
    NCHW); convert_vinvl_params folds the statistics."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class Bottleneck(nn.Module):
    """ResNeXt bottleneck, stride on the 3x3 (stride_in_1x1=False)."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1, num_groups: int = 1,
                 device=None):
        super().__init__()
        self.needs_proj = in_channels != out_channels or stride != 1
        if self.needs_proj:
            self.downsample_conv = nn.Conv2d(in_channels, out_channels, 1,
                                             stride, bias=False,
                                             device=device)
            self.downsample_bn = FrozenBN(out_channels, device)
        self.conv1 = nn.Conv2d(in_channels, bottleneck_channels, 1,
                               bias=False, device=device)
        self.bn1 = FrozenBN(bottleneck_channels, device)
        self.conv2 = nn.Conv2d(bottleneck_channels, bottleneck_channels, 3,
                               stride, padding=1, groups=num_groups,
                               bias=False, device=device)
        self.bn2 = FrozenBN(bottleneck_channels, device)
        self.conv3 = nn.Conv2d(bottleneck_channels, out_channels, 1,
                               bias=False, device=device)
        self.bn3 = FrozenBN(out_channels, device)

    def forward(self, x):
        identity = x
        if self.needs_proj:
            identity = self.downsample_bn(self.downsample_conv(x))
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + identity)


class ResNetStage(nn.Module):
    """num_blocks bottlenecks named block0.. as the Flax stage."""

    def __init__(self, num_blocks: int, in_channels: int,
                 bottleneck_channels: int, out_channels: int,
                 first_stride: int = 1, num_groups: int = 1, device=None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", Bottleneck(
                in_channels if i == 0 else out_channels, bottleneck_channels,
                out_channels, first_stride if i == 0 else 1, num_groups,
                device))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class C4Backbone(nn.Module):
    """Stem + layer1..layer3 -> (B, 1024, H/16, W/16)."""

    def __init__(self, cfg: DetectorConfig, device=None):
        super().__init__()
        c = cfg
        self.stage_count = len(c.stage_blocks)
        self.stem_conv1 = nn.Conv2d(3, c.stem_channels, 7, 2, padding=3,
                                    bias=False, device=device)
        self.stem_bn1 = FrozenBN(c.stem_channels, device)
        cin = c.stem_channels
        for si in range(self.stage_count):
            self.add_module(f"layer{si + 1}", ResNetStage(
                c.stage_blocks[si], cin, c.bottleneck_channels[si],
                c.stage_out_channels[si], 1 if si == 0 else 2,
                c.num_groups, device))
            cin = c.stage_out_channels[si]

    def forward(self, x):
        x = F.relu(self.stem_bn1(self.stem_conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for si in range(self.stage_count):
            x = getattr(self, f"layer{si + 1}")(x)
        return x


class Res5Head(nn.Module):
    """ROI feature extractor head (layer4, stride 2): (N, 1024, r, r) ->
    pooled (N, 2048). Shared by the box and attribute heads."""

    def __init__(self, cfg: DetectorConfig, device=None):
        super().__init__()
        c = cfg
        base = c.num_groups * c.width_per_group
        self.layer4 = ResNetStage(
            c.res5_blocks, c.backbone_out_channels,
            base * 2 ** len(c.stage_blocks), c.res5_out_channels, 2,
            c.num_groups, device)

    def forward(self, x):
        return self.layer4(x).mean(dim=(2, 3))


class RPNHead(nn.Module):
    def __init__(self, cfg: DetectorConfig, device=None):
        super().__init__()
        ch = cfg.backbone_out_channels
        self.conv = nn.Conv2d(ch, ch, 3, padding=1, device=device)
        self.cls_logits = nn.Conv2d(ch, cfg.num_anchors, 1, device=device)
        self.bbox_pred = nn.Conv2d(ch, cfg.num_anchors * 4, 1,
                                   device=device)

    def forward(self, feat):
        """-> logits (B, fh, fw, A), deltas (B, fh, fw, 4A), the Flax
        model's NHWC order."""
        t = F.relu(self.conv(feat))
        return (self.cls_logits(t).permute(0, 2, 3, 1),
                self.bbox_pred(t).permute(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# Box math (py-faster-rcnn legacy conventions, as maskrcnn_benchmark keeps
# them: +1 box widths, generate_anchors rounding).
# ---------------------------------------------------------------------------

def generate_base_anchors(stride: int, sizes, ratios) -> np.ndarray:
    """Legacy generate_anchors (anchor_generator.py): base window
    [0, stride-1]^2, ratio enumeration with rounding, then scale
    enumeration. Returns (A, 4) float32."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float32)

    def whctr(a):
        w = a[2] - a[0] + 1
        h = a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mkanchors(ws, hs, xc, yc):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack([xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
                          xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)])

    w, h, xc, yc = whctr(base)
    size_ratios = (w * h) / np.asarray(ratios, np.float32)
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * np.asarray(ratios, np.float32))
    ratio_anchors = mkanchors(ws, hs, xc, yc)
    out = []
    scales = np.asarray(sizes, np.float32) / stride
    for ra in ratio_anchors:
        w, h, xc, yc = whctr(ra)
        out.append(mkanchors(w * scales, h * scales, xc, yc))
    return np.concatenate(out, 0).astype(np.float32)


def shift_anchors(base: np.ndarray, fh: int, fw: int,
                  stride: int) -> np.ndarray:
    """(A, 4) -> (fh * fw * A, 4), row-major over (y, x, a)."""
    sx = np.arange(fw, dtype=np.float32) * stride
    sy = np.arange(fh, dtype=np.float32) * stride
    xx, yy = np.meshgrid(sx, sy)
    shifts = np.stack([xx, yy, xx, yy], -1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode_boxes(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """BoxCoder.decode (maskrcnn box_coder.py): legacy +1 widths, dw/dh
    clamped at log(1000/16), x2 = ctr + w/2 - 1."""
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp_max(deltas[..., 2] / ww, BBOX_XFORM_CLIP)
    dh = torch.clamp_max(deltas[..., 3] / wh, BBOX_XFORM_CLIP)
    px = dx * widths + ctr_x
    py = dy * heights + ctr_y
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph,
                        px + 0.5 * pw - 1, py + 0.5 * ph - 1], -1)


def clip_boxes(boxes: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
    """Clip (..., 4) boxes to an image of hw (2,) = (h, w); a batch of
    boxes (B, ..., 4) takes hw (B, 2), one (h, w) per image."""
    h = hw[..., 0].to(boxes.dtype)
    w = hw[..., 1].to(boxes.dtype)
    if hw.dim() == 2:
        shape = (-1,) + (1,) * (boxes.dim() - 2)
        h, w = h.reshape(shape), w.reshape(shape)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi - 1)
    return torch.stack([clip(boxes[..., 0], w), clip(boxes[..., 1], h),
                        clip(boxes[..., 2], w), clip(boxes[..., 3], h)], -1)


def top_k(x: torch.Tensor, k: int):
    """jax.lax.top_k along the last axis: the k largest, equal values
    lowest index first (a stable descending sort)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) rows at idx (B, K) -> (B, K, ...)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


def rpn_proposals(logits, deltas, anchors, hw, cfg: DetectorConfig):
    """Anchors + RPN outputs -> (B, post_nms, 4) boxes, their validity and
    their RPN scores (the JAX _rpn_proposals_single over a batch)."""
    b = logits.shape[0]
    n = anchors.shape[0]
    pre = min(cfg.rpn_pre_nms_top_n, n)
    scores = logits.reshape(b, -1).float()
    top_s, top_i = top_k(scores, pre)
    sel_anchors = anchors[top_i]
    sel_deltas = _take(deltas.reshape(b, -1, 4).float(), top_i)
    boxes = clip_boxes(decode_boxes(sel_deltas, sel_anchors), hw)
    keep, _ = nms(boxes, top_s, cfg.rpn_nms_thresh,
                  max_outputs=cfg.rpn_post_nms_top_n)
    valid = keep >= 0
    keep = keep.clamp_min(0).long()
    return (torch.where(valid[..., None], _take(boxes, keep), 0.0), valid,
            top_s.gather(1, keep) * valid)


def select_detections(probs, box_deltas, proposals, prop_valid, hw,
                      cfg: DetectorConfig):
    """Flatten (proposal, class > 0) pairs -> one class-offset NMS per
    image (the JAX _select_detections_single over a batch): the threshold,
    the class NMS and the cap at detections_per_img, with the
    min_detections floor met by rank-penalising below-threshold pairs."""
    b, p, c = probs.shape
    pool = min(cfg.box_candidate_pool, p * (c - 1))
    fg = torch.where(prop_valid[..., None], probs[..., 1:], 0.0)
    flat = fg.reshape(b, -1)
    above = flat > cfg.box_score_thresh
    key = torch.where(above, flat + 2.0, flat)
    top_key, top_i = top_k(key, pool)
    pi = torch.div(top_i, c - 1, rounding_mode="floor")
    ci = top_i % (c - 1) + 1                               # true class id
    rows = torch.arange(b, device=probs.device)[:, None]
    sel_deltas = box_deltas.reshape(b, p, c, 4)[rows, pi, ci]
    sel_boxes = clip_boxes(decode_boxes(sel_deltas, _take(proposals, pi),
                                        weights=cfg.bbox_reg_weights), hw)
    sel_scores = flat.gather(1, top_i)
    sel_above = above.gather(1, top_i)
    # class-offset trick: boxes of different classes never overlap
    side = torch.maximum(hw[:, 0], hw[:, 1]).float()
    offset = ci.float() * (side[:, None] + 2.0)
    keep, _ = nms(sel_boxes + offset[..., None], top_key,
                  cfg.box_nms_thresh, max_outputs=cfg.detections_per_img)
    kvalid = keep >= 0
    keep_c = keep.clamp_min(0).long()
    d_boxes = _take(sel_boxes, keep_c)
    d_scores = sel_scores.gather(1, keep_c)
    d_labels = ci.gather(1, keep_c)
    d_above = sel_above.gather(1, keep_c) & kvalid
    # NMS emits above-threshold picks first (they carry the +2 key); keep
    # below-threshold survivors only up to the min-detections floor
    rank = torch.cumsum(kvalid.int(), dim=1) - 1
    d_valid = kvalid & (d_above | (rank < cfg.min_detections_per_img))
    d_boxes = torch.where(d_valid[..., None], d_boxes, 0.0)
    return (d_boxes, d_scores * d_valid, d_labels * d_valid, d_valid)


class AttrRCNN(nn.Module):
    """The VinVL-style detector. forward() takes NHWC float32 images,
    already resized and BGR-pixel-mean-subtracted and padded to a fixed
    canvas, and valid_hw (B, 2) giving each image's true (h, w)."""

    def __init__(self, cfg: DetectorConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.backbone = C4Backbone(c, device)
        self.rpn = RPNHead(c, device)
        self.roi_head = Res5Head(c, device)
        r5 = c.res5_out_channels
        self.cls_score = nn.Linear(r5, c.num_classes, device=device)
        self.bbox_pred = nn.Linear(r5, c.num_classes * 4, device=device)
        self.cls_embedding = nn.Embedding(c.num_classes, c.cls_emd_dim,
                                          device=device)
        self.fc_attr = nn.Linear(r5 + c.cls_emd_dim, c.attr_emd_dim,
                                 device=device)
        self.attr_score = nn.Linear(c.attr_emd_dim, c.num_attributes,
                                    device=device)

    def anchors(self, fh: int, fw: int, device) -> torch.Tensor:
        c = self.cfg
        return torch.from_numpy(shift_anchors(
            generate_base_anchors(c.anchor_stride, c.anchor_sizes,
                                  c.aspect_ratios), fh, fw,
            c.anchor_stride)).to(device)

    def pool(self, feat: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """ROIAlign of boxes (B, R, 4) on feat (B, C, H, W), image by
        image -> (B * R, C, r, r)."""
        c = self.cfg
        pooled = [roi_align(f.permute(1, 2, 0), bx,
                            output_size=c.pooler_resolution,
                            sampling_ratio=c.pooler_sampling_ratio,
                            spatial_scale=1.0 / c.anchor_stride)
                  for f, bx in zip(feat, boxes)]
        return torch.cat(pooled).permute(0, 3, 1, 2).contiguous()

    def head(self, rois: torch.Tensor) -> torch.Tensor:
        """The shared res5 head over (N, C, r, r) ROIs, roi_chunk at a
        time -> (N, 2048)."""
        n = self.cfg.roi_chunk
        return torch.cat([self.roi_head(rois[s:s + n])
                          for s in range(0, rois.shape[0], n)])

    def box_head(self, feat, proposals):
        """Box logits and deltas (B, P, classes), (B, P, 4 classes) of the
        proposals (B, P, 4) on the feature map."""
        b, p = proposals.shape[:2]
        box_feats = self.head(self.pool(feat, proposals))
        return (self.cls_score(box_feats).reshape(b, p, -1),
                self.bbox_pred(box_feats).reshape(b, p, -1))

    def forward(self, images: torch.Tensor, valid_hw: torch.Tensor,
                intermediates: bool = False) -> dict:
        """-> {boxes (B, D, 4) xyxy, scores, labels (>= 1), valid,
        num_detections, features (B, D, 2048), attr_scores, attr_labels
        (B, D, max_attr)}; with `intermediates` also the feature map
        (B, C, H/16, W/16), the RPN's logits and deltas (NHWC), the
        proposals with their validity and RPN scores, and the box head's
        logits, class probabilities and deltas on those proposals."""
        with full_float32():
            return self._forward(images, valid_hw, intermediates)

    def _forward(self, images, valid_hw, intermediates):
        c = self.cfg
        hw = valid_hw.to(images.device)
        feat = self.backbone(images.float().permute(0, 3, 1, 2).contiguous())
        logits, deltas = self.rpn(feat)
        fh, fw = feat.shape[2], feat.shape[3]
        proposals, prop_valid, prop_scores = rpn_proposals(
            logits, deltas, self.anchors(fh, fw, feat.device), hw, c)
        cls_logits, box_deltas = self.box_head(feat, proposals)
        probs = torch.softmax(cls_logits.float(), dim=-1)
        d_boxes, d_scores, d_labels, d_valid = select_detections(
            probs, box_deltas.float(), proposals, prop_valid, hw, c)

        # the attribute head re-pools the FINAL boxes through the shared
        # res5 extractor (AttrRCNN.py:89-103)
        b, d = d_boxes.shape[:2]
        det_feats = self.head(self.pool(feat, d_boxes))
        cls_emb = self.cls_embedding(d_labels.reshape(-1))
        attr_h = F.relu(self.fc_attr(torch.cat([det_feats, cls_emb], -1)))
        attr_probs = torch.softmax(self.attr_score(attr_h).float(),
                                   dim=-1).reshape(b, d, -1)
        attr_probs[..., 0] = 0.0                    # background attribute
        attr_probs = torch.where(attr_probs > c.attr_thresh, attr_probs,
                                 0.0)
        attr_scores, attr_labels = top_k(attr_probs, c.max_attr_per_obj)
        out = {"boxes": d_boxes, "scores": d_scores, "labels": d_labels,
               "valid": d_valid, "num_detections": d_valid.sum(-1),
               "features": det_feats.reshape(b, d, -1),
               "attr_scores": attr_scores, "attr_labels": attr_labels}
        if intermediates:
            out.update(feature_map=feat, rpn_logits=logits,
                       rpn_deltas=deltas, proposals=proposals,
                       proposal_valid=prop_valid,
                       proposal_scores=prop_scores, cls_logits=cls_logits,
                       box_deltas=box_deltas, probs=probs)
        return out


# ---------------------------------------------------------------------------
# Weight conversion: maskrcnn_benchmark / scene_graph_benchmark state dict
# -> AttrRCNN's state_dict (the checkpoint layout per resnet.py, rpn.py,
# roi_box_feature_extractors.py, roi_attribute_predictors.py).
# ---------------------------------------------------------------------------

BN_EPS = 1e-5   # FrozenBatchNorm2d uses the stored statistics verbatim


def convert_vinvl_params(state_dict: dict,
                         cfg: DetectorConfig) -> dict[str, torch.Tensor]:
    """torch state dict (e.g. torch.load(...)['model']) -> AttrRCNN's
    state_dict (float32 CPU tensors). 'module.' prefixes are stripped;
    frozen BN is folded into (scale, bias) with the JAX package's float32
    arithmetic; convolutions stay OIHW (grouped ones (out, in / groups,
    kh, kw))."""
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}

    def g(name):
        t = sd[name]
        return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t)).astype(np.float32)

    out = {}

    def conv(dst, src):
        out[f"{dst}.weight"] = g(f"{src}.weight")
        if f"{src}.bias" in sd:
            out[f"{dst}.bias"] = g(f"{src}.bias")

    def bn(dst, src):
        w = g(f"{src}.weight")
        mean = g(f"{src}.running_mean") if f"{src}.running_mean" in sd \
            else np.zeros_like(w)
        var = g(f"{src}.running_var") if f"{src}.running_var" in sd \
            else np.ones_like(w)
        scale = w / np.sqrt(var + BN_EPS)
        out[f"{dst}.scale"] = scale
        out[f"{dst}.bias"] = g(f"{src}.bias") - mean * scale

    def stage(dst, src, num_blocks):
        for i in range(num_blocks):
            for j in (1, 2, 3):
                conv(f"{dst}.block{i}.conv{j}", f"{src}.{i}.conv{j}")
                bn(f"{dst}.block{i}.bn{j}", f"{src}.{i}.bn{j}")
            if f"{src}.{i}.downsample.0.weight" in sd:
                conv(f"{dst}.block{i}.downsample_conv",
                     f"{src}.{i}.downsample.0")
                bn(f"{dst}.block{i}.downsample_bn",
                   f"{src}.{i}.downsample.1")

    conv("backbone.stem_conv1", "backbone.body.stem.conv1")
    bn("backbone.stem_bn1", "backbone.body.stem.bn1")
    for si, n in enumerate(cfg.stage_blocks):
        stage(f"backbone.layer{si + 1}", f"backbone.body.layer{si + 1}", n)
    for name in ("conv", "cls_logits", "bbox_pred"):
        conv(f"rpn.{name}", f"rpn.head.{name}")
    stage("roi_head.layer4", "roi_heads.box.feature_extractor.head.layer4",
          cfg.res5_blocks)
    for dst, src in (("cls_score", "roi_heads.box.predictor.cls_score"),
                     ("bbox_pred", "roi_heads.box.predictor.bbox_pred"),
                     ("cls_embedding", "attribute.predictor.cls_embedding"),
                     ("fc_attr", "attribute.predictor.fc_attr"),
                     ("attr_score", "attribute.predictor.attr_score")):
        conv(dst, src)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}
