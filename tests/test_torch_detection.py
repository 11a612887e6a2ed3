"""The VinVL detector path of ravqa_tpu_torch against ravqa_tpu on the CPU:
ops/vision.py, models/detection.py, data/extraction.py and the weight
bridges (convert_vinvl_params, models.convert.detector_to_state_dict).

One synthetic maskrcnn state dict (scripts/synthetic_okvqa.py's, tiny
widths) goes through both packages' convert_vinvl_params; the JAX forward
is jitted once per module-scoped fixture. Tolerances: box_iou and
decode/clip 1e-6 (the same float32 arithmetic); roi_align 1e-5;
continuous detector outputs within 1e-4 of each tensor's largest
magnitude; anchors, NMS indices, proposals' validity, labels, attribute
labels and validity exactly (every top-k is a stable sort in the port,
lowest index first on ties, as jax.lax.top_k); boxes 1e-3 px.
"""

import base64
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.data import extraction as jax_extraction
from ravqa_tpu.models import detection as jax_det
from ravqa_tpu.ops import vision as jax_vision
from ravqa_tpu_torch.data import extraction
from ravqa_tpu_torch.models import detection, detector_to_state_dict
from ravqa_tpu_torch.ops import vision
from ravqa_tpu_torch.scripts.synthetic_okvqa import \
    synthetic_vinvl_state_dict


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _np_sd(cfg, seed=0):
    return {k: v.numpy() for k, v in
            synthetic_vinvl_state_dict(cfg, seed).items()}


def _boxes(rng, n, span=80.0):
    xy = rng.uniform(0, span, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(1, 30, (n, 2))],
                          -1).astype(np.float32)


def test_box_iou_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 17), _boxes(rng, 23)
    b[3] = b[3, [2, 3, 0, 1]]                    # an inverted box: area 0
    np.testing.assert_allclose(
        vision.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_vision.box_iou(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,thresh,max_out", [(40, 0.5, 40), (200, 0.7, 30),
                                              (12, 0.3, 20)])
def test_nms_matches_jax(n, thresh, max_out):
    """Indices and counts identical, one image and a batch of three; equal
    scores keep the first index (the scores are rounded to 0.05)."""
    rng = np.random.default_rng(n)
    boxes = np.stack([_boxes(rng, n) for _ in range(3)])
    scores = np.round(rng.random((3, n)) * 20).astype(np.float32) / 20
    got_b = vision.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       thresh, max_out)
    for i in range(3):
        want = jax_vision.nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                              thresh, max_outputs=max_out)
        got = vision.nms(torch.from_numpy(boxes[i]),
                         torch.from_numpy(scores[i]), thresh, max_out)
        for g in (got, (got_b[0][i], got_b[1][i])):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(want[0]))
            assert int(g[1]) == int(want[1])


@pytest.mark.parametrize("out_size,sr,scale", [(7, 2, 1 / 16), (4, 3, 0.5),
                                               (14, 2, 1 / 16)])
def test_roi_align_matches_jax(out_size, sr, scale):
    """1e-5, with boxes past the map's edge on every side and a degenerate
    one (the JAX sampling clamps to the edge)."""
    rng = np.random.default_rng(out_size)
    feat = rng.normal(size=(11, 13, 24)).astype(np.float32)
    boxes = np.concatenate([_boxes(rng, 9, 200.0), np.array(
        [[-30.0, -12.0, 400.0, 50.0], [150.0, 170.0, 260.0, 300.0],
         [3.0, 3.0, 3.0, 3.0], [0.0, 0.0, 207.9, 175.9]], np.float32)])
    np.testing.assert_allclose(
        vision.roi_align(torch.from_numpy(feat), torch.from_numpy(boxes),
                         out_size, sr, scale).numpy(),
        np.asarray(jax_vision.roi_align(jnp.asarray(feat),
                                        jnp.asarray(boxes), out_size, sr,
                                        scale)), rtol=0, atol=1e-5)


def test_anchors_match_jax():
    for cfg in (detection.DetectorConfig.tiny(),
                detection.DetectorConfig.vinvl_x152c4()):
        base = detection.generate_base_anchors(
            cfg.anchor_stride, cfg.anchor_sizes, cfg.aspect_ratios)
        want = jax_det.generate_base_anchors(
            cfg.anchor_stride, cfg.anchor_sizes, cfg.aspect_ratios)
        np.testing.assert_array_equal(base, want)
        np.testing.assert_array_equal(
            detection.shift_anchors(base, 5, 7, cfg.anchor_stride),
            jax_det.shift_anchors(want, 5, 7, cfg.anchor_stride))


def test_decode_and_clip_boxes_match_jax():
    rng = np.random.default_rng(0)
    boxes = _boxes(rng, 50)
    deltas = rng.normal(size=(50, 4)).astype(np.float32)
    deltas[:5, 2:] = 9.0                          # past the dw/dh clamp
    hw = np.array([60, 90], np.int32)
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        got = detection.decode_boxes(torch.from_numpy(deltas),
                                     torch.from_numpy(boxes), weights)
        want = jax_det.decode_boxes(jnp.asarray(deltas), jnp.asarray(boxes),
                                    weights)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(
            detection.clip_boxes(got, torch.from_numpy(hw)).numpy(),
            np.asarray(jax_det.clip_boxes(want, jnp.asarray(hw))),
            rtol=1e-6, atol=1e-4)
    # a batch of boxes clips per image
    b2 = torch.from_numpy(np.stack([boxes, boxes]))
    hw2 = torch.tensor([[60, 90], [30, 20]])
    got = detection.clip_boxes(b2, hw2)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jax_det.clip_boxes(
                jnp.asarray(boxes), jnp.asarray(hw2[i].numpy()))))


@pytest.fixture(scope="module", params=[5, 60], ids=["attrs5", "attrs60"])
def tiny(request):
    """The tiny AttrRCNN in both packages from one synthetic maskrcnn state
    dict, and the JAX forward (jitted, with its intermediates) on two
    images. With 60 attributes every attribute probability falls under the
    0.05 threshold, so the attributes' top-3 is a tie of zeros."""
    cfg = detection.DetectorConfig.tiny(num_attributes=request.param)
    jcfg = jax_det.DetectorConfig.tiny(num_attributes=request.param)
    sd = _np_sd(cfg)
    params = jax.device_get(jax_det.convert_vinvl_params(sd, jcfg))
    rng = np.random.default_rng(0)
    imgs = (rng.normal(size=(2, 64, 96, 3)) * 50).astype(np.float32)
    hw = np.array([[64, 96], [48, 80]], np.int32)
    model = jax_det.AttrRCNN(jcfg)
    out, state = jax.jit(lambda p, i, h: model.apply(
        {"params": p}, i, h, capture_intermediates=True,
        mutable=["intermediates"]))(params, imgs, hw)
    port = detection.AttrRCNN(cfg)
    port.load_state_dict(detection.convert_vinvl_params(sd, cfg))
    return dict(cfg=cfg, jcfg=jcfg, sd=sd, params=params, imgs=imgs, hw=hw,
                want=jax.tree.map(np.asarray, out),
                inter=jax.tree.map(np.asarray, state["intermediates"]),
                port=port.eval())


def _scale_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_convert_vinvl_params_matches_jax(tiny):
    """The port's convert_vinvl_params equals the JAX package's tree
    carried across by detector_to_state_dict (HWIO -> OIHW, grouped
    (kh, kw, in / groups, out) included; the folded BN identical), and
    holds every parameter the port's model has; 'module.' prefixes go."""
    cfg = tiny["cfg"]
    got = detection.convert_vinvl_params(
        {f"module.{k}": v for k, v in tiny["sd"].items()}, cfg)
    want = detector_to_state_dict(tiny["params"])
    assert set(got) == set(want) == set(tiny["port"].state_dict())
    for k in got:
        assert torch.equal(got[k], want[k]), k
    grouped = got["backbone.layer1.block0.conv2.weight"]
    assert grouped.shape == (cfg.bottleneck_channels[0],
                             cfg.bottleneck_channels[0] // cfg.num_groups,
                             3, 3)


def test_attr_rcnn_matches_jax(tiny):
    """The forward on the JAX parameters: the C4 feature map, the RPN's
    logits and deltas and the box head's logits within 1e-4 of their
    scale; proposals, detections, labels, validity and attribute labels
    identical (attribute labels compared everywhere: the port's top-k is a
    stable sort, so the ties of zero-probability attributes come out in
    JAX's order); boxes 1e-3 px."""
    want, inter = tiny["want"], tiny["inter"]
    with torch.no_grad():
        got = tiny["port"](torch.from_numpy(tiny["imgs"]),
                           torch.from_numpy(tiny["hw"]), intermediates=True)
    assert _scale_err(got["feature_map"].permute(0, 2, 3, 1),
                      inter["backbone"]["__call__"][0]) <= 1e-4
    logits, deltas = inter["rpn"]["__call__"][0]
    assert _scale_err(got["rpn_logits"], logits) <= 1e-4
    assert _scale_err(got["rpn_deltas"], deltas) <= 1e-4
    cls = inter["cls_score"]["__call__"][0]
    assert _scale_err(got["cls_logits"].reshape(cls.shape), cls) <= 1e-4
    for key in ("features", "scores", "attr_scores"):
        assert _scale_err(got[key], want[key]) <= 1e-4, key
    for key in ("labels", "valid", "num_detections", "attr_labels"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0,
                               atol=1e-3)
    if tiny["cfg"].num_attributes == 60:
        assert (want["attr_scores"] == 0).all()
        assert (want["attr_labels"] == np.arange(3)).all()


def test_selection_on_fixed_inputs_matches_jax(tiny):
    """The proposal and detection selection alone, on the same continuous
    inputs in both packages (the JAX forward's RPN outputs and box head):
    proposals and detections identical."""
    cfg, jcfg, inter = tiny["cfg"], tiny["jcfg"], tiny["inter"]
    logits, deltas = inter["rpn"]["__call__"][0]
    fh, fw = logits.shape[1:3]
    anchors = jax_det.shift_anchors(jax_det.generate_base_anchors(
        cfg.anchor_stride, cfg.anchor_sizes, cfg.aspect_ratios), fh, fw,
        cfg.anchor_stride)
    hw = tiny["hw"]
    jp = [jax_det._rpn_proposals_single(logits[i], deltas[i], anchors,
                                        jnp.asarray(hw[i]), jcfg)
          for i in range(2)]
    props, valid, _ = detection.rpn_proposals(
        torch.tensor(logits), torch.tensor(deltas), torch.tensor(anchors),
        torch.tensor(hw), cfg)
    for i in range(2):
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jp[i][1]))
        np.testing.assert_allclose(props[i].numpy(), np.asarray(jp[i][0]),
                                   rtol=0, atol=1e-4)
    p = props.shape[1]
    cls = inter["cls_score"]["__call__"][0].reshape(2, p, -1)
    box = inter["bbox_pred"]["__call__"][0].reshape(2, p, -1)
    probs = np.asarray(jax.nn.softmax(cls, -1))
    props_j = np.stack([np.asarray(x[0]) for x in jp])
    valid_j = np.stack([np.asarray(x[1]) for x in jp])
    got = detection.select_detections(
        torch.tensor(probs), torch.tensor(box), torch.tensor(props_j),
        torch.tensor(valid_j), torch.tensor(hw), cfg)
    for i in range(2):
        want = jax_det._select_detections_single(
            probs[i], box[i], props_j[i], valid_j[i], jnp.asarray(hw[i]),
            jcfg)
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=1e-4)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


def _objects_match(got, want):
    assert got["num_boxes"] == want["num_boxes"]
    assert len(got["objects"]) == len(want["objects"])
    for g, w in zip(got["objects"], want["objects"]):
        assert (g["class"], g["attributes"]) == (w["class"],
                                                 w["attributes"])
        np.testing.assert_allclose(g["rect"], w["rect"], rtol=0, atol=0.011)
        assert abs(g["conf"] - w["conf"]) <= 1.1e-4
        np.testing.assert_allclose(g["attr_scores"], w["attr_scores"],
                                   rtol=0, atol=1.1e-4)
        gf, wf = (np.frombuffer(base64.b64decode(o["feature"]), np.float32)
                  for o in (g, w))
        assert _scale_err(gf, wf) <= 1e-4


def test_extractor_rows_match_jax(tiny, tmp_path):
    """VinVLFeatureExtractor.predict on three images of other sizes (a
    batch of 2 and a padded one) -> the same TSV rows as the JAX
    extractor's: classes and attributes identical, rects and scores to
    their rounding, the base64 features as float32 arrays to 1e-4 of their
    scale; then write_predictions_tsv and load_vg_labelmap as JAX's."""
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, s + (3,)).astype(np.uint8)
              for s in ((50, 70), (90, 40), (33, 33))]
    lab = {i: f"class{i}" for i in range(1, tiny["cfg"].num_classes)}
    attr = {i: f"attr{i}" for i in range(1, tiny["cfg"].num_attributes)}
    kw = dict(canvas_hw=(64, 64), batch_size=2, min_size=40, max_size=64)
    want = jax_extraction.VinVLFeatureExtractor(
        tiny["jcfg"], {"params": tiny["params"]}, lab, attr,
        **kw).predict(images)
    ex = extraction.VinVLFeatureExtractor(
        tiny["cfg"], detector_to_state_dict(tiny["params"]), lab, attr,
        device="cpu", **kw)
    got = ex.predict(images)
    for g, w in zip(got, want):
        _objects_match(g, w)
    paths = [str(tmp_path / f"{n}.tsv") for n in ("port", "jax")]
    extraction.write_predictions_tsv(paths[0], ["1", "2", "3"], got)
    jax_extraction.write_predictions_tsv(paths[1], ["1", "2", "3"], got)
    assert open(paths[0]).read() == open(paths[1]).read()
    for layout in ({"idx_to_label": {"1": "cat"},
                    "idx_to_attribute": {"2": "red"}},
                   {"label_to_idx": {"cat": 1},
                    "attribute_to_idx": {"red": 2}}):
        p = tmp_path / "labelmap.json"
        p.write_text(json.dumps(layout))
        assert extraction.load_vg_labelmap(str(p)) == \
            jax_extraction.load_vg_labelmap(str(p))


def test_preprocess_and_region_features_match_jax():
    """scale_for_detection, preprocess_for_detection (the host resize, the
    BGR mean, the canvas) and oscar_region_features exactly."""
    rng = np.random.default_rng(0)
    for h, w in ((480, 640), (300, 1000), (17, 9)):
        assert extraction.scale_for_detection(h, w) == \
            jax_extraction.scale_for_detection(h, w)
        im = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        got = extraction.preprocess_for_detection(im, (1024, 1024))
        want = jax_extraction.preprocess_for_detection(im, (1024, 1024))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    feats = rng.normal(size=(5, 8)).astype(np.float32)
    boxes = _boxes(rng, 5)
    np.testing.assert_array_equal(
        extraction.oscar_region_features(feats, boxes, (90, 120)),
        jax_extraction.oscar_region_features(feats, boxes, (90, 120)))
