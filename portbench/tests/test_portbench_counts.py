"""The operation and byte counts behind k1_roofline and mfu, at worked
shapes: each counts the function's work once, whatever implements it."""

import json
import os

import pytest

from portbench import spec

ROOT = spec.ROOT


def _cfg(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def _work(name):
    with open(os.path.join(ROOT, "portbench", "workloads",
                           name + ".json")) as f:
        return json.load(f)


def test_k1_bound_at_the_serve_shape():
    k1 = spec.reader("layer_metrics", "k1_roofline.burst")
    b, lq, n, ld, dim = 32, 64, 168_320, 220, 128
    ops = 2 * 32 * 64 * 168_320 * 220 * 128
    assert ops == 19_414_594_355_200
    moved = (168_320 * 220 * 128 * 4      # the float32 index, read once
             + 168_320 * 220              # its int8 mask
             + 32 * 64 * 128 * 4          # the float32 query
             + 32 * 168_320 * 4)          # the (B, N) float32 scores
    assert moved == 19_019_188_736
    t = k1.launch_bound_s(b, lq, n, ld, dim, 4, 989e12, 3.35e12)
    assert t == pytest.approx(ops / 989e12)          # compute-bound
    assert t == pytest.approx(0.0196305302, rel=1e-6)
    # a bf16 index halves the index bytes; still compute-bound
    assert k1.launch_bound_s(b, lq, n, ld, dim, 2, 989e12, 3.35e12) == t


def test_flmr_request_flops():
    fl = spec.part("flops", "flmr_base_okvqa")
    cfg, work = _cfg("flmr_base_okvqa"), _work("flmr_exact_burst")
    layer = (4 * 2 * 32 * 768 * 768         # q, k, v, out projections
             + 2 * 2 * 32 * 32 * 768        # scores and weighted sum
             + 2 * 2 * 32 * 768 * 3072)     # the MLP
    bert = 12 * layer
    linear = 2 * 32 * 768 * 128
    mapping = 2 * (768 * 2048 + 2048 * 4096)
    search = 2 * 64 * 168_306 * 220 * 128
    assert fl.request_flops(cfg, work) == bert + linear + mapping + search
    assert fl.request_flops(cfg, work) == pytest.approx(6.122e11, rel=1e-3)


def test_flmr_step_flops():
    fl = spec.part("flops", "flmr_base_okvqa")
    cfg = _cfg("flmr_base_okvqa")
    q_layer = (4 * 2 * 960 * 768 ** 2 + 2 * 2 * 960 * 32 * 768
               + 2 * 2 * 960 * 768 * 3072)           # 30 queries x 32
    d_rows = 150 * 220                                 # 30 x nway 5 docs
    d_layer = (4 * 2 * d_rows * 768 ** 2 + 2 * 2 * d_rows * 220 * 768
               + 2 * 2 * d_rows * 768 * 3072)
    fwd = (12 * q_layer + 2 * 960 * 768 * 128
           + 30 * 2 * (768 * 2048 + 2048 * 4096)
           + 12 * d_layer + 2 * d_rows * 768 * 128
           + 2 * 64 * 150 * 220 * 128                  # each query's nway
           + 2 * 30 * 64 * 150 * 220 * 128)            # in-batch negatives
    assert fl.step_flops(cfg, {}) == 3 * fwd
    assert fl.step_flops(cfg, {}) == pytest.approx(1.82e13, rel=0.01)


def test_preflmr_request_flops():
    fl = spec.part("flops", "preflmr_vitl")
    cfg, work = _cfg("preflmr_vitl"), _work("preflmr_hier_burst")
    seq = 257                                          # 16 x 16 patches + CLS
    vit = (2 * 256 * 14 * 14 * 3 * 1024
           + 24 * (4 * 2 * seq * 1024 ** 2 + 2 * 2 * seq * seq * 1024
                   + 2 * 2 * seq * 1024 * 4096))
    bert = 12 * (4 * 2 * 32 * 768 ** 2 + 2 * 2 * 32 * 32 * 768
                 + 2 * 2 * 32 * 768 * 3072)
    tmap = (2 * 256 * 1024 * 768
            + (4 * 2 * 256 * 768 ** 2 + 2 * 2 * 256 * 256 * 768
               + 2 * 2 * 256 * 768 * 3072)             # self-attention, MLP
            + 2 * 2 * 256 * 768 ** 2 + 2 * 2 * 32 * 768 ** 2
            + 2 * 2 * 256 * 32 * 768                    # cross-attention
            + 2 * 256 * 768 * 128)
    tower = (bert + 2 * 32 * 768 * 128 + vit
             + 2 * (1024 * 2048 + 2048 * 4096) + tmap)
    lq = 32 + 32 + 256
    search = (2 * lq * (168_306 // 64) * 4 * 128       # stage 0
              + 2 * lq * 32 * 64 * 8 * 128             # stage 1
              + 2 * lq * 256 * 512 * 128)              # fine stage
    assert fl.request_flops(cfg, work) == tower + search
    assert fl.request_flops(cfg, work) == pytest.approx(1.854e11, rel=1e-3)
