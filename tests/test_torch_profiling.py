"""The port's profiling utilities (ravqa_tpu_torch/utils/profiling.py)
against the JAX package's (ravqa_tpu/utils/profiling.py): StepTimer's
summary keys and arithmetic on the same step times, device_memory_stats's
CPU entry, a Chrome trace naming an annotate span, and the exports."""

import json
import os

import numpy as np
import pytest
import torch

from ravqa_tpu import utils as jax_utils
from ravqa_tpu.utils import profiling as jax_prof
from ravqa_tpu_torch import utils
from ravqa_tpu_torch.utils import profiling as prof


def test_step_timer_summary_matches_jax():
    times = np.random.default_rng(0).uniform(0.01, 0.2, 9).tolist()
    got, want = prof.StepTimer(), jax_prof.StepTimer()
    got.times, want.times = list(times), list(times)
    for skip in (0, 1, 3, 20):
        g, w = got.summary(skip), want.summary(skip)
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-12)
    assert prof.StepTimer().summary() == jax_prof.StepTimer().summary() == {}


def test_step_timer_waits_for_its_value():
    t = prof.StepTimer()
    x = torch.randn(64, 64)
    for _ in range(3):
        assert t.tick(x @ x) >= 0
    t.tick(np.float32(1.0))
    t.tick()
    s = t.summary()
    assert s["steps"] == 4 and s["steps_per_s"] > 0
    assert s.keys() == {"steps", "mean_s", "p50_s", "p95_s", "steps_per_s"}


def test_device_memory_stats_on_the_cpu():
    stats = prof.device_memory_stats()
    assert stats == [{"device": "cpu"}]
    # the JAX package gives one such entry per CPU device, with no counter
    assert all(set(s) == {"device"} for s in jax_prof.device_memory_stats())


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    log_dir = str(tmp_path / "trace")
    with prof.trace(log_dir):
        with prof.annotate("triples_step"):
            (torch.randn(32, 32) @ torch.randn(32, 32)).sum().item()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "triples_step" for e in events)


def test_exports_match_jax():
    assert set(jax_utils.__all__) <= set(utils.__all__)
    utils.set_seed(3)
    a = (np.random.rand(), torch.rand(()).item())
    utils.set_seed(3)
    assert (np.random.rand(), torch.rand(()).item()) == a
