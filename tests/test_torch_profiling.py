"""The port's profiling utilities (ravqa_tpu_torch/utils/profiling.py)
against the JAX package's (ravqa_tpu/utils/profiling.py): StepTimer's
summary keys and arithmetic on the same step times, device_memory_stats's
CPU entry, a Chrome trace naming an annotate span and a span of a thread
that started before the trace, and the exports."""

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


def test_trace_merges_the_spans_of_a_thread_started_before_it(tmp_path):
    """A server's dispatcher runs before the profiler starts, which then
    leaves out its ranges: trace() merges the recorded span into the file,
    on the dispatcher's thread id, inside the block's anchor range."""
    import threading
    go, done = threading.Event(), threading.Event()
    tid = {}

    def dispatcher():
        tid["id"] = threading.get_native_id()
        go.wait(timeout=30)
        with prof.span("serve.dispatch", n=2):
            (torch.randn(16, 16) @ torch.randn(16, 16)).sum().item()
        done.set()

    t = threading.Thread(target=dispatcher, daemon=True)
    t.start()
    log_dir = str(tmp_path / "trace")
    with prof.trace(log_dir):
        go.set()
        assert done.wait(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    merged = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in merged] == ["serve.dispatch"]
    (e,) = merged
    assert e["ph"] == "X" and e["tid"] == tid["id"]
    assert e["args"]["n"] == 2 and e["dur"] > 0
    anchor = next(a for a in events if a.get("name") == prof.TRACE_ANCHOR)
    assert anchor["ts"] <= e["ts"]
    assert e["ts"] + e["dur"] <= anchor["ts"] + anchor["dur"]
    assert prof.take_spans() == []


def test_trace_places_spans_by_clock_marks():
    """The merged spans' offset: each clock mark's query less its host
    time, the least of them (a query's latency only adds), a stray far
    below the median left out; without marks the range's anchor."""
    def mark(us):
        return {"name": "clock.mark", "start": int(us * 1e3)}

    def call(ts):
        return {"name": "cudaStreamQuery", "cat": "cuda_runtime", "ts": ts}

    spans = [mark(1_000.0), mark(50_000.0), mark(90_000.0),
             {"name": "serve.dispatch", "start": 1_000_000}]
    # true offset 500; lags 3, 1 and 7 us; a stray 400 us early near the
    # second mark, which a coarse anchor 300 us low pairs with it
    events = [call(1_503.0), call(50_501.0), call(90_507.0), call(50_100.0)]
    assert prof.mark_offset(spans, events, 200.0) == pytest.approx(503.0)
    assert prof.mark_offset(spans, events[:3], 500.0) == pytest.approx(
        501.0)
    assert prof.mark_offset(spans[3:], events, 123.0) == 123.0


def test_exports_match_jax():
    assert set(jax_utils.__all__) <= set(utils.__all__)
    utils.set_seed(3)
    a = (np.random.rand(), torch.rand(()).item())
    utils.set_seed(3)
    assert (np.random.rand(), torch.rand(()).item()) == a
