"""Profiling and observability.

Port of ravqa_tpu/utils/profiling.py on torch.profiler and torch.cuda:
- trace(log_dir): torch.profiler around a block, written to log_dir as a
  Chrome trace (trace.json; chrome://tracing or Perfetto read it), with
  the card's activity when CUDA is available;
- annotate(name): a named span in that trace (record_function);
- device_memory_stats(): each card's allocator counters in bytes from
  torch.cuda.memory_stats (the keys with "bytes" or "size"); on a machine
  without a card one entry {"device": "cpu"}, as the JAX package gives on
  its CPU backend;
- StepTimer: step wall times taken after the step's device work has
  finished (tick(value) reads the value back to the host, or synchronizes
  its card), since a launch returns before the kernels run.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace: `with trace('/tmp/prof'): step()` writes
    <log_dir>/trace.json."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named host span: `with annotate('encode'): ...`."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> list[dict]:
    """Per-device memory counters in bytes. One {"device": "cpu"} entry
    without a card."""
    if not torch.cuda.is_available():
        return [{"device": "cpu"}]
    out = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out.append({"device": f"cuda:{i}",
                    **{k: int(v) for k, v in s.items()
                       if "bytes" in k or "size" in k}})
    return out


def _sync(value) -> None:
    """Wait for the work that produces `value`: a tensor on a card is
    synchronized with its device and read back; anything else is read
    into numpy (a host value is ready already)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
        value.detach().cpu()
    else:
        np.asarray(value)


class StepTimer:
    """Wall-clock step timing that waits for the device.

    usage:
        t = StepTimer()
        for batch in ...:
            out = step(batch)
            t.tick(out["loss"])   # waits for the loss -> a true step end
        print(t.summary())
    """

    def __init__(self):
        self.times: list[float] = []
        self._last = time.perf_counter()

    def tick(self, sync_value=None) -> float:
        if sync_value is not None:
            _sync(sync_value)
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.times.append(dt)
        return dt

    def summary(self, skip_first: int = 1) -> dict:
        ts = self.times[skip_first:] or self.times
        if not ts:
            return {}
        return {"steps": len(ts),
                "mean_s": float(np.mean(ts)),
                "p50_s": float(np.percentile(ts, 50)),
                "p95_s": float(np.percentile(ts, 95)),
                "steps_per_s": float(1.0 / np.mean(ts))}
