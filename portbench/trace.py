"""The traced run's profiler and the reduction of its trace.

`Tracer` wraps torch.profiler around the measured window. Copied from
ravqa_tpu_torch/profile_serve.py (`kernel_events`): a trace on the card
loses kernels, mostly the first after the profiler starts, so BURN_IN
launches of torch's `spin_kernel` (torch.cuda._sleep) go first, before the
window's range opens; they are left out of every reading.

`Trace` reads the Chrome trace once: the device's kernel, memcpy and
memset events, the launches that made them (by correlation id), and the
benchmark's own record_function ranges ("pb.*"), so each kernel is
attributed to the innermost range on the launching thread that was open
when it was launched.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch
from torch.autograd.profiler import record_function

BURN_IN = 64
BURN_IN_CYCLES = 10_000
BURN_IN_KERNEL = "spin_kernel"
WINDOW = "pb.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    """`with Tracer(on) as t:` profiles its block when `on`; `t.trace` is
    the parsed Trace afterwards (None when off).

    `span(name)` is the benchmark's range around a call into a layer: a
    record_function range, and the host clock's start and end. The
    profiler does not record the ranges of a thread that was running
    before it started (the server's dispatcher), and names such a
    thread's launches by an id of its own, so the trace takes every range
    from the host clock, placed on its timeline by the window's range,
    which the profiler does record. In the window one thread at a time
    makes the benchmark's ranges (the dispatcher, or the training loop),
    so a launch belongs to the innermost range open when it was made,
    whichever thread made it."""

    def __init__(self, on: bool):
        self.on, self.trace, self._prof = on, None, None
        self.spans = []

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            self.spans.append((name, t, time.perf_counter()))

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            for _ in range(BURN_IN):
                torch.cuda._sleep(BURN_IN_CYCLES)
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self.trace = Trace(json.load(f)["traceEvents"],
                                       self.spans)
            finally:
                os.remove(path)
        self._prof = None
        return False


class Trace:
    def __init__(self, events: list, spans=()):
        self.device, launches = [], {}
        win = None
        for e in events:
            cat = e.get("cat")
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                if BURN_IN_KERNEL not in e.get("name", ""):
                    self.device.append(e)
            elif cat in ("cuda_runtime", "cuda_driver") \
                    and "correlation" in args:
                launches[args["correlation"]] = e
            elif cat == "user_annotation" and e.get("name") == WINDOW:
                win = e
        self.launches = launches
        host_win = [s for s in spans if s[0] == WINDOW]
        if win is None or not host_win:
            raise RuntimeError("the trace holds no window range")
        self.t0 = win["ts"]
        self.t1 = win["ts"] + win["dur"]
        # host clock (s) -> trace time (us), anchored at the window's start
        offset = self.t0 - host_win[0][1] * 1e6
        self.ranges = sorted(({"name": name, "ts": a * 1e6 + offset,
                               "dur": (b - a) * 1e6}
                              for name, a, b in spans if name != WINDOW),
                             key=lambda r: r["ts"])
        self.device = [e for e in self.device
                       if self.t0 <= e["ts"] <= self.t1]
        self.device.sort(key=lambda e: e["ts"])
        self._starts = [r["ts"] for r in self.ranges]
        for e in self.device:
            e["_range"] = self.range_of(e)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def range_of(self, event) -> str:
        """The innermost benchmark range open when the device event was
        launched ("" when none)."""
        corr = (event.get("args") or {}).get("correlation")
        launch = self.launches.get(corr)
        if launch is None:
            return ""
        return self._open_at(launch["ts"]) or ""

    def by_range(self, prefix: str) -> tuple:
        """(device seconds of the events launched in ranges whose name
        starts with `prefix`, the number of such ranges in the window)."""
        secs = sum(e["dur"] for e in self.device
                   if e["_range"].startswith(prefix)) / 1e6
        n = sum(1 for r in self.ranges if r["name"].startswith(prefix)
                and self.t0 <= r["ts"] <= self.t1)
        return secs, n

    def busy_s(self) -> float:
        """Seconds of the window in which a device event ran (the union of
        their intervals)."""
        busy, end = 0.0, self.t0
        for e in self.device:
            s, f = max(e["ts"], end), min(e["ts"] + e["dur"], self.t1)
            if f > s:
                busy += f - s
            end = max(end, f)
        return busy / 1e6

    def gaps(self) -> list:
        """[(start, length)] of the window's idle intervals, in us."""
        out, end = [], self.t0
        for e in self.device:
            if e["ts"] > end:
                out.append((end, e["ts"] - end))
            end = max(end, e["ts"] + e["dur"])
        if self.t1 > end:
            out.append((end, self.t1 - end))
        return out

    def kernels(self, pattern: str) -> list:
        return [e for e in self.device
                if e.get("cat") == "kernel" and pattern in e["name"]]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        the benchmark range open on the host at each gap's middle."""
        ops = defaultdict(float)
        for e in self.device:
            ops[e["name"]] += e["dur"] / 1e6
        idle = defaultdict(float)
        for start, length in self.gaps():
            name = self._open_at(start + length / 2) or \
                "host outside the benchmark's ranges"
            idle[name] += length / 1e6
        order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in gaps]}

    def _open_at(self, ts, depth: int = 4):
        """The innermost benchmark range open at `ts`: the ranges nest at
        most `depth` deep, so only that many of the latest to start are
        looked at."""
        i = bisect.bisect_right(self._starts, ts)
        for j in range(i - 1, max(i - 1 - depth, -1), -1):
            r = self.ranges[j]
            if r["ts"] + r["dur"] >= ts:
                return r["name"]
        return None
