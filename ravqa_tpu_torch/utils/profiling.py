"""Profiling and observability.

Port of ravqa_tpu/utils/profiling.py on torch.profiler and torch.cuda, and
the port's span recorder:
- span(name, **attrs): one span of host time (name, start and end on
  time.perf_counter_ns, the native thread id, the span open on the same
  thread when it began, attributes such as `req`, `dispatch`, `n`) while
  recording is on, kept in memory until take_spans() hands it out. On a
  thread a running profiler follows it also enters a record_function of
  its name, so the span shows in that profiler's trace; elsewhere it does
  not (the profiler would drop the range, and entering one lets other
  threads take the interpreter lock, twice). While recording is off it
  returns one shared no-op object: no clock reading, no record_function.
  It never waits on the device: a span times the host, and the device
  time of its work is read from the kernels it launched (a profiler
  trace);
- clock_mark(device): while recording, on a CUDA device, a zero-length
  span "clock.mark" at the host time just before a cudaStreamQuery on
  the device's current stream (which waits on nothing): a profiler's
  trace holds that call as a runtime event on the clock its launches
  are on, so the pair places the spans on that clock to within the
  call's own microseconds. A server's dispatch and a training step make
  one each;
- recording(): recording on for the process within the block; enabled()
  reads it. A torch.profiler running in the process turns it on too, so
  a profiled run (the benchmark's traced run among them) records the
  program's spans unasked. The recorder keeps at most MAX_SPANS, the
  latest, so a long profiled run that never takes them stays bounded;
  take_spans() hands out all it holds, and a reader keeps those of its
  own interval (trace() and the benchmark's reader do);
- mark_offset(spans, events, coarse): the clock marks' placement, for
  trace() and for a reader of a profiler trace;
- trace(log_dir): torch.profiler around a block, written to log_dir as a
  Chrome trace (trace.json; chrome://tracing or Perfetto read it), with
  the card's activity when CUDA is available, and the block's spans merged
  in as "X" events on their own threads: the profiler leaves out the
  ranges of a thread that was running before it started (a server's
  dispatcher), the merged spans do not;
- annotate(name): span(name), the named host span of the JAX package;
- device_memory_stats(): each card's allocator counters in bytes from
  torch.cuda.memory_stats (the keys with "bytes" or "size"); on a machine
  without a card one entry {"device": "cpu"}, as the JAX package gives on
  its CPU backend;
- StepTimer: step wall times taken after the step's device work has
  finished (tick(value) reads the value back to the host, or synchronizes
  its card), since a launch returns before the kernels run.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import threading
import time

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd.profiler import record_function

# the range that places the merged spans on a trace's clock where no
# clock mark does (trace()); the marks' span name and runtime call
TRACE_ANCHOR = "utils.trace"
MARK, MARK_CALL = "clock.mark", "cudaStreamQuery"
# how far a mark may lie from its call when placed by the coarse offset;
# how far below the pairs' median a pair may lie and still count (us)
PAIR_US = 10_000.0
MARK_SPREAD_US = 100.0
# the most spans the recorder holds (the latest)
MAX_SPANS = 1 << 17


class _Recorder:
    """The process's spans: `on` counts the open recording() blocks;
    `spans` holds the latest MAX_SPANS finished spans as (id, parent id,
    name, native thread id, start ns, end ns, attrs) until take_spans()."""

    def __init__(self):
        self.on = 0
        self.spans = collections.deque(maxlen=MAX_SPANS)
        self.ids = itertools.count(1)
        self.lock = threading.Lock()
        self.local = threading.local()

    def thread(self):
        """(this thread's stack of open spans, its native id)."""
        loc = self.local
        try:
            return loc.stack, loc.tid
        except AttributeError:
            loc.stack, loc.tid = [], threading.get_native_id()
            return loc.stack, loc.tid

    def add(self, record: tuple) -> None:
        with self.lock:
            self.spans.append(record)


_REC = _Recorder()


class _NoSpan:
    """What span() returns while recording is off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "tid", "start", "_rf",
                 "_stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __bool__(self):
        return True

    def set(self, **attrs) -> None:
        """Attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack, self.tid = _REC.thread()
        self.parent = stack[-1].id if stack else None
        self.id = next(_REC.ids)
        stack.append(self)
        self._stack = stack
        self._rf = None
        if _profiled_thread():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._stack.pop()
        _REC.add((self.id, self.parent, self.name, self.tid, self.start, end,
                  self.attrs))
        return False


def clock_mark(device) -> None:
    """A "clock.mark" span and a cudaStreamQuery on `device`'s current
    stream right after its host time, while recording is on and `device`
    is a CUDA device (module docstring)."""
    if not enabled():
        return
    device = torch.device(device)
    if device.type != "cuda":
        return
    stack, tid = _REC.thread()
    stream = torch.cuda.current_stream(device)
    t = time.perf_counter_ns()
    stream.query()
    _REC.add((next(_REC.ids), stack[-1].id if stack else None, MARK, tid,
              t, t, {}))


def _profiled_thread() -> bool:
    """Whether a running profiler records this thread's ranges."""
    return torch._C._autograd._profiler_enabled()


def enabled() -> bool:
    """Whether spans are recorded: inside recording(), or while a
    torch.profiler runs in the process."""
    return _REC.on > 0 or _autograd_profiler._is_profiler_enabled


def span(name: str, **attrs):
    """`with span("serve.dispatch", n=4) as s:` records the block as one
    span while recording is on (s.set(k=v) adds attributes inside it);
    otherwise the shared no-op NO_SPAN, which is false."""
    if not (_REC.on or _autograd_profiler._is_profiler_enabled):
        return NO_SPAN
    return _Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Record spans within the block."""
    with _REC.lock:
        _REC.on += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.on -= 1


def take_spans() -> list[dict]:
    """Hand out, and forget, every span recorded so far: dicts with "id",
    "parent" (the id of the span open on the same thread when it began, or
    None), "name", "tid" (native thread id), "start" and "end"
    (perf_counter_ns), "self" (ns of the span not covered by its
    children) and "attrs"."""
    with _REC.lock:
        spans = list(_REC.spans)
        _REC.spans.clear()
    child_ns: dict = {}
    for sid, parent, _, _, start, end, _ in spans:
        if parent is not None:
            child_ns[parent] = child_ns.get(parent, 0) + end - start
    return [{"id": sid, "parent": parent, "name": name, "tid": tid,
             "start": start, "end": end,
             "self": end - start - child_ns.get(sid, 0), "attrs": attrs}
            for sid, parent, name, tid, start, end, attrs in spans]


def _chrome_events(spans: list[dict], offset_us: float, pid) -> list[dict]:
    """Spans as Chrome-trace "X" events: host perf_counter_ns -> the
    trace's microseconds by `offset_us` (trace us minus host us of one
    instant both clocks saw)."""
    return [{"ph": "X", "cat": "program_span", "name": s["name"],
             "pid": pid, "tid": s["tid"],
             "ts": s["start"] / 1e3 + offset_us,
             "dur": (s["end"] - s["start"]) / 1e3,
             "args": {"id": s["id"], "parent": s["parent"], **s["attrs"]}}
            for s in spans]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace: `with trace('/tmp/prof'): step()` writes
    <log_dir>/trace.json, with the spans recorded in the block (taken
    from the recorder) merged in. They are placed by the block's clock
    marks (mark_offset), else by a range this thread opens as the block
    starts, whose start the profiler records on its clock and the host on
    perf_counter_ns (its stamp can lie some hundred microseconds from the
    runtime events' clock)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    with recording():
        prof.__enter__()
        try:
            t0 = time.perf_counter_ns()
            with record_function(TRACE_ANCHOR):
                yield prof
        finally:
            prof.__exit__(None, None, None)
            spans = [s for s in take_spans() if s["end"] >= t0]
            path = os.path.join(log_dir, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
            events = doc["traceEvents"]
            anchor = next((e for e in events
                           if e.get("name") == TRACE_ANCHOR
                           and e.get("ph") == "X"), None)
            if anchor is not None:
                offset = mark_offset(spans, events, anchor["ts"] - t0 / 1e3)
                events += _chrome_events(spans, offset, anchor.get("pid", 0))
                with open(path, "w") as f:
                    json.dump(doc, f)


def mark_offset(spans, events, coarse: float) -> float:
    """Trace us less host us by the clock marks among `spans` (as
    take_spans() gives them) and the MARK_CALL runtime events among
    `events` (a profiler trace's): each mark paired with the call nearest
    to it placed by `coarse` (within PAIR_US), the least difference of a
    pair (only the call's latency lifts one), pairs over MARK_SPREAD_US
    below their median left out as strays; `coarse` without marks."""
    calls = sorted(e["ts"] for e in events if e.get("name") == MARK_CALL)
    cands = []
    for s in spans:
        if s["name"] != MARK or not calls:
            continue
        at = s["start"] / 1e3
        i = bisect.bisect_left(calls, at + coarse)
        near = min(calls[max(i - 1, 0):i + 1],
                   key=lambda t: abs(t - at - coarse))
        if abs(near - at - coarse) <= PAIR_US:
            cands.append(near - at)
    if not cands:
        return coarse
    cands.sort()
    low = cands[len(cands) // 2] - MARK_SPREAD_US
    return min(c for c in cands if c >= low)


def annotate(name: str):
    """A named host span: `with annotate('encode'): ...` (span(name))."""
    return span(name)


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
