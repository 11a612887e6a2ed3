"""The program's own spans in a traced run, on the device trace's clock.

The program (ravqa_tpu_torch.utils.profiling) records its spans while a
torch.profiler runs in the process, which the traced run's Tracer starts
around the window; `of(ctx)` takes them once, after the run, and keeps
them on the trace as `trace.program` for every reader. A program without
the recorder, or a run that recorded nothing, gives None, and each reader
of a program span then reports nothing.

Spans are on the host's perf_counter and go onto the profiler's timeline
by the program's clock marks (profiling.mark_offset: each dispatch and
training step records a "clock.mark" span at the host time just before a
cudaStreamQuery, which the trace holds as a runtime event on the clock of
the launches), paired by the offset the cell's `log.t0` gives (read on
entering the window's range). The record_function ranges, the Tracer's
own anchor among them, do not do: their stamps lie tens to hundreds of
microseconds from the runtime events', so a launch made just after a span
opens would land in the span before it. Without marks the spans are
placed by `log.t0`.

Each device event is attributed to the innermost program span open when
it was launched: on the launching thread, where the launch's thread id is
a thread the program's spans were recorded on; otherwise on the thread
that opened `serve.dispatch` or `train.step` (the profiler names some
threads' launches by an id of its own, and autograd's backward launches
from a thread of its own, inside the open `train.backward`).
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

DISPATCHING = ("serve.dispatch", "train.step")


def _profiling():
    """The program's recorder module, or None where it has none."""
    try:
        from ravqa_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "take_spans") else None


def take() -> list:
    """The spans the program recorded ([] where it has no recorder)."""
    profiling = _profiling()
    return profiling.take_spans() if profiling is not None else []


def of(ctx):
    """The run's Program, made once and kept on its trace, or None (no
    trace, or no span recorded)."""
    trace = ctx.trace
    if trace is None:
        return None
    if not hasattr(trace, "program"):
        spans = take()
        trace.program = Program(trace, spans, ctx.log.t0) if spans else None
    return trace.program


def _segments(spans: list) -> tuple:
    """One thread's properly nested spans -> (times, owner): from times[i]
    on, owner[i] is the innermost open span (None: none open)."""
    points = []
    for s in spans:
        points.append((s["ts"], 1, s["id"]))
        points.append((s["ts"] + s["dur"], 0, s["id"]))
    points.sort(key=lambda p: (p[0], p[1]))
    stack, times, owner = [], [], []
    for t, opens, sid in points:
        if opens:
            stack.append(sid)
        elif sid in stack:
            stack.remove(sid)
        times.append(t)
        owner.append(stack[-1] if stack else None)
    return times, owner


def _at(seg: tuple, ts: float):
    times, owner = seg
    i = bisect.bisect_right(times, ts) - 1
    return owner[i] if i >= 0 else None


class Program:
    """The program's spans of one traced run and its device events'
    attribution to them (trace times in us, as the Trace's)."""

    def __init__(self, trace, spans: list, host_t0: float):
        self.trace = trace
        profiling = _profiling()
        # host us -> trace us
        self.offset = profiling.mark_offset(
            spans, trace.launches.values(), trace.t0 - host_t0 * 1e6)
        self.spans = {s["id"]: {**s, "ts": s["start"] / 1e3 + self.offset,
                                "dur": (s["end"] - s["start"]) / 1e3}
                      for s in spans if s["name"] != profiling.MARK}
        threads = defaultdict(list)
        for s in self.spans.values():
            threads[s["tid"]].append(s)
        self._threads = {tid: _segments(ss) for tid, ss in threads.items()}
        self.dispatching = sorted({s["tid"] for s in self.spans.values()
                                   if s["name"] in DISPATCHING})
        # per span id: device seconds and kernels of the events attributed
        # to it
        self.device_s, self.kernel_n = Counter(), Counter()
        for e in trace.device:
            sid = self.span_of(e)
            if sid is not None:
                self.device_s[sid] += e["dur"] / 1e6
                self.kernel_n[sid] += e.get("cat") == "kernel"
        self._chains: dict = {}

    def span_of(self, event):
        """The id of the innermost span open at the event's launch (module
        docstring), or None."""
        corr = (event.get("args") or {}).get("correlation")
        launch = self.trace.launches.get(corr)
        if launch is None:
            return None
        ts = launch["ts"]
        seg = self._threads.get(launch.get("tid"))
        if seg is not None:
            return _at(seg, ts)
        for tid in self.dispatching:
            sid = _at(self._threads[tid], ts)
            if sid is not None:
                return sid
        return None

    def chain(self, sid) -> tuple:
        """The names of span `sid` and of its ancestors."""
        got = self._chains.get(sid)
        if got is None:
            s = self.spans[sid]
            parent = s["parent"]
            got = (s["name"],) + (self.chain(parent)
                                  if parent in self.spans else ())
            self._chains[sid] = got
        return got

    def in_window(self, name: str) -> list:
        """The spans named `name` that started in the window."""
        t0, t1 = self.trace.t0, self.trace.t1
        return [s for s in self.spans.values()
                if s["name"] == name and t0 <= s["ts"] <= t1]

    def device_within(self, name: str) -> float:
        """Device seconds of the window's events launched inside a span
        named `name` (or inside its children)."""
        return sum(v for sid, v in self.device_s.items()
                   if name in self.chain(sid))

    def kernels_within(self, name: str) -> int:
        return sum(v for sid, v in self.kernel_n.items()
                   if name in self.chain(sid))

    def idle_within(self, name: str) -> float:
        """Seconds of the window's device idle gaps inside spans named
        `name`."""
        gaps = self.trace.gaps()
        starts = [g[0] for g in gaps]
        idle = 0.0
        for s in self.in_window(name):
            a, b = s["ts"], min(s["ts"] + s["dur"], self.trace.t1)
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            while i < len(gaps) and gaps[i][0] < b:
                g0, g1 = gaps[i][0], gaps[i][0] + gaps[i][1]
                idle += max(0.0, min(b, g1) - max(a, g0))
                i += 1
        return idle / 1e6


def per_count(ctx, value_of, count: str):
    """value_of(program) over the number of `count` spans in the window
    (None without spans, without any such span, or where value_of gives
    None)."""
    prog = of(ctx)
    if prog is None:
        return None
    n = len(prog.in_window(count))
    value = value_of(prog) if n else None
    return value / n if value is not None else None
