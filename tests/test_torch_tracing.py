"""The port's span recorder (ravqa_tpu_torch/utils/profiling.py), the spans
the program records where its work happens, and the benchmark's reading
of them (portbench/program.py and its readers in portbench/layer_metrics/).

- the recorder: off, span() is one shared no-op object, reads no clock and
  enters no record_function; on, spans carry their parent, thread id,
  attributes and self time, and stay on their threads; a running
  torch.profiler turns recording on; it holds at most MAX_SPANS;
- a micro-batcher's collect and dispatch spans on its own thread, a CPU
  RetrievalServer (exact and hierarchical) and a CPU train_step, with the
  span tree each dispatch and step gives;
- the harness on a synthetic Chrome trace: every reader it had gives the
  same value with and without program spans; device events attributed by
  thread, or by the dispatching thread's open span, placed by the clock
  marks; each new reader against numbers worked out by hand.
"""

import collections
import os
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from portbench import program, spec
from portbench.generator import Log
from portbench.run import Ctx
from portbench.trace import WINDOW, Trace
from ravqa_tpu_torch.serving import ServeConfig, _MicroBatchServer
from ravqa_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "synthetic_flmr.json")
HIER_OPTS = ["data_pipeline.raw.setup_kwargs.n_docs=512",
             "model_config.search_mode=hierarchical", "serve.preset=fast",
             "serve.block_size=8", "serve.n_summary=4",
             "serve.n_candidates=24"]


@pytest.fixture(autouse=True)
def _clean_recorder():
    profiling.take_spans()
    yield
    profiling.take_spans()


def _names(spans):
    return Counter(s["name"] for s in spans)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class _Raises:
    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read while recording is off")


def test_off_records_nothing_reads_no_clock_and_enters_no_range(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: entered.append(name))
    monkeypatch.setattr(profiling, "time", _Raises())
    assert not profiling.enabled()
    a = profiling.span("serve.dispatch", n=3)
    b = profiling.annotate("tower.query")
    assert a is b is profiling.NO_SPAN and not a
    with a as s:
        s.set(padded=4)
        with profiling.span("search.k1"):
            pass
    assert entered == [] and profiling.take_spans() == []


def test_on_records_parents_threads_attributes_and_self_time(monkeypatch):
    entered = []
    real = profiling.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    with profiling.recording():
        assert profiling.enabled()
        with profiling.span("train.step", step=1) as step:
            assert step and step.tid == threading.get_native_id()
            with profiling.span("train.forward"):
                with profiling.span("tower.query"):
                    pass
            with profiling.span("train.backward") as bw:
                bw.set(n=2)
    assert not profiling.enabled()
    # no profiler follows this thread: no range is entered
    assert entered == []
    spans = profiling.take_spans()
    assert profiling.take_spans() == []
    by = {s["name"]: s for s in spans}
    assert by["train.step"]["parent"] is None
    assert by["train.forward"]["parent"] == by["train.step"]["id"]
    assert by["tower.query"]["parent"] == by["train.forward"]["id"]
    assert by["train.backward"]["parent"] == by["train.step"]["id"]
    assert {s["tid"] for s in spans} == {threading.get_native_id()}
    assert by["train.step"]["attrs"] == {"step": 1}
    assert by["train.backward"]["attrs"] == {"n": 2}
    for s in spans:
        assert s["start"] <= s["end"]
    dur = {k: s["end"] - s["start"] for k, s in by.items()}
    assert by["train.step"]["self"] == dur["train.step"] - \
        dur["train.forward"] - dur["train.backward"]
    assert by["train.forward"]["self"] == dur["train.forward"] - \
        dur["tower.query"]
    assert by["tower.query"]["self"] == dur["tower.query"]


def test_a_clock_mark_needs_recording_and_a_card():
    profiling.clock_mark("cuda")          # off: not even the device read
    with profiling.recording():
        profiling.clock_mark("cpu")
        profiling.clock_mark(torch.device("cpu"))
    assert profiling.take_spans() == []


def test_recording_nests():
    assert not profiling.enabled()
    with profiling.recording():
        with profiling.recording():
            pass
        assert profiling.enabled()
    assert not profiling.enabled()


def test_the_recorder_keeps_the_latest_spans(monkeypatch):
    """A profiled run that never takes its spans stays bounded: the
    recorder holds the latest MAX_SPANS."""
    assert profiling._REC.spans.maxlen == profiling.MAX_SPANS
    monkeypatch.setattr(profiling._REC, "spans",
                        collections.deque(maxlen=3))
    with profiling.recording():
        for i in range(5):
            with profiling.span("serve.dispatch", dispatch=i):
                pass
    assert [s["attrs"]["dispatch"] for s in profiling.take_spans()] == \
        [2, 3, 4]
    assert profiling.take_spans() == []


def test_a_running_profiler_turns_recording_on_and_sees_its_thread():
    """The profiler's own thread gets each span as a range in its trace
    too; a thread that was running before it started (as a server's
    dispatcher is) records the span and enters no range."""
    from torch.profiler import ProfilerActivity, profile
    go, done = threading.Event(), threading.Event()

    def dispatcher():
        go.wait(timeout=30)
        with profiling.span("serve.dispatch"):
            pass
        done.set()

    t = threading.Thread(target=dispatcher, daemon=True)
    t.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        with profiling.span("serve.collect", n=0):
            pass
        go.set()
        assert done.wait(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive() and not profiling.enabled()
    assert _names(profiling.take_spans()) == {"serve.collect": 1,
                                              "serve.dispatch": 1}
    ranges = {e.name for e in prof.events()}
    assert "serve.collect" in ranges and "serve.dispatch" not in ranges


def test_spans_of_threads_stay_on_their_threads():
    """Each thread's spans nest on that thread only: a span open on one
    thread is no other thread's parent."""
    ids = {}
    gate = threading.Barrier(2)

    def work(name):
        ids[name] = threading.get_native_id()
        with profiling.span(name):
            gate.wait(timeout=10)
            with profiling.span(name + ".child"):
                gate.wait(timeout=10)

    with profiling.recording():
        ts = [threading.Thread(target=work, args=(n,)) for n in "ab"]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in ts)
    by = {s["name"]: s for s in profiling.take_spans()}
    for n in "ab":
        assert by[n]["tid"] == by[n + ".child"]["tid"] == ids[n]
        assert by[n + ".child"]["parent"] == by[n]["id"]


class _EchoServer(_MicroBatchServer):
    """A micro-batcher whose dispatch answers each request with its
    payload: the queue's spans without a model."""

    dispatches = 0

    def __init__(self, **kw):
        super().__init__(ServeConfig(**kw))

    def _dispatch(self, batch):
        self.dispatches += 1
        with profiling.span("serve.dispatch", dispatch=self.dispatches,
                            n=len(batch)):
            for x, fut in batch:
                fut.set_result(x)

    def submit(self, x):
        return self._enqueue((x,))


def test_collect_and_dispatch_spans_on_the_dispatcher():
    with profiling.recording():
        # made while recording, so every collect of the dispatcher records
        server = _EchoServer(max_batch=4, max_wait_ms=5.0)
        try:
            caller = threading.get_native_id()
            futs = [server.submit(i) for i in range(10)]
            assert [f.result(timeout=10) for f in futs] == list(range(10))
        finally:
            server.stop()
    spans = profiling.take_spans()
    dispatches = [s for s in spans if s["name"] == "serve.dispatch"]
    collects = [s for s in spans if s["name"] == "serve.collect"]
    assert {s["name"] for s in spans} == {"serve.dispatch", "serve.collect"}
    assert {s["tid"] for s in spans} == {dispatches[0]["tid"]} != {caller}
    assert sum(d["attrs"]["n"] for d in dispatches) == 10
    assert sum(s["attrs"]["n"] for s in collects) == 10
    assert all(s["parent"] is None for s in spans)


def test_a_server_records_nothing_while_off():
    server = _EchoServer(max_batch=2)
    try:
        assert server.submit(1).result(timeout=10) == 1
    finally:
        server.stop()
    assert profiling.take_spans() == []


# ---------------------------------------------------------------------------
# the program's spans: a CPU server and a CPU training step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["exact", "hierarchical"])
def cpu_server(request, tmp_path_factory):
    from ravqa_tpu_torch import main as torch_main
    from ravqa_tpu_torch.config import apply_overrides, load_config
    torch.set_num_threads(2)
    opts = HIER_OPTS if request.param == "hierarchical" else []
    cfg = apply_overrides(load_config(CONFIG), opts)
    data = torch_main.build_pipeline(cfg).get_data(
        cfg.data_pipeline_output_node, explode=True)
    server = torch_main.build_server(
        cfg, data, "cpu", str(tmp_path_factory.mktemp("serve_spans")))
    yield request.param, server, data["train"].items[:12]
    server.stop()


SEARCH_SPANS = {"exact": ["search.k1", "search.topk"],
                "hierarchical": ["search.stage0", "search.stage1",
                                 "search.fine", "search.topk"]}


def test_server_span_tree(cpu_server):
    mode, server, items = cpu_server
    assert server.searcher.mode == mode
    n_sizes = len(server.sizes)
    with profiling.recording():
        futs = [server.submit(it["question"], it["image_features"])
                for it in items]
        for f in futs:
            f.result(timeout=120)
    # the last dispatch's span closes after its results are set
    spans, deadline = [], time.monotonic() + 60
    while time.monotonic() < deadline:
        spans += profiling.take_spans()
        if sum(s["name"] == "serve.dispatch" for s in spans) \
                == len(server.sizes) - n_sizes:
            break
        time.sleep(0.01)
    by_id = {s["id"]: s for s in spans}

    def kids(s):
        return [c["name"] for c in sorted(spans, key=lambda c: c["start"])
                if c["parent"] == s["id"]]

    dispatches = [s for s in spans if s["name"] == "serve.dispatch"]
    assert [(d["attrs"]["n"], d["attrs"]["padded"]) for d in dispatches] \
        == server.sizes[n_sizes:]
    assert sum(d["attrs"]["n"] for d in dispatches) == len(items)
    for d in dispatches:
        names = kids(d)
        assert names[:3] == ["serve.stack", "tower.h2d", "tower.query"]
        assert names[-1] == "serve.results"
        assert names[3:-1][:len(SEARCH_SPANS[mode]) - 1] == \
            SEARCH_SPANS[mode][:-1]
        assert set(names[3:-1]) == set(SEARCH_SPANS[mode])
        tower = next(s for s in spans if s["parent"] == d["id"]
                     and s["name"] == "tower.query")
        assert kids(tower) == ["tower.text", "tower.mapping"]
    # the caller's thread records nothing; the dispatcher's spans nest on
    # it
    assert {s["tid"] for s in spans} == {dispatches[0]["tid"]}
    assert {s["name"] for s in spans if s["parent"] is None} <= {
        "serve.dispatch", "serve.collect"}
    assert all(s["parent"] is None or by_id[s["parent"]]["tid"] == s["tid"]
               for s in spans)


def _flmr_batch(rng, cfg, b, lq, ld):
    vocab = cfg.bert.vocab_size
    nway = cfg.nway
    return dict(
        query_input_ids=rng.integers(5, vocab, (b, lq)).astype(np.int64),
        query_attention_mask=np.ones((b, lq), np.int64),
        image_features=rng.normal(size=(b, cfg.vision_dim)).astype(
            np.float32),
        doc_input_ids=rng.integers(5, vocab, (b * nway, ld)).astype(
            np.int64),
        doc_attention_mask=np.ones((b * nway, ld), np.int64))


def test_train_step_span_tree():
    from ravqa_tpu_torch.executors import FLMRExecutor, TrainConfig
    from ravqa_tpu_torch.models import FLMRModelConfig, FLMRRetriever
    torch.manual_seed(0)
    cfg = FLMRModelConfig.tiny()
    ex = FLMRExecutor(FLMRRetriever(cfg), TrainConfig(lr=1e-3),
                      device="cpu", quiet=True, logger_backends=())
    batch = _flmr_batch(np.random.default_rng(0), cfg, 2, 8, 12)
    with profiling.recording():
        for _ in range(2):
            ex.train_step(batch)
    spans = profiling.take_spans()
    steps = [s for s in spans if s["name"] == "train.step"]
    assert [s["attrs"]["step"] for s in steps] == [1, 2]
    for st in steps:
        kids = sorted((s for s in spans if s["parent"] == st["id"]),
                      key=lambda s: s["start"])
        assert [k["name"] for k in kids] == ["train.forward",
                                             "train.backward",
                                             "train.optimizer"]
        fwd = kids[0]
        towers = sorted((s for s in spans if s["parent"] == fwd["id"]),
                        key=lambda s: s["start"])
        assert [t["name"] for t in towers] == ["tower.query", "tower.doc"]
        assert sum(k["end"] - k["start"] for k in kids) + st["self"] == \
            st["end"] - st["start"]


# ---------------------------------------------------------------------------
# the harness: a synthetic Chrome trace
# ---------------------------------------------------------------------------

H0 = 50.0                 # host seconds at the window's start
T0 = 1_000_000.0          # trace us at the window's start
WIN_US = 10_000.0         # a 10 ms window
DISPATCHER, CALLER, FOREIGN = 101, 202, 303
# an operator's own span on a thread of its own (utils.annotate)
CLIENT_SPAN = "client.work"


def _host(us):
    """Trace us -> host perf_counter seconds."""
    return H0 + (us - T0) / 1e6


def _ns(us):
    return int(round(_host(us) * 1e9))


def _span(sid, parent, name, tid, a_us, b_us, **attrs):
    return {"id": sid, "parent": parent, "name": name, "tid": tid,
            "start": _ns(a_us), "end": _ns(b_us), "self": 0,
            "attrs": attrs}


def _scene():
    """Two dispatches on the dispatcher thread, each with a tower and a
    search; a caller thread submitting; launches from the dispatcher and
    from a thread the profiler names by an id of its own.

    Dispatch d (d = 0, 1) spans [T0 + 4000 d + 100, T0 + 4000 d + 3900]:
    tower.query [+200, +1200] with tower.text [+300, +800]; search.fine
    [+1450, +3000]; serve.results [+3200, +3800]; the benchmark's ranges
    pb.dispatch [+100, +3950], pb.encode [+150, +1250], pb.search [+1400,
    +3050]; between the two dispatches a serve.collect [+3920, +4090].
    Kernels (launch -> run): a text kernel launched at +400 runs [+500,
    +900]; a mapping kernel launched by the foreign thread at +1000
    (inside tower.query, outside tower.text) runs [+1000, +1300]; a fine
    kernel launched at +1600 runs [+1700, +2700]; a copy launched at
    +3350 runs [+3350, +3450]. A span [+1550, +4200] on a caller's thread
    of its own overlaps the fine kernel's launch and the next dispatch,
    and takes no device event.
    Each dispatch's clock mark is at its start, its query on the trace at
    the same instant."""
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW,
               "ts": T0, "dur": WIN_US, "tid": 1}]
    pb, spans, corr, sid = [], [], 0, 0
    for d in range(2):
        base = T0 + 4000 * d
        pb += [("pb.dispatch", _host(base + 100), _host(base + 3950)),
               ("pb.encode.b4", _host(base + 150), _host(base + 1250)),
               ("pb.search.b4", _host(base + 1400), _host(base + 3050))]
        root = sid + 1
        spans += [
            _span(root, None, "serve.dispatch", DISPATCHER, base + 100,
                  base + 3900, dispatch=d + 1, n=4, padded=4),
            _span(root + 1, root, "tower.query", DISPATCHER, base + 200,
                  base + 1200),
            _span(root + 2, root + 1, "tower.text", DISPATCHER, base + 300,
                  base + 800),
            _span(root + 3, root, "search.fine", DISPATCHER, base + 1450,
                  base + 3000),
            _span(root + 4, root, "serve.results", DISPATCHER, base + 3200,
                  base + 3800),
            _span(root + 5, None, CLIENT_SPAN, CALLER, base + 1550,
                  base + 4200),
            _span(root + 6, None, "serve.collect", DISPATCHER, base + 3920,
                  base + 4090, n=4),
            _span(root + 7, root, "clock.mark", DISPATCHER, base + 100,
                  base + 100)]
        sid = root + 7
        corr += 1
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaStreamQuery", "ts": base + 100,
                       "dur": 2, "tid": FOREIGN,
                       "args": {"correlation": corr}})
        for tid, lts, kts, dur, cat, name in (
                (DISPATCHER, 400, 500, 400, "kernel", "text_gemm"),
                (FOREIGN, 1000, 1000, 300, "kernel", "mapping_gemm"),
                (DISPATCHER, 1600, 1700, 1000, "kernel",
                 "maxsim_mma_kernel"),
                (DISPATCHER, 3350, 3350, 100, "gpu_memcpy", "Memcpy DtoH")):
            corr += 1
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "ts": base + lts,
                           "dur": 5, "tid": tid,
                           "args": {"correlation": corr}})
            events.append({"ph": "X", "cat": cat, "name": name,
                           "ts": base + kts, "dur": dur, "tid": 7,
                           "args": {"correlation": corr}})
    pb.append((WINDOW, H0, H0 + WIN_US / 1e6))
    return events, pb, spans


def _ctx(events, pb, cell="flmr_exact_burst"):
    c = spec.Cell(cell)
    log = Log(t0=H0, t1=H0 + WIN_US / 1e6, setup_s=1.0,
              completed_in_window=8, lags_ms=[0.5, 1.0, 2.0])
    out = {"log": log, "sizes": [(4, 4), (4, 4)], "data_waits": [1e-3],
           "peak": 0, "checks": {}}
    return Ctx(c, out, Trace([dict(e, args=dict(e.get("args") or {}))
                              for e in events], pb))


PARENT_READERS = ("batch_fill.burst", "data_wait_ms.train", "gen_lag_ms",
                  "idle_pct.burst", "k1_roofline.burst", "mfu.burst",
                  "search_ms.burst", "tower_ms.burst")


def _parent_readings(ctx):
    t = ctx.trace
    return ({m: spec.reader("layer_metrics", m).read(ctx)
             for m in PARENT_READERS},
            t.busy_s(), t.gaps(), t.breakdown(top=100),
            [e["_range"] for e in t.device], t.by_range("pb."))


def test_readers_read_the_same_with_and_without_program_spans(monkeypatch):
    events, pb, spans = _scene()
    monkeypatch.setattr(program, "take", lambda: [])
    bare = _ctx(events, pb)
    assert program.of(bare) is None
    want = _parent_readings(bare)
    assert want[0]["tower_ms.burst"] == pytest.approx(0.7)
    assert want[0]["search_ms.burst"] == pytest.approx(1.0)
    monkeypatch.setattr(program, "take", lambda: [dict(s) for s in spans])
    ctx = _ctx(events, pb)
    assert program.of(ctx) is not None
    got = _parent_readings(ctx)
    assert got == want


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    events, pb, _ = _scene()
    monkeypatch.delattr(profiling, "take_spans")
    assert program.take() == []
    ctx = _ctx(events, pb)
    for m in ("dispatch_idle_ms.burst", "tower_launches.burst",
              "fine_ms.burst", "forward_ms.train"):
        assert spec.reader("layer_metrics", m).read(ctx) is None


def test_attribution_by_thread_or_the_dispatching_thread(monkeypatch):
    events, pb, spans = _scene()
    monkeypatch.setattr(program, "take", lambda: [dict(s) for s in spans])
    ctx = _ctx(events, pb)
    prog = program.of(ctx)
    placed = {}
    for e in ctx.trace.device:
        sid = prog.span_of(e)
        placed.setdefault(e["name"], set()).add(
            prog.spans[sid]["name"] if sid else None)
    # the mapping kernel, launched by a thread no span was recorded on,
    # goes to the dispatcher's open span
    assert placed == {"text_gemm": {"tower.text"},
                      "mapping_gemm": {"tower.query"},
                      "maxsim_mma_kernel": {"search.fine"},
                      "Memcpy DtoH": {"serve.results"}}
    # the caller's span, open at the fine kernel's launch, takes nothing
    assert prog.device_within(CLIENT_SPAN) == 0
    assert prog.device_within("tower.query") == pytest.approx(2 * 700e-6)
    assert prog.device_within("serve.dispatch") == pytest.approx(
        2 * 1800e-6)
    assert prog.kernels_within("tower.query") == 4


def test_fallback_follows_the_training_thread(monkeypatch):
    """Autograd launches the backward from a thread of its own: its
    kernels go to the training thread's open train.backward."""
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW,
               "ts": T0, "dur": WIN_US, "tid": 1}]
    spans = [_span(1, None, "train.step", DISPATCHER, T0 + 100, T0 + 9000,
                   step=1),
             _span(2, 1, "train.forward", DISPATCHER, T0 + 200, T0 + 2000),
             _span(3, 2, "tower.doc", DISPATCHER, T0 + 1000, T0 + 1900),
             _span(4, 1, "train.backward", DISPATCHER, T0 + 2100,
                   T0 + 6000),
             _span(5, 1, "train.optimizer", DISPATCHER, T0 + 6100,
                   T0 + 8900),
             _span(7, 1, "clock.mark", DISPATCHER, T0 + 100, T0 + 100)]
    events.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaStreamQuery", "ts": T0 + 100, "dur": 2,
                   "tid": DISPATCHER, "args": {"correlation": 99}})
    for corr, (tid, lts, dur) in enumerate(
            ((DISPATCHER, 300, 500), (DISPATCHER, 1100, 700),
             (FOREIGN, 2500, 2000), (FOREIGN, 5000, 400),
             (DISPATCHER, 6500, 1500), (DISPATCHER, 9150, 10)), 1):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": T0 + lts,
                       "dur": 5, "tid": tid, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                       "ts": T0 + lts + 10, "dur": dur, "tid": 7,
                       "args": {"correlation": corr}})
    pb = [("pb.step", _host(T0 + 100), _host(T0 + 9050)),
          (WINDOW, H0, H0 + WIN_US / 1e6)]
    monkeypatch.setattr(program, "take", lambda: [dict(s) for s in spans])
    ctx = _ctx(events, pb, "flmr_train")
    read = {m: spec.reader("layer_metrics", m).read(ctx)
            for m in ("forward_ms.train", "backward_ms.train",
                      "optimizer_ms.train", "doc_tower_ms.train")}
    assert read == pytest.approx({"forward_ms.train": 1.2,
                                  "backward_ms.train": 2.4,
                                  "optimizer_ms.train": 1.5,
                                  "doc_tower_ms.train": 0.7})
    prog = program.of(ctx)
    # a launch after the step, with no span open, goes to none
    assert prog.span_of(ctx.trace.device[-1]) is None
    assert [prog.span_of(e) for e in ctx.trace.device[2:4]] == [4, 4]


def test_serve_readers_on_a_synthetic_trace(monkeypatch):
    events, pb, spans = _scene()
    monkeypatch.setattr(program, "take", lambda: [dict(s) for s in spans])
    ctx = _ctx(events, pb)
    read = {m: spec.reader("layer_metrics", m).read(ctx)
            for m in ("dispatch_idle_ms.burst", "tower_launches.burst",
                      "fine_ms.burst")}
    # per dispatch: busy [500, 900], [1000, 1300], [1700, 2700], [3350,
    # 3450] inside [100, 3900]: 3800 - 1800 us idle
    assert read["dispatch_idle_ms.burst"] == pytest.approx(2.0)
    assert read["tower_launches.burst"] == 2
    assert read["fine_ms.burst"] == pytest.approx(1.0)
    prog = program.of(ctx)
    idle_s = ctx.trace.window_s - ctx.trace.busy_s()
    assert read["dispatch_idle_ms.burst"] * len(
        prog.in_window("serve.dispatch")) / 1e3 <= idle_s


@pytest.mark.parametrize("late_us", [0.0, 300.0, 1500.0])
def test_spans_are_placed_by_their_clock_marks(monkeypatch, late_us):
    """log.t0 is read after the window's range opens, as late as the
    thread waited for the interpreter lock, and the record_function
    stamps lie off the runtime events' clock: the marks place the spans
    all the same, by the least lag of a query behind its mark, and every
    reading is the one an exact anchor gives."""
    events, pb, spans = _scene()
    monkeypatch.setattr(program, "take", lambda: [dict(s) for s in spans])
    want = _ctx(events, pb)
    lagged = [dict(e, ts=e["ts"] + lag) if e["name"] == "cudaStreamQuery"
              else e for e, lag in zip(events, _lags(events, (3.0, 1.0)))]
    monkeypatch.setattr(program, "take", lambda: [dict(s) for s in spans])
    got = _ctx(lagged, pb)
    got.log.t0 += late_us / 1e6
    names = ("dispatch_idle_ms.burst", "tower_launches.burst",
             "fine_ms.burst")
    assert program.of(want).offset == pytest.approx(T0 - H0 * 1e6)
    assert program.of(got).offset == pytest.approx(T0 - H0 * 1e6 + 1.0)
    assert {m: spec.reader("layer_metrics", m).read(got) for m in names} \
        == {m: spec.reader("layer_metrics", m).read(want) for m in names}
    assert program.of(got).idle_within("serve.dispatch") == pytest.approx(
        program.of(want).idle_within("serve.dispatch"))
    assert all(s["name"] != "clock.mark"
               for s in program.of(got).spans.values())


def _lags(events, lags):
    """Each event's lag: the queries' in turn from `lags`, 0 for the
    rest."""
    it = iter(lags)
    return [next(it) if e["name"] == "cudaStreamQuery" else 0.0
            for e in events]


def test_a_stray_query_is_no_anchor_and_no_mark_falls_back(monkeypatch):
    """A query of another caller nearer to a mark placed by a late log.t0
    pairs with it far below the median and is left out; a run without
    marks is placed by log.t0."""
    events, pb, spans = _scene()
    stray = {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamQuery",
             "ts": T0 + 4000 + 100 - 500, "dur": 2, "tid": FOREIGN,
             "args": {"correlation": 999}}
    monkeypatch.setattr(program, "take", lambda: [dict(s) for s in spans])
    ctx = _ctx(events + [stray], pb)
    ctx.log.t0 += 300e-6
    prog = program.of(ctx)
    assert prog.offset == pytest.approx(T0 - H0 * 1e6)
    unmarked = [s for s in spans if s["name"] != "clock.mark"]
    monkeypatch.setattr(program, "take", lambda: [dict(s) for s in unmarked])
    ctx = _ctx(events, pb)
    ctx.log.t0 += 300e-6
    prog = program.of(ctx)
    assert prog.offset == pytest.approx(T0 - H0 * 1e6 - 300)
