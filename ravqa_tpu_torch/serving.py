"""Serving: dynamic micro-batching over encode -> search (RetrievalServer)
and over retrieve -> generate (VQAServer).

Port of ravqa_tpu/serving.py (ServeConfig, ServerOverloaded,
_MicroBatchServer, RetrievalServer, VQAServer, make_http_server).

- Batching window: the dispatcher thread collects up to `max_batch`
  requests or waits at most `max_wait_ms`.
- Load shedding: with `max_queue` set, a full queue rejects at admission
  (ServerOverloaded, HTTP 503).
- Host work off the hot path: tokenization happens on the caller's thread
  at submit(); the dispatcher stacks arrays and runs device code. The query
  embeddings stay on the device between encode and search; only the (B, k)
  results come back to the host.
- Batch buckets: each dispatch is padded to the smallest of
  ServeConfig.buckets() that holds it (powers of two up to max_batch by
  default, or `batch_buckets`), with copies of its first request, whose
  results are dropped; as the JAX server does. The shapes a dispatch can
  take are then few and fixed; warm_up runs each of them once.
- A sharded index (main.py --num_devices): rank 0 owns the server and the
  query tower; its searcher is a MeshSearchFront, which broadcasts each
  dispatch's (B, Lq, dim) query embeddings (and a RAG dispatch's doc
  gathers) to the other ranks, where serve_shard runs the same collective
  search over their shards until the front's shutdown() message.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 32        # most requests per dispatch
    max_wait_ms: float = 2.0   # batching window at low load
    k: int = 10                # top-k passages per query
    max_queue: int = 0         # bounded request queue; 0 = unbounded. When
    #   full, submit() raises ServerOverloaded immediately
    batch_buckets: Optional[tuple] = None
    #   the batch sizes a dispatch is padded to: the smallest bucket that
    #   holds it. None -> powers of two up to max_batch (1, 2, 4, ...,
    #   max_batch); (max_batch,) pads every dispatch to max_batch

    def buckets(self) -> tuple:
        if self.batch_buckets:
            bs = tuple(sorted(set(int(b) for b in self.batch_buckets)))
            assert bs[-1] >= self.max_batch, \
                "largest bucket must cover max_batch"
            return bs
        out, b = [], 1
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return tuple(out)


class ServerOverloaded(RuntimeError):
    """Raised by submit() when the bounded request queue is full."""


@dataclasses.dataclass
class RetrievalResult:
    pids: np.ndarray           # (k,) passage ids
    scores: np.ndarray         # (k,) MaxSim scores
    contents: Optional[list] = None


@dataclasses.dataclass
class VQAResult:
    answer: str
    doc_scores: np.ndarray     # (n_docs,) retrieval scores
    passages: Optional[list] = None   # retrieved contents


class _MicroBatchServer:
    """Bounded-window micro-batching dispatcher; subclasses implement
    `_dispatch(batch)` where batch is a list of (payload..., future).
    `sizes` records each dispatch's (requests, padded size)."""

    def __init__(self, config: Optional[ServeConfig] = None):
        self.cfg = config if config is not None else ServeConfig()
        self._q: queue.Queue = queue.Queue(maxsize=self.cfg.max_queue)
        self._buckets = self.cfg.buckets()
        self.sizes: list[tuple[int, int]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _enqueue(self, item) -> Future:
        fut: Future = Future()
        try:
            self._q.put_nowait(item + (fut,))
        except queue.Full:
            raise ServerOverloaded(
                f"request queue full ({self.cfg.max_queue})")
        return fut

    def _bucket(self, n: int) -> int:
        """The smallest bucket that holds n requests."""
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _padded(self, batch: list) -> list:
        """The batch padded to its bucket with copies of its first row
        (their results are dropped); records (n, padded size)."""
        n = len(batch)
        size = self._bucket(n)
        self.sizes.append((n, size))
        return batch + [batch[0]] * (size - n)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        # fail queued-but-uncollected requests instead of leaving their
        # futures pending
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            fut = item[-1]
            if not fut.done():
                fut.set_exception(RuntimeError("server stopped"))

    def _collect(self):
        """Block for the first request, then fill up to max_batch within
        the max_wait_ms window."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.cfg.max_wait_ms / 1e3
        while len(batch) < self.cfg.max_batch:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                batch.append(self._q.get(timeout=left))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                self._dispatch(batch)
            except BaseException as e:          # deliver, don't kill loop
                for *_, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def _dispatch(self, batch):                 # pragma: no cover
        raise NotImplementedError


class RetrievalServer(_MicroBatchServer):
    """Micro-batching server over (query tokenizer, FLMR executor,
    LateInteractionSearcher).

    serve = RetrievalServer(executor, searcher, query_tokenizer,
                            image_feature_dim=768)
    result = serve.submit("what is this?", image_features=feat).result()

    An in-graph-vision retriever (PreFLMR) takes raw pixels per request
    instead: RetrievalServer(..., image_feature_dim=0,
    pixel_shape=(224, 224, 3)) and submit(text, pixel_values=img).
    """

    def __init__(self, executor, searcher, query_tokenizer,
                 image_feature_dim: int = 0,
                 id2content: Optional[dict] = None,
                 pixel_shape: Optional[tuple] = None,
                 config: Optional[ServeConfig] = None):
        """id2content: optional {pid: text} map; results carry contents
        when given. pixel_shape: (H, W, 3) of the in-graph ViT's images.
        `dispatches` counts the batches run."""
        self.ex = executor
        self.searcher = searcher
        self.qt = query_tokenizer
        self.image_feature_dim = image_feature_dim
        self.pixel_shape = None if pixel_shape is None else tuple(pixel_shape)
        self.id2content = id2content
        self.dispatches = 0
        super().__init__(config)

    # -- client side --------------------------------------------------------
    def submit(self, text: str,
               image_features: Optional[np.ndarray] = None,
               pixel_values: Optional[np.ndarray] = None) -> Future:
        """Tokenize on the caller's thread, enqueue, return a Future.
        Missing image features or pixels are zeros of the server's shape.
        Raises ValueError here, before the request joins a batch, for an
        image the server does not take or one of another shape."""
        feats_shape = ((self.image_feature_dim,) if self.image_feature_dim
                       else None)
        image_features = _checked(image_features, feats_shape,
                                  "image_features")
        pixel_values = _checked(pixel_values, self.pixel_shape,
                                "pixel_values")
        ids, mask = self.qt.tensorize([text])
        return self._enqueue((np.asarray(ids)[0], np.asarray(mask)[0],
                              image_features, pixel_values))

    def search_batch(self, texts: Sequence[str],
                     image_features: Optional[np.ndarray] = None
                     ) -> list[RetrievalResult]:
        """Blocking convenience wrapper."""
        feats = ([None] * len(texts) if image_features is None
                 else list(image_features))
        futs = [self.submit(t, f) for t, f in zip(texts, feats)]
        return [f.result() for f in futs]

    def _stack(self, batch, slot: int) -> Optional[np.ndarray]:
        """The batch's image features (slot 2) or pixels (slot 3), None
        when the server takes none."""
        if batch[0][slot] is None:
            return None
        return np.stack([b[slot] for b in batch])

    def encode(self, batch) -> torch.Tensor:
        """The query embeddings of (ids, mask, features, pixels, ...)
        rows, on the executor's device."""
        pixels = self._stack(batch, 3)
        extra = {} if pixels is None else {"pixel_values": pixels}
        return self.ex.encode_query(np.stack([b[0] for b in batch]),
                                    np.stack([b[1] for b in batch]),
                                    self._stack(batch, 2), **extra)

    @torch.inference_mode()
    def warm_up(self) -> None:
        """Run a blank query through encode and search at each bucket
        size, so the first requests do not pay for the kernel build and
        library set-up."""
        ids, mask = self.qt.tensorize([""])
        feats = (np.zeros((self.image_feature_dim,), np.float32)
                 if self.image_feature_dim else None)
        pixels = (np.zeros(self.pixel_shape, np.float32)
                  if self.pixel_shape is not None else None)
        row = (np.asarray(ids)[0], np.asarray(mask)[0], feats, pixels)
        for size in self._buckets:
            q = self.encode([row] * size)
            self.searcher.search_device(q, self.cfg.k)[0].cpu()

    # -- dispatcher ---------------------------------------------------------
    @torch.inference_mode()
    def _dispatch(self, batch):
        self.dispatches += 1
        q = self.encode(self._padded(batch))
        scores, rows = self.searcher.search_device(q, self.cfg.k)
        scores = scores.cpu().numpy()
        pids = self.searcher.index.pids[rows.cpu().numpy()]
        for i, (*_, fut) in enumerate(batch):
            fut.set_result(RetrievalResult(
                pids=pids[i], scores=scores[i],
                contents=([self.id2content.get(p, "")
                           for p in pids[i].tolist()]
                          if self.id2content is not None else None)))


class VQAServer(_MicroBatchServer):
    """End-to-end VQA serving through a RagExecutor: live (or static)
    retrieval, greedy or beam decoding per (question, passage), the answer
    picked by the joint doc and generation score (the deployment form of
    the reference's RagModelForBlip.generate, rag_model_blip.py:735-824).

    serve = VQAServer(rag_executor, query_tokenizer, image_feature_dim=768,
                      pixel_shape=(224, 224, 3))
    ans = serve.submit("what animal is this?", image_features=f,
                       pixel_values=img).result()
    ans.answer, ans.passages, ans.doc_scores
    """

    def __init__(self, rag_executor, query_tokenizer,
                 image_feature_dim: int = 0,
                 pixel_shape: Optional[tuple] = None,
                 config: Optional[ServeConfig] = None):
        """image_feature_dim: the retriever's image features per request;
        pixel_shape: (H, W, 3) when the generator is BLIP-2 (raw pixels ride
        with each request), None for a text-only generator. `dispatches`
        counts the batches run."""
        self.ex = rag_executor
        self.qt = query_tokenizer
        self.image_feature_dim = image_feature_dim
        self.pixel_shape = None if pixel_shape is None else tuple(pixel_shape)
        self.dispatches = 0
        super().__init__(config if config is not None
                         else ServeConfig(max_batch=8))

    def submit(self, question: str,
               image_features: Optional[np.ndarray] = None,
               pixel_values: Optional[np.ndarray] = None,
               question_id=None) -> Future:
        """Tokenize on the caller's thread, enqueue, return a Future.
        Missing image features or pixels are zeros of the server's shape;
        an image of another shape, or one the server does not take, raises
        ValueError here. question_id keys a static-retrieval executor's
        map (an unknown or None id gets dummy passages)."""
        feats_shape = ((self.image_feature_dim,) if self.image_feature_dim
                       else None)
        image_features = _checked(image_features, feats_shape,
                                  "image_features")
        pixel_values = _checked(pixel_values, self.pixel_shape,
                                "pixel_values")
        ids, mask = self.qt.tensorize([question])
        return self._enqueue((question, np.asarray(ids)[0],
                              np.asarray(mask)[0], image_features,
                              pixel_values, question_id))

    def answer_batch(self, questions: Sequence[str],
                     image_features: Optional[np.ndarray] = None
                     ) -> list[VQAResult]:
        """Blocking convenience wrapper."""
        feats = ([None] * len(questions) if image_features is None
                 else list(image_features))
        futs = [self.submit(t, f) for t, f in zip(questions, feats)]
        return [f.result() for f in futs]

    @staticmethod
    def gen_batch(rows) -> dict:
        """The executor's generate() batch of (question, ids, mask,
        features, pixels, question_id, ...) rows."""
        out = {"questions": [r[0] for r in rows],
               "question_ids": [r[5] for r in rows],
               "query_input_ids": np.stack([r[1] for r in rows]),
               "query_attention_mask": np.stack([r[2] for r in rows])}
        for key, slot in (("image_features", 3), ("pixel_values", 4)):
            if rows[0][slot] is not None:
                out[key] = np.stack([r[slot] for r in rows])
        return out

    def warm_up(self) -> None:
        """Answer a blank question at each bucket size, so that the first
        requests do not pay for the kernel build and library set-up."""
        ids, mask = self.qt.tensorize([""])
        feats = (np.zeros((self.image_feature_dim,), np.float32)
                 if self.image_feature_dim else None)
        pixels = (np.zeros(self.pixel_shape, np.float32)
                  if self.pixel_shape is not None else None)
        row = ("", np.asarray(ids)[0], np.asarray(mask)[0], feats, pixels,
               None)
        for size in self._buckets:
            self.ex.generate(self.gen_batch([row] * size))

    def _dispatch(self, batch):
        self.dispatches += 1
        # whole request rows pad the batch: question, ids, image and the
        # static-retrieval key alike
        out = self.ex.generate(self.gen_batch(self._padded(batch)))
        for i, (*_, fut) in enumerate(batch):
            fut.set_result(VQAResult(
                answer=out["predictions"][i],
                doc_scores=np.asarray(out["doc_scores"])[i],
                passages=out["retrieved_contents"][i]))


class _IndexFront:
    """Rank 0's view of a sharded index for the server: attributes of the
    rank's shard, and the (collective) doc gathers broadcast to the
    worker ranks first."""

    def __init__(self, front: "MeshSearchFront"):
        self._front = front

    def __getattr__(self, name):
        return getattr(self._front.searcher.index, name)

    def gather_tokens(self, rows: torch.Tensor) -> torch.Tensor:
        return self._front._call("gather_tokens", rows)

    def gather_mask(self, rows: torch.Tensor) -> torch.Tensor:
        return self._front._call("gather_mask", rows)


class MeshSearchFront:
    """The searcher of rank 0's server over a sharded index: each call is
    broadcast (a pickled message: the operation and its CPU tensors) to
    the ranks running serve_shard, then run here, so every rank joins the
    same collective. search_device returns the merged top-k, as the
    sharded searcher does on every rank."""

    def __init__(self, searcher):
        self.searcher = searcher
        self.index = _IndexFront(self)
        self.mesh = searcher.mesh

    def _call(self, op: str, *tensors, **kw):
        from .parallel.mesh import broadcast_object
        broadcast_object((op, tuple(t.cpu() for t in tensors), kw), 0)
        return _run(self.searcher, op, tensors, kw)

    def search_device(self, q: torch.Tensor, k: int):
        return self._call("search_device", q, k=k)

    def shutdown(self) -> None:
        """End the worker ranks' serve_shard loops."""
        from .parallel.mesh import broadcast_object
        broadcast_object(("stop", (), {}), 0)


def _run(searcher, op: str, tensors, kw):
    if op == "search_device":
        return searcher.search_device(*tensors, **kw)
    return getattr(searcher.index, op)(*tensors, **kw)


def serve_shard(searcher) -> int:
    """A worker rank's loop: run each message rank 0's MeshSearchFront
    broadcasts on this rank's shard, until its shutdown. Returns the
    number of messages run."""
    from .parallel.mesh import broadcast_object
    dev = searcher.index.device
    n = 0
    while True:
        op, tensors, kw = broadcast_object(None, 0)
        if op == "stop":
            return n
        with torch.inference_mode():
            _run(searcher, op, tuple(t.to(dev) for t in tensors), kw)
        n += 1


def _checked(value, shape: Optional[tuple],
             name: str) -> Optional[np.ndarray]:
    """A request's image input as float32 of the server's `shape` (zeros
    when missing); None where the server takes none (`shape` None)."""
    if shape is None:
        if value is not None:
            raise ValueError(f"this server takes no {name}")
        return None
    if value is None:
        return np.zeros(shape, np.float32)
    value = np.asarray(value, np.float32)
    if value.shape != shape:
        raise ValueError(f"{name} of shape {value.shape}; this server takes "
                         f"{shape}")
    return value


# ---------------------------------------------------------------------------
# HTTP front end (stdlib only): GET /healthz; POST /search {"query": str,
# "image_features": [float]?, "pixel_values": [[[float]]]? (H x W x 3),
# "timeout_s": float?} to a RetrievalServer; POST /answer {"question": str,
# "image_features"?, "pixel_values"?, "question_id"?, "timeout_s"?} to a
# VQAServer.
# ---------------------------------------------------------------------------

def make_http_server(server, host: str = "0.0.0.0", port: int = 8080):
    """Wrap a RetrievalServer or a VQAServer in a ThreadingHTTPServer. Call
    .serve_forever() (blocking) or run it on a thread and .shutdown()."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    is_vqa = isinstance(server, VQAServer)
    route = "/answer" if is_vqa else "/search"

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):                    # quiet access log
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True,
                                 "mode": "vqa" if is_vqa else "retrieval"})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                return self._json(400, {"error": "bad json"})
            if self.path != route:
                return self._json(404, {"error": "not found"})
            try:
                if is_vqa:
                    fut = server.submit(req["question"],
                                        req.get("image_features"),
                                        req.get("pixel_values"),
                                        question_id=req.get("question_id"))
                else:
                    fut = server.submit(req["query"],
                                        req.get("image_features"),
                                        req.get("pixel_values"))
            except KeyError as e:
                return self._json(400, {"error": f"missing field {e}"})
            except (TypeError, ValueError) as e:       # malformed image
                return self._json(400, {"error": str(e)})
            except ServerOverloaded as e:              # shed -> retry later
                return self._json(503, {"error": str(e)})
            except Exception as e:                     # surface, don't die
                return self._json(500, {"error": str(e)})
            try:
                res = fut.result(timeout=req.get("timeout_s",
                                                 120 if is_vqa else 60))
                if is_vqa:
                    return self._json(200, {
                        "answer": res.answer,
                        "doc_scores": np.asarray(res.doc_scores,
                                                 np.float64).tolist(),
                        "passages": res.passages})
                return self._json(200, {
                    "pids": np.asarray(res.pids).tolist(),
                    "scores": np.asarray(res.scores, np.float64).tolist(),
                    "contents": res.contents})
            except Exception as e:                     # surface, don't die
                return self._json(500, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)
