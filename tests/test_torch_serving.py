"""The port's serving slice as a whole, against the JAX package's.

Both packages' `build_server` run on configs/synthetic_flmr.json (tiny
width). The JAX executor's parameters are saved as a flattened-key .npz
and loaded by the port's build_server through `train.load_model_path`;
the same questions and image features then go to both servers.

Tolerance on scores: rtol 1e-4, atol 1e-4 * Lq. The towers agree to
rtol 1e-4 (tests/test_torch_models.py), and each score sums Lq maxima of
dot products in an order that differs between the engines. Pids are
compared tie-aware: a pid whose score clears the k-th score by more than
the tolerance must be in the other engine's top-k.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from ravqa_tpu.config import apply_overrides as jax_apply_overrides
from ravqa_tpu.config import load_config as jax_load_config
from ravqa_tpu_torch.config import apply_overrides, load_config
from ravqa_tpu_torch.models import flatten_params
from ravqa_tpu_torch.serving import (RetrievalServer, ServeConfig,
                                     ServerOverloaded, make_http_server)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "synthetic_flmr.json")
# the same tiny model over 512 passages, served by hierarchical search
# under the fast preset: 64 blocks of 8, of which stage 0 keeps 32; stage 1
# keeps 24 of their 256 docs (the int8 stage1_rows path)
PREFLMR_CONFIG = os.path.join(REPO, "configs",
                              "synthetic_preflmr_vitl_serve.json")
# the PreFLMR ViT-L serve config cut to tiny widths over 64 passages
PREFLMR_TINY_OPTS = [
    "data_pipeline.raw.setup_kwargs.n_docs=64",
    "data_pipeline.raw.setup_kwargs.emit_pixels=32",
    "data_pipeline.loaders.setup_kwargs.query_maxlen=16",
    "data_pipeline.loaders.setup_kwargs.doc_maxlen=16",
    "model_config.bert={'vocab_size': 512, 'hidden_size': 64, "
    "'num_layers': 2, 'num_heads': 4, 'intermediate_size': 128, "
    "'max_position_embeddings': 64}",
    "model_config.dim=32", "model_config.vit={'tiny': True}",
    "model_config.vision_embedding_size=64",
    "model_config.vision_patch_dim=64",
    "model_config.mapping_network_prefix_length=4",
    "model_config.transformer_mapping_hidden=32",
    "model_config.transformer_mapping_num_heads=4"]
RAG_CONFIG = os.path.join(REPO, "configs", "synthetic_rag_blip2_serve.json")
# the RAVQA-v2 serve config cut to tiny widths over 64 passages with 32 x 32
# images (tests/test_torch_rag.py serves the same cut)
RAG_TINY_OPTS = [
    "data_pipeline.raw.setup_kwargs.n_docs=64",
    "data_pipeline.raw.setup_kwargs.vision_dim=16",
    "data_pipeline.raw.setup_kwargs.emit_pixels=32",
    "data_pipeline.loaders.setup_kwargs.query_maxlen=16",
    "data_pipeline.loaders.setup_kwargs.doc_maxlen=16",
    "model_config.bert={'vocab_size': 512, 'hidden_size': 64, "
    "'num_layers': 2, 'num_heads': 4, 'intermediate_size': 128, "
    "'max_position_embeddings': 64}",
    "model_config.dim=32", "model_config.vision_embedding_size=16",
    "model_config.mapping_network_prefix_length=4",
    "model_config.generator={'type': 'blip2', 'num_query_tokens': 4, "
    "'vision': {'image_size': 32, 'patch_size': 8, 'hidden_size': 32, "
    "'num_layers': 2, 'num_heads': 4, 'intermediate_size': 64}, "
    "'qformer': {'hidden_size': 32, 'num_layers': 2, 'num_heads': 4, "
    "'intermediate_size': 64, 'encoder_hidden_size': 32}, "
    "'t5': {'vocab_size': 512, 'd_model': 64, 'd_kv': 16, 'd_ff': 128, "
    "'num_layers': 2, 'num_heads': 4, 'feed_forward_proj': 'gated-gelu', "
    "'tie_word_embeddings': False}}",
    "model_config.rag.gen_maxlen=24"]
# training also reads each question's image features (the retriever's)
RAG_TRAIN_OPTS = ["data_pipeline.raw.setup_kwargs.features_with_pixels=True"]
WIT_CONFIG = os.path.join(REPO, "configs", "synthetic_flmr_wit_pretrain.json")
# a tiny cut of the WIT pretraining config, over an 8-d synthetic dump
WIT_TINY_OPTS = [
    "model_config.vision_embedding_size=8",
    "model_config.bert={'num_layers': 1, 'hidden_size': 32, 'num_heads': 2, "
    "'intermediate_size': 64}",
    "model_config.dim=16", "model_config.mapping_network_prefix_length=4",
    "data_pipeline.loaders.setup_kwargs.doc_maxlen=24",
    "data_pipeline.loaders.setup_kwargs.query_maxlen=8",
    "train.total_steps=2", "train.val_every=2", "train.batch_size=4"]
HIER_OPTS = ["data_pipeline.raw.setup_kwargs.n_docs=512",
             "model_config.search_mode=hierarchical", "serve.preset=fast",
             "serve.block_size=8", "serve.n_summary=4",
             "serve.n_candidates=24"]

ROI_CONFIG = os.path.join(REPO, "configs", "okvqa", "flmr_with_roi.json")
# a tiny cut of flmr_with_roi.json over a synthetic OK-VQA world
ROI_TINY_OPTS = [
    "data_pipeline.loaders.setup_kwargs.doc_maxlen=16",
    "data_pipeline.loaders.setup_kwargs.nway=2",
    "model_config.bert={'vocab_size': 30522, 'hidden_size': 64, "
    "'num_layers': 1, 'num_heads': 4, 'intermediate_size': 128, "
    "'max_position_embeddings': 64}",
    "model_config.mapping_network_prefix_length=2",
    "model_config.num_negative_samples=1", "train.batch_size=4",
    "train.total_steps=2", "train.val_every=2", "metrics.Ks=[1, 5]"]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from ravqa_tpu import main as jax_main
    from ravqa_tpu_torch import main as torch_main
    tmp = tmp_path_factory.mktemp("serve")
    cfg = jax_load_config(CONFIG)
    jdata = jax_main.build_pipeline(cfg, cache_dir=None).get_data(
        cfg.data_pipeline_output_node, explode=True)
    jserver = jax_main.build_server(cfg, jdata, None, str(tmp / "jax"))
    params = tmp / "params.npz"
    np.savez(params, **flatten_params(
        jax.device_get(jserver.ex.state.params)))
    tcfg = apply_overrides(load_config(CONFIG),
                           [f"train.load_model_path={params}"])
    tdata = torch_main.build_pipeline(tcfg).get_data(
        tcfg.data_pipeline_output_node, explode=True)
    tserver = torch_main.build_server(tcfg, tdata, "cpu", str(tmp / "torch"))
    items = jdata["train"].items[:8]
    yield jserver, tserver, items
    jserver.stop()
    tserver.stop()


@pytest.fixture(scope="module")
def hier_servers(tmp_path_factory):
    """Both packages' build_server on the hierarchical config, the port
    loading the JAX executor's parameters."""
    from ravqa_tpu import main as jax_main
    from ravqa_tpu_torch import main as torch_main
    tmp = tmp_path_factory.mktemp("serve_hier")
    cfg = jax_apply_overrides(jax_load_config(CONFIG), HIER_OPTS)
    jdata = jax_main.build_pipeline(cfg, cache_dir=None).get_data(
        cfg.data_pipeline_output_node, explode=True)
    jserver = jax_main.build_server(cfg, jdata, None, str(tmp / "jax"))
    params = tmp / "params.npz"
    np.savez(params, **flatten_params(
        jax.device_get(jserver.ex.state.params)))
    tcfg = apply_overrides(load_config(CONFIG), HIER_OPTS + [
        f"train.load_model_path={params}"])
    tdata = torch_main.build_pipeline(tcfg).get_data(
        tcfg.data_pipeline_output_node, explode=True)
    tserver = torch_main.build_server(tcfg, tdata, "cpu", str(tmp / "torch"))
    yield jserver, tserver, jdata["train"].items[:12]
    jserver.stop()
    tserver.stop()


def test_hierarchical_served_answers_match_jax(hier_servers):
    jserver, tserver, items = hier_servers
    js, ts = jserver.searcher, tserver.searcher
    assert ts.mode == js.mode == "hierarchical"
    assert ts.index.block_summaries.shape == (64, 4, 32)
    assert ts.resolve_blocks(10) == js.resolve_blocks(10) == 32
    assert ts._summ_rows is not None and js._summ_rows is not None
    assert ts._summ_rows.dtype == torch.int8
    lq = tserver.qt.query_maxlen + tserver.ex.model.cfg.prefix_len
    tol = dict(rtol=1e-4, atol=1e-4 * lq)
    jfuts = [jserver.submit(it["question"], it["image_features"])
             for it in items]
    tfuts = [tserver.submit(it["question"], it["image_features"])
             for it in items]
    for jf, tf in zip(jfuts, tfuts):
        j, t = jf.result(timeout=120), tf.result(timeout=120)
        assert t.pids.shape == t.scores.shape == (10,)
        _tie_aware(t.pids, t.scores, j.pids, j.scores, tol)


def _tie_aware(got_p, got_s, want_p, want_s, tol):
    np.testing.assert_allclose(got_s, want_s, **tol)
    margin = tol["atol"] + tol["rtol"] * abs(want_s[-1])
    assert set(want_p[want_s > want_s[-1] + margin]) <= set(got_p)
    assert set(got_p[got_s > got_s[-1] + margin]) <= set(want_p)


def test_served_answers_match_jax(servers):
    jserver, tserver, items = servers
    jfuts = [jserver.submit(it["question"], it["image_features"])
             for it in items]
    tfuts = [tserver.submit(it["question"], it["image_features"])
             for it in items]
    lq = tserver.qt.query_maxlen + tserver.ex.model.cfg.prefix_len
    tol = dict(rtol=1e-4, atol=1e-4 * lq)
    for jf, tf in zip(jfuts, tfuts):
        j, t = jf.result(timeout=120), tf.result(timeout=120)
        assert t.pids.shape == t.scores.shape == (10,)
        assert t.scores.dtype == np.float32 and np.isfinite(t.scores).all()
        _tie_aware(t.pids, t.scores, j.pids, j.scores, tol)
        assert t.contents == [tserver.id2content[p] for p in t.pids]


def test_search_batch_matches_submit(servers):
    _, tserver, items = servers
    texts = [it["question"] for it in items[:3]]
    feats = np.stack([it["image_features"] for it in items[:3]])
    got = tserver.search_batch(texts, feats)
    for t, f, r in zip(texts, feats, got):
        want = tserver.submit(t, f).result(timeout=60)
        np.testing.assert_array_equal(r.pids, want.pids)


def test_build_server_loads_the_checkpoint(servers):
    jserver, tserver, _ = servers
    assert tserver.ex.inference_only
    sd = tserver.ex.model.state_dict()
    want = np.asarray(jserver.ex.state.params["linear"]["kernel"]).T
    np.testing.assert_array_equal(sd["linear.weight"].numpy(), want)


def test_http_front_end(servers):
    _, tserver, items = servers
    httpd = make_http_server(tserver, "127.0.0.1", 0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()

    def post(obj):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/search", data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as r:
            assert json.loads(r.read())["ok"]
        out = post({"query": items[0]["question"],
                    "image_features": items[0]["image_features"].tolist()})
        direct = tserver.submit(items[0]["question"],
                                items[0]["image_features"]).result(60)
        assert out["pids"] == direct.pids.tolist()
        with pytest.raises(urllib.error.HTTPError) as e:
            post({})
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()


class _SlowExecutor:
    """Stub executor whose encode blocks until released."""

    def __init__(self):
        self.release = threading.Event()

    def encode_query(self, ids, mask, feats):
        self.release.wait(30)
        return torch.zeros((len(ids), 2, 4))


class _StubSearcher:
    class index:
        pids = np.arange(4)

    def search_device(self, q, k):
        b = q.shape[0]
        return torch.zeros((b, k)), torch.zeros((b, k), dtype=torch.long)


class _Tok:
    query_maxlen = 2

    def tensorize(self, texts):
        return np.ones((1, 2), np.int32), np.ones((1, 2), np.int32)


def test_bounded_queue_sheds_and_stop_fails_pending():
    ex = _SlowExecutor()
    server = RetrievalServer(ex, _StubSearcher(), _Tok(), image_feature_dim=3,
                             config=ServeConfig(max_batch=1, max_queue=2,
                                                max_wait_ms=0.0, k=2))
    try:
        first = server.submit("a")
        t_end = time.monotonic() + 30
        while server._q.qsize() and time.monotonic() < t_end:
            time.sleep(0.01)                      # dispatcher takes `first`
        queued = [server.submit("b"), server.submit("c")]
        with pytest.raises(ServerOverloaded):
            server.submit("d")
    finally:
        ex.release.set()
        server.stop()
    assert first.result(timeout=30).pids.shape == (2,)
    for f in queued:                              # served or failed, never
        assert f.done()                           # left pending


BUCKET_CASES = [dict(max_batch=1), dict(max_batch=5), dict(max_batch=8),
                dict(max_batch=32), dict(max_batch=33),
                dict(max_batch=8, batch_buckets=(8,)),
                dict(max_batch=8, batch_buckets=(3, 8, 3, 16)),
                dict(max_batch=32, batch_buckets=[1, 4, 16, 32])]


@pytest.mark.parametrize("case", range(len(BUCKET_CASES)))
def test_buckets_match_jax(case):
    """ServeConfig.buckets() and the bucket each batch size pads to, as
    the JAX server's; a largest bucket below max_batch is refused by
    both."""
    from ravqa_tpu import serving as jax_serving
    kw = BUCKET_CASES[case]
    got = ServeConfig(**kw).buckets()
    assert got == jax_serving.ServeConfig(**kw).buckets()
    ex = _SlowExecutor()
    ex.release.set()
    server = RetrievalServer(ex, _StubSearcher(), _Tok(),
                             config=ServeConfig(**kw))
    try:
        for n in range(1, kw["max_batch"] + 1):
            want = min(b for b in got if b >= n)
            assert server._bucket(n) == want
            assert len(server._padded(list(range(n)))) == want
    finally:
        server.stop()
    for mod in (jax_serving, sys.modules[ServeConfig.__module__]):
        with pytest.raises(AssertionError):
            mod.ServeConfig(max_batch=9, batch_buckets=(4, 8)).buckets()


def test_padded_dispatch_matches_unpadded_search(servers):
    """A dispatch of 3 runs at bucket 4 with a copy of its first request;
    the 3 answers are the unpadded search's (tie-aware, the file's
    tolerance), and the server records (3, 4). Live requests are
    dispatched at bucket sizes only."""
    _, tserver, items = servers
    qt = tserver.qt
    rows = []
    for it in items[:3]:
        ids, mask = qt.tensorize([it["question"]])
        rows.append((ids[0], mask[0], np.asarray(it["image_features"],
                                                 np.float32), None))
    n0 = len(tserver.sizes)
    padded = tserver._padded(rows)
    assert tserver.sizes[n0:] == [(3, 4)] and len(padded) == 4
    assert padded[3] is rows[0]
    with torch.inference_mode():
        ps, pr = tserver.searcher.search_device(tserver.encode(padded), 10)
        us, ur = tserver.searcher.search_device(tserver.encode(rows), 10)
    assert ps.shape == (4, 10)
    lq = qt.query_maxlen + tserver.ex.model.cfg.prefix_len
    tol = dict(rtol=1e-4, atol=1e-4 * lq)
    pids = tserver.searcher.index.pids
    for i in range(3):
        _tie_aware(pids[pr[i].numpy()], ps[i].numpy(),
                   pids[ur[i].numpy()], us[i].numpy(), tol)
    texts = [it["question"] for it in items[:5]]
    got = tserver.search_batch(texts, np.stack(
        [it["image_features"] for it in items[:5]]))
    assert len(got) == 5
    buckets = tserver.cfg.buckets()
    assert all(size in buckets and n <= size
               for n, size in tserver.sizes)


class _StubRag:
    """A RagExecutor stand-in: generate answers each row with its question
    and keeps the batches it was given."""

    def __init__(self):
        self.batches = []

    def generate(self, batch):
        self.batches.append(batch)
        n = len(batch["questions"])
        return {"predictions": [f"{q}|{i}" for q, i in zip(
                    batch["questions"], batch["question_ids"])],
                "doc_scores": np.arange(n * 2, dtype=np.float32).reshape(
                    n, 2),
                "retrieved_contents": [[q] for q in batch["questions"]]}


def test_vqa_server_pads_whole_rows():
    """VQAServer pads a dispatch to its bucket with copies of the first
    request's whole row (question, ids, image features, pixels and the
    static-retrieval key) and answers the real requests only; warm_up
    runs each bucket once."""
    from ravqa_tpu_torch.serving import VQAServer
    ex = _StubRag()
    server = VQAServer(ex, _Tok(), image_feature_dim=3, pixel_shape=(2, 2, 3),
                       config=ServeConfig(max_batch=8, max_wait_ms=500.0))
    try:
        server.warm_up()
        assert [len(b["questions"]) for b in ex.batches] == [1, 2, 4, 8]
        ex.batches.clear()
        futs = [server.submit(f"q{i}", np.full(3, i, np.float32),
                              np.full((2, 2, 3), i, np.float32),
                              question_id=str(i)) for i in range(3)]
        answers = [f.result(timeout=30) for f in futs]
    finally:
        server.stop()
    got = [a.answer for a in answers]
    assert got == ["q0|0", "q1|1", "q2|2"]
    sent = [b for b in ex.batches]
    rows = sum(len(b["questions"]) for b in sent)
    assert all(len(b["questions"]) in (1, 2, 4, 8) for b in sent)
    assert rows >= 3
    for b in sent:
        n = len(b["questions"])
        real = [i for i, q in enumerate(b["questions"])
                if i == 0 or q != b["questions"][0]]
        for i in range(len(real), n):
            assert b["questions"][i] == b["questions"][0]
            assert b["question_ids"][i] == b["question_ids"][0]
            np.testing.assert_array_equal(b["image_features"][i],
                                          b["image_features"][0])
            np.testing.assert_array_equal(b["pixel_values"][i],
                                          b["pixel_values"][0])


def test_submit_refuses_images_the_server_does_not_take():
    """A request whose image features have another width, or that sends
    pixels to a server without a ViT, fails at submit() and never reaches
    a batch; the requests beside it are served."""
    ex = _SlowExecutor()
    ex.release.set()
    server = RetrievalServer(ex, _StubSearcher(), _Tok(), image_feature_dim=3,
                             config=ServeConfig(k=2))
    try:
        good = server.submit("a", np.ones(3, np.float32))
        with pytest.raises(ValueError, match="image_features of shape"):
            server.submit("b", np.ones(4, np.float32))
        with pytest.raises(ValueError, match="takes no pixel_values"):
            server.submit("c", pixel_values=np.zeros((2, 2, 3), np.float32))
        blank = server.submit("d")
        for fut in (good, blank):
            assert fut.result(timeout=30).pids.shape == (2,)
    finally:
        server.stop()


JAX_ORBAX_FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_checkpoint",
                                 "orbax")


def test_serve_slice_imports_no_jax(tmp_path):
    """The exact and the hierarchical serve slices, the PreFLMR serve slice
    (in-graph ViT and transformer mapping, a tiny cut of
    configs/synthetic_preflmr_vitl_serve.json: a request without pixels
    gets a blank image of the ViT's own size), the HF key mappings, the
    training slice (train, then eval from its checkpoint, and entry()),
    the residual codec, the stage-2 kernels' module and the stage-2
    experiment, and the RAG serve slice (build_server on a tiny cut of
    configs/synthetic_rag_blip2_serve.json: a VQAServer over FLMR retrieval
    and BLIP-2, one answer; then a RAG train step on the same cut), WIT
    pretraining (train, then test, on a tiny cut of
    configs/synthetic_flmr_wit_pretrain.json over a synthetic WIT dump),
    evaluate_m2kr and a DPR train step and evaluation, the parallel layer
    and the multi-rank dry run (entry.dryrun_multichip on 4 CPU ranks,
    which imports nothing of jax either), and FLMR with ROIs
    (the VinVL detector and the Oscar captioner at tiny widths over a
    synthetic OK-VQA world through the extraction scripts' loops, then
    train and test on a tiny cut of configs/okvqa/flmr_with_roi.json, the
    test with --use_dummy_data), and text-retrieval training
    (Collection/Queries/Triples from a ranking, the cross-encoder Scorer's
    distillation_scores.json, KD triples, TriplesExecutor.train_on_triples
    under the profiler's trace, its evaluation through
    evaluate_msmarco_ranking, the BEM fallback; the HF T5/BLIP-2
    converters imported), and the orbax checkpoints (the committed JAX
    fixture read through the port's OCDBT and zstd reader, an executor's
    orbax checkpoint written and loaded), in one process: nothing of the
    JAX package (ravqa_tpu) or of jax/jaxlib/flax/orbax/tensorstore/
    zstandard/msgpack loads."""
    code = (
        "import sys, numpy as np\n"
        "from ravqa_tpu_torch.config import apply_overrides, load_config\n"
        "from ravqa_tpu_torch.main import build_pipeline, build_server, main\n"
        "import ravqa_tpu_torch.profile_serve\n"
        "import ravqa_tpu_torch.scripts.profiler_trace_loss\n"
        "import ravqa_tpu_torch.ops.residual\n"
        "import ravqa_tpu_torch.ops.stage2\n"
        "import ravqa_tpu_torch.scripts.exp_residual_stage2\n"
        "import ravqa_tpu_torch.entry\n"
        "import ravqa_tpu_torch.models.convert_flmr\n"
        "import ravqa_tpu_torch.parallel.tp\n"
        "from ravqa_tpu_torch.entry import dryrun_multichip\n"
        "assert dryrun_multichip(4, 'cpu')['exact'].shape == (8, 3)\n"
        f"args = ['--config', {CONFIG!r}, '--device', 'cpu',\n"
        f"        '--log_dir', {str(tmp_path)!r}]\n"
        "assert main(args + ['--mode', 'train', '--opts',\n"
        "                    'train.total_steps=2', 'train.val_every=2']) == 0\n"
        "assert main(args + ['--mode', 'test']) == 0\n"
        f"for opts in ([], {HIER_OPTS!r}):\n"
        f"    cfg = apply_overrides(load_config({CONFIG!r}), opts)\n"
        "    data = build_pipeline(cfg).get_data(\n"
        "        cfg.data_pipeline_output_node, explode=True)\n"
        "    s = build_server(cfg, data, 'cpu')\n"
        "    r = s.submit('cat dog sky').result(timeout=120)\n"
        "    s.stop()\n"
        "    assert r.pids.shape == (10,)\n"
        "    assert s.searcher.mode == ('hierarchical' if opts else 'exact')\n"
        f"cfg = apply_overrides(load_config({PREFLMR_CONFIG!r}),\n"
        f"                      {PREFLMR_TINY_OPTS!r})\n"
        "data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,\n"
        "                                    explode=True)\n"
        "s = build_server(cfg, data, 'cpu')\n"
        "assert s.pixel_shape == (32, 32, 3)\n"
        "img = data['train'].items[0]['image']\n"
        "for px in (None, img):\n"
        "    r = s.submit('cat dog sky', pixel_values=px).result(120)\n"
        "    assert r.pids.shape == (10,)\n"
        "s.stop()\n"
        f"cfg = apply_overrides(load_config({RAG_CONFIG!r}),\n"
        f"                      {RAG_TINY_OPTS!r})\n"
        "data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,\n"
        "                                    explode=True)\n"
        "s = build_server(cfg, data, 'cpu')\n"
        "r = s.submit('cat dog sky').result(120)\n"
        "s.stop()\n"
        "assert len(r.passages) == 5 and isinstance(r.answer, str)\n"
        "from ravqa_tpu_torch.main import build_rag_executor, rag_batches\n"
        f"cfg = apply_overrides(load_config({RAG_CONFIG!r}),\n"
        f"                      {RAG_TINY_OPTS + RAG_TRAIN_OPTS!r})\n"
        "data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,\n"
        "                                    explode=True)\n"
        "ex = build_rag_executor(cfg, data, 'cpu')\n"
        "m = ex.train_step_rag(next(rag_batches(data['train'], 2)))\n"
        "assert np.isfinite(float(m['loss'])) and ex.step == 1\n"
        "from ravqa_tpu_torch.scripts.synthetic_wit import "
        "write_synthetic_wit\n"
        f"p = write_synthetic_wit({str(tmp_path / 'wit')!r}, 16, 8, 8)\n"
        f"wit = ['--config', {WIT_CONFIG!r}, '--device', 'cpu',\n"
        f"       '--log_dir', {str(tmp_path)!r}, '--experiment_name', 'w',\n"
        "       '--opts', 'data_pipeline.wit.setup_kwargs.tsv_path.train='\n"
        "       + p['train'], 'data_pipeline.wit.setup_kwargs.tsv_path.test='\n"
        "       + p['test'], 'data_pipeline.features.setup_kwargs.'\n"
        "       'features_path=' + p['features']]\n"
        f"wit += {WIT_TINY_OPTS!r}\n"
        "assert main(wit[:2] + ['--mode', 'train'] + wit[2:]) == 0\n"
        "assert main(wit[:2] + ['--mode', 'test'] + wit[2:]) == 0\n"
        "from ravqa_tpu_torch.executors.m2kr import M2KRTask, evaluate_m2kr\n"
        "from ravqa_tpu_torch.main import build_executor\n"
        f"cfg = load_config({CONFIG!r})\n"
        "data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,\n"
        "                                    explode=True)\n"
        "r = evaluate_m2kr(build_executor(cfg, 'cpu'), [M2KRTask(\n"
        "    'okvqa', data['test'], data['passages']['full_passages'])])\n"
        "assert 'okvqa/pos_item_ids_recall_at_5' in r['_flat']\n"
        "from ravqa_tpu_torch.executors import DPRExecutor, TrainConfig\n"
        "from ravqa_tpu_torch.models import (BertConfig, DPRModelConfig,\n"
        "                                    DPRRetriever)\n"
        "d = DPRRetriever(DPRModelConfig.tiny(bert=BertConfig.tiny(\n"
        "    vocab_size=data['tokenizer'].vocab_size + 8)))\n"
        "d.reset_parameters(__import__('torch').Generator().manual_seed(0))\n"
        "dx = DPRExecutor(d, TrainConfig(lr=1e-3), device='cpu', quiet=True)\n"
        "m = dx.train_step(data['train'].collate([0, 1]))\n"
        "assert np.isfinite(float(m['loss'])) and dx.step == 1\n"
        "corpus = data['passages']['full_passages']\n"
        "from ravqa_tpu_torch.data import corpus_doc_batches, "
        "query_eval_batches\n"
        "r = dx.evaluate_retrieval(query_eval_batches(data['test']),\n"
        "    corpus_doc_batches(corpus, data['doc_tokenizer']), corpus.ids,\n"
        "    pos_item_ids=[it['pos_item_ids'] for it in data['test'].items])\n"
        "assert 'pos_item_ids_recall_at_5' in r\n"
        "import ravqa_tpu_torch.ops.vision\n"
        "import ravqa_tpu_torch.scripts.extract_vinvl_features\n"
        "from ravqa_tpu_torch.models.captioner import CaptionerConfig\n"
        "from ravqa_tpu_torch.models.detection import DetectorConfig\n"
        "from ravqa_tpu_torch.scripts.synthetic_okvqa import (\n"
        "    VOCAB_SIZE, config_opts, extract_synthetic,\n"
        "    write_synthetic_okvqa)\n"
        f"w = write_synthetic_okvqa({str(tmp_path / 'okvqa')!r}, 4, 8, 4,\n"
        "                          48, (40, 48))\n"
        "det = DetectorConfig.tiny()\n"
        "extract_synthetic(w, det, CaptionerConfig.tiny(\n"
        "    img_feature_dim=det.res5_out_channels + 6,\n"
        "    bert=BertConfig.tiny(vocab_size=VOCAB_SIZE)), 'cpu',\n"
        "    canvas=(48, 48), batch=4, min_size=40, max_size=48,\n"
        "    log=lambda m: None)\n"
        f"roi = ['--config', {ROI_CONFIG!r}, '--device', 'cpu',\n"
        f"       '--log_dir', {str(tmp_path)!r}, '--experiment_name',\n"
        f"       'roi', '--opts'] + config_opts(w) + {ROI_TINY_OPTS!r}\n"
        "assert main(roi[:2] + ['--mode', 'train'] + roi[2:]) == 0\n"
        "assert main(roi[:2] + ['--mode', 'test', '--use_dummy_data']\n"
        "            + roi[2:]) == 0\n"
        "from ravqa_tpu_torch.data.colbert_data import (Collection,\n"
        "    Queries, Triples, create_triples_from_ranking)\n"
        "from ravqa_tpu_torch.executors.triples_executor import "
        "TriplesExecutor\n"
        "from ravqa_tpu_torch.metrics import (evqa_accuracy, mrr_at_k,\n"
        "    success_at_k, initialize_bem_scoring_function)\n"
        "from ravqa_tpu_torch.metrics.retrieval_metrics import (\n"
        "    evaluate_msmarco_ranking, save_ranking_tsv)\n"
        "from ravqa_tpu_torch.models import (CrossEncoderReranker,\n"
        "    FLMRModelConfig, FLMRRetriever, RerankerConfig,\n"
        "    RerankerTokenizer, convert_hf_blip2_params,\n"
        "    convert_hf_t5_params)\n"
        "from ravqa_tpu_torch.retrieval import (Scorer,\n"
        "    kd_triples_from_scores, load_distillation_scores)\n"
        "from ravqa_tpu_torch.utils import (StepTimer, annotate,\n"
        "    device_memory_stats, trace)\n"
        "import torch\n"
        "tok = data['tokenizer']\n"
        "col = Collection(list(corpus.contents), list(corpus.ids))\n"
        "qs = Queries({str(i): it['question'] for i, it in\n"
        "              enumerate(data['train'].items)})\n"
        "ranked = [list(corpus.ids[:6])] * len(qs)\n"
        "rows = create_triples_from_ranking(ranked, [[corpus.ids[0]]] *\n"
        "                                   len(qs), list(qs.qid2text))\n"
        "rr = CrossEncoderReranker(RerankerConfig.tiny(\n"
        "    vocab_size=tok.vocab_size + 8, head='pooler_classifier'))\n"
        "sc = Scorer(rr, RerankerTokenizer(tok, 32), bsize=8)\n"
        f"dpath = {str(tmp_path / 'distillation_scores.json')!r}\n"
        "sc.score_ranking([r[0] for r in rows for _ in r[1:]],\n"
        "                 [p for r in rows for p in r[1:]], qs.qid2text,\n"
        "                 dict(zip(col.pids, col.passages)), dpath)\n"
        "kd = Triples(kd_triples_from_scores(load_distillation_scores(\n"
        "    dpath), nway=2))\n"
        "fm = FLMRRetriever(FLMRModelConfig.tiny(\n"
        "    bert=BertConfig.tiny(vocab_size=tok.vocab_size + 8),\n"
        "    query_mode='text_only', dim=16, nway=2))\n"
        "tx = TriplesExecutor(fm, TrainConfig(lr=1e-3), device='cpu',\n"
        "    quiet=True, distill_weight=1.0,\n"
        "    query_tokenizer=data['query_tokenizer'],\n"
        "    doc_tokenizer=data['doc_tokenizer'])\n"
        "timer = StepTimer()\n"
        f"with trace({str(tmp_path / 'trace')!r}), annotate('step'):\n"
        "    m = tx.train_on_triples(kd, qs, col, bsize=2, steps=2)\n"
        "    timer.tick(torch.ones(()))\n"
        "assert np.isfinite(m['distill_kl']) and tx.step == 2\n"
        "assert device_memory_stats() == [{'device': 'cpu'}]\n"
        "r = tx.evaluate_retrieval(query_eval_batches(data['test']),\n"
        "    corpus_doc_batches(corpus, data['doc_tokenizer']), corpus.ids,\n"
        "    pos_item_ids=[it['pos_item_ids'] for it in data['test'].items])\n"
        "got = r['_retrieved_pids']\n"
        "pos = [it['pos_item_ids'] for it in data['test'].items]\n"
        f"rank = {str(tmp_path / 'ranking.tsv')!r}\n"
        "save_ranking_tsv(rank, range(len(got)), got,\n"
        "                 [[0.0] * len(g) for g in got])\n"
        f"qrels = {str(tmp_path / 'qrels.tsv')!r}\n"
        "with open(qrels, 'w') as f:\n"
        "    for i, ps in enumerate(pos):\n"
        "        f.writelines(f'{i} 0 {p} 1' + chr(10) for p in ps)\n"
        "e = evaluate_msmarco_ranking(rank, qrels)\n"
        "assert abs(e['mrr@10'] - mrr_at_k(got, pos, 10)) < 1e-12\n"
        "assert 0 <= success_at_k(got, pos, 5) <= 1\n"
        "fb = initialize_bem_scoring_function()\n"
        "assert evqa_accuracy(['a cat'], [['cat']], ['q'], fb) == 1.0\n"
        "from ravqa_tpu_torch.executors import orbax_io\n"
        f"fx = orbax_io.load({JAX_ORBAX_FIXTURE!r})\n"
        "assert fx['step'] == 3 and 'opt_state' in fx\n"
        f"ck = {str(tmp_path / 'orbax_ck')!r}\n"
        "ex = build_executor(load_config(" + repr(CONFIG) + "), 'cpu')\n"
        "ex.save_checkpoint(ck, backend='orbax')\n"
        "ex.load_checkpoint_orbax(ck)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('ravqa_tpu', 'jax', 'jaxlib', 'flax', 'orbax',\n"
        "              'tensorstore', 'zstandard', 'msgpack')))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name,stage", [
    ("void coarse_sweep_kernel<signed char, 8>(...)", "stage 0"),
    ("void summary_tile::summary_kernel<(anonymous namespace)::CoarseBf16Op>"
     "(summary_tile::Args, CUtensorMap)", "stage 0"),
    ("void stage1_sweep_kernel<__nv_bfloat16, signed char>(...)", "stage 1"),
    ("void maxsim_kernel<float, float>(...)", "exact"),
    ("void maxsim_int8_kernel<4>(...)", "exact int8"),
    ("void residual_maxsim_kernel<1>(...)", "residual fine stage"),
    ("void at::native::sbtopk::gatherTopK<float, unsigned int, 2>", "top-k"),
    ("void at::native::radixFindKthValues<float>", "top-k"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn", "plain fine stage")])
def test_profile_serve_splits_kernels_by_stage(name, stage):
    from ravqa_tpu_torch.profile_serve import _stage
    assert _stage(name).startswith(stage)


def test_profile_serve_needs_a_gpu():
    from ravqa_tpu_torch.profile_serve import main
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(SystemExit, match="CUDA GPU"):
        main([CONFIG])


def test_profile_serve_counts_device_events():
    """_device_events' sums, kernel count and launch count of a Chrome
    trace, leaving out the burn-in's spin kernels but counting their
    launches."""
    from ravqa_tpu_torch.profile_serve import BURN_IN_KERNEL, _device_events

    events = [
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel"},
        {"cat": "kernel", "name": "spin_kernel(long)", "dur": 5.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel"},
        {"cat": "cuda_driver", "name": "cuLaunchKernelEx"},
        {"cat": "kernel", "name": "maxsim_kernel", "dur": 1500.0},
        {"cat": "kernel", "name": "maxsim_kernel", "dur": 500.0},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync"},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "dur": 250.0},
        {"cat": "cpu_op", "name": "aten::mm", "dur": 9.0}]

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    out, kernels, launches = _device_events(Prof(), BURN_IN_KERNEL)
    assert out == {"maxsim_kernel": [2.0, 2], "Memcpy DtoH": [0.25, 1]}
    assert (kernels, launches) == (2, 3)


def test_profiler_trace_loss_needs_a_gpu():
    from ravqa_tpu_torch.scripts.profiler_trace_loss import main
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(SystemExit, match="CUDA device"):
        main(["--seconds", "1"])


@pytest.mark.parametrize("argv", [
    ["--config", CONFIG, "--mode", "train", "--num_devices", "2"],
    ["--config", CONFIG, "--mode", "train", "--opts",
     "executor.ExecutorClass=DPRExecutor"],
])
def test_unported_modes_raise(argv, tmp_path):
    """--num_devices 2 now trains over 2 gloo ranks (the data-parallel
    CLI against one device: tests/test_torch_ddp.py): it writes the
    checkpoint from rank 0. An executor class that main.py does not build
    still raises (the JAX package's builds an FLMRExecutor for it:
    ROADMAP.md C20)."""
    from ravqa_tpu_torch.main import main
    args = argv + ["--device", "cpu", "--log_dir", str(tmp_path)]
    if "--num_devices" in argv:
        assert main(args + ["--opts", "train.total_steps=2",
                            "train.val_every=2"]) == 0
        assert os.path.exists(tmp_path / "default" / "ckpt" /
                              "params.msgpack")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(args)


@pytest.fixture(scope="module")
def rag_trained(tmp_path_factory):
    """--mode train on configs/synthetic_rag.json (3 steps, a validation at
    step 3): its log directory."""
    from ravqa_tpu_torch.main import main
    log_dir = tmp_path_factory.mktemp("rag")
    assert main(["--config", os.path.join(REPO, "configs",
                                          "synthetic_rag.json"),
                 "--mode", "train", "--device", "cpu", "--log_dir",
                 str(log_dir), "--experiment_name", "r", "--opts",
                 "train.total_steps=3", "train.val_every=3"]) == 0
    return log_dir


@pytest.mark.parametrize("mode", ["train", "test", "eval"])
def test_rag_train_test_eval_modes(rag_trained, mode, capsys):
    """train, test and eval on a RAG config (once refused, ROADMAP.md A6):
    training writes the checkpoint (params, optimizer and step) and logs
    finite losses and the validation's metrics; test and eval load that
    checkpoint and write <split>_rag_metrics.json (SyntheticOKVQA has no
    valid split, so both score the test questions)."""
    from ravqa_tpu_torch.main import main
    run = rag_trained / "r"
    if mode == "train":
        assert sorted(os.listdir(run / "ckpt")) == [
            "opt_state.msgpack", "params.msgpack", "rng.msgpack",
            "step.json"]
        assert json.load(open(run / "ckpt" / "step.json")) == {"step": 3}
        logged = [json.loads(line) for line in open(run / "metrics.jsonl")]
        train = [r for r in logged if "train/loss" in r]
        assert train and all(np.isfinite(r["train/loss"]) for r in train)
        assert any("valid/vqa_accuracy" in r for r in logged)
        return
    assert main(["--config", os.path.join(REPO, "configs",
                                          "synthetic_rag.json"),
                 "--mode", mode, "--device", "cpu", "--log_dir",
                 str(rag_trained), "--experiment_name", "r"]) == 0
    assert "no checkpoint found" not in capsys.readouterr().out
    split = "test" if mode == "test" else "valid"
    metrics = json.load(open(run / f"{split}_rag_metrics.json"))
    assert set(metrics) == {"exact_match", "vqa_accuracy"}
    assert all(0.0 <= v <= 1.0 for v in metrics.values())


@pytest.mark.parametrize("name,opts", [
    ("synthetic_rag.json", []),
    ("synthetic_rag_blip2_serve.json", RAG_TINY_OPTS)])
def test_rag_configs_serve(name, opts):
    """A RAG config, once refused, builds a VQAServer (T5 or BLIP-2) that
    answers; --mode prepare_data runs on it too."""
    from ravqa_tpu_torch.main import build_pipeline, build_server, main
    from ravqa_tpu_torch.serving import VQAServer
    path = os.path.join(REPO, "configs", name)
    cfg = apply_overrides(load_config(path), opts)
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    server = build_server(cfg, data, "cpu")
    try:
        assert isinstance(server, VQAServer)
        res = server.submit("cat dog sky").result(timeout=120)
        assert len(res.passages) == server.ex.rag_cfg.n_docs
        assert np.isfinite(res.doc_scores).all()
    finally:
        server.stop()
    assert main(["--config", path, "--mode", "prepare_data",
                 "--opts"] + opts) == 0


@pytest.mark.parametrize("name", ["synthetic_flmr_pixels.json",
                                  "synthetic_preflmr.json"])
def test_unported_model_features_raise(name):
    """The in-graph ViT (synthetic_flmr_pixels.json) and the PreFLMR
    transformer mapping on patch features (synthetic_preflmr.json), once
    refused, now build and encode their queries: text | mapping |
    (transformer mapping) tokens, from the dataset's pixels or features."""
    from ravqa_tpu_torch.data import query_eval_batches
    from ravqa_tpu_torch.main import build_executor, build_pipeline
    cfg = load_config(os.path.join(REPO, "configs", name))
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    ex = build_executor(cfg, "cpu", inference_only=True)
    mc = ex.model.cfg
    q = ex.encode_queries(query_eval_batches(data["test"]))
    if mc.in_graph_vision:
        n_vision = mc.prefix_len
    else:
        n_vision = mc.prefix_len + data["test"].items[0][
            "image_patch_features"].shape[0]
    assert q.shape == (len(data["test"].items),
                       data["query_tokenizer"].query_maxlen + n_vision,
                       mc.dim)
    assert np.isfinite(q).all()
    np.testing.assert_allclose(np.linalg.norm(q[:, -n_vision:], axis=-1),
                               1.0, rtol=1e-5)


def test_prepare_data_mode(capsys):
    from ravqa_tpu_torch.main import main
    assert main(["--config", CONFIG, "--mode", "prepare_data"]) == 0
    assert "query_tokenizer" in capsys.readouterr().out


def test_punctuation_skiplist_matches_jax():
    from ravqa_tpu import tokenization as jax_tok
    from ravqa_tpu.models.flmr import punctuation_skiplist_ids as jax_ids
    from ravqa_tpu_torch.models import punctuation_skiplist_ids
    from ravqa_tpu_torch.tokenization import (WordPieceTokenizer,
                                              make_tiny_vocab)
    tok = WordPieceTokenizer(make_tiny_vocab(["cat"]))
    assert punctuation_skiplist_ids(tok) == jax_ids(
        jax_tok.WordPieceTokenizer(jax_tok.make_tiny_vocab(["cat"])))
    assert punctuation_skiplist_ids(tok)          # the tiny vocab has . , ?
