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
HIER_OPTS = ["data_pipeline.raw.setup_kwargs.n_docs=512",
             "model_config.search_mode=hierarchical", "serve.preset=fast",
             "serve.block_size=8", "serve.n_summary=4",
             "serve.n_candidates=24"]


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


def test_serve_slice_imports_no_jax():
    """The exact and the hierarchical serve slices, the residual codec, the
    stage-2 kernels' module and the stage-2 experiment, in one process:
    nothing of the JAX package (ravqa_tpu) or of jax/jaxlib/flax loads."""
    code = (
        "import sys, numpy as np\n"
        "from ravqa_tpu_torch.config import apply_overrides, load_config\n"
        "from ravqa_tpu_torch.main import build_pipeline, build_server\n"
        "import ravqa_tpu_torch.profile_serve\n"
        "import ravqa_tpu_torch.ops.residual\n"
        "import ravqa_tpu_torch.ops.stage2\n"
        "import ravqa_tpu_torch.scripts.exp_residual_stage2\n"
        f"for opts in ([], {HIER_OPTS!r}):\n"
        f"    cfg = apply_overrides(load_config({CONFIG!r}), opts)\n"
        "    data = build_pipeline(cfg).get_data(\n"
        "        cfg.data_pipeline_output_node, explode=True)\n"
        "    s = build_server(cfg, data, 'cpu')\n"
        "    r = s.submit('cat dog sky').result(timeout=120)\n"
        "    s.stop()\n"
        "    assert r.pids.shape == (10,)\n"
        "    assert s.searcher.mode == ('hierarchical' if opts else 'exact')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('ravqa_tpu', 'jax', 'jaxlib', 'flax')))\n")
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


@pytest.mark.parametrize("argv", [
    ["--config", CONFIG, "--mode", "train"],
    ["--config", CONFIG, "--mode", "eval"],
    ["--config", os.path.join(REPO, "configs", "synthetic_rag.json"),
     "--mode", "serve"],
])
def test_unported_modes_raise(argv):
    from ravqa_tpu_torch.main import main
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("name", ["synthetic_flmr_pixels.json",
                                  "synthetic_preflmr.json"])
def test_unported_model_features_raise(name):
    from ravqa_tpu_torch.main import _flmr_config_from
    cfg = load_config(os.path.join(REPO, "configs", name))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _flmr_config_from(cfg.model_config)


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
