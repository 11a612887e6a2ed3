"""Data-parallel entry points of the port on gloo ranks spawned on the CPU
(parallel.launch, tests/_torch_ranks.py), the companion of
tests/test_torch_ddp.py:

- a RAG train step on 2 ranks against the port's one-device step on the
  same global batches (tests/test_torch_rag_train.py holds that step to
  the JAX package's): each rank's loss is its share of the global batch's
  (the NLL and retrieval losses over the global counts), so the summed
  losses and grads are the global step's;
- main.py --num_devices 2: train, then test, against the one-device CLI,
  and serve over HTTP against the one-device server;
- the RAVQA-v2 VQAServer over a sharded index on 2 ranks against the
  one-device server (serving.MeshSearchFront: the searches and the
  retrieved docs' gathers broadcast to the other rank);
- entry.dryrun_multichip(4, "cpu").

Tolerances, tests/test_torch_train.py's: losses and grad norms rtol 1e-4,
parameters within 2 lr a step.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import _torch_ranks
from ravqa_tpu_torch.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLMR_CFG = os.path.join(REPO, "configs", "synthetic_flmr.json")
RAG_CFG = os.path.join(REPO, "configs", "synthetic_rag.json")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_rag_step_on_two_ranks_matches_one_device():
    one = _torch_ranks.rag_rank(RAG_CFG, 2)
    ranks = launch(_torch_ranks.rag_rank, 2, RAG_CFG, 2, timeout=60,
                   join_timeout=300)
    got = ranks[0]
    for gm, wm in zip(got["metrics"], one["metrics"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=1e-4, err_msg=k)
    assert set(got["params"]) == set(one["params"])
    for name, p in one["params"].items():
        np.testing.assert_allclose(got["params"][name], p, rtol=0,
                                   atol=2 * 2 * 1e-3, err_msg=name)
        np.testing.assert_array_equal(ranks[1]["params"][name],
                                      got["params"][name])


def _main(argv):
    from ravqa_tpu_torch.main import main
    assert main(argv + ["--device", "cpu"]) == 0


def test_cli_train_then_test_on_two_ranks(tmp_path):
    """--num_devices 2 train (6 steps, a validation at 3 and 6), then
    --mode test on its checkpoint (a sharded index), against the same on
    one device: the logged losses, the checkpoint and the metrics."""
    opts = ["--opts", "train.total_steps=6", "train.val_every=3",
            "train.log_every=1"]
    for name, extra in (("one", []), ("two", ["--num_devices", "2"])):
        base = ["--config", FLMR_CFG, "--log_dir", str(tmp_path),
                "--experiment_name", name] + extra
        _main(base + ["--mode", "train"] + opts)
        _main(base + ["--mode", "test"])

    def log(name):
        with open(tmp_path / name / "metrics.jsonl") as f:
            return [json.loads(x) for x in f]

    one, two = log("one"), log("two")
    assert len(one) == len(two)
    for a, b in zip(one, two):
        assert sorted(a) == sorted(b)
        for k, v in a.items():
            if k not in ("time", "step"):
                np.testing.assert_allclose(b[k], v, rtol=1e-4, err_msg=k)
    with open(tmp_path / "one" / "test_metrics.json") as f:
        want = json.load(f)
    with open(tmp_path / "two" / "test_metrics.json") as f:
        assert json.load(f) == pytest.approx(want)
    from ravqa_tpu_torch.models.convert import load_params
    a = load_params(str(tmp_path / "one" / "ckpt" / "params.msgpack"))
    b = load_params(str(tmp_path / "two" / "ckpt" / "params.msgpack"))
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=0,
                                   atol=6 * 2 * 2e-3, err_msg=k)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, text):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/search",
        data=json.dumps({"query": text,
                         "image_features": [0.5] * 16}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_cli_serve_on_two_ranks(tmp_path):
    """--mode serve --num_devices 2 (rank 0's HTTP server, rank 1's shard
    loop) answers like the one-device server; SIGTERM ends every rank."""
    from ravqa_tpu_torch.config import load_config
    from ravqa_tpu_torch.main import build_pipeline, build_server
    cfg = load_config(FLMR_CFG)
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    one = build_server(cfg, data, "cpu")
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ravqa_tpu_torch.main", "--config", FLMR_CFG,
         "--mode", "serve", "--device", "cpu", "--num_devices", "2",
         "--host", "127.0.0.1", "--port", str(port), "--log_dir",
         str(tmp_path)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                       timeout=2)
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                assert time.monotonic() < deadline, "server did not start"
                time.sleep(0.5)
        texts = [it["question"] for it in data["test"].items[:6]]
        want = one.search_batch(texts, np.full((6, 16), 0.5, np.float32))
        for t, w in zip(texts, want):
            got = _post(port, t)
            assert [str(p) for p in got["pids"]] == [str(p) for p in w.pids]
            np.testing.assert_allclose(got["scores"], w.scores, rtol=1e-5,
                                       atol=1e-4)
    finally:
        one.stop()
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
    assert "[rank 1/2] backend gloo device cpu" in out
    assert proc.returncode is not None


def test_vqa_server_on_two_ranks_matches_one_device():
    from ravqa_tpu_torch.config import apply_overrides, load_config
    from ravqa_tpu_torch.main import build_pipeline, build_server
    from test_torch_serving import RAG_CONFIG, RAG_TINY_OPTS
    ranks = launch(_torch_ranks.vqa_serve_rank, 2, RAG_CONFIG, RAG_TINY_OPTS,
                   "cat dog sky", timeout=60, join_timeout=300)
    cfg = apply_overrides(load_config(RAG_CONFIG), RAG_TINY_OPTS)
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    one = build_server(cfg, data, "cpu")
    want = one.submit("cat dog sky").result(120)
    one.stop()
    answer, passages, scores = ranks[0]
    assert answer == want.answer and passages == list(want.passages)
    np.testing.assert_allclose(scores, want.doc_scores, rtol=1e-5,
                               atol=1e-5)
    assert ranks[1] > 0             # the worker ran the broadcast calls


def test_dryrun_multichip_on_four_cpu_ranks():
    from ravqa_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(4, "cpu")
    assert np.isfinite(out["loss"]) and out["tp_max_abs_err"] < 1e-4
    for name in ("exact", "two_stage", "residual", "factored",
                 "hierarchical_int8", "fast"):
        assert out[name].shape == (8, 3), name
