"""The port's WIT mapping-network pretraining against the JAX package's.

On a tiny cut of configs/synthetic_flmr_wit_pretrain.json (vision-only
queries; the BERT tower and the linear frozen) over a synthetic WIT dump
the test writes, with the JAX executor's parameters carried into the port:
- the collated batch (EmptyTextInput + VisionInput) equals JAX's, and the
  vision-only query is the mapping network's prefix_len tokens alone,
  every one of them unit-norm (nothing masked), equal to JAX's
  encode_queries;
- FLMRVisionPretrainingExecutor's loss and its parts, and one train_step:
  the loss, the grad norm over the trainable parameters (JAX's grads of
  the mapping network; ROADMAP.md C21), the update of the mapping
  network; every other parameter bit-identical, without requires_grad
  or grad;
- `main --mode train` then `--mode test` on the CPU: the test metrics
  equal the JAX package's run_eval on the port's checkpoint, and the
  second run reads the `wit` node from the cache without running
  LoadWITData.

Tolerances: the forward rtol 1e-5, atol 1e-6 (tests/test_torch_models.py's
tower tolerance); the grad norm rtol 1e-4; the mapping network's update
within 2 lr of JAX's (a first Adam step moves a coordinate by about lr
whatever its grad's size, so a near-zero grad whose float32 rounding
differs moves it the other way); metrics exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu import main as jax_main
from ravqa_tpu.config import apply_overrides as jax_apply_overrides
from ravqa_tpu.config import load_config as jax_load_config
from ravqa_tpu_torch import main as torch_main
from ravqa_tpu_torch.config import apply_overrides, load_config
from ravqa_tpu_torch.models import flax_to_state_dict
from ravqa_tpu_torch.scripts.synthetic_wit import write_synthetic_wit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "synthetic_flmr_wit_pretrain.json")
LR = 1e-3
TINY = ["model_config.vision_embedding_size=8",
        "model_config.bert={'num_layers': 1, 'hidden_size': 32, "
        "'num_heads': 2, 'intermediate_size': 64}",
        "model_config.dim=16", "model_config.mapping_network_prefix_length=4",
        "data_pipeline.loaders.setup_kwargs.doc_maxlen=24",
        "data_pipeline.loaders.setup_kwargs.query_maxlen=8",
        f"train.lr={LR}", "train.total_steps=4", "train.val_every=2",
        "train.log_every=2", "train.batch_size=4"]


def wit_opts(d):
    paths = write_synthetic_wit(str(d), n_train=24, n_test=8, vision_dim=8,
                                seed=0)
    return [f"data_pipeline.wit.setup_kwargs.tsv_path.train={paths['train']}",
            f"data_pipeline.wit.setup_kwargs.tsv_path.test={paths['test']}",
            "data_pipeline.features.setup_kwargs.features_path="
            f"{paths['features']}"] + TINY


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both packages' data and executors on the JAX executor's params."""
    tmp = tmp_path_factory.mktemp("wit")
    opts = wit_opts(tmp)
    jcfg = jax_apply_overrides(jax_load_config(CONFIG), opts)
    jdata = jax_main.build_pipeline(jcfg, cache_dir=None).get_data(
        jcfg.data_pipeline_output_node, explode=True)
    jex = jax_main.build_executor(jcfg, jdata, None, str(tmp / "j"),
                                  quiet=True)
    tcfg = apply_overrides(load_config(CONFIG), opts)
    tdata = torch_main.build_pipeline(tcfg).get_data(
        tcfg.data_pipeline_output_node, explode=True)
    tex = torch_main.build_executor(tcfg, "cpu")
    params = jax.device_get(jex.state.params)
    tex.model.load_state_dict(flax_to_state_dict(params))
    return dict(opts=opts, jdata=jdata, jex=jex, tdata=tdata, tex=tex,
                params=params, tmp=tmp)


def test_builds_the_pretraining_executor(world):
    from ravqa_tpu.executors import FLMRVisionPretrainingExecutor as J
    from ravqa_tpu_torch.executors import FLMRVisionPretrainingExecutor as T
    assert type(world["jex"]) is J and type(world["tex"]) is T
    assert world["tex"].model.cfg.query_mode == "vision_only"
    frozen = {n for n, p in world["tex"].model.named_parameters()
              if not p.requires_grad}
    assert frozen == {n for n, _ in world["tex"].model.named_parameters()
                      if not n.startswith("vision_projection")}


def test_collated_batch_and_query_match_jax(world):
    # the JAX executor drew its init batch from its dataset's generator:
    # both datasets draw the negatives from one seed here
    for data in (world["jdata"], world["tdata"]):
        data["train"].rng = np.random.default_rng(5)
    jb = world["jdata"]["train"].collate([0, 1, 2, 3])
    tb = world["tdata"]["train"].collate([0, 1, 2, 3])
    assert sorted(tb) == sorted(jb)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    from ravqa_tpu.data.datasets import query_eval_batches as jqeb
    from ravqa_tpu_torch.data import query_eval_batches
    want = world["jex"].encode_queries(jqeb(world["jdata"]["test"], 3))
    got = world["tex"].encode_queries(query_eval_batches(
        world["tdata"]["test"], 3))
    assert got.shape == (8, 4, 16) == want.shape      # prefix_len tokens
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                               rtol=1e-5)
    # the text never reaches the query: other tokens, the same embeddings
    tq = world["tex"].encode_query(np.zeros_like(tb["query_input_ids"]),
                                   tb["query_attention_mask"],
                                   tb["image_features"])
    np.testing.assert_array_equal(
        tq.numpy(), world["tex"].encode_query(
            None, None, tb["image_features"]).numpy())


def test_loss_and_train_step_match_jax(world):
    from ravqa_tpu_torch.main import build_executor
    jex, params = world["jex"], world["params"]
    tcfg = apply_overrides(load_config(CONFIG), world["opts"])
    tex = build_executor(tcfg, "cpu")
    tex.model.load_state_dict(flax_to_state_dict(params))
    batch = world["tdata"]["train"].collate([4, 5, 6, 7])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jparts), jgrads = jax.value_and_grad(jex.loss_fn, has_aux=True)(
        jex.state.params, jbatch, jax.random.PRNGKey(0))
    loss, parts = tex.loss_fn(batch, tex.generator)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in ("nway_loss", "ib_loss"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the JAX executor's train step on a copy of its state
    state = jex.state
    jm = jex.train_step(jbatch)
    jafter = jax.device_get(jex.state.params)
    jex.state = state
    before = {n: p.detach().clone() for n, p in tex.model.named_parameters()}
    tm = tex.train_step(batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    mapping = jax.device_get(jgrads["vision_projection"])
    want_norm = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                            for g in jax.tree.leaves(mapping)))
    np.testing.assert_allclose(float(tm["grad_norm"]), want_norm, rtol=1e-4)
    assert float(jm["grad_norm"]) > want_norm      # JAX's counts the towers
    want = flax_to_state_dict(jafter)
    for n, p in tex.model.named_parameters():
        if n.startswith("vision_projection"):
            assert p.requires_grad and p.grad is not None
            assert not torch.equal(p.detach(), before[n]), n
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       rtol=0, atol=2 * LR, err_msg=n)
        else:
            assert not p.requires_grad and p.grad is None, n
            assert torch.equal(p.detach(), before[n]), n
            np.testing.assert_array_equal(p.detach().numpy(),
                                          want[n].numpy(), err_msg=n)
    assert {id(p) for p in tex.optimizer.trainable} == {
        id(p) for n, p in tex.model.named_parameters()
        if n.startswith("vision_projection")}


def test_cli_train_then_test_matches_jax(world, tmp_path, monkeypatch):
    """--mode train then --mode test on the CPU; the test metrics equal the
    JAX run_eval on the port's checkpoint; the second run reads the wit
    node from the cache."""
    from ravqa_tpu_torch.data import TRANSFORM_REGISTRY
    from ravqa_tpu_torch.main import main
    log = str(tmp_path)
    common = ["--config", CONFIG, "--device", "cpu", "--log_dir", log,
              "--experiment_name", "wit", "--opts"] + world["opts"]
    load = TRANSFORM_REGISTRY["LoadWITData"]
    runs = []
    orig = load.__call__

    def counted(self, *a):
        runs.append(1)
        return orig(self, *a)

    monkeypatch.setattr(load, "__call__", counted)
    assert main(["--mode", "train"] + common) == 0
    exp = os.path.join(log, "wit")
    cached = os.listdir(os.path.join(exp, "cache"))
    assert len(cached) == 1 and cached[0].startswith("wit.") \
        and cached[0].endswith(".torch.pkl")
    hist = [json.loads(line) for line in open(os.path.join(exp,
                                                           "metrics.jsonl"))]
    assert [h["step"] for h in hist if "train/loss" in h] == [2, 4]
    assert all(np.isfinite(h["train/loss"]) for h in hist
               if "train/loss" in h)
    final = {k[len("valid/"):]: v for h in hist if h["step"] == 4
             for k, v in h.items() if k.startswith("valid/")}
    assert "pos_item_ids_recall_at_10" in final
    assert main(["--mode", "test"] + common) == 0
    assert runs == [1]                     # the test run read the cache
    with open(os.path.join(exp, "test_metrics.json")) as f:
        got = json.load(f)
    assert got == final          # valid falls back to test in WIT's data
    jcfg = jax_apply_overrides(jax_load_config(CONFIG), world["opts"])
    jdata = jax_main.build_pipeline(jcfg, cache_dir=None).get_data(
        jcfg.data_pipeline_output_node, explode=True)
    jex = jax_main.build_executor(jcfg, jdata, None, str(tmp_path / "j"),
                                  quiet=True)
    jex.load_checkpoint(os.path.join(exp, "ckpt"))
    assert jax_main.run_eval(jcfg, jex, jdata, str(tmp_path / "j"),
                             "test") == got
