"""Checkpoint interchange between the port and the JAX package: the optax
state (executors/opt_state.py), the PRNG key (utils/prng.py) and the orbax
backend (executors/orbax_io.py).

Both packages' executors train a tiny FLMR retriever's parameters (one
JAX init) on a linear loss, sum(param * g) over the parameters, whose
gradient is g itself: the same gradients reach both optimizers exactly,
so what is compared is the optimizer's state and arithmetic, through the
checkpoint files, for every case of tests/test_torch_train.py's OPT_CASES:

- a fresh executor's four files (params, opt_state, rng msgpack and
  step.json) are byte-equal to the JAX executor's;
- JAX takes n steps (mid accumulation window where there is one) and
  saves; the port loads and takes m; the result matches JAX's n + m
  steps; the port saves and JAX loads (without ckpt_opt_state_missing)
  and continues; that matches JAX's uninterrupted run. Every leaf of the
  params, mu, nu and acc_grads trees is compared by its path, and the
  keys and counts exactly;
- the same for the RAG executor (tiny FLMR + T5 with LoRA, retriever_lr,
  accumulation, the frozen generator base);
- the orbax backend both ways (the JAX package's default OCDBT + zstd
  files read by the port; the port's plain zarr files restored by JAX's
  load_checkpoint_orbax), its params+step-only fallback, truncation and
  crc errors, and the OCDBT reader against tensorstore on multi-level
  trees;
- tests/fixtures/jax_checkpoint, a JAX-written checkpoint committed for
  the card (chip_smoke.py reads it through the port's zstd path):
  regenerated here, it decodes to the committed values and digest.

Tolerance (the optimizer's, tests/test_torch_train.py): rtol 1e-5, atol
1e-6 on the float leaves of a run continued across the packages; what a
checkpoint file carries (a fresh state, an orbax restore) exactly.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from flax import serialization

from ravqa_tpu import models as jax_models
from ravqa_tpu.executors import base as jbase
from ravqa_tpu.executors import rag_executor as jrag
from ravqa_tpu_torch.executors import base as tbase
from ravqa_tpu_torch.executors import orbax_io
from ravqa_tpu_torch.executors.rag_executor import RagConfig, RagExecutor
from ravqa_tpu_torch.models import (BertConfig, FLMRModelConfig,
                                    FLMRRetriever, T5Config, T5Model,
                                    read_flax_msgpack)
from ravqa_tpu_torch.utils import prng
from _ckpt_digest import tree_digest
from test_torch_train import OPT_CASES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_checkpoint")
TOL = dict(rtol=1e-5, atol=1e-6)
BERT = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
            intermediate_size=32, max_position_embeddings=32)
FLMR = dict(vision_dim=8, prefix_len=2, dim=8, nway=2,
            separate_question_encoder=True)
T5 = dict(vocab_size=64, eos_token_id=1, d_model=16, d_kv=8, d_ff=32,
          num_layers=1, num_heads=2)
RAG_TRAIN = dict(lr=1e-2, retriever_lr=1e-3, weight_decay=0.05,
                 schedule="linear", total_steps=12,
                 accumulate_grad_batches=2)
RAG = dict(use_lora=True, lora_rank=2, generator_type="t5")
# and a freeze flag that freezes nothing here (no vision_model): JAX
# leaves the chain unmasked
CASES = {**OPT_CASES, "noop_freeze": dict(lr=1e-2,
                                          modules=("freeze_image_encoder",))}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the two executors on one linear loss
# ---------------------------------------------------------------------------

_CACHE: dict = {}


def _jax_flmr_params():
    if "flmr" not in _CACHE:
        model = jax_models.FLMRRetriever(jax_models.FLMRModelConfig.tiny(
            bert=jax_models.BertConfig.tiny(**BERT), **FLMR))
        ids = jnp.ones((2, 6), jnp.int32)
        _CACHE["flmr"] = jax.device_get(model.init(
            jax.random.PRNGKey(0), query_input_ids=ids,
            query_attention_mask=ids,
            image_features=jnp.ones((2, 8), jnp.float32),
            doc_input_ids=jnp.ones((4, 6), jnp.int32),
            doc_attention_mask=jnp.ones((4, 6), jnp.int32))["params"])
    return _CACHE["flmr"]


def _linear_jax(params, batch, rng):
    return sum(jnp.vdot(p, g) for p, g in zip(jax.tree.leaves(params),
                                               jax.tree.leaves(batch))), {}


def _linear_port(ex):
    def loss_fn(batch, generator):
        return sum((p * batch[n]).sum() for n, p in
                   ex.model.named_parameters() if p.requires_grad), {}
    return loss_fn


class _JaxExecutor(jbase.BaseExecutor):
    loss_fn = staticmethod(_linear_jax)


def _jax_executor(case):
    """The JAX executor of `case` (built once: its jitted step is reused),
    reset to its initial state."""
    if case not in _CACHE:
        jex = _JaxExecutor(None, _jax_flmr_params(),
                           jbase.TrainConfig(**CASES[case]), quiet=True)
        _CACHE[case] = (jex, jax.device_get(jex.state))
    jex, state0 = _CACHE[case]
    jex.state = jax.device_put(state0)
    jex.logger.history.clear()
    return jex


def _port_executor(case):
    ex = tbase.BaseExecutor(
        FLMRRetriever(FLMRModelConfig.tiny(bert=BertConfig.tiny(**BERT),
                                           **FLMR)),
        tbase.TrainConfig(**CASES[case]), device="cpu", quiet=True)
    ex.loss_fn = _linear_port(ex)
    ex.load_params_tree(_jax_flmr_params())
    return ex


def _grads(params, step):
    """Step `step`'s gradient tree in the JAX layout (one leaf all zero,
    as a parameter no loss term reaches)."""
    rng = np.random.default_rng(1000 + step)
    out = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * 3).astype(np.float32), params)
    if "linear" in out:
        out["linear"]["kernel"] *= 0
    return out


def _steps(jex, tex, steps):
    for i in steps:
        g = _grads(jax.device_get(jex.state.params) if jex is not None
                   else tex._to_flax(tex._named_params()), i)
        if jex is not None:
            jex.train_step(jax.tree.map(jnp.asarray, g))
        if tex is not None:
            tex.train_step(tex._from_flax(g))


def _jax_tree(jex):
    st = jax.device_get(jex.state)
    return {"params": serialization.to_state_dict(st.params),
            "opt_state": serialization.to_state_dict(st.opt_state),
            "rng": np.asarray(st.rng), "step": np.asarray(st.step)}


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            out.update(_flat(v, path + (str(k),)))
        else:
            out[path + (str(k),)] = v
    return out


def _assert_trees(got, want, exact=False):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        if isinstance(w[k], dict):
            assert isinstance(g[k], dict) and not g[k], k
            continue
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if exact or a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg="/".join(k))
        else:
            np.testing.assert_allclose(a, b, err_msg="/".join(k), **TOL)


def _missing(history):
    return [r for r in history if "ckpt_opt_state_missing" in r]


# ---------------------------------------------------------------------------
# msgpack checkpoints
# ---------------------------------------------------------------------------

CKPT_FILES = ["opt_state.msgpack", "params.msgpack", "rng.msgpack",
              "step.json"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fresh_checkpoint_bytes_equal_jax(case, tmp_path):
    """A fresh executor's checkpoint, the optimizer's optax tree
    included, is byte-equal to the JAX executor's."""
    jex, tex = _jax_executor(case), _port_executor(case)
    jex.save_checkpoint(str(tmp_path / "j"))
    tex.save_checkpoint(str(tmp_path / "t"))
    assert sorted(os.listdir(tmp_path / "t")) == CKPT_FILES
    for name in CKPT_FILES:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    with open(tmp_path / "t" / "opt_state.msgpack", "rb") as f:
        assert f.read() == serialization.to_bytes(
            jax.device_get(jex.tx.init(jex.state.params)))


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_resume_across_packages(case, tmp_path):
    """JAX n steps -> the port m -> JAX k, against JAX's n + m + k steps;
    n lands inside an accumulation window."""
    every = max(OPT_CASES[case].get("accumulate_grad_batches", 1), 1)
    n, m = 2 * every + 1, 2 * every
    jex, tex = _jax_executor(case), _port_executor(case)
    _steps(jex, None, range(n))
    jex.save_checkpoint(str(tmp_path / "j"))
    tex.load_checkpoint(str(tmp_path / "j"))
    assert not _missing(tex.logger.history)
    assert tex.step == n and tex.optimizer.micro == n % every
    _assert_trees(tex.checkpoint_state(), _jax_tree(jex), exact=True)
    _steps(jex, tex, range(n, n + m))
    _assert_trees(tex.checkpoint_state(), _jax_tree(jex))

    tex.save_checkpoint(str(tmp_path / "t"))
    assert (tmp_path / "t" / "rng.msgpack").read_bytes() == \
        serialization.to_bytes(jax.device_get(jex.state.rng))
    uninterrupted = jax.device_get(jex.state)
    jex.load_checkpoint(str(tmp_path / "t"))
    assert not _missing(jex.logger.history)
    assert int(jex.state.step) == n + m
    _steps(jex, None, range(n + m, n + 2 * m))
    resumed = _jax_tree(jex)
    jex.state = jax.device_put(uninterrupted)
    _steps(jex, None, range(n + m, n + 2 * m))
    _assert_trees(resumed, _jax_tree(jex))


def test_rng_msgpack_after_steps_equals_jax(tmp_path):
    """The key after N steps, each splitting it once, byte for byte."""
    jex, tex = _jax_executor("plain"), _port_executor("plain")
    _steps(jex, tex, range(5))
    tex.save_checkpoint(str(tmp_path / "t"))
    jex.save_checkpoint(str(tmp_path / "j"))
    assert (tmp_path / "t" / "rng.msgpack").read_bytes() == \
        (tmp_path / "j" / "rng.msgpack").read_bytes()
    np.testing.assert_array_equal(tex.rng_key, np.asarray(jex.state.rng))


def test_prng_split_matches_jax():
    keys = np.random.default_rng(0).integers(
        0, 2 ** 32, size=(1000, 2), dtype=np.uint64).astype(np.uint32)
    split = jax.jit(jax.vmap(lambda k: jax.random.split(k, 3)))
    want = np.asarray(split(jnp.asarray(keys)))
    got = np.stack([prng.split(k, 3) for k in keys])
    np.testing.assert_array_equal(got, want)
    for seed in (0, 1, 7, 2 ** 31 + 5, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.prng_key(seed),
                                      np.asarray(jax.random.PRNGKey(seed)))


def test_params_only_checkpoint_keeps_the_key(tmp_path):
    """Without opt_state.msgpack and rng.msgpack (a params-only
    checkpoint) the port starts a fresh optimizer, keeps its key and logs
    ckpt_opt_state_missing, as the JAX executor does."""
    jex, tex = _jax_executor("accum2_clip"), _port_executor("accum2_clip")
    _steps(jex, None, range(3))
    jex.save_checkpoint(str(tmp_path / "j"))
    for name in ("opt_state.msgpack", "rng.msgpack"):
        os.remove(tmp_path / "j" / name)
    jex.state = jax.device_put(_CACHE["accum2_clip"][1])
    key = tex.rng_key.copy()
    tex.load_checkpoint(str(tmp_path / "j"))
    jex.load_checkpoint(str(tmp_path / "j"))
    assert len(_missing(tex.logger.history)) == 1 == \
        len(_missing(jex.logger.history))
    assert tex.step == 3 and tex.optimizer.updates == 0
    np.testing.assert_array_equal(tex.rng_key, key)
    _assert_trees(tex.checkpoint_state(), _jax_tree(jex), exact=True)


def test_serving_checkpoint_equals_jax_and_loads_params_only(tmp_path):
    """A serving executor (no optimizer) writes the JAX serving
    executor's four files, its opt_state.msgpack the empty map; a
    training executor loads that directory params-only, with
    ckpt_opt_state_missing, as the JAX executor does."""
    jex = _JaxExecutor(None, _jax_flmr_params(),
                       jbase.TrainConfig(**OPT_CASES["accum2_clip"]),
                       quiet=True, inference_only=True)
    tex = tbase.BaseExecutor(
        FLMRRetriever(FLMRModelConfig.tiny(bert=BertConfig.tiny(**BERT),
                                           **FLMR)),
        tbase.TrainConfig(**OPT_CASES["accum2_clip"]), device="cpu",
        quiet=True, inference_only=True)
    tex.load_params_tree(_jax_flmr_params())
    jex.save_checkpoint(str(tmp_path / "j"))
    tex.save_checkpoint(str(tmp_path / "t"))
    for name in CKPT_FILES:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    assert (tmp_path / "t" / "opt_state.msgpack").read_bytes() == b"\x80"
    trainer = _port_executor("accum2_clip")
    trainer.load_checkpoint(str(tmp_path / "j"))
    assert len(_missing(trainer.logger.history)) == 1
    assert trainer.step == 0 and trainer.optimizer.updates == 0


# ---------------------------------------------------------------------------
# the RAG executor
# ---------------------------------------------------------------------------

def _rag_executors():
    if "rag" not in _CACHE:
        flmr = jax_models.FLMRRetriever(jax_models.FLMRModelConfig.tiny(
            bert=jax_models.BertConfig.tiny(**BERT), **FLMR))
        gen = jax_models.T5Model(jax_models.T5Config.tiny(**T5))
        gp = gen.init(jax.random.PRNGKey(1), jnp.ones((2, 8), jnp.int32),
                      jnp.ones((2, 8), jnp.int32),
                      jnp.ones((2, 3), jnp.int32))["params"]
        jex = jrag.RagExecutor(
            flmr, _jax_flmr_params(), gen, gp, None,
            jrag.RagConfig(**RAG), jbase.TrainConfig(**RAG_TRAIN),
            quiet=True)
        jex.loss_fn = _linear_jax
        _CACHE["rag"] = (jex, jax.device_get(jex.state))
    jex, state0 = _CACHE["rag"]
    jex.state = jax.device_put(state0)
    jex.logger.history.clear()
    tex = RagExecutor(
        FLMRRetriever(FLMRModelConfig.tiny(bert=BertConfig.tiny(**BERT),
                                           **FLMR)),
        T5Model(T5Config.tiny(**T5)), None, RagConfig(**RAG),
        train_cfg=tbase.TrainConfig(**RAG_TRAIN), device="cpu", quiet=True)
    tex.loss_fn = _linear_port(tex)
    tex.load_params_tree(jax.device_get(jex.state.params))
    return jex, tex


def test_rag_resume_across_packages(tmp_path):
    """The RAG executor's tree ({"retriever", "generator": {"base",
    "lora"}}, the base frozen, retriever_lr's two groups, accumulation 2):
    fresh files byte-equal, then JAX -> port -> JAX as above."""
    jex, tex = _rag_executors()
    jex.save_checkpoint(str(tmp_path / "j0"))
    tex.save_checkpoint(str(tmp_path / "t0"))
    for name in CKPT_FILES:
        assert (tmp_path / "t0" / name).read_bytes() == \
            (tmp_path / "j0" / name).read_bytes(), name
    _steps(jex, None, range(3))
    jex.save_checkpoint(str(tmp_path / "j"))
    tex.load_checkpoint(str(tmp_path / "j"))
    assert not _missing(tex.logger.history) and tex.optimizer.micro == 1
    _steps(jex, tex, range(3, 7))
    tree = tex.checkpoint_state()
    gen = tree["opt_state"]["1"]["inner_state"]["inner_opt_state"][
        "inner_states"]["base"]["inner_state"]["0"]["mu"]["generator"]
    assert _flat(gen["lora"]) and not any(
        isinstance(v, np.ndarray) for v in _flat(gen["base"]).values())
    _assert_trees(tree, _jax_tree(jex))
    tex.save_checkpoint(str(tmp_path / "t"))
    uninterrupted = jax.device_get(jex.state)
    jex.load_checkpoint(str(tmp_path / "t"))
    assert not _missing(jex.logger.history)
    _steps(jex, None, range(7, 10))
    resumed = _jax_tree(jex)
    jex.state = jax.device_put(uninterrupted)
    _steps(jex, None, range(7, 10))
    _assert_trees(resumed, _jax_tree(jex))


# ---------------------------------------------------------------------------
# orbax
# ---------------------------------------------------------------------------

ORBAX_CASES = ["accum2_clip", "freeze", "groups_linear_wd"]


@pytest.mark.parametrize("case", ORBAX_CASES)
def test_port_orbax_restores_in_jax(case, tmp_path):
    """The port's orbax checkpoint (plain zarr, uncompressed) restores in
    the JAX executor's load_checkpoint_orbax, every value exactly."""
    jex, tex = _jax_executor(case), _port_executor(case)
    _steps(None, tex, range(3))
    tex.save_checkpoint(str(tmp_path), backend="orbax")
    assert not os.path.exists(tmp_path / "orbax" / "manifest.ocdbt")
    jex.load_checkpoint_orbax(str(tmp_path))
    assert not _missing(jex.logger.history)
    _assert_trees(_jax_tree(jex), tex.checkpoint_state(), exact=True)


@pytest.mark.parametrize("case", ORBAX_CASES)
def test_jax_orbax_restores_in_port(case, tmp_path):
    """The JAX executor's orbax checkpoint with orbax's defaults (OCDBT,
    zstd chunks) restores in the port, every value exactly."""
    jex, tex = _jax_executor(case), _port_executor(case)
    _steps(jex, None, range(3))
    jex.save_checkpoint(str(tmp_path), backend="orbax")
    assert os.path.exists(tmp_path / "orbax" / "manifest.ocdbt")
    tex.load_checkpoint_orbax(str(tmp_path))
    assert not _missing(tex.logger.history) and tex.step == 3
    _assert_trees(tex.checkpoint_state(), _jax_tree(jex), exact=True)


def test_orbax_params_and_step_only_falls_back_like_jax(tmp_path):
    """An orbax checkpoint of params and step only: both executors load
    its params and step, start a fresh optimizer, keep their key and log
    ckpt_opt_state_missing."""
    jex, tex = _jax_executor("accum2_clip"), _port_executor("accum2_clip")
    _steps(jex, None, range(3))
    st = jax.device_get(jex.state)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "orbax"), {"params": st.params,
                                         "step": st.step})
    ckptr.wait_until_finished()
    key = tex.rng_key.copy()
    jex.state = jax.device_put(_CACHE["accum2_clip"][1])
    tex.load_checkpoint_orbax(str(tmp_path))
    jex.load_checkpoint_orbax(str(tmp_path))
    assert len(_missing(tex.logger.history)) == 1 == \
        len(_missing(jex.logger.history))
    assert tex.step == 3 and tex.optimizer.updates == 0
    np.testing.assert_array_equal(tex.rng_key, key)
    _assert_trees(tex.checkpoint_state(), _jax_tree(jex), exact=True)


def test_inference_only_orbax_load_reads_no_opt_state(tmp_path):
    """A serving executor loads a full orbax checkpoint without reading
    the optimizer's arrays (their files removed here): the params, the
    step and the key restored, no ckpt_opt_state_missing."""
    src = _port_executor("accum2_clip")
    _steps(None, src, range(3))
    src.save_checkpoint(str(tmp_path), backend="orbax")
    for d in (tmp_path / "orbax").iterdir():
        if d.name.startswith("opt_state."):
            shutil.rmtree(d)
    tex = tbase.BaseExecutor(
        FLMRRetriever(FLMRModelConfig.tiny(bert=BertConfig.tiny(**BERT),
                                           **FLMR)),
        tbase.TrainConfig(**OPT_CASES["accum2_clip"]), device="cpu",
        quiet=True, inference_only=True)
    tex.load_checkpoint_orbax(str(tmp_path))
    assert tex.step == 3 and not _missing(tex.logger.history)
    np.testing.assert_array_equal(tex.rng_key, src.rng_key)
    want = src.checkpoint_state()
    _assert_trees(tex.checkpoint_state()["params"], want["params"],
                  exact=True)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_truncated_orbax_chunk_raises(writer, tmp_path):
    """A chunk cut short fails the load (the optimizer is never quietly
    reset)."""
    jex, tex = _jax_executor("accum2_clip"), _port_executor("accum2_clip")
    (tex if writer == "port" else jex).save_checkpoint(str(tmp_path),
                                                       backend="orbax")
    root = tmp_path / "orbax"
    if writer == "port":
        victim = max((p for p in root.rglob("0.0") if p.is_file()),
                     key=lambda p: p.stat().st_size)
    else:                       # the data file of the largest chunk
        where = [v for v in orbax_io.OcdbtStore(str(root)).values.values()
                 if v[0] == "file"]
        victim = root / max(where, key=lambda v: v[3])[1]
    data = victim.read_bytes()
    victim.write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match="truncated|crc32c|zstd|length"):
        _port_executor("accum2_clip").load_checkpoint_orbax(str(tmp_path))


@pytest.mark.parametrize("compression", ["zstd", "none"])
def test_ocdbt_reader_matches_tensorstore(compression, tmp_path):
    """A multi-level OCDBT B+tree (a small node size), inline and indirect
    values: every key and value the port's reader returns, as tensorstore
    lists and reads them; a flipped byte fails the node's crc32c."""
    import tensorstore as ts
    config = {"max_decoded_node_bytes": 200, "max_inline_value_bytes": 16,
              "compression": ({"id": "zstd", "level": 3}
                              if compression == "zstd" else None)}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": config}).result()
    rng = np.random.default_rng(0)
    with ts.Transaction() as txn:
        for i in range(60):
            kv.with_transaction(txn)[f"p.{i % 7}.w{i:03d}/0.0"] = \
                rng.bytes(int(rng.integers(0, 64)))
    store = orbax_io.OcdbtStore(str(tmp_path))
    keys = [k.decode() for k in kv.list().result()]
    assert sorted(store.values) == sorted(keys)
    assert any(v[0] == "file" for v in store.values.values())
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k
    node = max(p for p in (tmp_path / "d").iterdir())
    data = bytearray(node.read_bytes())
    data[data.rindex(b"\x0c\xdb\x20\xde") + 20] ^= 0xFF
    node.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        s = orbax_io.OcdbtStore(str(tmp_path))
        [s.read(k) for k in keys]


@pytest.mark.parametrize("compressor", [{"id": "zstd", "level": 1}, None])
def test_zarr_chunk_grid_matches_tensorstore(compressor, tmp_path):
    """An array written by tensorstore's zarr v2 driver in a grid of
    chunks, edge chunks included, reads back exactly."""
    import tensorstore as ts
    want = np.random.default_rng(0).normal(size=(13, 7)).astype(np.float32)
    arr = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path}/a",
                   "metadata": {"shape": [13, 7], "chunks": [4, 3],
                                "dtype": "<f4", "compressor": compressor}},
                  create=True).result()
    arr.write(want).result()

    def get(key):
        with open(tmp_path / key, "rb") as f:
            return f.read()
    np.testing.assert_array_equal(orbax_io._read_array(get, "a"), want)


# ---------------------------------------------------------------------------
# the committed JAX fixture (read on the card by chip_smoke.py)
# ---------------------------------------------------------------------------

FIXTURE_CASE = "accum2_clip"
FIXTURE_STEPS = 3


def write_fixture(path):
    """The JAX executor's checkpoint after FIXTURE_STEPS steps of
    FIXTURE_CASE's optimizer (mid accumulation window) on the tiny FLMR
    retriever: the msgpack files and orbax/ (OCDBT, zstd chunks), and
    digest.json: the model and train config to rebuild it, and
    tree_digest of {"params", "opt_state", "rng", "step"}."""
    jex = _jax_executor(FIXTURE_CASE)
    _steps(jex, None, range(FIXTURE_STEPS))
    shutil.rmtree(path, ignore_errors=True)
    jex.save_checkpoint(path)
    jex.save_checkpoint(path, backend="orbax")
    with open(os.path.join(path, "digest.json"), "w") as f:
        json.dump({"bert": BERT, "flmr": FLMR,
                   "train": OPT_CASES[FIXTURE_CASE],
                   "steps": FIXTURE_STEPS,
                   "digest": tree_digest(_jax_tree(jex))},
                  f, indent=1, sort_keys=True)


def _read_msgpack_dir(path):
    def read(name):
        with open(os.path.join(path, name), "rb") as f:
            return read_flax_msgpack(f.read())
    with open(os.path.join(path, "step.json")) as f:
        step = np.asarray(json.load(f)["step"], np.int32)
    return {"params": read("params.msgpack"),
            "opt_state": read("opt_state.msgpack"),
            "rng": read("rng.msgpack"), "step": step}


def test_committed_fixture_decodes_to_regenerated_values(tmp_path):
    """The committed fixture, read by the port's readers (msgpack and the
    orbax OCDBT + zstd path), holds the values a regeneration writes; its
    digest is theirs; a port executor resumes from either form."""
    write_fixture(str(tmp_path / "fx"))
    with open(FIXTURE + "/digest.json") as f:
        meta = json.load(f)
    with open(tmp_path / "fx" / "digest.json") as f:
        assert json.load(f) == meta
    for path in (FIXTURE, str(tmp_path / "fx")):
        for tree in (orbax_io.load(os.path.join(path, "orbax")),
                     _read_msgpack_dir(path)):
            assert tree_digest(tree) == meta["digest"]
    _assert_trees(orbax_io.load(os.path.join(FIXTURE, "orbax")),
                  _jax_tree(_CACHE[FIXTURE_CASE][0]), exact=True)
    size = sum(f.stat().st_size for f in
               __import__("pathlib").Path(FIXTURE).rglob("*") if f.is_file())
    assert size < 1 << 20
    for load in ("load_checkpoint", "load_checkpoint_orbax"):
        tex = _port_executor(FIXTURE_CASE)
        getattr(tex, load)(FIXTURE)
        assert tex.step == FIXTURE_STEPS and tex.optimizer.micro == 1
        assert tree_digest(tex.checkpoint_state()) == \
            meta["digest"]
