"""The port and the JAX package load each other's checkpoints.

The JAX executor's `save_checkpoint` (a directory with params.msgpack,
opt_state.msgpack, rng.msgpack and step.json) and `save_params` (one flax
msgpack file) write `model.init` parameters; the port's executor loads
both, from the file and from the directory, through its own msgpack
decoder (models/convert.py: no flax, no msgpack package), and `build_server`
finds `<log_dir>/ckpt/params.msgpack` on its own. The port writes the same
four files, which the JAX executor loads whole; the optimizer's state and
the orbax backend are held to the JAX package's in
tests/test_torch_opt_state.py.

Tolerance on query embeddings: atol 1e-5, rtol 1e-4, as
tests/test_torch_models.py (float32 on both sides, reductions ordered
differently by XLA and PyTorch).
"""

import json
import os
import shutil
import struct

import jax
import msgpack
import numpy as np
import pytest
import torch

from ravqa_tpu.config import load_config as jax_load_config
from ravqa_tpu_torch.config import load_config
from ravqa_tpu_torch.models import read_flax_msgpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "synthetic_flmr.json")
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX executor on the tiny config, its checkpoint directory and
    params file, a batch of queries and the JAX embeddings of it."""
    from ravqa_tpu import main as jax_main
    from ravqa_tpu.executors.base import save_params
    tmp = tmp_path_factory.mktemp("ckpt")
    cfg = jax_load_config(CONFIG)
    data = jax_main.build_pipeline(cfg, cache_dir=None).get_data(
        cfg.data_pipeline_output_node, explode=True)
    ex = jax_main.build_executor(cfg, data, None, str(tmp / "log"),
                                 quiet=True)
    ckpt = tmp / "log" / "ckpt"
    ex.save_checkpoint(str(ckpt))
    params_file = tmp / "model.params"
    save_params(ex.state.params, str(params_file))
    batch = data["test"].collate(list(range(4)))
    want = ex.encode_queries([batch])
    return dict(ex=ex, ckpt=str(ckpt), file=str(params_file),
                log=str(tmp / "log"), batch=batch, want=want)


def _port_executor(seed=123):
    from ravqa_tpu_torch import main as torch_main
    from ravqa_tpu_torch.config import apply_overrides
    cfg = apply_overrides(load_config(CONFIG), [f"seed={seed}"])
    return torch_main.build_executor(cfg, "cpu")


def _embed(ex, batch):
    return ex.encode_query(batch["query_input_ids"],
                           batch["query_attention_mask"],
                           batch["image_features"]).numpy()


@pytest.mark.parametrize("where", ["directory", "params_msgpack", "file"])
def test_port_loads_jax_checkpoints(saved, where):
    path = {"directory": saved["ckpt"],
            "params_msgpack": os.path.join(saved["ckpt"], "params.msgpack"),
            "file": saved["file"]}[where]
    ex = _port_executor()
    before = _embed(ex, saved["batch"])
    ex.load_checkpoint(path)
    got = _embed(ex, saved["batch"])
    assert got.shape == saved["want"].shape
    np.testing.assert_allclose(got, saved["want"], **TOL)
    assert not np.allclose(before, saved["want"], **TOL)   # weights moved


def test_build_server_finds_the_jax_checkpoint(saved):
    """<log_dir>/ckpt/params.msgpack, the JAX serve's own auto-load path,
    is loaded without train.load_model_path."""
    from ravqa_tpu_torch import main as torch_main
    cfg = load_config(CONFIG)
    data = torch_main.build_pipeline(cfg).get_data(
        cfg.data_pipeline_output_node, explode=True)
    server = torch_main.build_server(cfg, data, "cpu", saved["log"])
    try:
        sd = server.ex.model.state_dict()
        want = np.asarray(saved["ex"].state.params["linear"]["kernel"]).T
        np.testing.assert_array_equal(sd["linear.weight"].numpy(), want)
    finally:
        server.stop()


def test_msgpack_reader_matches_msgpack():
    """Every msgpack form flax writes, decoded as the msgpack package
    decodes it: ints of every width and sign, floats, str and bin of every
    length class, nil, bools, nested maps and arrays (fix, 16 and 32)."""
    tree = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                     2 ** 32, 2 ** 63, -1, -32, -33, -128, -129, -32768,
                     -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
            "floats": [0.5, -1.25e-7, 3.0e38],
            "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                     "e" * 70000, "héllo"],
            "bins": [b"", b"\x00" * 300, b"\x01" * 70000],
            "misc": [None, True, False],
            "big_array": list(range(20)), "nested": {"x": {"y": [[], {}]}},
            **{f"k{i}": i for i in range(20)}}
    data = msgpack.packb(tree, use_bin_type=True)
    assert read_flax_msgpack(data) == msgpack.unpackb(data, raw=False,
                                                      strict_map_key=False)
    f32 = msgpack.packb(struct.unpack(">f", struct.pack(">f", 1.5))[0],
                        use_single_float=True)
    assert read_flax_msgpack(f32) == 1.5


def test_msgpack_reader_decodes_flax_arrays():
    """flax's arrays (float32, int32, bf16), the optimizer state's int32
    scalars, the key's uint32 pair and empty maps (optax's MaskedNode and
    EmptyState) read back; write_flax_msgpack writes flax's bytes for
    them, a FieldDict in its own order as flax writes a namedtuple."""
    from flax import serialization
    from ravqa_tpu_torch.models.convert import FieldDict, write_flax_msgpack
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.array([1, -2], np.int32),
                  "d": jax.numpy.asarray([1.5, -2.25], jax.numpy.bfloat16)},
            "e": {"count": np.asarray(3, np.int32),
                  "key": np.array([0, 5], np.uint32), "masked": {}}}
    data = serialization.to_bytes(tree)
    got = read_flax_msgpack(data)
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert got["a"].dtype == np.float32 and got["a"].shape == (2, 3)
    np.testing.assert_array_equal(got["b"]["c"], tree["b"]["c"])
    np.testing.assert_array_equal(got["b"]["d"], [1.5, -2.25])
    assert got["e"]["count"].shape == () and got["e"]["count"] == 3
    assert got["e"]["count"].dtype == np.int32
    assert got["e"]["key"].dtype == np.uint32 and got["e"]["masked"] == {}
    assert write_flax_msgpack(jax.tree.map(np.asarray, tree)) == data
    from optax import MultiStepsState
    state = MultiStepsState(np.asarray(1, np.int32), np.asarray(2, np.int32),
                            {}, {"w": np.ones(2, np.float32)}, ())
    fields = FieldDict((k, serialization.to_state_dict(getattr(state, k)))
                       for k in state._fields)
    assert list(fields) != sorted(fields)
    assert write_flax_msgpack(fields) == serialization.to_bytes(state)


def test_msgpack_reader_rejects_what_flax_params_do_not_use():
    ext5 = b"\x81\xa1a\xd4\x05\x00"              # {"a": fixext1 type 5}
    with pytest.raises(ValueError, match="ext type 5"):
        read_flax_msgpack(ext5)
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True,
                                   "shape": [2], "chunks": {}}})
    with pytest.raises(ValueError, match="chunked"):
        read_flax_msgpack(chunked)
    with pytest.raises(ValueError, match="0xc1"):
        read_flax_msgpack(b"\xc1")
    with pytest.raises(ValueError, match="truncated"):
        read_flax_msgpack(msgpack.packb("abc")[:-1])
    with pytest.raises(ValueError, match="trailing"):
        read_flax_msgpack(msgpack.packb(1) + b"\x00")


# ---------------------------------------------------------------------------
# the port's own checkpoints (the trainer's save_checkpoint)
# ---------------------------------------------------------------------------

# warmup + linear decay + accumulation: the state a params-only resume
# would reset (schedule position, Adam's moments, the accumulator)
RESUME_OPTS = ["train.lr=1e-3", "train.warmup_steps=4", "train.total_steps=8",
               "train.schedule=linear", "train.accumulate_grad_batches=2"]


@pytest.fixture(scope="module")
def port_world():
    from ravqa_tpu_torch import main as torch_main
    from ravqa_tpu_torch.config import apply_overrides
    cfg = apply_overrides(load_config(CONFIG), RESUME_OPTS)
    data = torch_main.build_pipeline(cfg).get_data(
        cfg.data_pipeline_output_node, explode=True)
    loader = data["train"].loader(batch_size=4, shuffle=True, seed=0)
    return cfg, [next(loader) for _ in range(8)]


def _trainer(cfg, log_dir=None):
    from ravqa_tpu_torch import main as torch_main
    return torch_main.build_executor(cfg, "cpu", log_dir=log_dir)


def _state(ex):
    return {k: v.clone() for k, v in ex.model.state_dict().items()}


def test_port_checkpoint_loads_in_jax(saved, port_world, tmp_path):
    """params.msgpack from the port's save_checkpoint decodes with the JAX
    package's load_params on a model.init template: the same tree, the
    port's values; the JAX executor of the same train config loads the
    whole directory, its optimizer's state and key included
    (tests/test_torch_opt_state.py holds those to JAX's values)."""
    from ravqa_tpu.config import apply_overrides as jax_overrides
    from ravqa_tpu.executors.base import load_params as jax_load_params
    from ravqa_tpu_torch.models import flax_to_state_dict
    cfg, batches = port_world
    ex = _trainer(cfg)
    ex.train_step(batches[0])
    ex.train_step(batches[1])
    ex.save_checkpoint(str(tmp_path / "ck"))
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "opt_state.msgpack", "params.msgpack", "rng.msgpack", "step.json"]
    template = jax.device_get(saved["ex"].state.params)
    tree = jax_load_params(template,
                           str(tmp_path / "ck" / "params.msgpack"))
    assert jax.tree.structure(tree) == jax.tree.structure(template)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(template)):
        assert a.shape == b.shape and a.dtype == b.dtype
    got = flax_to_state_dict(jax.device_get(tree))
    for k, v in ex.model.state_dict().items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy())
    from ravqa_tpu import main as jax_main
    jcfg = jax_overrides(jax_load_config(CONFIG), RESUME_OPTS)
    jdata = jax_main.build_pipeline(jcfg, cache_dir=None).get_data(
        jcfg.data_pipeline_output_node, explode=True)
    jex = jax_main.build_executor(jcfg, jdata, None, str(tmp_path / "j"),
                                  quiet=True)
    jex.load_checkpoint(str(tmp_path / "ck"))
    assert int(jex.state.step) == 2
    assert not any(r.get("ckpt_opt_state_missing")
                   for r in jex.logger.history)
    np.testing.assert_array_equal(np.asarray(jex.state.rng), ex.rng_key)
    mini = jax.device_get(jex.state.opt_state).mini_step
    assert int(mini) == ex.optimizer.micro == 0
    np.testing.assert_array_equal(
        np.asarray(jex.state.params["linear"]["kernel"]),
        ex.model.linear.weight.detach().numpy().T)


def test_params_msgpack_bytes_equal_flax(saved):
    """write_flax_msgpack gives flax.serialization.to_bytes' bytes for the
    JAX executor's own params tree."""
    from flax import serialization
    from ravqa_tpu_torch.models.convert import write_flax_msgpack
    tree = jax.device_get(saved["ex"].state.params)
    tree = jax.tree.map(np.asarray, tree)
    assert write_flax_msgpack(tree) == serialization.to_bytes(tree)


@pytest.mark.parametrize("split", [4, 3])
def test_resume_parity(port_world, tmp_path, split):
    """`split` steps, save, a fresh executor loads, the rest: the same
    parameters as 8 steps in one run, bit for bit. split 3 saves in the
    middle of an accumulation window (tests/test_checkpoint_resume.py)."""
    cfg, batches = port_world
    ex = _trainer(cfg)
    for b in batches:
        ex.train_step(b)
    want = _state(ex)
    ex1 = _trainer(cfg)
    for b in batches[:split]:
        ex1.train_step(b)
    ex1.save_checkpoint(str(tmp_path / "ck"))
    ex2 = _trainer(cfg)
    ex2.load_checkpoint(str(tmp_path / "ck"))
    assert ex2.step == split
    assert ex2.optimizer.micro == split % 2
    for b in batches[split:]:
        ex2.train_step(b)
    got = _state(ex2)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert ex2.optimizer.updates == 4


def test_params_only_checkpoint_loads_with_fresh_optimizer(port_world,
                                                          saved, tmp_path):
    """A directory without opt_state.msgpack (a params-only checkpoint,
    the port's or the JAX package's) loads its params and step; the
    optimizer starts afresh and ckpt_opt_state_missing is logged, as the
    JAX package does."""
    cfg, batches = port_world
    ex = _trainer(cfg)
    ex.train_step(batches[0])
    ex.save_checkpoint(str(tmp_path / "ck"))
    os.remove(tmp_path / "ck" / "opt_state.msgpack")
    ex2 = _trainer(cfg)
    ex2.load_checkpoint(str(tmp_path / "ck"))
    assert ex2.step == 1 and ex2.optimizer.updates == 0
    assert [r["ckpt_opt_state_missing"] for r in ex2.logger.history
            if "ckpt_opt_state_missing" in r] == [1]
    ex2.train_step(batches[1])                      # trains on from there
    shutil.copytree(saved["ckpt"], tmp_path / "jax")  # the JAX checkpoint
    os.remove(tmp_path / "jax" / "opt_state.msgpack")
    ex3 = _trainer(cfg)
    ex3.load_checkpoint(str(tmp_path / "jax"))
    with open(os.path.join(saved["ckpt"], "step.json")) as f:
        assert ex3.step == json.load(f)["step"]
    assert any(r.get("ckpt_opt_state_missing") for r in ex3.logger.history)
    np.testing.assert_array_equal(
        ex3.model.linear.weight.detach().numpy(),
        read_flax_msgpack(open(os.path.join(saved["ckpt"], "params.msgpack"),
                               "rb").read())["linear"]["kernel"].T)


def test_serving_executor_loads_a_training_checkpoint(port_world, tmp_path):
    """An inference_only executor (build_server's) loads a full checkpoint
    and builds no optimizer state (C5)."""
    from ravqa_tpu_torch import main as torch_main
    cfg, batches = port_world
    ex = _trainer(cfg)
    ex.train_step(batches[0])
    ex.save_checkpoint(str(tmp_path / "ck"))
    srv = torch_main.build_executor(cfg, "cpu", inference_only=True)
    srv.load_checkpoint(str(tmp_path / "ck"))
    assert srv.optimizer is None and srv.step == 1
    assert not srv.logger.history
    for k, v in ex.model.state_dict().items():
        assert torch.equal(srv.model.state_dict()[k], v)


class _FakeExecutor:
    def save_checkpoint(self, path):
        os.makedirs(path, exist_ok=True)
        open(os.path.join(path, "params.msgpack"), "w").write("x")


def test_checkpoint_manager_keeps_top_k(tmp_path):
    """executors.callbacks, the JAX package's host-only copy
    (tests/test_callbacks.py)."""
    from ravqa_tpu_torch.executors.callbacks import CheckpointManager
    cm = CheckpointManager(str(tmp_path), monitor="recall_at_5", mode="max",
                           save_top_k=2, save_last=True)
    ex = _FakeExecutor()
    assert cm.on_validation(ex, {"recall_at_5": 0.5}, 10) is True
    assert cm.on_validation(ex, {"recall_at_5": 0.7}, 20) is True
    assert cm.on_validation(ex, {"recall_at_5": 0.6}, 30) is False
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step"))
    assert kept == ["step_20", "step_30"]
    assert cm.best_value == 0.7
    assert os.path.exists(tmp_path / "last")
    assert cm.on_validation(ex, {"recall_at_5": 0.55}, 40) is False
    assert not os.path.exists(tmp_path / "step_40")


@pytest.mark.parametrize("mode,vals,stops,patience", [
    ("max", [0.5, 0.6, 0.55, 0.58, 0.59], [False] * 4 + [True], 2),
    ("min", [1.0, 0.9, 0.95, 0.95], [False] * 3 + [True], 1)])
def test_early_stopping(mode, vals, stops, patience):
    from ravqa_tpu_torch.executors.callbacks import EarlyStopping
    es = EarlyStopping(monitor="m", mode=mode, patience=patience)
    assert [es.update({"m": v}) for v in vals] == stops
