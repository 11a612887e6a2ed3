"""The port loads the JAX package's checkpoints.

The JAX executor's `save_checkpoint` (a directory with params.msgpack,
opt_state.msgpack, rng.msgpack and step.json) and `save_params` (one flax
msgpack file) write `model.init` parameters; the port's executor loads
both, from the file and from the directory, through its own msgpack
decoder (models/convert.py: no flax, no msgpack package), and `build_server`
finds `<log_dir>/ckpt/params.msgpack` on its own.

Tolerance on query embeddings: atol 1e-5, rtol 1e-4, as
tests/test_torch_models.py (float32 on both sides, reductions ordered
differently by XLA and PyTorch).
"""

import os
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
    from flax import serialization
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.array([1, -2], np.int32),
                  "d": jax.numpy.asarray([1.5, -2.25], jax.numpy.bfloat16)}}
    got = read_flax_msgpack(serialization.to_bytes(tree))
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert got["a"].dtype == np.float32 and got["a"].shape == (2, 3)
    np.testing.assert_array_equal(got["b"]["c"], tree["b"]["c"])
    np.testing.assert_array_equal(got["b"]["d"], [1.5, -2.25])


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
