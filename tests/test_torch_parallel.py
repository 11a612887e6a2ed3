"""The port's parallel layer (ravqa_tpu_torch/parallel) against the JAX
package's on its 8-device CPU mesh (tests/conftest.py), the port's ranks
spawned as gloo processes (parallel.launch, tests/_torch_ranks.py):

- make_mesh and shard_batch: each rank's dim-0 slice of a global batch
  equals the shard JAX's shard_batch puts on the device of the same
  position, at 2, 4 and 8 ranks; axis sizes and positions, a tuple of axes
  included;
- gather_with_local_grads: the values and gradients of the JAX test
  (tests/test_cross_device_negatives.py), exactly; gather_rows, the
  differentiable all_gather that training uses: each row's gradient summed
  over every rank's copy;
- fsdp_sharding and tp_sharding: the plans over the port's parameter and
  nn.Linear names against the JAX package's specs on the same trees (a
  JAX spec's sharded dim found in the port's layout by converting a tree
  of index arrays through models.convert);
- launch: a failing rank's traceback reaches the caller and no rank is
  left running;
- choose_backend and rank_device: NCCL where each rank on the host owns a
  card (torchrun's LOCAL_WORLD_SIZE and LOCAL_RANK on several nodes),
  gloo on the CPU and where ranks share a card (the device count mocked).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_ranks
from ravqa_tpu import parallel as jpar
from ravqa_tpu.models import bert as jax_bert
from ravqa_tpu.models import flmr as jax_flmr
from ravqa_tpu.models import t5 as jax_t5
from ravqa_tpu_torch import parallel as tpar
from ravqa_tpu_torch.models import (BertConfig, BertModel, FLMRModelConfig,
                                    FLMRRetriever, T5Config, T5Model,
                                    flax_to_state_dict)
from ravqa_tpu_torch.models.convert import generator_to_state_dict
from ravqa_tpu_torch.parallel import launch


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jpar.make_mesh(axes, jax.devices()[:n])


def _batch(b=16):
    rng = np.random.default_rng(0)
    return {"ids": rng.integers(0, 100, (b, 5)),
            "feats": rng.normal(size=(b, 3)).astype(np.float32),
            "docs": rng.integers(0, 100, (2 * b, 4)),
            "names": [f"q{i}" for i in range(b)], "k": 7}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_batch_matches_jax(n):
    batch = _batch()
    ranks = launch(_torch_ranks.mesh_rank, n, batch, timeout=60,
                   join_timeout=120)
    mesh = _jax_mesh({"data": n})
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    sharded = jpar.shard_batch(arrays, mesh)
    for r, got in enumerate(ranks):
        assert got["rank"] == r and got["size"] == n
        assert got["slice"]["k"] == 7
        rows = slice(r * 16 // n, (r + 1) * 16 // n)
        assert got["slice"]["names"] == batch["names"][rows]
        for k, v in sharded.items():
            dev = mesh.devices.reshape(-1)[r]
            want = [s.data for s in v.addressable_shards if s.device == dev]
            np.testing.assert_array_equal(got["slice"][k],
                                          np.asarray(want[0]), err_msg=k)
        # a (2, n/2) mesh: the tuple ("a", "b") counts "a" first, as
        # JAX's P(("a", "b")) orders the shards
        assert got["rank_ab"] == r and got["size_ab"] == n
        assert got["rank_b"] == r % (n // 2)


def test_gather_with_local_grads_matches_jax():
    """tests/test_cross_device_negatives.py on 8 ranks: the gather sees
    every row in rank order, and under sum(g * w) / rows only the local
    copy carries the gradient, i / 16; gather_rows sums all 8 copies."""
    b, d, n = 2, 4, 8
    x = np.arange(n * b * d, dtype=np.float32).reshape(n * b, d)
    mesh = _jax_mesh({"data": n})

    def loss(x):
        def inner(x_local):
            g = jpar.gather_with_local_grads(x_local, "data")
            w = jnp.arange(g.shape[0], dtype=jnp.float32)[:, None]
            return jnp.sum(g * w, axis=0, keepdims=True) / g.shape[0]
        y = jax.shard_map(inner, mesh=mesh, in_specs=P("data"),
                          out_specs=P("data"), check_vma=False)(x)
        return jnp.sum(y)

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(x)))
    ranks = launch(_torch_ranks.gather_rank, n, x, timeout=60,
                   join_timeout=120)
    for r, got in enumerate(ranks):
        rows = slice(r * b, (r + 1) * b)
        for name in ("local", "rows"):
            np.testing.assert_array_equal(got[name][0], x)
        np.testing.assert_allclose(got["local"][1], want[rows], rtol=1e-6)
        np.testing.assert_allclose(got["rows"][1], n * want[rows],
                                   rtol=1e-6)


def _port_dims(tree, specs, to_state_dict) -> dict:
    """{port name: the port dim a JAX spec shards, or None}: a tree of the
    index along each leaf's sharded dim (zeros where replicated), through
    the converter; the port dim is the one along which the values vary."""
    def marks(leaf, spec):
        a = np.asarray(leaf)
        dims = [d for d, s in enumerate(tuple(spec.spec)) if s is not None]
        return (np.indices(a.shape)[dims[0]].astype(np.float32) + 1
                if dims else np.zeros(a.shape, np.float32))
    marked = jax.tree.map(marks, tree, specs)
    out = {}
    for k, v in to_state_dict(jax.device_get(marked)).items():
        a = v.numpy()
        vary = [d for d in range(a.ndim)
                if not np.all(a.max(axis=d) == a.min(axis=d))]
        assert len(vary) <= 1, (k, vary)
        out[k] = vary[0] if vary else None
    return out


def _flmr_pair(seed=0):
    cfg = FLMRModelConfig.tiny(separate_question_encoder=True)
    jcfg = jax_flmr.FLMRModelConfig(
        bert=jax_bert.BertConfig(**vars(cfg.bert)), dim=cfg.dim,
        vision_dim=cfg.vision_dim, prefix_len=cfg.prefix_len,
        separate_question_encoder=True)
    jm = jax_flmr.FLMRRetriever(jcfg)
    b = dict(query_input_ids=jnp.ones((2, 8), jnp.int32),
             query_attention_mask=jnp.ones((2, 8), jnp.int32),
             image_features=jnp.ones((2, cfg.vision_dim), jnp.float32),
             doc_input_ids=jnp.ones((4, 8), jnp.int32),
             doc_attention_mask=jnp.ones((4, 8), jnp.int32))
    params = jm.init(jax.random.PRNGKey(seed), **b)["params"]
    model = FLMRRetriever(cfg)
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    return params, model


@pytest.mark.parametrize("n,min_size", [(8, 1024), (4, 1024), (2, 64),
                                        (8, 2 ** 18)])
def test_fsdp_plan_matches_jax(n, min_size):
    params, model = _flmr_pair()
    specs = jpar.fsdp_sharding(params, _jax_mesh({"data": n}),
                               min_size=min_size)
    want = _port_dims(params, specs, flax_to_state_dict)
    mesh = types.SimpleNamespace(mesh_dim_names=("data",), shape=(n,))
    heads = {"doc_encoder": 4, "query_encoder": 4}
    got = tpar.fsdp_sharding(model, mesh, "data", min_size, heads)
    assert got == want
    assert any(v is not None for v in got.values()) == (min_size < 2 ** 18)


def _t5_params():
    jm = jax_t5.T5Model(jax_t5.T5Config.tiny())
    ids = jnp.ones((2, 6), jnp.int32)
    return jax.device_get(jm.init(jax.random.PRNGKey(0), ids, ids,
                                  jnp.ones((2, 3), jnp.int32))["params"])


def _bert_params():
    jm = jax_bert.BertModel(jax_bert.BertConfig.tiny())
    ids = jnp.ones((2, 6), jnp.int32)
    return jax.device_get(jm.init(jax.random.PRNGKey(0), ids, ids)["params"])


@pytest.mark.parametrize("model_axis", [2, 4, 8])
@pytest.mark.parametrize("kind", ["t5", "bert"])
def test_tp_plan_matches_jax(kind, model_axis):
    """Column-parallel where the JAX spec shards the port weight's dim 0
    (the Flax kernel's output, or a 3-D kernel's heads), row-parallel
    where it shards dim 1; at 8 the 4 heads cannot split whole, and both
    packages replicate the attention."""
    if kind == "t5":
        params, conv = _t5_params(), generator_to_state_dict
        model = T5Model(T5Config.tiny())
    else:
        params, conv = _bert_params(), flax_to_state_dict
        model = BertModel(BertConfig.tiny())
    mesh = _jax_mesh({"data": 8 // model_axis, "model": model_axis})
    want = _port_dims(params, jpar.tp_sharding(params, mesh), conv)
    plan = tpar.tp_sharding(
        model, types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                     shape=(8 // model_axis, model_axis)),
        "model")
    got = {f"{m}.weight": {"colwise": 0, "rowwise": 1}[v]
           for m, v in plan.items()}
    expected = {k: v for k, v in want.items() if v is not None}
    assert got == expected and plan


def test_a_failing_rank_reports_its_traceback():
    with pytest.raises(RuntimeError,
                       match=r"(?s)rank 1 failed.*ZeroDivision"):
        launch(_torch_ranks.fail_on_rank_1, 3, timeout=30, join_timeout=60)


# (device, world size, LOCAL_WORLD_SIZE or None, cards on the host,
#  the backend, the device of rank 9 with LOCAL_RANK 1)
BACKEND_CASES = [
    ("cpu", 4, None, 8, "gloo", "cpu"),
    ("cuda", 4, None, 8, "nccl", "cuda:9"),
    ("cuda", 4, None, 1, "gloo", "cuda:0"),
    ("cuda", 16, None, 8, "gloo", "cuda:0"),   # spawned: 16 ranks, 8 cards
    ("cuda", 16, 8, 8, "nccl", "cuda:1"),      # torchrun, 2 nodes x 8 cards
    ("cuda", 16, 4, 2, "gloo", "cuda:0"),      # 4 ranks a node, 2 cards
]


@pytest.mark.parametrize("device,world,local,cards,backend,dev",
                         BACKEND_CASES)
def test_backend_rule(monkeypatch, device, world, local, cards, backend,
                      dev):
    from ravqa_tpu_torch.parallel import mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
        monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.choose_backend(device, world) == backend
    assert str(mesh.rank_device(device, 9, backend)) == dev
