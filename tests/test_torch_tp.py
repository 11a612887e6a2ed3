"""Tensor parallelism of the port's towers (parallel.apply_tp) against the
JAX package's replicated forward (tests/test_tp.py): T5 (encoder-decoder
logits, the relative position bias sliced to each rank's heads) and BERT
(hidden states and pooled output), carried from the JAX parameters, on a
(data x model) mesh of 8 gloo ranks with the model axis 2 and 4 (whole
heads a rank) and 8 (T5's and BERT's 4 heads stay replicated, the MLPs
split), each rank fed its "data" slice. rtol and atol 2e-5, the JAX
test's tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from ravqa_tpu.models import bert as jax_bert
from ravqa_tpu.models import t5 as jax_t5
from ravqa_tpu_torch.models import flax_to_state_dict
from ravqa_tpu_torch.models.convert import generator_to_state_dict
from ravqa_tpu_torch.parallel import launch

TOL = dict(rtol=2e-5, atol=2e-5)


def _t5():
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 512, (8, 6)).astype(np.int64)
    mask = np.ones((8, 6), np.int64)
    mask[1, 4:] = 0
    dec = rng.integers(2, 512, (8, 3)).astype(np.int64)
    jm = jax_t5.T5Model(jax_t5.T5Config.tiny())
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                     jnp.asarray(mask), jnp.asarray(dec))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                               jnp.asarray(mask), jnp.asarray(dec)))
    state = {k: v.numpy() for k, v in
             generator_to_state_dict(jax.device_get(params)).items()}
    return state, {"ids": ids, "mask": mask, "dec": dec}, want


def _bert():
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 512, (8, 7)).astype(np.int64)
    mask = np.ones((8, 7), np.int64)
    mask[2, 5:] = 0
    jm = jax_bert.BertModel(jax_bert.BertConfig.tiny())
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                     jnp.asarray(mask))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                               jnp.asarray(mask))[0])
    state = {k: v.numpy() for k, v in
             flax_to_state_dict(jax.device_get(params)).items()}
    return state, {"ids": ids, "mask": mask}, want


AXES = (2, 4, 8)
KINDS = ("t5", "bert")


@pytest.fixture(scope="module")
def runs():
    """{(kind, model axis): (every rank's result, the JAX output)}, from
    one launch of 8 ranks."""
    worlds = {"t5": _t5(), "bert": _bert()}
    jobs = [(kind, worlds[kind][0], worlds[kind][1],
             {"data": 8 // m, "model": m}) for kind in KINDS for m in AXES]
    ranks = launch(_torch_ranks.tp_rank, 8, jobs, timeout=60,
                   join_timeout=240)
    return {(kind, m): ([r[i] for r in ranks], worlds[kind][2])
            for i, (kind, m) in enumerate((k, m) for k in KINDS
                                          for m in AXES)}


@pytest.mark.parametrize("model_axis", AXES)
@pytest.mark.parametrize("kind", KINDS)
def test_tp_forward_matches_jax_replicated(runs, kind, model_axis):
    ranks, want = runs[(kind, model_axis)]
    for got in ranks:
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["out"], want[lo:hi], **TOL)
    plan = ranks[0]["plan"]
    assert plan and all(v in ("colwise", "rowwise") for v in plan.values())
    heads_split = any(k.endswith((".q", ".query")) for k in plan)
    assert heads_split == (model_axis < 8)
