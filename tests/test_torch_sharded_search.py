"""The port's sharded search against the JAX package's on its CPU mesh.

The same cluster-ordered corpus (tests/test_torch_search.py's _clustered,
384 docs) is indexed by both packages over an "index" axis of 2, 4 and 8
shards: the JAX package on its 8-device CPU mesh (tests/conftest.py), the
port on as many gloo ranks (parallel.launch, tests/_torch_ranks.py), one
launch per shard count running every case. Float32, int8, and residual
indexes (flat and factored codecs trained by the JAX package on the global
tokens and carried into the port, as tests/test_torch_search.py does) are
searched in every mode and preset, use_pallas=False on both sides (the
JAX package's route on the CPU, its math in plain PyTorch in the port):
exact, two-stage, hierarchical with the fast preset's int8 doc and block
summaries and the stage-1 rows (aligned at 2 shards; at 4 and 8 a shard's
3-6 blocks miss the TPU kernel's lane rule, JAX's rows_fallback, and the
shard sweeps its rows over JAX's unaligned blocks, as K4 does on the
card), a k beyond what the requested blocks cover, centroid
pruning and a truncated coarse query.

Scores within rtol 1e-5 and atol 1e-4 per query token
(tests/test_torch_search.py's tolerance); rankings tie-aware: each pid the
port returns carries, in the JAX package's exact scores of every doc, the
score the port reports, and the top-k sets agree. Every rank returns the
same merged result.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from ravqa_tpu.ops import residual as jax_residual
from ravqa_tpu.ops.maxsim import maxsim_search_xla
from ravqa_tpu.parallel import make_mesh as jax_make_mesh
from ravqa_tpu.retrieval import index as jax_index
from ravqa_tpu.retrieval import search as jax_search
from ravqa_tpu_torch.parallel import launch
from test_torch_search import _clustered, _exact_scores, assert_tie_aware

SHARDS = (2, 4, 8)
BLOCK = 16
N_CAND = dict(n_candidates=40)
# (name, index kind, searcher kwargs, k)
SPECS = [
    ("exact_f32", "f32", {}, 10),
    ("exact_int8", "int8", {}, 10),
    ("two_stage", "f32", dict(mode="two_stage", **N_CAND), 5),
    ("two_stage_fast", "f32", dict(mode="two_stage", preset="fast"), 5),
    ("two_stage_int8", "int8", dict(mode="two_stage", **N_CAND), 5),
    ("two_stage_coarse_q", "f32", dict(mode="two_stage", coarse_query_len=3,
                                       **N_CAND), 5),
    ("hier", "f32", dict(mode="hierarchical", n_blocks=6, **N_CAND), 5),
    ("hier_fast", "f32", dict(mode="hierarchical", preset="fast",
                              **N_CAND), 5),
    ("hier_fast_rows", "f32", dict(mode="hierarchical", preset="fast",
                                   stage1_kernel=True, **N_CAND), 5),
    ("hier_int8_index", "int8", dict(mode="hierarchical", preset="fast",
                                     **N_CAND), 5),
    ("hier_k_beyond_blocks", "f32", dict(mode="hierarchical", n_blocks=2,
                                         **N_CAND), 20),
    ("residual_two_stage", "flat", dict(mode="two_stage",
                                        centroid_prune=16, **N_CAND), 5),
    ("residual_hier_fast", "flat", dict(mode="hierarchical", preset="fast",
                                        **N_CAND), 5),
    ("factored_two_stage", "factored", dict(mode="two_stage", **N_CAND), 5),
    ("factored_hier_prune", "factored", dict(
        mode="hierarchical", n_blocks=6, centroid_prune=16, **N_CAND), 5),
]
NAMES = [s[0] for s in SPECS]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    embs, masks, q = _clustered(seed=5)
    pids = np.arange(1000, 1000 + len(embs))
    toks = embs.astype(np.float32)
    codecs = {
        "flat": jax_residual.train_codec(toks, masks, n_centroids=32,
                                         nbits=2),
        "factored": jax_residual.train_codec_factored(
            toks, masks, k_coarse=4, k_fine=8, nbits=2)}
    return embs, masks, pids, q, codecs


def _arrays(jc) -> dict:
    def a(x):
        return None if x is None else np.array(x)
    return dict(centroids=a(jc.centroids), bucket_cutoffs=a(jc.bucket_cutoffs),
                bucket_weights=a(jc.bucket_weights), nbits=jc.nbits,
                coarse=a(jc.coarse), fine=a(jc.fine))


@pytest.fixture(scope="module")
def port(world):
    """{shards: every rank's results}, one launch per shard count."""
    embs, masks, pids, q, codecs = world
    arrays = {k: _arrays(v) for k, v in codecs.items()}
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = launch(_torch_ranks.search_rank, n, SPECS, embs,
                              masks, pids, q, arrays, BLOCK, timeout=60,
                              join_timeout=300)
        return cache[n]
    return get


def _jax_index(world, kind, mesh):
    embs, masks, pids, _, codecs = world
    kw = {} if mesh is None else dict(mesh=mesh, axis="index")
    idx = jax_index.build_index_from_embeddings(
        embs, masks, pids=pids, pad_multiple=8, dtype=jnp.float32, **kw)
    idx.build_summaries(n_summary=4, **kw)
    idx.build_block_summaries(block_size=BLOCK, **kw)
    if kind == "int8":
        idx.quantize_int8()
    elif kind in codecs:
        idx.quantize_residual(codec=codecs[kind], **kw)
    return idx


@pytest.fixture(scope="module")
def jax_side(world):
    @functools.lru_cache(maxsize=None)
    def index(n, kind):
        mesh = None if n == 1 else jax_make_mesh({"index": n},
                                                 jax.devices()[:n])
        return mesh, _jax_index(world, kind, mesh)

    @functools.lru_cache(maxsize=None)
    def exact(kind):
        jidx = index(1, kind)[1]
        if jidx.scales is None and jidx.tokens is not None:
            return np.asarray(maxsim_search_xla(jnp.asarray(world[3]),
                                                jidx.tokens, jidx.mask))
        return _exact_scores(jidx, world[3])
    return index, exact


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_search_matches_jax(port, jax_side, world, n, name):
    _, kind, kw, k = SPECS[NAMES.index(name)]
    q = world[3]
    index, exact = jax_side
    mesh, jidx = index(n, kind)
    with warnings.catch_warnings():
        # the JAX searcher warns where the lane rule narrows a cut
        warnings.simplefilter("ignore")
        js = jax_search.LateInteractionSearcher(
            jidx, mesh=mesh, axis="index", use_pallas=False,
            approx_topk=False, **kw)
        want_s, want_p = js.search(q, k=k)
    ranks = port(n)
    got_s, got_p, cuts = ranks[0][name]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name][1], got_p)
        np.testing.assert_array_equal(r[name][0], got_s)
    assert got_s.shape == got_p.shape == (q.shape[0], k)
    single = index(1, kind)[1]
    assert_tie_aware(got_s, got_p, exact(kind), want_s, q.shape[1],
                     single.pids)
    np.testing.assert_array_equal(np.sort(got_p, 1), np.sort(want_p, 1))
    if name == "hier_fast_rows":
        # 2 shards hold 12 blocks of 16 (the lane rule needs 8): aligned;
        # 4 and 8 hold 6 and 3: JAX falls back to its plain stage 1 over
        # the unaligned blocks, the port's shard keeps the rows for them
        assert cuts["rows_fallback"] == (n > 2) and cuts["rows"]
    if name == "hier_k_beyond_blocks":
        # 2 requested blocks over n shards cover k = 20 docs only when
        # each shard takes ceil(20 / 16) = 2; its candidates stay at k
        assert cuts["b_local"] == 2 and cuts["c_local"] == 20


def test_sharded_codec_trains_on_the_global_sample(world):
    """A sharded index trains its residual codec on the sample the whole
    token array gives (the JAX package's picks), so its tables and records
    equal a one-device port index's, at 2 and 4 shards."""
    from ravqa_tpu_torch.retrieval import build_index_from_embeddings
    embs, masks = world[0], world[1]
    one = build_index_from_embeddings(embs, masks, None, 8, torch.float32)
    one.build_summaries(n_summary=2)
    one.quantize_residual(16, 2, seed=3, sample=600, heldout=200)
    for n in (2, 4):
        ranks = launch(_torch_ranks.codec_rank, n, embs, masks, 16, 600, 200,
                       timeout=60, join_timeout=300)
        for r in ranks:
            np.testing.assert_allclose(r["centroids"],
                                       one.codec_centroids.numpy(),
                                       atol=1e-6)
            np.testing.assert_allclose(r["weights"],
                                       one.codec_weights.numpy(), atol=1e-6)
            np.testing.assert_array_equal(r["records"],
                                          one.records.numpy())


def test_sharded_load_save_and_encode(world, tmp_path):
    """load_index reads each rank's rows of a saved index; a sharded save
    writes the whole index; encode_corpus on a mesh encodes only each
    rank's rows, and the shards equal build_index_from_embeddings'."""
    from ravqa_tpu_torch.retrieval import (build_index_from_embeddings,
                                           load_index, save_index)
    embs, masks = world[0][:203], world[1][:203]
    one = build_index_from_embeddings(embs, masks, None, 8, torch.float32)
    # 203 docs pad to 208 alone, to 224 over 4 shards: save the latter
    padded = build_index_from_embeddings(embs, masks, None, 32,
                                         torch.float32)
    save_index(padded, str(tmp_path / "ix"))
    ranks = launch(_torch_ranks.index_io_rank, 4, str(tmp_path / "ix"),
                   embs, masks, timeout=60, join_timeout=300)
    n_local = 224 // 4
    full = padded.tokens.numpy()
    for r, got in enumerate(ranks):
        rows = slice(r * n_local, (r + 1) * n_local)
        assert got["n_pad"] == 224
        np.testing.assert_array_equal(got["loaded"], full[rows])
        np.testing.assert_array_equal(got["loaded_mask"],
                                      padded.mask.numpy()[rows])
        np.testing.assert_array_equal(got["pids"], padded.pids)
        np.testing.assert_array_equal(got["built"], full[rows])
        np.testing.assert_array_equal(got["encoded"], full[rows])
        np.testing.assert_array_equal(got["encoded_mask"],
                                      padded.mask.numpy()[rows])
    # each rank encoded its own docs only: 56 + 56 + 56 + 35 real rows
    assert [g["encoded_rows"] for g in ranks] == [56, 56, 56, 35]
    resaved = load_index(str(tmp_path / "ix_resaved"), torch.float32)
    np.testing.assert_array_equal(resaved.tokens.numpy(), full)
    assert resaved.num_docs == one.num_docs == 203
