"""ravqa_tpu_torch.retrieval (index + exact search) against ravqa_tpu.

The same embeddings go into both packages' build_index_from_embeddings and
exact LateInteractionSearcher (the JAX one with use_pallas=False and
approx_topk=False). Scores must agree within rtol 1e-5, atol 1e-4 * Lq
(float32 on both sides; the MaxSim sums run in different orders). Pids are
compared tie-aware: each pid the port returns must carry, in the JAX
package's full score matrix, the score the port reports for it, and the
k-th best scores must agree (near-ties may swap order between engines).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.ops import residual as jax_residual
from ravqa_tpu.ops.maxsim import maxsim_search_xla
from ravqa_tpu.retrieval import index as jax_index
from ravqa_tpu.retrieval import search as jax_search
from ravqa_tpu_torch.ops import residual as torch_residual
from ravqa_tpu_torch.retrieval import (LateInteractionSearcher,
                                       build_index_from_embeddings,
                                       encode_corpus)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _normed(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _corpus(seed=0, n=13, ld=7, dim=16):
    rng = np.random.default_rng(seed)
    embs = _normed(rng, (n, ld, dim))
    masks = (rng.random((n, ld)) > 0.3).astype(np.float32)
    masks[:, 0] = 1
    masks[4] = 0                                  # a doc with no tokens
    return embs * masks[..., None], masks


def assert_tie_aware(scores, pids, full, want_scores, lq, pid_of_row):
    tol = dict(rtol=1e-5, atol=1e-4 * lq)
    np.testing.assert_allclose(scores, want_scores, **tol)
    row_of_pid = {p: r for r, p in enumerate(pid_of_row) if p >= 0}
    pad_rows = [r for r, p in enumerate(pid_of_row) if p < 0]
    for b in range(scores.shape[0]):
        for s, p in zip(scores[b], pids[b]):
            rows = [row_of_pid[p]] if p >= 0 else pad_rows
            np.testing.assert_allclose(full[b, rows], s, **tol)


@pytest.mark.parametrize("k", [5, 15])           # 15 > num_docs: pad rows
def test_exact_search_matches_jax(k):
    embs, masks = _corpus()
    pids = np.arange(100, 113)
    rng = np.random.default_rng(1)
    q = _normed(rng, (4, 6, 16))
    q[:, -1] = 0.0                                # zero query rows
    jidx = jax_index.build_index_from_embeddings(embs, masks, pids=pids,
                                                 pad_multiple=8,
                                                 dtype=jnp.float32)
    want_s, want_p = jax_search.LateInteractionSearcher(
        jidx, use_pallas=False, approx_topk=False).search(q, k=k)
    tidx = build_index_from_embeddings(embs, masks, pids=pids,
                                       pad_multiple=8, dtype=torch.float32)
    got_s, got_p = LateInteractionSearcher(tidx).search(q, k=k)
    assert got_s.shape == got_p.shape == (4, k)
    full = np.asarray(maxsim_search_xla(jnp.asarray(q), jidx.tokens,
                                        jidx.mask))
    assert_tie_aware(got_s, got_p, full, want_s, q.shape[1], jidx.pids)
    if k > 13:
        # the empty rows (doc pid 104 and three pads) tie for the last 3
        assert set(got_p[:, -3:].ravel()) <= {-1, 104}
        assert (got_p[:, -3:] == -1).sum(axis=1).min() >= 2
        np.testing.assert_allclose(got_s[:, -3:], -9999.0 * 6, rtol=1e-6)


@pytest.mark.parametrize("as_list", [False, True])
def test_index_layout_matches_jax(as_list):
    embs, masks = _corpus(seed=2, n=10)
    if as_list:                                   # ragged per-doc arrays
        lens = [7 - (i % 3) for i in range(10)]
        embs = [embs[i, :n] for i, n in enumerate(lens)]
        masks = [masks[i, :n] for i, n in enumerate(lens)]
    j = jax_index.build_index_from_embeddings(embs, masks, pad_multiple=8,
                                              dtype=jnp.float32)
    t = build_index_from_embeddings(embs, masks, pad_multiple=8,
                                    dtype=torch.float32)
    assert (t.num_docs, t.n_pad, t.doc_maxlen, t.dim) == \
        (j.num_docs, j.n_pad, j.doc_maxlen, j.dim) == (10, 16, 7, 16)
    assert t.mask.dtype == torch.int8 and t.meta == j.meta
    np.testing.assert_array_equal(t.pids, j.pids)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    bf = build_index_from_embeddings(embs, masks, pad_multiple=8)
    assert bf.tokens.dtype == torch.bfloat16      # the JAX default too


def test_encode_corpus_matches_one_shot_build():
    embs, masks = _corpus(seed=3, n=11)
    batches = [(embs[s:s + 4], masks[s:s + 4]) for s in range(0, 11, 4)]
    idx = encode_corpus(
        lambda b: (torch.from_numpy(b[0]), torch.from_numpy(b[1])),
        batches, pad_multiple=8, dtype=torch.float32)
    ref = build_index_from_embeddings(embs, masks, pad_multiple=8,
                                      dtype=torch.float32)
    assert torch.equal(idx.tokens, ref.tokens)
    assert torch.equal(idx.mask, ref.mask)
    np.testing.assert_array_equal(idx.pids, ref.pids)


def test_unported_modes_raise():
    """A mesh is searched with an index sharded over it (the sharded
    search itself: tests/test_torch_sharded_search.py); a mesh the index
    was not built with raises, as does a sharded index without its mesh."""
    embs, masks = _corpus(n=8)
    idx = build_index_from_embeddings(embs, masks, pad_multiple=8)
    with pytest.raises(ValueError, match="same mesh and axis"):
        LateInteractionSearcher(idx, mesh=object())
    import dataclasses
    sharded = dataclasses.replace(idx, mesh=object())
    with pytest.raises(ValueError, match="searched with its mesh"):
        LateInteractionSearcher(sharded)
    with pytest.raises(ValueError, match="same mesh and axis"):
        LateInteractionSearcher(sharded, sharded.mesh, axis="data")
    # TPU knobs are accepted as no-ops
    LateInteractionSearcher(idx, use_pallas=True, tile_d=16,
                            approx_topk=True, approx_recall=0.9,
                            stage1_tile_b=4, centroid_prune=0,
                            preset="fast")


# -- pruned modes ------------------------------------------------------------

def _clustered(seed=0, n=384, ld=10, dim=32, n_topics=6, b=6, lq=6):
    """A cluster-ordered corpus with masked tail tokens and a doc with no
    token; queries are noisy copies of a doc's first tokens."""
    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)

    rng = np.random.default_rng(seed)
    topics = unit(rng.normal(size=(n_topics, dim)))
    doc_topic = np.sort(rng.integers(n_topics, size=n))
    embs = unit(topics[doc_topic][:, None]
                + 0.35 * rng.normal(size=(n, ld, dim)))
    masks = np.ones((n, ld), np.float32)
    masks[:, -2:] = rng.random((n, 2)) > 0.5
    masks[3] = 0
    embs *= masks[..., None]
    q = unit(embs[rng.integers(4, n, size=b), :lq]
             + 0.1 * rng.normal(size=(b, lq, dim)))
    q[:, -1] = 0.0
    return embs, masks, q


def _both_indexes(embs, masks, block_size=16):
    jidx = jax_index.build_index_from_embeddings(embs, masks, pad_multiple=8,
                                                 dtype=jnp.float32)
    jidx.build_summaries(n_summary=4)
    jidx.build_block_summaries(block_size=block_size)
    tidx = build_index_from_embeddings(embs, masks, pad_multiple=8,
                                       dtype=torch.float32)
    tidx.build_summaries(n_summary=4)
    tidx.build_block_summaries(block_size=block_size)
    return jidx, tidx


@pytest.fixture(scope="module")
def pruned():
    embs, masks, q = _clustered()
    jidx, tidx = _both_indexes(embs, masks)
    return jidx, tidx, q


def test_summaries_match_jax(pruned):
    jidx, tidx, _ = pruned
    assert tidx.summaries.dtype == torch.float32 and tidx.block_size == 16
    np.testing.assert_allclose(tidx.summaries.numpy(),
                               np.asarray(jidx.summaries), atol=1e-5)
    np.testing.assert_allclose(tidx.block_summaries.numpy(),
                               np.asarray(jidx.block_summaries), atol=1e-5)


# n_candidates / n_blocks small enough that every cut prunes; None lets
# the preset decide (fast: 256 candidates over 32 of the 24 blocks)
KNOBS = [dict(n_candidates=40, n_blocks=6), dict(n_candidates=40),
         dict(n_candidates=None)]


@pytest.mark.parametrize("knobs", range(len(KNOBS)))
@pytest.mark.parametrize("preset", ["reference", "fast"])
@pytest.mark.parametrize("mode", ["exact", "two_stage", "hierarchical"])
def test_searcher_matches_jax(pruned, mode, preset, knobs):
    """use_pallas=False on both sides: the XLA route in the JAX package,
    its math in plain PyTorch in the port."""
    jidx, tidx, q = pruned
    kw = dict(mode=mode, preset=preset, **KNOBS[knobs])
    if mode != "hierarchical":
        kw.pop("n_blocks", None)
    js = jax_search.LateInteractionSearcher(jidx, use_pallas=False,
                                            approx_topk=False, **kw)
    ts = LateInteractionSearcher(tidx, use_pallas=False, **kw)
    want_s, want_p = js.search(q, k=5)
    got_s, got_p = ts.search(q, k=5)
    assert (ts._summ_rows is None) == (js._summ_rows is None)
    assert (ts._summ_i8 is None) == (js._summ_i8 is None)
    full = np.asarray(maxsim_search_xla(jnp.asarray(q), jidx.tokens,
                                        jidx.mask))
    assert_tie_aware(got_s, got_p, full, want_s, q.shape[1], jidx.pids)
    np.testing.assert_array_equal(np.sort(got_p, 1), np.sort(want_p, 1))


@pytest.mark.parametrize("mode", ["two_stage", "hierarchical"])
def test_kernel_route_matches_jax_interpret(mode):
    """use_pallas=True on both sides, preset fast: the JAX package runs
    its Pallas kernels in interpret mode (K3, and K4's XLA twin off the
    TPU), the port the kernels' plain versions on a CPU index."""
    from jax.experimental.pallas import tpu as pltpu
    embs, masks, q = _clustered(seed=1, n=256)
    jidx, tidx = _both_indexes(embs, masks)
    kw = dict(mode=mode, preset="fast", n_candidates=32)
    with pltpu.force_tpu_interpret_mode():
        js = jax_search.LateInteractionSearcher(jidx, use_pallas=True,
                                                approx_topk=False, **kw)
        want_s, want_p = js.search(q, k=5)
    ts = LateInteractionSearcher(tidx, use_pallas=True, **kw)
    got_s, got_p = ts.search(q, k=5)
    for name in ("_summ_t", "_summ_t_scale", "_bsum_t", "_bsum_t_scale",
                 "_summ_rows", "_summ_rows_scale"):
        j, t = getattr(js, name), getattr(ts, name)
        assert (j is None) == (t is None), name
        if t is not None:
            # the kernels' copies, contiguous; each package built its own
            # summaries (k-means sums ~1e-7 apart), so an int8 code or a
            # bf16 value may sit one step over a rounding edge (the
            # quantizers are bit-equal on equal inputs: test_torch_quant.py)
            assert t.is_contiguous(), name
            step = {torch.int8: 1.0, torch.bfloat16: 2 ** -8}.get(t.dtype,
                                                                  0.0)
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32),
                                       rtol=1e-5, atol=step)
    full = np.asarray(maxsim_search_xla(jnp.asarray(q), jidx.tokens,
                                        jidx.mask))
    assert_tie_aware(got_s, got_p, full, want_s, q.shape[1], jidx.pids)


def test_pruned_modes_need_summaries():
    embs, masks = _corpus(n=16)
    idx = build_index_from_embeddings(embs, masks, pad_multiple=8)
    with pytest.raises(ValueError, match="build_summaries"):
        LateInteractionSearcher(idx, mode="two_stage")
    idx.build_summaries(n_summary=2)
    with pytest.raises(ValueError, match="build_block_summaries"):
        LateInteractionSearcher(idx, mode="hierarchical")
    with pytest.raises(ValueError, match="unknown search mode"):
        LateInteractionSearcher(idx, mode="centroid")
    with pytest.raises(ValueError, match="divide"):
        idx.build_block_summaries(block_size=7)


# -- compressed indexes: int8 and residual ------------------------------------

def _carried(jc):
    """A JAX-trained residual codec carried into the port."""
    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))
    return torch_residual.ResidualCodec(
        centroids=t(jc.centroids), bucket_cutoffs=t(jc.bucket_cutoffs),
        bucket_weights=t(jc.bucket_weights), nbits=jc.nbits,
        coarse=t(jc.coarse), fine=t(jc.fine))


def _compress(jidx, tidx, codec):
    """int8, or a residual codec trained by the JAX package on the float
    tokens and carried into the port, so both index the same records."""
    if codec == "int8":
        jidx.quantize_int8()
        tidx.quantize_int8()
        return
    toks, msk = np.asarray(jidx.tokens), np.asarray(jidx.mask)
    jc = (jax_residual.train_codec(toks, msk, n_centroids=32, nbits=2)
          if codec == "flat" else
          jax_residual.train_codec_factored(toks, msk, k_coarse=4, k_fine=8,
                                            nbits=2))
    jidx.quantize_residual(codec=jc)
    tidx.quantize_residual(codec=_carried(jc))


@pytest.fixture(scope="module")
def compressed():
    embs, masks, q = _clustered(seed=2)
    out = {}
    for codec in ("int8", "flat", "factored"):
        jidx, tidx = _both_indexes(embs, masks)
        _compress(jidx, tidx, codec)
        out[codec] = (jidx, tidx)
    return out, q


def _exact_scores(jidx, q):
    """The JAX package's exact scores of every doc under the index's own
    codec (int8: dequantized tokens; residual: the bf16 fine stage)."""
    if jidx.tokens is not None:
        from ravqa_tpu.ops.quant import maxsim_search_int8_xla
        return np.asarray(maxsim_search_int8_xla(
            jnp.asarray(q), jidx.tokens, jidx.scales, jidx.mask))
    from ravqa_tpu.retrieval.coarse import _fine_stage
    n = jidx.n_pad
    cand = jnp.broadcast_to(jnp.arange(n), (q.shape[0], n))
    s, r = _fine_stage(jnp.asarray(q), cand, None, jidx.mask, k=n,
                       records=jidx.records, centroids=jidx.codec_centroids,
                       bucket_weights=jidx.codec_weights, nbits=jidx.nbits)
    full = np.empty((q.shape[0], n), np.float32)
    np.put_along_axis(full, np.asarray(r), np.asarray(s), axis=1)
    return full


@pytest.mark.parametrize("preset", ["reference", "fast"])
@pytest.mark.parametrize("mode", ["exact", "two_stage", "hierarchical"])
@pytest.mark.parametrize("codec", ["int8", "flat", "factored"])
def test_compressed_searcher_matches_jax(compressed, codec, mode, preset):
    """use_pallas=False on both sides (the XLA route, in plain PyTorch in
    the port), with pruning cuts that bite; a residual index has no exact
    mode."""
    indexes, q = compressed
    jidx, tidx = indexes[codec]
    kw = dict(mode=mode, preset=preset, n_candidates=40)
    if mode == "hierarchical":
        kw["n_blocks"] = 6
    if codec != "int8" and mode == "exact":
        with pytest.raises(ValueError, match="pruned search mode"):
            LateInteractionSearcher(tidx, use_pallas=False, **kw)
        return
    js = jax_search.LateInteractionSearcher(jidx, use_pallas=False,
                                            approx_topk=False, **kw)
    ts = LateInteractionSearcher(tidx, use_pallas=False, **kw)
    want_s, want_p = js.search(q, k=5)
    got_s, got_p = ts.search(q, k=5)
    assert_tie_aware(got_s, got_p, _exact_scores(jidx, q), want_s,
                     q.shape[1], jidx.pids)


@pytest.mark.parametrize("codec,mode", [("int8", "exact"),
                                        ("int8", "hierarchical"),
                                        ("flat", "two_stage"),
                                        ("flat", "hierarchical"),
                                        ("factored", "hierarchical")])
def test_compressed_kernel_route_matches_jax_interpret(compressed, codec,
                                                       mode):
    """use_pallas=True on both sides, preset fast: the JAX package's
    Pallas kernels in interpret mode (K5 in exact mode, K6 in the residual
    fine stage), the kernels' plain versions on a CPU index in the port."""
    from jax.experimental.pallas import tpu as pltpu
    indexes, q = compressed
    jidx, tidx = indexes[codec]
    kw = dict(mode=mode, preset="fast", n_candidates=32)
    with pltpu.force_tpu_interpret_mode():
        js = jax_search.LateInteractionSearcher(jidx, use_pallas=True,
                                                approx_topk=False, **kw)
        want_s, want_p = js.search(q, k=5)
    got_s, got_p = LateInteractionSearcher(tidx, use_pallas=True,
                                           **kw).search(q, k=5)
    if codec == "int8" and mode == "exact":
        # K5 scores quantized queries: compare with the JAX kernel's
        # scores, not the float-query ones
        from ravqa_tpu.ops.quant import (maxsim_search_int8_pallas,
                                         quantize_queries_int8)
        q8, qs = quantize_queries_int8(jnp.asarray(q))
        with pltpu.force_tpu_interpret_mode():
            full = np.asarray(maxsim_search_int8_pallas(
                q8, qs, jidx.tokens, jidx.scales, tile_d=8))
    else:
        full = None
    if full is None:
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5,
                                   atol=1e-4 * q.shape[1])
        np.testing.assert_array_equal(np.sort(got_p, 1), np.sort(want_p, 1))
    else:
        assert_tie_aware(got_s, got_p, full, want_s, q.shape[1], jidx.pids)


@pytest.mark.parametrize("mode", ["two_stage", "hierarchical"])
def test_centroid_prune_matches_jax(compressed, mode):
    indexes, q = compressed
    jidx, tidx = indexes["flat"]
    kw = dict(mode=mode, n_candidates=40, centroid_prune=12)
    js = jax_search.LateInteractionSearcher(jidx, use_pallas=False,
                                            approx_topk=False, **kw)
    ts = LateInteractionSearcher(tidx, use_pallas=False, **kw)
    assert ts.resolve_centroid_prune(5, 40) == js.resolve_centroid_prune(
        5, 40) == 12
    assert ts.resolve_centroid_prune(5, 12) == 0      # would not cut
    want_s, _ = js.search(q, k=5)
    got_s, got_p = ts.search(q, k=5)
    assert_tie_aware(got_s, got_p, _exact_scores(jidx, q), want_s,
                     q.shape[1], jidx.pids)
    # a token index ignores the knob, as in the JAX package
    assert LateInteractionSearcher(indexes["int8"][1], centroid_prune=12,
                                   mode=mode).resolve_centroid_prune(5, 40) \
        == 0


@pytest.mark.parametrize("index_kind", ["float", "int8"])
def test_search_single_device_defaults_match_jax(index_kind):
    """Called with its defaults, the port's search_single_device takes the
    JAX function's route: on an int8 index the float query is scored by
    the XLA route's math, not quantized (use_pallas=False)."""
    from ravqa_tpu_torch.retrieval import search_single_device
    embs, masks = _corpus(seed=4)
    q = _normed(np.random.default_rng(5), (3, 6, 16))
    jidx = jax_index.build_index_from_embeddings(embs, masks, pad_multiple=8,
                                                 dtype=jnp.float32)
    tidx = build_index_from_embeddings(embs, masks, pad_multiple=8,
                                       dtype=torch.float32)
    if index_kind == "int8":
        jidx.quantize_int8()
        tidx.quantize_int8()
    want_s, want_r = (np.asarray(x) for x in jax_search.search_single_device(
        jnp.asarray(q), jidx.tokens, jidx.mask, jidx.scales, k=5))
    got_s, got_r = (x.numpy() for x in search_single_device(
        torch.from_numpy(q), tidx.tokens, tidx.mask, tidx.scales, k=5))
    atol = 1e-4 * q.shape[1]
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=atol)
    for b in range(q.shape[0]):
        assert set(want_r[b][want_s[b] > want_s[b, -1] + atol]) \
            <= set(got_r[b])
