"""ravqa_tpu_torch.retrieval.index (compressed indexes and persistence)
against ravqa_tpu.retrieval.index.

Tolerances, with their reasons:
- int8 codes and scales, residual codes and packed bytes: exact;
- a residual record's bf16 scale: one bf16 step (lax.rsqrt and
  torch.rsqrt may round apart by a float32 ulp before the cast);
- summaries: each package runs its own k-means (sums in another order),
  so a bf16 summary may sit one bf16 step apart;
- searches: scores rtol 1e-5, atol 1e-4 * Lq; rows tie-aware.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.ops import residual as jr
from ravqa_tpu.retrieval import index as jax_index
from ravqa_tpu.retrieval import search as jax_search
from ravqa_tpu_torch.ops import residual as tr
from ravqa_tpu_torch.retrieval import (LateInteractionSearcher, TokenIndex,
                                       build_index_from_embeddings,
                                       load_index, save_index)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _normed(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def corpus(seed=0, n=128, ld=10, dim=32, n_topics=6, b=4, lq=6):
    """Cluster-ordered docs with masked tail tokens and one doc with no
    valid token; queries are noisy copies of docs' first tokens."""
    rng = np.random.default_rng(seed)
    topics = _normed(rng.normal(size=(n_topics, dim)))
    embs = _normed(topics[np.sort(rng.integers(n_topics, size=n))][:, None]
                   + 0.35 * rng.normal(size=(n, ld, dim)))
    masks = np.ones((n, ld), np.float32)
    masks[:, -2:] = rng.random((n, 2)) > 0.5
    masks[3] = 0
    embs *= masks[..., None]
    q = _normed(embs[rng.integers(4, n, size=b), :lq]
                + 0.1 * rng.normal(size=(b, lq, dim)))
    return embs, masks, q


def port_codec(jc):
    def t(x):
        return None if x is None else _t(np.asarray(x))
    return tr.ResidualCodec(centroids=t(jc.centroids),
                            bucket_cutoffs=t(jc.bucket_cutoffs),
                            bucket_weights=t(jc.bucket_weights),
                            nbits=jc.nbits, coarse=t(jc.coarse),
                            fine=t(jc.fine))


def both(embs, masks, codec, summaries=True, nbits=2):
    """The JAX and port indexes of one corpus, float32, summaries built by
    each package, then compressed: codec "int8", "flat" or "factored"
    (the JAX-trained codec carried into the port) or None."""
    j = jax_index.build_index_from_embeddings(embs, masks, pad_multiple=8,
                                              dtype=jnp.float32)
    t = build_index_from_embeddings(embs, masks, pad_multiple=8,
                                    dtype=torch.float32)
    if summaries:
        j.build_summaries(n_summary=3)
        j.build_block_summaries(block_size=16)
        t.build_summaries(n_summary=3)
        t.build_block_summaries(block_size=16)
    if codec == "int8":
        j.quantize_int8()
        t.quantize_int8()
    elif codec in ("flat", "factored"):
        toks, msk = np.asarray(j.tokens), np.asarray(j.mask)
        jc = (jr.train_codec(toks, msk, n_centroids=16, nbits=nbits)
              if codec == "flat" else
              jr.train_codec_factored(toks, msk, k_coarse=4, k_fine=8,
                                      nbits=nbits))
        j.quantize_residual(codec=jc)
        t.quantize_residual(codec=port_codec(jc))
    return j, t


def assert_records_equal(got, want, ld):
    """Codes and packed bytes exact; bf16 scales within one bf16 step."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[:, :2 * ld], want[:, :2 * ld])
    np.testing.assert_array_equal(got[:, 4 * ld:], want[:, 4 * ld:])
    gs = got[:, 2 * ld:4 * ld].copy().view(np.uint16).astype(np.int32)
    ws = want[:, 2 * ld:4 * ld].copy().view(np.uint16).astype(np.int32)
    assert np.abs(gs - ws).max() <= 1


def assert_search_equal(got, want, lq):
    gs, gr = (np.asarray(x) for x in got)
    ws, wr = (np.asarray(x) for x in want)
    atol = 1e-4 * lq
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=atol)
    for b in range(gs.shape[0]):
        assert set(wr[b][ws[b] > ws[b, -1] + atol]) <= set(gr[b])
        assert set(gr[b][gs[b] > gs[b, -1] + atol]) <= set(wr[b])


# -- step 0: an index without tokens, and int8 summaries ---------------------

def test_residual_index_has_no_tokens_and_still_describes_itself():
    embs, masks, q = corpus()
    j, t = both(embs, masks, "factored")
    assert t.tokens is None and t.records.dtype == torch.uint8
    assert (t.n_pad, t.doc_maxlen, t.dim, t.nbits) == \
        (j.n_pad, j.doc_maxlen, j.dim, j.nbits) == (128, 10, 32, 2)
    assert t.device == torch.device("cpu")
    assert t.meta["dim"] == 32
    for mode in ("two_stage", "hierarchical"):
        s, p = LateInteractionSearcher(t, mode=mode).search(q, k=5)
        assert p.shape == (4, 5) and np.isfinite(s).all()
    with pytest.raises(ValueError, match="pruned search mode"):
        LateInteractionSearcher(t, mode="exact")
    with pytest.raises(ValueError, match="before quantize_residual"):
        t.build_summaries()
    with pytest.raises(ValueError, match="already residual"):
        t.quantize_residual()


def test_int8_index_builds_bf16_summaries_like_jax():
    embs, masks, _ = corpus(seed=1)
    j, t = both(embs, masks, "int8", summaries=False)
    j.build_summaries(n_summary=3)
    t.build_summaries(n_summary=3)
    assert t.summaries.dtype == torch.bfloat16
    assert j.summaries.dtype == jnp.bfloat16
    np.testing.assert_allclose(t.summaries.float().numpy(),
                               np.asarray(j.summaries, np.float32),
                               rtol=2 ** -7, atol=1e-6)


def test_quantize_int8_matches_jax():
    embs, masks, _ = corpus(seed=2)
    j, t = both(embs, masks, "int8", summaries=False)
    assert t.tokens.dtype == torch.int8 and t.scales.dtype == torch.float32
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    with pytest.raises(ValueError, match="already int8"):
        t.quantize_int8()


@pytest.mark.parametrize("nbits", [2, 4])
@pytest.mark.parametrize("codec", ["flat", "factored"])
def test_quantize_residual_with_carried_codec_matches_jax(codec, nbits):
    embs, masks, _ = corpus(seed=3)
    j, t = both(embs, masks, codec, nbits=nbits)
    assert_records_equal(t.records, j.records, t.doc_maxlen)
    assert (t.codec_coarse is None) == (codec == "flat")
    rows = np.array([0, 3, 7, 50])
    np.testing.assert_allclose(
        t.gather_tokens(_t(rows)).numpy(),
        np.asarray(j.gather_tokens(jnp.asarray(rows))), rtol=2 ** -7,
        atol=1e-6)
    for g, w in zip(t.unpack_residual(), j.unpack_residual()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2 ** -7)


@pytest.mark.parametrize("n_centroids", [16, (4, 8)])
def test_quantize_residual_trains_its_codec(n_centroids):
    embs, masks, q = corpus(seed=4)
    _, t = both(embs, masks, None)
    t.quantize_residual(n_centroids=n_centroids, nbits=4, seed=1)
    assert t.nbits == 4 and t.codec_centroids.shape == (16 if n_centroids
                                                        == 16 else 32, 32)
    assert (t.codec_coarse is not None) == isinstance(n_centroids, tuple)
    # the reconstruction stays close to the tokens it replaced
    rec = t.gather_tokens(torch.arange(8)).numpy()
    valid = masks[:8] > 0
    err = np.linalg.norm((rec - embs[:8])[valid], axis=-1)
    assert err.mean() < 0.5


# -- persistence ---------------------------------------------------------------

@pytest.mark.parametrize("codec", ["int8", "flat", "factored"])
def test_jax_save_loads_and_searches_in_the_port(tmp_path, codec):
    embs, masks, q = corpus(seed=5)
    j, _ = both(embs, masks, codec)
    jax_index.save_index(j, str(tmp_path))
    t = load_index(str(tmp_path), dtype=torch.float32)
    assert t.num_docs == j.num_docs and t.nbits == j.nbits
    np.testing.assert_array_equal(t.pids, j.pids)
    mode = "exact" if codec == "int8" else "hierarchical"
    if mode == "hierarchical":
        # the JAX save keeps no block summaries: both sides build them
        # from the loaded summaries
        j2 = jax_index.load_index(str(tmp_path), dtype=jnp.float32)
        j2.build_block_summaries(block_size=16)
        t.build_block_summaries(block_size=16)
        np.testing.assert_array_equal(t.records.numpy(),
                                      np.asarray(j.records))
    else:
        j2 = j
        np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
        np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    for preset in ("reference", "fast"):
        want = jax_search.LateInteractionSearcher(
            j2, mode=mode, preset=preset, use_pallas=False,
            approx_topk=False, n_candidates=32).search_device(
                jnp.asarray(q), k=10)
        got = LateInteractionSearcher(t, mode=mode, preset=preset,
                                      use_pallas=False,
                                      n_candidates=32).search_device(
            _t(q), k=10)
        assert_search_equal(got, want, q.shape[1])


def test_jax_legacy_separate_array_save_repacks(tmp_path):
    """The JAX package's older residual save (separate codes, residuals
    and bf16 scales arrays) repacks into the same record rows and
    searches as the JAX package does."""
    embs, masks, q = corpus(seed=6)
    j, _ = both(embs, masks, "flat")
    codes, scales, packed = j.unpack_residual()
    np.savez(tmp_path / "index.npz", mask=np.asarray(j.mask, np.int8),
             pids=j.pids,
             scales=np.asarray(scales.astype(jnp.bfloat16)).view(np.uint16),
             codes=np.asarray(codes, np.int16),
             residuals=np.asarray(packed, np.uint8),
             codec_centroids=np.asarray(j.codec_centroids, np.float32),
             codec_weights=np.asarray(j.codec_weights, np.float32),
             summaries=np.asarray(j.summaries, np.float32))
    with open(tmp_path / "metadata.json", "w") as f:
        json.dump({"num_docs": j.num_docs, "quantized": True,
                   "scales_dtype": "bfloat16", "nbits": 2,
                   "residual_layout": "planar", "dim": j.dim}, f)
    t = load_index(str(tmp_path), dtype=torch.float32)
    np.testing.assert_array_equal(t.records.numpy(), np.asarray(j.records))
    assert t.tokens is None and t.summaries.dtype == torch.float32
    jl = jax_index.load_index(str(tmp_path), dtype=jnp.float32)
    want = jax_search.LateInteractionSearcher(
        jl, mode="two_stage", use_pallas=False, approx_topk=False,
        n_candidates=32).search_device(jnp.asarray(q), k=10)
    got = LateInteractionSearcher(t, mode="two_stage", use_pallas=False,
                                  n_candidates=32).search_device(_t(q),
                                                                 k=10)
    assert_search_equal(got, want, q.shape[1])


def test_load_refuses_an_interleaved_residual_save(tmp_path):
    embs, masks, _ = corpus(seed=7)
    _, t = both(embs, masks, "flat")
    save_index(t, str(tmp_path))
    meta_path = os.path.join(str(tmp_path), "metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["residual_layout"] == "planar"
    del meta["residual_layout"]                   # an older save
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="bit-pack layout"):
        load_index(str(tmp_path))


@pytest.mark.parametrize("codec", [None, "int8", "factored"])
def test_port_save_loads_in_jax_and_round_trips(tmp_path, codec):
    embs, masks, q = corpus(seed=8)
    j, t = both(embs, masks, codec)
    save_index(t, str(tmp_path))
    jl = jax_index.load_index(str(tmp_path), dtype=jnp.float32)
    tl = load_index(str(tmp_path), dtype=torch.float32)
    assert jl.num_docs == tl.num_docs == t.num_docs and jl.meta == tl.meta
    np.testing.assert_array_equal(jl.pids, t.pids)
    np.testing.assert_array_equal(np.asarray(jl.mask), t.mask.numpy())
    if codec is None or codec == "int8":
        np.testing.assert_array_equal(np.asarray(jl.tokens),
                                      t.tokens.numpy())
        np.testing.assert_array_equal(tl.tokens.numpy(), t.tokens.numpy())
        if codec == "int8":
            np.testing.assert_array_equal(np.asarray(jl.scales),
                                          t.scales.numpy())
        mode = "exact"
    else:
        for name in ("records", "codec_centroids", "codec_weights",
                     "codec_coarse", "codec_fine", "summaries"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jl, name)),
                getattr(t, name).numpy(), err_msg=name)
            np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                          getattr(t, name).numpy())
        mode = "two_stage"
    want = jax_search.LateInteractionSearcher(
        jl, mode=mode, use_pallas=False, approx_topk=False,
        n_candidates=32).search_device(jnp.asarray(q), k=5)
    got = LateInteractionSearcher(tl, mode=mode, use_pallas=False,
                                  n_candidates=32).search_device(_t(q), k=5)
    assert_search_equal(got, want, q.shape[1])


def test_bf16_scales_save_as_uint16_bits(tmp_path):
    """bf16 scales go down as their uint16 bit patterns and come back
    exactly, with no ml_dtypes on the loading side."""
    rng = np.random.default_rng(9)
    t = TokenIndex(tokens=_t(rng.integers(-127, 128, size=(8, 4, 16))
                             .astype(np.int8)),
                   mask=torch.ones(8, 4, dtype=torch.int8),
                   pids=np.arange(8), num_docs=8,
                   scales=_t(rng.random((8, 4)).astype(np.float32)).to(
                       torch.bfloat16))
    save_index(t, str(tmp_path))
    with open(tmp_path / "metadata.json") as f:
        assert json.load(f)["scales_dtype"] == "bfloat16"
    assert np.load(tmp_path / "index.npz")["scales"].dtype == np.uint16
    tl = load_index(str(tmp_path))
    assert tl.scales.dtype == torch.bfloat16
    assert torch.equal(tl.scales, t.scales)
    jl = jax_index.load_index(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jl.scales, np.float32),
                                  t.scales.float().numpy())


# -- the JAX argument positions: mesh and axis --------------------------------

def test_positional_calls_bind_as_in_jax(tmp_path):
    """mesh and axis sit where the JAX package has them, so positional
    calls written for it bind the same parameters: the searcher's third
    argument is the axis (not use_pallas), load_index's third the mesh
    (not the device), quantize_residual's fifth the seed."""
    embs, masks, q = corpus(seed=6, n=64)
    j, t = both(embs, masks, None)
    s = LateInteractionSearcher(t, None, "index")
    assert s.use_pallas is False                  # a CPU index's default
    want = jax_search.LateInteractionSearcher(j, None, "index", False,
                                              approx_topk=False).search(q, 5)
    assert_search_equal(s.search(q, 5), want, q.shape[1])

    save_index(t, str(tmp_path))
    tl = load_index(str(tmp_path), torch.float32, None, "index")
    jl = jax_index.load_index(str(tmp_path), jnp.float32, None, "index")
    assert tl.tokens.dtype == torch.float32 and tl.device.type == "cpu"
    np.testing.assert_array_equal(tl.tokens.numpy(), np.asarray(jl.tokens))

    by_pos = t.quantize_residual(16, 2, None, "index", 1)
    _, by_kw = both(embs, masks, None)
    by_kw.quantize_residual(n_centroids=16, nbits=2, seed=1)
    assert torch.equal(by_pos.records, by_kw.records)


def test_a_given_mesh_raises_until_sharding_is_ported(tmp_path):
    """The four calls this test once saw refuse a mesh now take one, at
    the JAX argument positions: on 2 gloo ranks, load_index(path, dtype,
    mesh) reads each rank's rows, build_index_from_embeddings(..., mesh)
    keeps them, quantize_residual(16, 2, mesh) trains on the global sample
    (the same records as one device), and LateInteractionSearcher(index,
    mesh, "index") searches like the JAX package's sharded searcher. A
    mesh that is not the index's still raises."""
    import jax
    import _torch_ranks
    from ravqa_tpu.parallel import make_mesh as jax_make_mesh
    from ravqa_tpu_torch.parallel import launch
    embs, masks, q = corpus(seed=7, n=32)
    _, t = both(embs, masks, None, summaries=False)
    save_index(t, str(tmp_path))
    ranks = launch(_torch_ranks.positional_mesh_rank, 2, str(tmp_path),
                   embs, masks, q, timeout=60, join_timeout=120)
    mesh = jax_make_mesh({"index": 2}, jax.devices()[:2])
    j = jax_index.build_index_from_embeddings(embs, masks, None, 8,
                                              jnp.float32, mesh, "index")
    want = jax_search.LateInteractionSearcher(
        j, mesh, "index", False, approx_topk=False).search(q, 5)
    one = build_index_from_embeddings(embs, masks, pad_multiple=8,
                                      dtype=torch.float32)
    one.build_summaries(n_summary=2)
    one.quantize_residual(16, 2, None, "index", 1)
    for r, got in enumerate(ranks):
        rows = slice(16 * r, 16 * (r + 1))
        np.testing.assert_array_equal(got["loaded"], t.tokens.numpy()[rows])
        np.testing.assert_array_equal(got["built"], t.tokens.numpy()[rows])
        np.testing.assert_array_equal(got["records"],
                                      one.records.numpy()[rows])
        assert_search_equal(got["search"], want, q.shape[1])
    with pytest.raises(ValueError, match="same mesh"):
        LateInteractionSearcher(t, object(), "index")