"""ravqa_tpu_torch.ops.residual and the residual fine stage of
ravqa_tpu_torch.retrieval.coarse against ravqa_tpu.

The same numpy inputs go through the JAX function and the port's; the
JAX package's fused kernel runs in TPU interpret mode, kept tiny.
Tolerances, with their reasons:
- bucket ids, packed bytes, record rows and codes: exact (integer math;
  the codec is carried across, so both sides assign against one table);
- reconstruction-norm scales: one float32 ulp (lax.rsqrt and torch.rsqrt
  may round apart), so a bf16 scale may sit one bf16 step apart;
- trained codecs on well-separated data: atol 1e-5 (k-means sums in
  another order);
- scores: rtol 1e-5, atol 1e-4 * Lq (float32 sums of the same bf16
  products in another order); top-k rows compared tie-aware.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.ops import residual as jr
from ravqa_tpu.retrieval import coarse as jax_coarse
from ravqa_tpu_torch.ops import residual as tr
from ravqa_tpu_torch.retrieval import coarse as torch_coarse


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))          # a writable copy


def _normed(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def clustered(seed=0, n=48, ld=12, dim=32, n_topics=6):
    """Docs whose tokens are topic + noise, with masked tail tokens and
    one doc with no valid token."""
    rng = np.random.default_rng(seed)
    topics = _normed(rng.normal(size=(n_topics, dim)))
    tok = _normed(topics[rng.integers(n_topics, size=n)][:, None]
                  + 0.4 * rng.normal(size=(n, ld, dim)))
    mask = np.ones((n, ld), np.int8)
    mask[:, -3:] = rng.random((n, 3)) > 0.5
    mask[2] = 0
    tok *= mask[..., None]
    return tok, mask


def port_codec(jc):
    """A JAX-trained codec carried into the port."""
    def t(x):
        return None if x is None else _t(np.asarray(x))
    return tr.ResidualCodec(centroids=t(jc.centroids),
                            bucket_cutoffs=t(jc.bucket_cutoffs),
                            bucket_weights=t(jc.bucket_weights),
                            nbits=jc.nbits, coarse=t(jc.coarse),
                            fine=t(jc.fine))


def jax_codec(kind, nbits, tok, mask):
    if kind == "flat":
        return jr.train_codec(tok, mask, n_centroids=16, nbits=nbits,
                              sample=256, heldout=128)
    return jr.train_codec_factored(tok, mask, k_coarse=4, k_fine=8,
                                   nbits=nbits, sample=256, heldout=128)


def _tol(lq):
    return dict(rtol=1e-5, atol=1e-4 * lq)


def assert_search_equal(got, want, lq):
    gs, gr = (np.asarray(x) for x in got)
    ws, wr = (np.asarray(x) for x in want)
    tol = _tol(lq)
    np.testing.assert_allclose(gs, ws, **tol)
    for b in range(gs.shape[0]):
        assert set(wr[b][ws[b] > ws[b, -1] + tol["atol"]]) <= set(gr[b])
        assert set(gr[b][gs[b] > gs[b, -1] + tol["atol"]]) <= set(wr[b])


# -- bit layouts ---------------------------------------------------------------

@pytest.mark.parametrize("nbits", [2, 4, 8])
def test_unpack_bits_bit_equal(nbits):
    rng = np.random.default_rng(nbits)
    packed = rng.integers(0, 256, size=(3, 5, 32 * nbits // 8)).astype(
        np.uint8)
    want = np.asarray(jr.unpack_bits(jnp.asarray(packed), nbits))
    got = tr.unpack_bits(_t(packed), nbits)
    assert got.dtype == torch.uint8 and got.shape == (3, 5, 32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nbits", [2, 4, 8])
def test_pack_and_split_records_bit_equal(nbits):
    rng = np.random.default_rng(10 + nbits)
    n, ld, dim = 6, 7, 16
    codes = rng.integers(0, 65536, size=(n, ld)).astype(np.int32)
    codes[0, :3] = [32767, 32768, 65535]          # the uint16 range's edges
    scales = rng.random((n, ld)).astype(np.float32)
    packed = rng.integers(0, 256, size=(n, ld, dim * nbits // 8)).astype(
        np.uint8)
    want = np.asarray(jr.pack_records(jnp.asarray(codes),
                                      jnp.asarray(scales).astype(
                                          jnp.bfloat16),
                                      jnp.asarray(packed)))
    got = tr.pack_records(_t(codes), _t(scales), _t(packed))
    assert got.dtype == torch.uint8
    assert got.shape[1] == tr.record_bytes(ld, dim, nbits)
    np.testing.assert_array_equal(got.numpy(), want)
    # split a gathered (B, C, RB) copy back, as the fine stage does
    rows = rng.integers(0, n, size=(2, 4))
    wc, ws, wp = (np.asarray(x) for x in jr.split_records(
        jnp.asarray(want)[rows], ld))
    gc, gs, gp = tr.split_records(got[_t(rows)], ld)
    np.testing.assert_array_equal(gc.numpy(), wc)
    np.testing.assert_array_equal(gs.numpy(), ws)
    np.testing.assert_array_equal(gp.numpy(), wp)
    assert gc.dtype == torch.int32 and gs.dtype == torch.float32


# -- training ------------------------------------------------------------------

def test_sample_split_and_buckets_match_jax():
    tok, mask = clustered()
    want = jr._sample_split(tok, mask, 100, 40, seed=3)
    got = tr._sample_split(_t(tok), _t(mask), 100, 40, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    resid = np.random.default_rng(1).normal(size=500).astype(np.float32)
    for nbits in (2, 4):
        for g, w in zip(tr._fit_buckets(_t(resid), nbits),
                        jr._fit_buckets(resid, nbits)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def separated(seed=0, n=64, ld=8, dim=16, k=4):
    """Tokens around k orthogonal directions, far apart: k-means near-ties
    cannot flip an assignment between the frameworks."""
    rng = np.random.default_rng(seed)
    centers = np.eye(dim, dtype=np.float32)[:k]
    tok = _normed(centers[rng.integers(k, size=(n, ld))]
                  + 0.05 * rng.normal(size=(n, ld, dim)))
    return tok, np.ones((n, ld), np.int8)


@pytest.mark.parametrize("nbits", [2, 4])
def test_train_codec_matches_jax(nbits):
    tok, mask = separated()
    want = jr.train_codec(tok, mask, n_centroids=4, nbits=nbits,
                          sample=300, heldout=100)
    got = tr.train_codec(_t(tok), _t(mask), n_centroids=4, nbits=nbits,
                         sample=300, heldout=100)
    assert got.nbits == nbits and not got.factored
    for name in ("centroids", "bucket_cutoffs", "bucket_weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, err_msg=name)


def test_train_codec_factored_matches_jax():
    tok, mask = separated(seed=1, k=8)
    want = jr.train_codec_factored(tok, mask, k_coarse=4, k_fine=2,
                                   sample=300, heldout=100)
    got = tr.train_codec_factored(_t(tok), _t(mask), k_coarse=4, k_fine=2,
                                  sample=300, heldout=100)
    assert got.factored and got.centroids.shape == (8, 16)
    for name in ("centroids", "coarse", "fine", "bucket_cutoffs",
                 "bucket_weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="power of two"):
        tr.train_codec_factored(_t(tok), _t(mask), k_coarse=4, k_fine=3)


# -- compression ---------------------------------------------------------------

@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("kind", ["flat", "factored"])
def test_compress_with_carried_codec_matches_jax(kind, nbits):
    tok, mask = clustered(seed=4)
    jc = jax_codec(kind, nbits, tok, mask)
    wc, wp, ws = (np.asarray(x) for x in jr.compress(tok, mask, jc,
                                                     block=20))
    gc, gp, gs = tr.compress(_t(tok), _t(mask), port_codec(jc), block=17)
    assert gc.dtype == torch.int32 and gp.dtype == torch.uint8
    np.testing.assert_array_equal(gc.numpy(), wc)
    np.testing.assert_array_equal(gp.numpy(), wp)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=2.4e-7, atol=0)
    assert (gs.numpy()[mask == 0] == 0).all()
    want = np.asarray(jr.decompress(jnp.asarray(wc), jnp.asarray(wp),
                                    jc.centroids, jc.bucket_weights, nbits),
                      np.float32)
    got = tr.decompress(gc, gp, _t(np.asarray(jc.centroids)),
                        _t(np.asarray(jc.bucket_weights)), nbits)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


# -- the fused kernel's plain version (K6) --------------------------------------

def _records(kind, nbits, seed=5):
    """A compressed corpus: JAX codec, JAX records (numpy), queries and
    per-query candidates that include the doc with no valid token."""
    tok, mask = clustered(seed=seed)
    jc = jax_codec(kind, nbits, tok, mask)
    codes, packed, scales = jr.compress(tok, mask, jc)
    records = np.asarray(jr.pack_records(codes, scales.astype(jnp.bfloat16),
                                         packed))
    rng = np.random.default_rng(seed)
    q = _normed(tok[rng.integers(3, len(tok), size=2), :5]
                + 0.1 * rng.normal(size=(2, 5, tok.shape[-1])))
    cand = rng.integers(0, len(tok), size=(2, 32))
    cand[:, 3] = 2                       # the doc with no valid token
    return jc, records, mask, q, cand


@pytest.mark.parametrize("nbits", [2, 4])
@pytest.mark.parametrize("kind", ["flat", "factored"])
def test_maxsim_residual_torch_matches_pallas_interpret(kind, nbits):
    jc, records, mask, q, cand = _records(kind, nbits)
    ld = mask.shape[1]
    cg, sg, pg = jr.split_records(jnp.asarray(records)[cand], ld)
    want = np.asarray(jr.maxsim_residual_pallas(
        jnp.asarray(q), cg, pg, jnp.asarray(mask)[cand], jc.centroids,
        jc.bucket_weights, sg, jc.coarse, jc.fine, nbits=nbits, tile_c=16,
        interpret=True))
    pc = port_codec(jc)
    got = tr.maxsim_residual(_t(q), _t(records), _t(cand), _t(mask),
                             pc.centroids, pc.bucket_weights, nbits=nbits,
                             coarse=pc.coarse, fine=pc.fine)
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), want, **_tol(q.shape[1]))
    np.testing.assert_allclose(got.numpy()[:, 3], -9999.0 * q.shape[1])


# -- the residual fine stage ----------------------------------------------------

def _fine_kwargs(jc, records, mask):
    pc = port_codec(jc)
    jkw = dict(records=jnp.asarray(records), centroids=jc.centroids,
               bucket_weights=jc.bucket_weights, nbits=jc.nbits,
               codec_coarse=jc.coarse, codec_fine=jc.fine)
    tkw = dict(records=_t(records), centroids=pc.centroids,
               bucket_weights=pc.bucket_weights, nbits=pc.nbits,
               codec_coarse=pc.coarse, codec_fine=pc.fine)
    return jkw, tkw


@pytest.mark.parametrize("prune", [0, 12])
@pytest.mark.parametrize("kind", ["flat", "factored"])
def test_fine_stage_records_matches_jax(kind, prune):
    """The XLA route (use_pallas_residual=False) on both sides, with and
    without the centroid-only cut."""
    jc, records, mask, q, cand = _records(kind, 2, seed=6)
    jkw, tkw = _fine_kwargs(jc, records, mask)
    want = jax_coarse._fine_stage(jnp.asarray(q), jnp.asarray(cand), None,
                                  jnp.asarray(mask), k=5,
                                  centroid_prune=prune, **jkw)
    got = torch_coarse._fine_stage(_t(q), _t(cand), None, _t(mask), k=5,
                                   centroid_prune=prune, **tkw)
    assert_search_equal(got, want, q.shape[1])


@pytest.mark.parametrize("kind", ["flat", "factored"])
def test_fine_stage_kernel_route_matches_jax_interpret(kind):
    """use_pallas_residual=True: the JAX package's fused kernel in
    interpret mode, the port's K6 plain version on CPU tensors."""
    from jax.experimental.pallas import tpu as pltpu
    jc, records, mask, q, cand = _records(kind, 4, seed=7)
    jkw, tkw = _fine_kwargs(jc, records, mask)
    with pltpu.force_tpu_interpret_mode():
        want = jax_coarse._fine_stage(jnp.asarray(q), jnp.asarray(cand),
                                      None, jnp.asarray(mask), k=5,
                                      use_pallas_residual=True, **jkw)
    before = tr.maxsim_residual.launches
    got = torch_coarse._fine_stage(_t(q), _t(cand), None, _t(mask), k=5,
                                   use_pallas_residual=True, **tkw)
    assert tr.maxsim_residual.launches == before    # CPU: plain version
    assert_search_equal(got, want, q.shape[1])


def test_flat_codec_gate_keeps_large_codebooks_on_the_plain_stage(
        monkeypatch):
    """A flat codec of more than 1024 centroids never reaches the fused
    kernel (the JAX package's gate)."""
    tok, mask = clustered(seed=8)
    rng = np.random.default_rng(8)
    codec = tr.ResidualCodec(
        centroids=_t(_normed(rng.normal(size=(1100, tok.shape[-1])))),
        bucket_cutoffs=_t(np.float32([-0.1, 0.0, 0.1])),
        bucket_weights=_t(np.float32([-0.2, -0.05, 0.05, 0.2])))
    codes, packed, scales = tr.compress(_t(tok), _t(mask), codec)
    records = tr.pack_records(codes, scales, packed)
    called = []
    monkeypatch.setattr(torch_coarse, "maxsim_residual",
                        lambda *a, **kw: called.append(1))
    q = _t(tok[:2, :4])
    cand = torch.arange(8).repeat(2, 1)
    s, r = torch_coarse._fine_stage(
        q, cand, None, _t(mask), k=3, records=records,
        centroids=codec.centroids, bucket_weights=codec.bucket_weights,
        nbits=2, use_pallas_residual=True)
    assert not called and r.shape == (2, 3)
    assert (r[:, 0] == torch.arange(2)).all()


@pytest.mark.parametrize("b,c,sm", [(32, 256, 132), (1, 256, 132),
                                    (2, 13, 132), (32, 1024, 132),
                                    (5, 37, 8), (64, 1, 132), (3, 200, 132)])
def test_residual_plan_covers_every_candidate_once(b, c, sm):
    """K6's runs, walked as csrc/residual_maxsim.cu walks them (a block
    holds runs 2x and 2x + 1, or one): run i scores query i // splits,
    candidates (i % splits) * cands .. + cands, cut at C; every (query,
    candidate) is scored by exactly one run, a run holds at most 64
    candidates, and the SMs get at least two runs each where the
    candidates allow."""
    cands = tr.residual_plan(b, c, sm)
    assert 1 <= cands <= 64
    splits = -(-c // cands)
    seen = []
    for wgs in (1, 2):
        per_query = -(-splits // wgs)
        for block in range(b * per_query):
            for wg in range(wgs):
                q = block // per_query
                c0 = ((block % per_query) * wgs + wg) * cands
                seen += [(q, c0 + j) for j in range(min(cands, c - c0))]
        if wgs == 1:
            assert sorted(seen) == [(q, j) for q in range(b)
                                    for j in range(c)]
            seen = []
    assert sorted(seen) == [(q, j) for q in range(b) for j in range(c)]
    if c >= 8 * 2 * sm // b:
        assert b * splits >= 2 * sm or cands == 64
    assert splits <= -(-c // 8)
