"""ravqa_tpu_torch.ops.maxsim against ravqa_tpu.ops.maxsim.

The port's plain MaxSim (the CPU path, and the reference its CUDA kernel
is checked against on the card) must equal the JAX package's XLA version
and its Pallas kernel (run in TPU interpret mode, as tests/test_maxsim.py
runs it) on the same numpy inputs.

Tolerance: rtol 1e-5, atol 1e-4 * Lq. Both sides compute in float32 but
sum the dim products and the Lq per-token maxima in different orders; each
of the Lq terms carries a float32 rounding error well below 1e-4 at these
magnitudes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.ops import maxsim as jax_maxsim
from ravqa_tpu_torch.ops import maxsim as torch_maxsim


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


CASES = ["random", "all_masked_docs", "zero_query_rows", "all_negative",
         "ragged_n"]


def make_case(case: str, seed: int = 0):
    """(q (B, Lq, dim), tokens (N, Ld, dim), mask (N, Ld) int8) numpy."""
    rng = np.random.default_rng(seed)
    b, lq, n, ld, dim = 3, 6, 32, 9, 16
    if case == "ragged_n":
        n = 37                        # not a multiple of 16 (port side only)
    q = rng.normal(size=(b, lq, dim)).astype(np.float32)
    tok = rng.normal(size=(n, ld, dim)).astype(np.float32)
    mask = (rng.random((n, ld)) > 0.3).astype(np.int8)
    mask[:, 0] = 1
    if case == "all_masked_docs":
        mask[[0, 5, n - 1]] = 0
    elif case == "zero_query_rows":
        q[:, -2:] = 0.0
    elif case == "all_negative":
        # every q.d < 0: a max that starts at 0 would score 0, not < 0
        q = np.abs(q)
        tok = -np.abs(tok)
    return q, tok, mask


def tol(lq):
    return dict(rtol=1e-5, atol=1e-4 * lq)


@pytest.mark.parametrize("case", CASES)
def test_plain_search_matches_jax_xla(case):
    q, tok, mask = make_case(case)
    got = torch_maxsim.maxsim_search_torch(
        torch.from_numpy(q), torch.from_numpy(tok), torch.from_numpy(mask))
    want = np.asarray(jax_maxsim.maxsim_search_xla(
        jnp.asarray(q), jnp.asarray(tok), jnp.asarray(mask)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **tol(q.shape[1]))
    if case == "all_masked_docs":
        np.testing.assert_array_equal(got.numpy()[:, [0, 5]],
                                      -9999.0 * q.shape[1])
    if case == "all_negative":
        assert (got.numpy() < 0).all()


@pytest.mark.parametrize("case", [c for c in CASES if c != "ragged_n"])
def test_plain_search_matches_jax_pallas_interpret(case):
    from jax.experimental.pallas import tpu as pltpu
    q, tok, mask = make_case(case)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_maxsim.maxsim_search_pallas(
            jnp.asarray(q), jnp.asarray(tok), jnp.asarray(mask), tile_d=8))
    got = torch_maxsim.maxsim_search_torch(
        torch.from_numpy(q), torch.from_numpy(tok), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **tol(q.shape[1]))


@pytest.mark.parametrize("with_q_mask", [False, True])
def test_maxsim_reduce_matches_jax(with_q_mask):
    rng = np.random.default_rng(3)
    scores = rng.normal(size=(4, 5, 7, 6)).astype(np.float32)  # (.., Ld, Lq)
    d_mask = (rng.random((4, 5, 7)) > 0.4).astype(np.float32)
    d_mask[1, 2] = 0.0                                         # all masked
    q_mask = (rng.random((4, 5, 6)) > 0.3).astype(np.float32) \
        if with_q_mask else None
    want = np.asarray(jax_maxsim.maxsim_reduce(
        jnp.asarray(scores), jnp.asarray(d_mask),
        None if q_mask is None else jnp.asarray(q_mask)))
    got = torch_maxsim.maxsim_reduce(
        torch.from_numpy(scores), torch.from_numpy(d_mask),
        None if q_mask is None else torch.from_numpy(q_mask))
    np.testing.assert_allclose(got.numpy(), want, **tol(6))


def test_chunking_does_not_change_scores():
    q, tok, mask = (torch.from_numpy(a) for a in make_case("ragged_n", 5))
    whole = torch_maxsim.maxsim_search_torch(q, tok, mask)
    chunked = torch_maxsim.maxsim_search_torch(q, tok, mask,
                                               max_chunk_elems=500)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


def test_wrapper_takes_plain_version_on_cpu_only():
    q, tok, mask = (torch.from_numpy(a) for a in make_case("random", 6))
    before = torch_maxsim.maxsim_search.launches
    got = torch_maxsim.maxsim_search(q, tok, mask)
    torch.testing.assert_close(got, torch_maxsim.maxsim_search_torch(
        q, tok, mask), rtol=0, atol=0)
    assert torch_maxsim.maxsim_search.launches == before  # no kernel launch
    with pytest.raises(ValueError, match="unsupported device"):
        torch_maxsim.maxsim_search(q.to("meta"), tok.to("meta"),
                                   mask.to("meta"))


def test_kernel_arg_checks_reject_what_the_kernel_does_not_take():
    q, tok, mask = (torch.from_numpy(a) for a in make_case("random", 7))
    check = torch_maxsim._check_kernel_args
    check(q, tok, mask)                                   # accepted
    with pytest.raises(TypeError):
        check(q.double(), tok, mask)
    with pytest.raises(TypeError):
        check(q, tok, mask.float())
    with pytest.raises(ValueError):
        check(q[:, :, :6], tok[:, :, :6].contiguous(), mask)  # dim % 4
    with pytest.raises(ValueError):
        check(q, tok.transpose(0, 1), mask.T)                 # layout
    with pytest.raises(ValueError):
        check(q, tok[:, :, :8], mask)                         # dim mismatch


# -- the summary sweeps' wrappers (their plain versions are held to the JAX
# package in tests/test_torch_coarse.py) ------------------------------------

def _sweep_inputs(seed=8):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(2, 5, 16)).astype(np.float32))
    summ_t = torch.from_numpy(rng.normal(size=(3, 20, 16)).astype(
        np.float32)).bfloat16()
    valid = torch.from_numpy(rng.random(20) > 0.2)
    rows = torch.from_numpy(rng.normal(size=(4, 3, 8, 16)).astype(
        np.float32)).bfloat16()
    blk = torch.from_numpy(rng.integers(0, 4, size=(2, 3)))
    return q, summ_t, valid, rows, blk


def test_sweep_wrappers_take_plain_versions_on_cpu_only():
    from ravqa_tpu_torch.ops.quant import (quantize_summaries_int8,
                                           quantize_summaries_t_int8)
    q, summ_t, valid, rows, blk = _sweep_inputs()
    counts = (torch_maxsim.coarse_sweep.launches,
              torch_maxsim.coarse_sweep_int8.launches,
              torch_maxsim.stage1_sweep.launches)
    torch.testing.assert_close(
        torch_maxsim.coarse_sweep(q, summ_t, valid),
        torch_maxsim.coarse_sweep_torch(q, summ_t, valid), rtol=0, atol=0)
    st8, dsc = quantize_summaries_t_int8(summ_t)
    torch.testing.assert_close(
        torch_maxsim.coarse_sweep(q, st8, valid, dscale=dsc),
        torch_maxsim.coarse_sweep_torch(q, st8, valid, dscale=dsc),
        rtol=0, atol=0)
    torch.testing.assert_close(
        torch_maxsim.stage1_sweep(q, rows, blk, tile_b=4),
        torch_maxsim.stage1_sweep_torch(q, rows, blk), rtol=0, atol=0)
    r8, rs = quantize_summaries_int8(rows.transpose(1, 2).reshape(32, 3, 16))
    rows8 = torch_maxsim.stage1_rows(r8, 8)
    torch.testing.assert_close(
        torch_maxsim.stage1_sweep(q, rows8, blk, dscale=rs),
        torch_maxsim.stage1_sweep_torch(q, rows8, blk, dscale=rs),
        rtol=0, atol=0)
    assert counts == (torch_maxsim.coarse_sweep.launches,
                      torch_maxsim.coarse_sweep_int8.launches,
                      torch_maxsim.stage1_sweep.launches)  # no kernel launch
    with pytest.raises(ValueError, match="dscale"):
        torch_maxsim.coarse_sweep(q, st8, valid)
    with pytest.raises(ValueError, match="dscale"):
        torch_maxsim.stage1_sweep(q, rows8, blk)
    meta = [t.to("meta") for t in (q, summ_t, valid, rows, blk)]
    with pytest.raises(ValueError, match="unsupported device"):
        torch_maxsim.coarse_sweep(*meta[:3])
    with pytest.raises(ValueError, match="unsupported device"):
        torch_maxsim.stage1_sweep(meta[0], meta[3], meta[4])


# -- the MMA route of K1 (bf16 index): its Python side, checkable here -------

# tests/test_torch_cuda.py's SHAPES: (B, Lq, N, Ld, dim)
CARD_SHAPES = [(3, 6, 37, 9, 16), (2, 80, 21, 150, 128), (5, 32, 64, 64, 8),
               (32, 64, 200, 220, 128), (3, 200, 19, 300, 64),
               (7, 1, 9, 1, 8)]


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_split_query_bf16_sums_back_to_the_query(parts):
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.normal(size=(4, 7, 32)).astype(np.float32))
    split = torch_maxsim.split_query_bf16(q, parts)
    assert split.dtype == torch.bfloat16 and split.shape == (parts, 4, 7, 32)
    total = split.double().sum(0)
    rel = ((total - q.double()).abs() / q.double().abs()).max().item()
    if parts == 1:
        assert torch.equal(split[0], q.bfloat16())
        assert rel <= 2.0 ** -8
    elif parts == 2:
        assert rel <= 2.0 ** -16
    else:                                   # every float32 bit kept
        assert torch.equal(total.float(), q)
    # a bfloat16 query is its own single part
    assert torch.equal(torch_maxsim.split_query_bf16(q.bfloat16(), 1)[0],
                       q.bfloat16())


def _parts_maxsim(parts, tokens, mask):
    """The MMA route's arithmetic in plain PyTorch: each bf16 query part
    times the bf16 doc values, summed into one float32 score before the
    max over doc tokens."""
    tf = tokens.float()
    sc = sum(torch.einsum("nld,bqd->nlbq", tf, p.float()) for p in parts)
    sc = sc.masked_fill(~mask.bool()[:, :, None, None], -9999.0)
    return sc.amax(dim=1).sum(dim=-1).T


@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("negative", [False, True])
def test_two_bf16_parts_hold_the_card_tolerance(shape, negative):
    """A float32 query against a bf16 index, as the card tests make it:
    two bf16 parts keep the MMA route within their tolerance (rtol 1e-5,
    atol 1e-4 * Lq) of the plain float32 MaxSim, one part (the query
    rounded to bf16) does not."""
    b, lq, n, ld, dim = shape
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, lq, dim)).astype(np.float32)
    tok = rng.normal(size=(n, ld, dim)).astype(np.float32)
    if negative:
        q, tok = np.abs(q), -np.abs(tok)
    mask = (rng.random((n, ld)) > 0.3).astype(np.int8)
    mask[::5] = 0
    q[:, -1] = 0.0
    q, mask = torch.from_numpy(q), torch.from_numpy(mask)
    tok = torch.from_numpy(tok).bfloat16()
    want = torch_maxsim.maxsim_search_torch(q, tok, mask)
    route = torch_maxsim.maxsim_route(q.dtype, tok.dtype)
    assert route == ("mma", 2, 1)
    got = _parts_maxsim(torch_maxsim.split_query_bf16(q, route.parts), tok,
                        mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * lq)
    if lq > 1 and dim >= 64:
        rounded = _parts_maxsim(torch_maxsim.split_query_bf16(q, 1), tok,
                                mask)
        assert not torch.allclose(rounded, want, rtol=1e-5, atol=1e-4 * lq)


def _walk_tiles(plan, n, ld):
    """Walk the tiles as csrc/mma_tile.cuh does: tile t holds docs
    (t // tpd) * dpt + d, d < dpt, at columns d * doc_cols + r, rows
    (t % tpd) * doc_cols + r of each, and goes to the MMA in `chunks`
    chunks of `width` columns. Returns every (doc, row) an MMA column
    scores, in order."""
    dpt, dc, tpd = plan.docs_per_tile, plan.doc_cols, plan.tiles_per_doc
    seen = []
    for t in range(-(-n // dpt) * tpd):
        dg, part = divmod(t, tpd)
        for col in range(plan.chunks * plan.width):
            d, r = divmod(col, dc)
            row = part * dc + r
            if d < min(dpt, n - dg * dpt) and row < ld:
                seen.append((dg * dpt + d, row))
    return seen


def _check_plan(plan, ld, n, block_rows, tile_rows):
    dpt, dc, tpd = plan.docs_per_tile, plan.doc_cols, plan.tiles_per_doc
    assert dc % 8 == 0 and 8 <= dc * dpt <= tile_rows and dpt <= 8
    assert plan.tiles_per_unit % tpd == 0 and (tpd == 1 or dpt == 1)
    assert plan.width % 8 == 0 and plan.chunks >= 1
    assert dpt * dc <= plan.chunks * plan.width <= tile_rows
    assert sorted(_walk_tiles(plan, n, ld)) == [
        (i, r) for i in range(n) for r in range(ld)]


@pytest.mark.parametrize("ld", [1, 9, 64, 128, 150, 220, 300])
@pytest.mark.parametrize("block_rows", [128, 256])
def test_mma_tile_plan_covers_every_doc_row_once(ld, block_rows):
    """Every (doc, row) of the index is scored by exactly one MMA column,
    at 64-column chunks and at the widths the kernels are built for."""
    n, b, lq = 37, 9, 32
    for dim in (64, 128):
        plan = torch_maxsim.mma_tile_plan(ld, n, b, lq, block_rows, dim=dim)
        _check_plan(plan, ld, n, block_rows, 256)
        assert plan.width in torch_maxsim.mma_widths(block_rows, dim)
        assert plan.queries_per_block * lq <= block_rows \
            or plan.queries_per_block == 1


def test_mma_tile_plan_fills_the_card():
    """32 tiles a unit at most; fewer when the card's SMs would walk fewer
    than eight units each; whole docs per unit when a doc spans tiles; one
    persistent block an SM, or one a unit when there are fewer units."""
    big = torch_maxsim.mma_tile_plan(128, 16384, 32, 32, 256)
    assert big[:5] == (2, 128, 1, 31, 8)
    assert (big.width, big.chunks, big.blocks) == (128, 2, 132)
    assert big.units == 4 * -(-8192 // 31) and big.units_per_block == 9
    narrow = torch_maxsim.mma_tile_plan(128, 16384, 32, 32, 256, dim=64)
    assert (narrow.width, narrow.chunks) == (64, 4)
    small = torch_maxsim.mma_tile_plan(64, 200, 32, 32, 256)
    assert small.tiles_per_unit == 1 and small.units == 200
    assert small.blocks == 132 and small.units_per_block == 2
    few = torch_maxsim.mma_tile_plan(64, 37, 2, 32, 256)
    assert few.units == few.blocks == 10 and few.units_per_block == 1
    long_docs = torch_maxsim.mma_tile_plan(600, 100000, 32, 32, 256)
    assert long_docs.tiles_per_doc == 3 and long_docs.tiles_per_unit == 30
    assert torch_maxsim.mma_tile_plan(64, 99, 3, 200, 128).queries_per_block \
        == 1
    serve = torch_maxsim.mma_tile_plan(220, 168320, 32, 64, 128, 132, 128)
    assert serve[:5] == (1, 112, 2, 32, 2) and serve.blocks == 132
    assert serve.units == 16 * 168320 * 2 // 32


@pytest.mark.parametrize("q_dtype,t_dtype,route", [
    (torch.float32, torch.float32, ("mma", 2, 2)),
    (torch.bfloat16, torch.bfloat16, ("mma", 1, 1)),
    (torch.float32, torch.bfloat16, ("mma", 2, 1))])
def test_maxsim_route_by_dtype(q_dtype, t_dtype, route):
    """Every dtype pair runs the tensor-core kernel; a float32 index as two
    bf16 planes against two query parts: hi.hi + lo.hi + hi.lo."""
    got = torch_maxsim.maxsim_route(q_dtype, t_dtype)
    assert got == route
    assert got.parts in torch_maxsim.MMA_BLOCK_ROWS
    assert got.planes in torch_maxsim.TILE_ROWS
    assert torch_maxsim.route_products(got) == {1: 1, 2: 2, 4: 3}[
        got.parts * got.planes]


# -- K1 on a float32 index: both sides split into bf16 parts ------------------

def _split_maxsim(q, tok, mask, parts):
    """The float32-index route's arithmetic in plain PyTorch: query and
    index each split into `parts` bf16 parts (split_query_bf16's rule), the
    products of part p and plane x with p + x < parts summed in float32
    before the mask, max and sum; float64 products of bf16 values are exact
    and the sums stay within float32's rounding."""
    qp = torch_maxsim.split_query_bf16(q, parts).double()
    tp = torch_maxsim.split_query_bf16(tok, parts).double()
    sc = sum(torch.einsum("nld,bqd->nlbq", tp[x], qp[p])
             for p in range(parts) for x in range(parts) if p + x < parts)
    sc = sc.float().masked_fill(~mask.bool()[:, :, None, None], -9999.0)
    return sc.amax(dim=1).sum(dim=-1).T


def _serve_geometry(negative, seed=0, b=4, lq=64, n=96, ld=220, dim=128):
    """The float32 serve's geometry: L2-normalized float32 query and doc
    tokens (scores of both signs), Lq = 64, Ld = 220, dim 128, ~30 % of
    the doc tokens masked, a doc with none and a zero query row.
    negative: every score < 0."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, dim))
    tok = rng.normal(size=(n, ld, dim))
    if negative:
        q, tok = np.abs(q), -np.abs(tok)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tok /= np.linalg.norm(tok, axis=-1, keepdims=True)
    mask = (rng.random((n, ld)) > 0.3).astype(np.int8)
    mask[7] = 0
    q[:, -1] = 0.0
    return (torch.from_numpy(q.astype(np.float32)),
            torch.from_numpy(tok.astype(np.float32)), torch.from_numpy(mask))


# the margin: the card checks hold K1 to 1e-3 max abs (chip_smoke.py) and
# to rtol 1e-5, atol 1e-4 * Lq (tests/test_torch_cuda.py); the split's own
# error must stay ten times inside the first, at 1e-4
SPLIT_MARGIN = 1e-4


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("negative", [False, True])
def test_two_sided_split_holds_the_card_tolerance(parts, negative):
    """Two bf16 parts per side (three products) keep the float32 serve's
    MaxSim within SPLIT_MARGIN of the plain float32 version, and the
    top-10 with it; three parts (six products) keep it closer still. The
    kernel takes two (csrc/maxsim_mma.cu)."""
    q, tok, mask = _serve_geometry(negative)
    want = torch_maxsim.maxsim_search_torch(q, tok, mask)
    got = _split_maxsim(q, tok, mask, parts)
    err = (got - want).abs().max().item()
    assert err <= SPLIT_MARGIN
    if parts == 3:
        assert err <= SPLIT_MARGIN / 10
    assert torch.equal(got[:, 7], torch.full_like(got[:, 7], -9999.0 * 64))
    gv, gi = torch.topk(got, 10, dim=1)
    wv, _ = torch.topk(want, 10, dim=1)
    assert (gv - wv).abs().max().item() <= SPLIT_MARGIN
    assert (want.gather(1, gi) - gv).abs().max().item() <= SPLIT_MARGIN
    if negative:
        assert bool((got < 0).all())
    else:
        assert bool((got < 0).any()) and bool((got > 0).any())


@pytest.mark.parametrize("dim", [8, 24, 64, 128])
def test_split_index_planes_sum_back_to_the_index(dim):
    """split_index_bf16: (N, Ld, 2 * dp) bf16, plane 0 the tokens rounded
    to bf16, plane 1 the remainder, zeros past dim; chunking changes
    nothing; at dim 128 the planes take the float32 index's bytes."""
    rng = np.random.default_rng(12)
    tok = torch.from_numpy(rng.normal(size=(9, 5, dim)).astype(np.float32))
    planes = torch_maxsim.split_index_bf16(tok)
    dp = torch_maxsim.index_plane_dim(dim)
    assert dp % 16 == 0 and dp >= dim and dp < 2 * max(dim, 16)
    assert planes.dtype == torch.bfloat16 and planes.shape == (9, 5, 2 * dp)
    hi, lo = planes[..., :dim], planes[..., dp:dp + dim]
    assert torch.equal(hi, tok.bfloat16())
    assert not planes[..., dim:dp].any() and not planes[..., dp + dim:].any()
    total = hi.double() + lo.double()
    rel = ((total - tok.double()).abs() / tok.double().abs()).max().item()
    assert rel <= 2.0 ** -16
    assert torch.equal(torch_maxsim.split_index_bf16(tok,
                                                     max_chunk_elems=7),
                       planes)
    if dim == 128:
        assert planes.numel() * 2 == tok.numel() * 4


@pytest.mark.parametrize("ld", [1, 9, 64, 100, 128, 150, 220, 300])
def test_mma_tile_plan_at_128_columns_covers_every_doc_row_once(ld):
    """The float32-index route's ring stages (TILE_ROWS[2] = 128 rows): the
    walk of test_mma_tile_plan_covers_every_doc_row_once; Ld = 220 spans
    two tiles of 112 columns, one chunk of 112 each."""
    n, b, lq = 37, 9, 64
    tr = torch_maxsim.TILE_ROWS[2]
    plan = torch_maxsim.mma_tile_plan(ld, n, b, lq, 128, tile_rows=tr)
    _check_plan(plan, ld, n, 128, tr)
    if ld == 220:
        assert (plan.tiles_per_doc, plan.doc_cols) == (2, 112)
        assert (plan.width, plan.chunks, plan.column_use) == (112, 1, 1.0)


# every K1 and K5 route: (query rows per unit row chunk, ring stage rows)
MMA_ROUTES = [(128, 128), (128, 256), (256, 256)]


@pytest.mark.parametrize("ld", [180, 220, 512])
@pytest.mark.parametrize("lq", [32, 64, 320, 352])
@pytest.mark.parametrize("b", [1, 2, 32, 192])
@pytest.mark.parametrize("route", MMA_ROUTES)
def test_mma_persistent_walk_covers_every_unit_once(ld, lq, b, route):
    """The persistent blocks' walk (block x takes units x, x + blocks, ...;
    unit u is query group u % groups over tile range u // groups) covers
    every (query group, tile range) once, the groups every query row once
    (in row chunks of the block's rows) and the ranges every tile once;
    each tile's chunks score every doc row once."""
    block_rows, tile_rows = route
    n = 301
    for sm_count in (132, 7):
        plan = torch_maxsim.mma_tile_plan(ld, n, b, lq, block_rows,
                                          sm_count, tile_rows)
        _check_plan(plan, ld, n, block_rows, tile_rows)
        g, tpu = plan.queries_per_block, plan.tiles_per_unit
        groups = -(-b // g)
        n_tiles = -(-n // plan.docs_per_tile) * plan.tiles_per_doc
        ranges = -(-n_tiles // tpu)
        assert plan.units == groups * ranges
        assert plan.blocks == min(plan.units, sm_count)
        walked = [u for x in range(plan.blocks)
                  for u in range(x, plan.units, plan.blocks)]
        assert sorted(walked) == list(range(plan.units))
        assert max(len(range(x, plan.units, plan.blocks))
                   for x in range(plan.blocks)) == plan.units_per_block
        rows, tiles = [], []
        for u in walked:
            grp, rng = u % groups, u // groups
            b0 = grp * g
            rows_g = min(g, b - b0) * lq
            if rng == 0:
                for c0 in range(0, rows_g, block_rows):
                    rows += range(b0 * lq + c0,
                                  b0 * lq + min(c0 + block_rows, rows_g))
            if grp == 0:
                tiles += range(rng * tpu, min((rng + 1) * tpu, n_tiles))
        assert sorted(rows) == list(range(b * lq))
        assert sorted(tiles) == list(range(n_tiles))


def _old_column_use(ld, tile_rows):
    """The share of MMA columns holding a padded doc's token when every tile
    ran all its tile_rows / 64 chunks of 64 columns (the tiling before the
    widths were fitted)."""
    if ld <= tile_rows:
        dc = -(-ld // 8) * 8
        return min(8, tile_rows // dc) * dc / tile_rows
    tpd = -(-ld // tile_rows)
    return -(-ld // 8) * 8 / (tpd * tile_rows)


@pytest.mark.parametrize("ld", [1, 9, 32, 64, 100, 128, 150, 180, 220, 300,
                                512])
@pytest.mark.parametrize("route", MMA_ROUTES)
@pytest.mark.parametrize("dim", [64, 128])
def test_mma_column_use_is_whole_where_a_width_fits(ld, route, dim):
    """column_use is 1.0 wherever a width the kernel is built for covers
    a tile's doc columns exactly and the tiles hold whole padded docs (or
    equal parts of one), and never below the tiling of 64-column chunks
    that ran every tile's full width: Ld 220 and 512 on every route."""
    block_rows, tile_rows = route
    widths = torch_maxsim.mma_widths(block_rows, dim)
    plan = torch_maxsim.mma_tile_plan(ld, 1000, 32, 64, block_rows, 132,
                                      tile_rows, dim)
    tile_cols = plan.docs_per_tile * plan.doc_cols
    padded = -(-ld // 8) * 8
    fits = any(tile_cols % w == 0 and tile_cols <= tile_rows for w in widths)
    whole = padded == plan.tiles_per_doc * tile_cols
    if fits and whole:
        assert plan.column_use == 1.0
    assert plan.column_use >= _old_column_use(ld, tile_rows)
    if ld in (220, 512) and dim == 128:
        assert plan.column_use == 1.0
