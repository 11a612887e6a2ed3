"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA Hopper GPU:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Every test here needs the card and skips without one. This file imports
no jax, so it runs where only PyTorch is installed (`--noconftest` keeps
tests/conftest.py, which imports jax, out).

Tolerance: rtol 1e-5, atol 1e-4 * Lq. The kernel and the plain version get
the same values (bf16 and int8 inputs are upcast exactly) and differ only
in the order they sum products and per-token maxima in float32; K1 on a
float32 index and X1 multiply float32 values as two bf16 parts a side
(hi.hi + lo.hi + hi.lo), about 2^-17 of each product off. K3's int32
maxima are exact: with unit query and doc scales its sums of integers
equal the plain version's bit for bit. TF32 is off for the plain versions'
float32 matmuls (the fixture below), as chip_smoke.py sets it.
"""

import numpy as np
import pytest
import torch

from ravqa_tpu_torch.ops import maxsim, quant, residual, stage2
from ravqa_tpu_torch.ops.quant import (quantize_index_int8,
                                       quantize_queries_int8,
                                       quantize_summaries_int8,
                                       quantize_summaries_t_int8)
from ravqa_tpu_torch.retrieval import (LateInteractionSearcher,
                                       build_index_from_embeddings)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs an NVIDIA GPU (CUDA kernels have no "
                              "CPU mode)"),
]

# (B, Lq, N, Ld, dim): small; query groups of several queries (Lq <= 64),
# one query over 64-128 columns (Lq=80) and over two column steps
# (Lq=200); Ld past the 128-row step with ragged tails; N not a multiple
# of the 8-doc tile; dim 8 is the narrowest the kernel takes
SHAPES = [(3, 6, 37, 9, 16), (2, 80, 21, 150, 128), (5, 32, 64, 64, 8),
          (32, 64, 200, 220, 128), (3, 200, 19, 300, 64), (7, 1, 9, 1, 8)]
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)]


def make(shape, q_dtype, t_dtype, negative=False, seed=0):
    b, lq, n, ld, dim = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, dim)).astype(np.float32)
    tok = rng.normal(size=(n, ld, dim)).astype(np.float32)
    if negative:                     # every q.d < 0: catches a max from 0
        q, tok = np.abs(q), -np.abs(tok)
    mask = (rng.random((n, ld)) > 0.3).astype(np.int8)
    mask[::5] = 0                    # docs with no valid token
    q[:, -1] = 0.0                   # a zero query row
    return (torch.from_numpy(q).cuda().to(q_dtype),
            torch.from_numpy(tok).cuda().to(t_dtype),
            torch.from_numpy(mask).cuda())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtypes", DTYPES)
@pytest.mark.parametrize("negative", [False, True])
def test_maxsim_kernel_matches_plain(shape, dtypes, negative):
    q, tok, mask = make(shape, *dtypes, negative=negative)
    before = maxsim.maxsim_search.launches
    got = maxsim.maxsim_search(q, tok, mask)
    torch.cuda.synchronize()
    assert maxsim.maxsim_search.launches == before + 1
    want = maxsim.maxsim_search_torch(q, tok, mask)
    lq = shape[1]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * lq)
    assert torch.equal(got[:, ::5], torch.full_like(got[:, ::5],
                                                    -9999.0 * lq))


def test_maxsim_kernel_is_deterministic():
    q, tok, mask = make(SHAPES[-1], torch.float32, torch.float32)
    a = maxsim.maxsim_search(q, tok, mask)
    b = maxsim.maxsim_search(q, tok, mask)
    assert torch.equal(a, b)


def test_maxsim_wrapper_raises_on_bad_input():
    q, tok, mask = make(SHAPES[0], torch.float32, torch.float32)
    with pytest.raises(ValueError):
        maxsim.maxsim_search(q, tok.transpose(0, 1), mask.T)
    with pytest.raises(TypeError):
        maxsim.maxsim_search(q, tok, mask.bool())
    with pytest.raises(TypeError):                 # bf16 query, f32 index
        maxsim.maxsim_search(q.bfloat16(), tok, mask)
    with pytest.raises(ValueError):
        maxsim.maxsim_search(q, tok.cpu(), mask)


def test_cuda_searcher_matches_cpu_searcher():
    rng = np.random.default_rng(3)
    embs = rng.normal(size=(50, 12, 32)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    masks = (rng.random((50, 12)) > 0.2).astype(np.float32)
    q = rng.normal(size=(4, 8, 32)).astype(np.float32)
    cpu = LateInteractionSearcher(build_index_from_embeddings(
        embs, masks, pad_multiple=8, dtype=torch.float32))
    gpu = LateInteractionSearcher(build_index_from_embeddings(
        embs, masks, pad_multiple=8, dtype=torch.float32, device="cuda"))
    cs, cp = cpu.search(q, k=5)
    gs, gp = gpu.search(q, k=5)
    np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=1e-4 * 8)
    np.testing.assert_array_equal(gp, cp)


# -- K1's MMA route (bf16 index: csrc/maxsim_mma.cu) --------------------------

# the serve shapes: Lq=64 over 220-token docs, and 64-token docs (4 per
# tile) at an N that is a multiple of nothing; 180-token docs (the triples
# eval's: three 64-column chunks) and 512-token docs (PreFLMR's: two tiles
# a doc)
MMA_SERVE_SHAPES = [(32, 64, 203, 220, 128), (32, 32, 16387, 64, 128),
                    (32, 32, 203, 180, 128), (32, 320, 61, 512, 128)]


@pytest.mark.parametrize("shape", MMA_SERVE_SHAPES)
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_maxsim_mma_route_at_serve_shapes(shape, q_dtype):
    q, tok, mask = make(shape, q_dtype, torch.bfloat16)
    before = maxsim.maxsim_search.launches
    got = maxsim.maxsim_search(q, tok, mask)
    torch.cuda.synchronize()
    assert maxsim.maxsim_search.launches == before + 1
    lq = shape[1]
    torch.testing.assert_close(got, maxsim.maxsim_search_torch(q, tok, mask),
                               rtol=1e-5, atol=1e-4 * lq)
    assert torch.equal(got[:, ::5], torch.full_like(got[:, ::5],
                                                    -9999.0 * lq))


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [MMA_SERVE_SHAPES[0], MMA_SERVE_SHAPES[3],
                                   (2, 64, 4096, 220, 128)])
def test_maxsim_mma_route_repeats_bit_for_bit(q_dtype, shape):
    """Every route (the float32 index's too) repeats bit for bit: the
    persistent blocks' walk and the summers' order are fixed."""
    for t_dtype in (torch.bfloat16,) + ((torch.float32,)
                                        if q_dtype == torch.float32 else ()):
        q, tok, mask = make(shape, q_dtype, t_dtype)
        a = maxsim.maxsim_search(q, tok, mask)
        for _ in range(3):
            assert torch.equal(a, maxsim.maxsim_search(q, tok, mask))


def test_maxsim_mma_launches_count_the_bf16_index_route_only():
    """Every call launches the tensor-core kernel; split_launches counts
    the float32 index's split route only."""
    q, tok, mask = make(SHAPES[0], torch.float32, torch.float32)
    launches = maxsim.maxsim_search.launches
    split = maxsim.maxsim_search.split_launches
    maxsim.maxsim_search(q, tok, mask)                    # f32 x f32: planes
    assert maxsim.maxsim_search.launches == launches + 1
    assert maxsim.maxsim_search.split_launches == split + 1
    maxsim.maxsim_search(q, tok.bfloat16(), mask)         # f32 x bf16
    maxsim.maxsim_search(q.bfloat16(), tok.bfloat16(), mask)
    assert maxsim.maxsim_search.launches == launches + 3
    assert maxsim.maxsim_search.split_launches == split + 1


# -- K1 on a float32 index: two bf16 planes, three products --------------------

# the float32 serve's shape at a small N (Ld=220 over two 112-column tiles),
# 64-token docs (two a tile), N a multiple of nothing, and the PreFLMR
# query (Lq=320: one query over three 128-row chunks); then every caller's
# geometry: the serve's bucket of 2, RAG's live retrieval (B 8), the
# training-time exact evaluation (B 192), WIT (Lq 32, B 64 and 1,024),
# M2KR (Lq 320, N 4,096), ROI (Lq 352: one query over three row chunks,
# the last part full), the triples (Ld 180: 96-column tiles), PreFLMR's
# exact search (Ld 512: four tiles a doc) and a shard of the sharded
# search (N 4,096)
SPLIT_SHAPES = [(32, 64, 203, 220, 128), (32, 32, 1031, 64, 128),
                (4, 64, 57, 100, 64), (8, 320, 203, 220, 128),
                (2, 64, 203, 220, 128), (8, 64, 1031, 220, 128),
                (192, 64, 509, 220, 128), (64, 32, 1031, 220, 128),
                (1024, 32, 67, 220, 128), (64, 320, 4096, 220, 128),
                (64, 352, 203, 220, 128), (64, 32, 1031, 180, 128),
                (32, 320, 203, 512, 128), (32, 64, 4096, 220, 128)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("negative", [False, True])
def test_maxsim_split_route_matches_plain(shape, negative):
    """A float32 index read as its bf16 planes, made once
    (split_index_bf16) or by the call: the plain float32 MaxSim to the card
    tolerance, an all-masked doc at exactly -9999 * Lq."""
    q, tok, mask = make(shape, torch.float32, torch.float32,
                        negative=negative)
    planes = maxsim.split_index_bf16(tok)
    before = maxsim.maxsim_search.split_launches
    got = maxsim.maxsim_search(q, tok, mask, planes=planes)
    torch.cuda.synchronize()
    assert maxsim.maxsim_search.split_launches == before + 1
    lq = shape[1]
    torch.testing.assert_close(got, maxsim.maxsim_search_torch(q, tok, mask),
                               rtol=1e-5, atol=1e-4 * lq)
    assert torch.equal(got[:, ::5], torch.full_like(got[:, ::5],
                                                    -9999.0 * lq))
    assert torch.equal(got, maxsim.maxsim_search(q, tok, mask))


def test_maxsim_split_route_refuses_wrong_planes():
    q, tok, mask = make(SPLIT_SHAPES[0], torch.float32, torch.float32)
    with pytest.raises(ValueError, match="planes"):
        maxsim.maxsim_search(q, tok, mask, planes=tok.bfloat16())


def test_cuda_searcher_keeps_the_planes_of_a_float32_index():
    rng = np.random.default_rng(4)
    embs = rng.normal(size=(40, 20, 64)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    masks = (rng.random((40, 20)) > 0.2).astype(np.float32)
    idx = build_index_from_embeddings(embs, masks, pad_multiple=8,
                                      dtype=torch.float32, device="cuda")
    s = LateInteractionSearcher(idx)
    q = torch.from_numpy(rng.normal(size=(3, 16, 64)).astype(
        np.float32)).cuda()
    s.search_device(q, 5)
    planes = idx.token_planes()
    s.search_device(q, 5)
    assert idx.token_planes() is planes               # made once
    assert planes.shape == (40, 20, 128) and planes.dtype == torch.bfloat16


# -- K2, K3, K4 ----------------------------------------------------------------

@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


# (B, Lq, S, N, dim): N ragged against the 128-doc tile; several query
# groups per block (Lq <= 64), one query over 64-128 columns (Lq=80) and
# over two column steps (Lq=150); Lq=7 is a multiple of nothing; S=1..8
SWEEP_SHAPES = [(3, 6, 3, 37, 16), (32, 32, 8, 1000, 128),
                (2, 150, 2, 130, 64), (4, 80, 4, 129, 32),
                (5, 7, 1, 300, 32), (1, 1, 4, 9, 16)]


def make_sweep(shape, dtype, negative=False, seed=0, all_invalid=False):
    b, lq, s, n, dim = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, dim)).astype(np.float32)
    st = rng.normal(size=(s, n, dim)).astype(np.float32)
    if negative:                     # every q.d < 0: catches a max from 0
        q, st = np.abs(q), -np.abs(st)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    st /= np.linalg.norm(st, axis=-1, keepdims=True)
    if lq > 1:
        q[:, -1] = 0.0               # a zero query row
    valid = np.ones(n, np.int8)
    valid[::5] = 0                   # docs with no valid token
    if all_invalid:
        valid[:] = 0
    return (torch.from_numpy(q).cuda(),
            torch.from_numpy(st).cuda().to(dtype),
            torch.from_numpy(valid).cuda())


def _close(got, want, lq):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * lq)


@pytest.mark.parametrize("shape", SWEEP_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("negative", [False, True])
def test_coarse_sweep_kernel_matches_plain(shape, dtype, negative):
    q, st, valid = make_sweep(shape, dtype, negative)
    before = maxsim.coarse_sweep.launches
    got = maxsim.coarse_sweep(q, st, valid)
    torch.cuda.synchronize()
    assert maxsim.coarse_sweep.launches == before + 1
    _close(got, maxsim.coarse_sweep_torch(q, st, valid), shape[1])
    assert torch.equal(got[:, ::5], torch.full_like(got[:, ::5], -9999.0))
    if negative:
        assert bool((got[:, 1::5] < 0).all())


@pytest.mark.parametrize("shape", SWEEP_SHAPES)
@pytest.mark.parametrize("negative", [False, True])
def test_coarse_sweep_int8_kernel_matches_plain(shape, negative):
    q, st, valid = make_sweep(shape, torch.float32, negative, seed=1)
    st8, dsc = quantize_summaries_t_int8(st)
    q8, qs = quantize_queries_int8(q)
    ones_q, ones_d = torch.ones_like(qs), torch.ones_like(dsc)
    raw = maxsim.coarse_sweep_int8(q8, ones_q, st8, ones_d, valid)
    assert torch.equal(raw, maxsim.coarse_sweep_int8_torch(
        q8, ones_q, st8, ones_d, valid))
    before = maxsim.coarse_sweep_int8.launches
    got = maxsim.coarse_sweep(q, st8, valid, dscale=dsc)
    torch.cuda.synchronize()
    assert maxsim.coarse_sweep_int8.launches == before + 1
    _close(got, maxsim.coarse_sweep_torch(q, st8, valid, dscale=dsc),
           shape[1])
    assert torch.equal(got[:, ::5], torch.full_like(got[:, ::5], -9999.0))


@pytest.mark.parametrize("negative", [False, True])
def test_coarse_sweeps_at_the_preflmr_query(negative):
    """K2 (bf16) and K3 at the PreFLMR query's Lq=320 (one query over
    three column passes of 128): the plain versions to the card
    tolerance, invalid docs at exactly -9999. K3's raw sums (unit scales)
    add 320 exact integer maxima in float32: bit for bit equal to the
    plain version's while every partial sum stays below 2^24 in magnitude
    (the mixed-sign data: about 9.5e6), and past it (the all-negative
    data: about 5.8e7) within float32's rounding of each addition, since
    the kernel and the plain version add in different orders."""
    shape = (4, 320, 4, 1024, 128)
    lq = shape[1]
    q, st, valid = make_sweep(shape, torch.bfloat16, negative)
    got = maxsim.coarse_sweep(q, st, valid)
    _close(got, maxsim.coarse_sweep_torch(q, st, valid), lq)
    assert torch.equal(got[:, ::5], torch.full_like(got[:, ::5], -9999.0))
    q, st, valid = make_sweep(shape, torch.float32, negative, seed=1)
    st8, dsc = quantize_summaries_t_int8(st)
    q8, qs = quantize_queries_int8(q)
    ones_q, ones_d = torch.ones_like(qs), torch.ones_like(dsc)
    raw = maxsim.coarse_sweep_int8(q8, ones_q, st8, ones_d, valid)
    want = maxsim.coarse_sweep_int8_torch(q8, ones_q, st8, ones_d, valid)
    b, _, _, n, dim = shape
    absum = maxsim._slot_max(q8.reshape(b * lq, dim).float(), st8,
                             1 << 26).abs().reshape(b, lq, n).sum(dim=1)
    if float(absum.max()) < 2 ** 24:
        assert torch.equal(raw, want)
    else:
        ok = valid.bool()
        err = (raw - want).abs()[:, ok]
        assert bool((err <= 2 * lq * 2.0 ** -24 * absum[:, ok]).all())
    got = maxsim.coarse_sweep(q, st8, valid, dscale=dsc)
    _close(got, maxsim.coarse_sweep_torch(q, st8, valid, dscale=dsc), lq)
    assert torch.equal(got[:, ::5], torch.full_like(got[:, ::5], -9999.0))


def test_coarse_sweep_all_invalid_and_no_validity_row():
    shape = SWEEP_SHAPES[1]
    q, st, valid = make_sweep(shape, torch.bfloat16, all_invalid=True)
    got = maxsim.coarse_sweep(q, st, valid)
    assert torch.equal(got, torch.full_like(got, -9999.0))
    _close(maxsim.coarse_sweep(q, st), maxsim.coarse_sweep_torch(q, st),
           shape[1])


@pytest.mark.parametrize("shape", SWEEP_SHAPES)
def test_coarse_sweep_bf16_takes_the_tensor_core_body(shape):
    """bf16 summaries run K2's tensor-core body: the wrapper equals the
    launch alone bit for bit and each counts once; float32 summaries count
    on the same counter."""
    q, st, valid = make_sweep(shape, torch.bfloat16, seed=3)
    before = maxsim.coarse_sweep.launches
    got = maxsim.coarse_sweep(q, st, valid)
    alone = maxsim.launch_coarse_bf16(q.bfloat16(), st, valid)
    assert maxsim.coarse_sweep.launches == before + 2
    assert torch.equal(got, alone)
    maxsim.coarse_sweep(q, st.float(), valid)
    assert maxsim.coarse_sweep.launches == before + 3


@pytest.mark.parametrize("negative", [False, True])
def test_coarse_sweep_bf16_at_the_two_stage_shape(negative):
    q, st, valid = make_sweep((32, 32, 8, 112640, 128), torch.bfloat16,
                              negative, seed=7)
    got = maxsim.coarse_sweep(q, st, valid)
    _close(got, maxsim.coarse_sweep_torch(q, st, valid), 32)
    assert torch.equal(got[:, ::5], torch.full_like(got[:, ::5], -9999.0))
    assert torch.equal(got, maxsim.coarse_sweep(q, st, valid))


# (B, Lq, S, bs, n_blocks, NB, dim): gathered docs per query below one
# 128-row tile (72), ragged over tiles (300), the bench's 64 x 32
STAGE1_SHAPES = [(3, 6, 3, 16, 5, 7, 16), (32, 32, 8, 64, 32, 40, 128),
                 (2, 150, 2, 24, 3, 4, 64), (4, 7, 1, 100, 3, 5, 32),
                 (1, 1, 4, 8, 1, 2, 16), (4, 320, 8, 64, 32, 64, 128)]


def make_stage1(shape, rows_dtype, negative=False, seed=2):
    b, lq, s, bs, nbl, nb, dim = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, dim)).astype(np.float32)
    summ = rng.normal(size=(nb * bs, s, dim)).astype(np.float32)
    if negative:
        q, summ = np.abs(q), -np.abs(summ)
    if lq > 1:
        q[:, -1] = 0.0               # a zero query row
    summ = torch.from_numpy(summ).cuda()
    dscale = None
    if rows_dtype == torch.int8:
        summ, dscale = quantize_summaries_int8(summ)
    else:
        summ = summ.to(rows_dtype)
    rows = maxsim.stage1_rows(summ, bs)
    blk = torch.from_numpy(rng.integers(0, nb, size=(b, nbl))).cuda()
    return torch.from_numpy(q).cuda(), rows, blk, dscale


@pytest.mark.parametrize("shape", STAGE1_SHAPES)
@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16,
                                        torch.int8])
@pytest.mark.parametrize("negative", [False, True])
def test_stage1_sweep_kernel_matches_plain(shape, rows_dtype, negative):
    q, rows, blk, dscale = make_stage1(shape, rows_dtype, negative)
    before = maxsim.stage1_sweep.launches
    got = maxsim.stage1_sweep(q, rows, blk, dscale=dscale)
    torch.cuda.synchronize()
    assert maxsim.stage1_sweep.launches == before + 1
    want = maxsim.stage1_sweep_torch(q, rows, blk, dscale=dscale)
    assert got.shape == (shape[0], shape[4] * shape[3])
    # unnormalized rows: scores ~ Lq * 10 (int8 codes ~ 127 before the
    # scale); relative 1e-5 covers the summation order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3 * shape[1])
    if negative:
        assert bool((got < 0).all())


def test_sweep_kernels_are_deterministic():
    q, st, valid = make_sweep(SWEEP_SHAPES[1], torch.bfloat16)
    assert torch.equal(maxsim.coarse_sweep(q, st, valid),
                       maxsim.coarse_sweep(q, st, valid))
    st8, dsc = quantize_summaries_t_int8(st)
    assert torch.equal(maxsim.coarse_sweep(q, st8, valid, dscale=dsc),
                       maxsim.coarse_sweep(q, st8, valid, dscale=dsc))
    q, rows, blk, _ = make_stage1(STAGE1_SHAPES[1], torch.bfloat16)
    assert torch.equal(maxsim.stage1_sweep(q, rows, blk),
                       maxsim.stage1_sweep(q, rows, blk))


# -- K3 and K4 on the tensor cores (csrc/summary_tile.cuh) at the serve's
# shapes: Lq = 64 (32 text + 32 mapping tokens); K3 over 1,024 padded
# blocks x 4 summaries, 256 valid; K4 over 32 of 256 blocks of 64 docs x 8
# summaries

def make_serve_stage0(seed=5):
    q, st, _ = make_sweep((32, 64, 4, 1024, 128), torch.float32, seed=seed)
    valid = torch.zeros(1024, dtype=torch.int8, device="cuda")
    valid[:256] = 1
    st[:, 256:] = 0
    return q, st, valid


@pytest.mark.parametrize("negative", [False, True])
def test_coarse_sweep_int8_kernel_at_the_serve_shape(negative):
    q, st, valid = make_serve_stage0()
    if negative:
        q, st = q.abs(), -st.abs()
    st8, dsc = quantize_summaries_t_int8(st)
    q8, qs = quantize_queries_int8(q)
    ones_q, ones_d = torch.ones_like(qs), torch.ones_like(dsc)
    assert torch.equal(
        maxsim.coarse_sweep_int8(q8, ones_q, st8, ones_d, valid),
        maxsim.coarse_sweep_int8_torch(q8, ones_q, st8, ones_d, valid))
    got = maxsim.coarse_sweep(q, st8, valid, dscale=dsc)
    _close(got, maxsim.coarse_sweep_torch(q, st8, valid, dscale=dsc), 64)
    assert torch.equal(got[:, 256:], torch.full_like(got[:, 256:], -9999.0))


def test_coarse_sweep_int8_unit_scales_exact_at_the_two_stage_shape():
    q, st, valid = make_sweep((32, 32, 8, 112640, 128), torch.float32,
                              seed=6)
    st8, dsc = quantize_summaries_t_int8(st)
    q8, qs = quantize_queries_int8(q)
    ones_q, ones_d = torch.ones_like(qs), torch.ones_like(dsc)
    assert torch.equal(
        maxsim.coarse_sweep_int8(q8, ones_q, st8, ones_d, valid),
        maxsim.coarse_sweep_int8_torch(q8, ones_q, st8, ones_d, valid))


@pytest.mark.parametrize("rows_dtype", [torch.bfloat16, torch.int8])
def test_stage1_sweep_kernel_at_the_serve_shape(rows_dtype):
    q, rows, _, dscale = make_stage1((32, 64, 8, 64, 32, 256, 128),
                                     rows_dtype)
    blk = torch.rand(32, 256, device="cuda").argsort(dim=1)[:, :32]
    got = maxsim.stage1_sweep(q, rows, blk, dscale=dscale)
    want = maxsim.stage1_sweep_torch(q, rows, blk, dscale=dscale)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3 * 64)


def test_summary_sweeps_repeat_bit_for_bit_at_the_serve_shapes():
    q, st, valid = make_serve_stage0()
    st8, dsc = quantize_summaries_t_int8(st)
    assert torch.equal(maxsim.coarse_sweep(q, st8, valid, dscale=dsc),
                       maxsim.coarse_sweep(q, st8, valid, dscale=dsc))
    for rows_dtype in (torch.bfloat16, torch.int8):
        q, rows, blk, dscale = make_stage1((32, 64, 8, 64, 32, 256, 128),
                                           rows_dtype)
        assert torch.equal(maxsim.stage1_sweep(q, rows, blk, dscale=dscale),
                           maxsim.stage1_sweep(q, rows, blk, dscale=dscale))


def test_summary_sweep_launches_count_every_route():
    """stage1_sweep counts float32 (CUDA cores), bf16 and int8 rows
    (tensor cores), each route once a call; the launches alone count on
    their wrappers' counters too; float32 rows still take their scale
    after the kernel."""
    shape = STAGE1_SHAPES[1]
    for rows_dtype in (torch.float32, torch.bfloat16, torch.int8):
        q, rows, blk, dscale = make_stage1(shape, rows_dtype)
        before = maxsim.stage1_sweep.launches
        got = maxsim.stage1_sweep(q, rows, blk, dscale=dscale)
        assert maxsim.stage1_sweep.launches == before + 1
        qc = q.to(torch.float32 if rows_dtype == torch.float32
                  else torch.bfloat16)
        raw = maxsim.launch_stage1(qc, rows, blk.to(torch.int32), dscale)
        assert maxsim.stage1_sweep.launches == before + 2
        torch.testing.assert_close(raw, got, rtol=0, atol=0)
    q, rows, blk, _ = make_stage1(shape, torch.float32)
    scale = torch.rand(rows.shape[0] * rows.shape[2], device="cuda") + 0.5
    torch.testing.assert_close(
        maxsim.stage1_sweep(q, rows, blk, dscale=scale),
        maxsim.stage1_sweep_torch(q, rows, blk, dscale=scale),
        rtol=1e-5, atol=1e-3 * shape[1])
    q, st, valid = make_sweep(SWEEP_SHAPES[1], torch.float32)
    st8, dsc = quantize_summaries_t_int8(st)
    q8, qs = quantize_queries_int8(q)
    before = maxsim.coarse_sweep_int8.launches
    got = maxsim.coarse_sweep(q, st8, valid, dscale=dsc)
    alone = maxsim.launch_coarse_int8(q8, qs, st8, dsc, valid)
    assert maxsim.coarse_sweep_int8.launches == before + 2
    assert torch.equal(got, alone)


def test_sweep_wrappers_raise_on_bad_input():
    q, st, valid = make_sweep(SWEEP_SHAPES[0], torch.float32)
    with pytest.raises(TypeError):
        maxsim.coarse_sweep(q, st.double(), valid)
    with pytest.raises(ValueError):                  # dim % 8
        maxsim.coarse_sweep(q[:, :, :12], st[:, :, :12].contiguous(), valid)
    with pytest.raises(ValueError):                  # dim mismatch
        maxsim.coarse_sweep(q, st[:, :, :8].contiguous(), valid)
    with pytest.raises(ValueError):                  # device
        maxsim.coarse_sweep(q, st.cpu(), valid)
    with pytest.raises(ValueError):                  # valid's length
        maxsim.coarse_sweep(q, st, valid[:-1])
    st8, dsc = quantize_summaries_t_int8(st)
    q8, qs = quantize_queries_int8(q)
    with pytest.raises(TypeError):
        maxsim.coarse_sweep_int8(q8.float(), qs, st8, dsc, valid)
    with pytest.raises(ValueError):                  # int8 needs dim % 16
        maxsim.coarse_sweep_int8(q8[:, :, :8].contiguous(), qs,
                                 st8[:, :, :8].contiguous(), dsc, valid)
    q, rows, blk, _ = make_stage1(STAGE1_SHAPES[0], torch.bfloat16)
    with pytest.raises(ValueError):                  # blk's batch
        maxsim.stage1_sweep(q, rows, blk[:1])
    with pytest.raises(ValueError):                  # device
        maxsim.stage1_sweep(q, rows, blk.cpu())
    with pytest.raises(ValueError):                  # layout
        maxsim.stage1_sweep(q, rows.transpose(1, 2), blk)
    with pytest.raises(TypeError):
        maxsim.stage1_sweep(q, rows.double(), blk)


def _pruned_indexes(n=1024, block_size=16):
    """The same clustered corpus on the CPU and on the card, with the
    CPU's summaries copied to the card, so both prune from equal inputs."""
    rng = np.random.default_rng(4)
    ld, dim = 16, 64
    topics = rng.normal(size=(16, dim))
    embs = topics[np.sort(rng.integers(16, size=n))][:, None] \
        + 0.35 * rng.normal(size=(n, ld, dim))
    embs = (embs / np.linalg.norm(embs, axis=-1, keepdims=True)).astype(
        np.float32)
    masks = (rng.random((n, ld)) > 0.2).astype(np.float32)
    q = embs[rng.integers(n, size=8), :12] + 0.1 * rng.normal(
        size=(8, 12, dim))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    cpu = build_index_from_embeddings(embs, masks, pad_multiple=8,
                                      dtype=torch.float32)
    cpu.build_summaries(n_summary=4).build_block_summaries(
        block_size=block_size)
    gpu = build_index_from_embeddings(embs, masks, pad_multiple=8,
                                      dtype=torch.float32, device="cuda")
    gpu.summaries = cpu.summaries.cuda()
    gpu.block_summaries = cpu.block_summaries.cuda()
    gpu.block_size = block_size
    return cpu, gpu, q


@pytest.mark.parametrize("mode,preset,kernels", [
    ("two_stage", "reference", ("coarse_sweep",)),
    ("two_stage", "fast", ("coarse_sweep_int8",)),
    ("hierarchical", "reference", ("coarse_sweep",)),
    ("hierarchical", "fast", ("coarse_sweep_int8", "stage1_sweep"))])
def test_cuda_pruned_searcher_matches_cpu_searcher(mode, preset, kernels):
    cpu_idx, gpu_idx, q = _pruned_indexes()
    kw = dict(mode=mode, preset=preset, n_candidates=48)
    cpu = LateInteractionSearcher(cpu_idx, use_pallas=True, **kw)
    gpu = LateInteractionSearcher(gpu_idx, **kw)
    assert gpu.use_pallas
    before = {k: getattr(maxsim, k).launches for k in kernels}
    gs, gp = gpu.search(q, k=5)
    for k in kernels:
        assert getattr(maxsim, k).launches == before[k] + 1, k
    cs, cp = cpu.search(q, k=5)
    np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=1e-4 * 12)
    np.testing.assert_array_equal(np.sort(gp, 1), np.sort(cp, 1))


def test_cuda_index_refuses_the_plain_route():
    _, gpu_idx, _ = _pruned_indexes()
    for mode in ("exact", "two_stage", "hierarchical"):
        with pytest.raises(ValueError, match="use_pallas=False"):
            LateInteractionSearcher(gpu_idx, mode=mode, use_pallas=False)


@pytest.mark.parametrize("n_docs,k", [(64, 5), (192, 150)])
def test_cuda_fast_hierarchical_runs_k4_off_the_lane_rule(n_docs, k):
    """Block size 16 would ask the TPU kernel for a multiple of 8 selected
    blocks. 64 docs are 4 blocks, below that at construction; 192 docs are
    12 blocks, and k=150 needs 10, more than the 8 aligned ones. A CPU
    index runs the plain stage 1 there, as the JAX searcher does; a CUDA
    index still runs K4, over every block. Every doc is then a candidate,
    so the answer is exact search's."""
    cpu_idx, gpu_idx, q = _pruned_indexes(n=n_docs)
    gpu = LateInteractionSearcher(gpu_idx, mode="hierarchical",
                                  preset="fast")
    assert gpu._summ_rows is not None
    before = maxsim.stage1_sweep.launches
    gs, gp = gpu.search(q, k=k)
    assert maxsim.stage1_sweep.launches == before + 1
    es, ep = LateInteractionSearcher(cpu_idx).search(q, k=k)
    np.testing.assert_allclose(gs, es, rtol=1e-5, atol=1e-4 * 12)
    np.testing.assert_array_equal(np.sort(gp, 1), np.sort(ep, 1))


# -- K5 (int8 exact search) and K6 (fused residual decompress + MaxSim) --------

# (B, Lq, N, Ld, dim): N off the 8-doc tile; Ld 64 (the 64-row tile), 220
# and 150 (two 128-row steps, ragged), 9 and 1; one query over 64-128
# columns (Lq=80) and over two column steps (Lq=200)
INT8_SHAPES = [(3, 6, 37, 9, 16), (2, 80, 21, 150, 128),
               (32, 32, 203, 64, 128), (5, 32, 19, 220, 64),
               (3, 200, 11, 70, 32), (7, 1, 9, 1, 16)]


def make_int8(shape, negative=False, seed=5):
    b, lq, n, ld, dim = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, dim)).astype(np.float32)
    tok = rng.normal(size=(n, ld, dim)).astype(np.float32)
    if negative:                     # every q.d < 0: catches a max from 0
        q, tok = np.abs(q), -np.abs(tok)
    mask = (rng.random((n, ld)) > 0.3).astype(np.int8)
    mask[::5] = 0                    # docs with no valid token
    if lq > 1:
        q[:, -1] = 0.0               # a zero query row
    tok8, ds = quantize_index_int8(torch.from_numpy(tok).cuda(),
                                   torch.from_numpy(mask).cuda())
    q8, qs = quantize_queries_int8(torch.from_numpy(q).cuda())
    return q8, qs, tok8, ds


@pytest.mark.parametrize("shape", INT8_SHAPES)
@pytest.mark.parametrize("negative", [False, True])
def test_maxsim_int8_kernel_matches_plain(shape, negative):
    """int32 dot products and their scaled values are equal on both sides;
    the float32 sums over Lq run in another order."""
    q8, qs, tok8, ds = make_int8(shape, negative)
    before = quant.maxsim_search_int8.launches
    got = quant.maxsim_search_int8(q8, qs, tok8, ds)
    torch.cuda.synchronize()
    assert quant.maxsim_search_int8.launches == before + 1
    want = quant.maxsim_search_int8_q8_torch(q8, qs, tok8, ds)
    _close(got, want, shape[1])
    torch.testing.assert_close(got[:, ::5], (-9999.0 * qs.sum(1))[:, None]
                               .expand_as(got[:, ::5]), rtol=1e-6, atol=0)
    assert torch.equal(got, quant.maxsim_search_int8(q8, qs, tok8, ds))
    if negative:
        assert bool((got[:, 1::5] < 0).all())


def test_maxsim_int8_wrapper_raises_on_bad_input():
    q8, qs, tok8, ds = make_int8(INT8_SHAPES[0])
    with pytest.raises(TypeError):
        quant.maxsim_search_int8(q8.float(), qs, tok8, ds)
    with pytest.raises(ValueError):                   # dim % 16
        quant.maxsim_search_int8(q8[:, :, :8].contiguous(), qs,
                                 tok8[:, :, :8].contiguous(), ds)
    with pytest.raises(ValueError):                   # shapes
        quant.maxsim_search_int8(q8, qs[:, :-1].contiguous(), tok8, ds)
    with pytest.raises(ValueError):                   # device
        quant.maxsim_search_int8(q8, qs, tok8.cpu(), ds)


@pytest.mark.parametrize("shape", MMA_SERVE_SHAPES)
def test_maxsim_int8_kernel_at_serve_shapes(shape):
    q8, qs, tok8, ds = make_int8(shape)
    got = quant.maxsim_search_int8(q8, qs, tok8, ds)
    _close(got, quant.maxsim_search_int8_q8_torch(q8, qs, tok8, ds),
           shape[1])
    torch.testing.assert_close(got[:, ::5], (-9999.0 * qs.sum(1))[:, None]
                               .expand_as(got[:, ::5]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", INT8_SHAPES + MMA_SERVE_SHAPES[:1])
@pytest.mark.parametrize("negative", [False, True])
def test_maxsim_int8_unit_scales_equal_plain_exactly(shape, negative):
    """With unit query and doc scales (0 kept on invalid tokens) every
    maximum is an int32 dot product or -9999, and every partial sum an
    integer below 2^24: any summation order gives the plain version's
    float32 bit for bit, as K3's pre-scale sums do."""
    q8, qs, tok8, ds = make_int8(shape, negative)
    ones_q, unit_d = torch.ones_like(qs), (ds > 0).float()
    got = quant.maxsim_search_int8(q8, ones_q, tok8, unit_d)
    want = quant.maxsim_search_int8_q8_torch(q8, ones_q, tok8, unit_d)
    assert float(want.abs().max()) < 2 ** 24
    assert torch.equal(got, want)


# (B, Lq, C, N, Ld, dim): C off any tile (13, 37), the 1M fine-stage shape
# (B=32, Lq=32, C=256, Ld=64, dim=128), Ld 220 across two tiles with
# Lq=64, Lq > 64 (the 8 x 8 tile), one token and one query token
RES_SHAPES = [(2, 5, 13, 40, 9, 16), (32, 32, 256, 600, 64, 128),
              (3, 64, 37, 100, 220, 128), (2, 100, 20, 50, 30, 64),
              (1, 1, 1, 5, 1, 8)]


def make_residual(shape, nbits, factored, negative=False, seed=6):
    """Random records of N docs for a random codec (flat: 64 centroids;
    factored: 8 x 16), candidates with repeats and docs with no valid
    token. negative: every centroid and weight > 0 and every query value
    < 0, so every token score is negative."""
    b, lq, c, n, ld, dim = shape
    rng = np.random.default_rng(seed)
    if factored:
        coarse = rng.normal(size=(8, dim)).astype(np.float32) * 0.3
        fine = rng.normal(size=(16, dim)).astype(np.float32) * 0.1
        if negative:
            coarse, fine = np.abs(coarse), np.abs(fine)
        cent = (coarse[:, None] + fine[None]).reshape(-1, dim)
    else:
        coarse = fine = None
        cent = rng.normal(size=(64, dim)).astype(np.float32) * 0.3
        if negative:
            cent = np.abs(cent)
    w = np.sort(rng.normal(size=2 ** nbits)).astype(np.float32) * 0.05
    if negative:
        w = np.abs(w) + 0.01
    q = rng.normal(size=(b, lq, dim)).astype(np.float32)
    q = -np.abs(q) if negative else q
    codes = rng.integers(0, len(cent), size=(n, ld))
    scales = rng.uniform(0.5, 1.5, size=(n, ld)).astype(np.float32)
    packed = rng.integers(0, 256, size=(n, ld, dim * nbits // 8)).astype(
        np.uint8)
    mask = (rng.random((n, ld)) > 0.3).astype(np.int8)
    mask[::5] = 0                    # docs with no valid token
    cand = rng.integers(0, n, size=(b, c))
    cand[:, 0] = 0                   # doc 0 has no valid token
    t = lambda x: None if x is None else torch.from_numpy(x).cuda()
    records = residual.pack_records(t(codes), t(scales), t(packed))
    return dict(q=t(q), records=records, cand=t(cand), mask=t(mask),
                centroids=t(cent), bucket_weights=t(w), nbits=nbits,
                coarse=t(coarse), fine=t(fine))


@pytest.mark.parametrize("shape", RES_SHAPES)
@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("factored", [False, True])
def test_residual_kernel_matches_plain(shape, nbits, factored):
    """The same bf16 products on both sides, float32 sums in another
    order."""
    a = make_residual(shape, nbits, factored)
    before = residual.maxsim_residual.launches
    got = residual.maxsim_residual(**a)
    torch.cuda.synchronize()
    assert residual.maxsim_residual.launches == before + 1
    want = residual.maxsim_residual_torch(**a)
    _close(got, want, shape[1])
    assert torch.equal(got[:, 0], torch.full_like(got[:, 0],
                                                  -9999.0 * shape[1]))
    assert torch.equal(got, residual.maxsim_residual(**a))


@pytest.mark.parametrize("factored", [False, True])
def test_residual_kernel_keeps_negative_maxima(factored):
    a = make_residual(RES_SHAPES[2], 2, factored, negative=True)
    got = residual.maxsim_residual(**a)
    _close(got, residual.maxsim_residual_torch(**a), RES_SHAPES[2][1])
    valid = (a["mask"][a["cand"]] != 0).any(-1)
    assert bool((got[valid] < 0).all()) and bool(valid.any())


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("nbits", [2, 4])
def test_residual_kernel_at_serve_shapes(factored, nbits):
    """The 1M fine stage's shape (B=32, Lq=32, C=256, Ld=64) and the
    residual serve's (Lq=64, Ld=220): every block of ~29 candidates,
    candidates over several chunks, the 8-byte decode."""
    for shape in ((32, 32, 256, 600, 64, 128), (32, 64, 256, 300, 220, 128)):
        a = make_residual(shape, nbits, factored)
        got = residual.maxsim_residual(**a)
        _close(got, residual.maxsim_residual_torch(**a), shape[1])
        assert torch.equal(got[:, 0], torch.full_like(got[:, 0],
                                                      -9999.0 * shape[1]))


def test_residual_kernel_flat_table_of_1024_at_lq_64():
    """The largest flat table the fused stage sends to the kernel."""
    a = make_residual((4, 64, 40, 60, 64, 128), 2, False)
    rng = np.random.default_rng(7)
    a["centroids"] = torch.from_numpy(
        rng.normal(size=(1024, 128)).astype(np.float32) * 0.3).cuda()
    codes = torch.from_numpy(rng.integers(0, 1024, size=(60, 64))).cuda()
    _, scl, pck = residual.split_records(a["records"], 64)
    a["records"] = residual.pack_records(codes, scl, pck)
    _close(residual.maxsim_residual(**a), residual.maxsim_residual_torch(**a),
           64)


def test_residual_wrapper_raises_on_bad_input():
    a = make_residual(RES_SHAPES[0], 2, True)
    with pytest.raises(ValueError):                   # nbits
        residual.maxsim_residual(**dict(a, nbits=3))
    with pytest.raises(ValueError):                   # records' width
        residual.maxsim_residual(**dict(a, nbits=4))
    with pytest.raises(ValueError):                   # factors' sizes
        residual.maxsim_residual(**dict(a, fine=a["fine"][:3]))
    with pytest.raises(TypeError):
        residual.maxsim_residual(**dict(a, mask=a["mask"].bool()))
    with pytest.raises(ValueError):                   # device
        residual.maxsim_residual(**dict(a, cand=a["cand"].cpu()))
    big = dict(a, centroids=torch.randn(40000, 16, device="cuda"),
               coarse=None, fine=None)
    with pytest.raises(RuntimeError):                 # table > shared memory
        residual.maxsim_residual(**big)


def _compressed_indexes(codec, n=1024):
    """The clustered corpus of _pruned_indexes, compressed on the CPU and
    copied to the card, so both sides search equal data."""
    cpu, gpu, q = _pruned_indexes(n=n)
    if codec == "int8":
        cpu.quantize_int8()
    else:
        cpu.quantize_residual(n_centroids=(8, 16) if codec == "factored"
                              else 64, nbits=2)
    gpu.tokens = None if cpu.tokens is None else cpu.tokens.cuda()
    for name in ("scales", "records", "codec_centroids", "codec_weights",
                 "codec_coarse", "codec_fine"):
        v = getattr(cpu, name)
        setattr(gpu, name, None if v is None else v.cuda())
    gpu.nbits = cpu.nbits
    return cpu, gpu, q


@pytest.mark.parametrize("codec,mode,kernels", [
    ("int8", "exact", ("maxsim_search_int8",)),
    ("int8", "hierarchical", ("coarse_sweep_int8", "stage1_sweep")),
    ("flat", "two_stage", ("maxsim_residual",)),
    ("flat", "hierarchical", ("maxsim_residual", "stage1_sweep")),
    ("factored", "hierarchical", ("maxsim_residual", "coarse_sweep_int8",
                                  "stage1_sweep"))])
def test_cuda_compressed_searcher_matches_cpu_searcher(codec, mode, kernels):
    cpu_idx, gpu_idx, q = _compressed_indexes(codec)
    kw = dict(mode=mode, preset="fast", n_candidates=48)
    cpu = LateInteractionSearcher(cpu_idx, use_pallas=True, **kw)
    gpu = LateInteractionSearcher(gpu_idx, **kw)
    wrappers = {"maxsim_search_int8": quant.maxsim_search_int8,
                "maxsim_residual": residual.maxsim_residual,
                "coarse_sweep_int8": maxsim.coarse_sweep_int8,
                "stage1_sweep": maxsim.stage1_sweep}
    before = {k: wrappers[k].launches for k in kernels}
    gs, gp = gpu.search(q, k=5)
    for k in kernels:
        assert wrappers[k].launches == before[k] + 1, k
    cs, cp = cpu.search(q, k=5)
    np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=1e-4 * 12)
    np.testing.assert_array_equal(np.sort(gp, 1), np.sort(cp, 1))


# -- X1, X2/X3: the stage-2 experiment's scorers -----------------------------

# (C, Ld): C a multiple of 128, of neither 32 nor 128 (200), and the
# experiment's 1,024; Ld the experiment's 64 (several candidates a tile) and
# 220 (a candidate across tiles); B=4, Lq=32, dim=128
STAGE2_SHAPES = [(c, ld) for c in (128, 200, 1024) for ld in (64, 220)]
# Lq of each register-tile width (<= 32, <= 64, <= 128) and its edges
STAGE2_LQ = [1, 5, 32, 33, 64, 100, 128]


def make_x1(c, ld, b=4, lq=32, dim=128, negative=False, seed=8):
    """X1's inputs made on the card: ids 0-3, random centroid scores,
    scales in [0.5, 1.5), ~30 % of the tokens masked and candidate 1 of
    every query with none. negative: every weight > 0 and every query
    value and centroid score < 0, so that every token score is
    negative."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, lq, dim, generator=g, device="cuda")
    cqg = torch.randn(b, c, ld, lq, generator=g, device="cuda")
    w = torch.tensor([-0.05, -0.01, 0.01, 0.05], device="cuda")
    if negative:
        q, cqg, w = -q.abs(), -cqg.abs(), w + 0.06
    mg = (torch.rand(b, c, ld, generator=g, device="cuda") > 0.3).to(
        torch.int8)
    mg[:, 1] = 0
    return dict(q=q, cqg=cqg,
                bits=torch.randint(4, (b, c, ld, dim), generator=g,
                                   device="cuda", dtype=torch.uint8),
                sg=0.5 + torch.rand(b, c, ld, generator=g, device="cuda"),
                mg=mg, weights=w)


def make_x2(c, ld, b=4, lq=32, dim=128, negative=False, seed=9):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, lq, dim, generator=g, device="cuda")
    tok = torch.randn(b, c, ld, dim, generator=g, device="cuda")
    if negative:
        q, tok = q.abs(), -tok.abs()
    mask = (torch.rand(b, c, ld, generator=g, device="cuda") > 0.3).to(
        torch.int8)
    mask[:, 1] = 0
    return q.bfloat16(), tok.bfloat16(), mask


@pytest.mark.parametrize("c,ld", STAGE2_SHAPES)
def test_fused_lut_kernel_matches_plain(c, ld):
    """The kernel's residual term is three bf16 products (hi.hi + lo.hi +
    hi.lo, about 2^-17 of it off float32), the plain version's float32;
    the rest differs in the order of float32 sums."""
    a = make_x1(c, ld)
    before = stage2.fused_lut_maxsim.launches
    got = stage2.fused_lut_maxsim(**a)
    torch.cuda.synchronize()
    assert stage2.fused_lut_maxsim.launches == before + 1
    _close(got, stage2.fused_lut_maxsim_torch(**a), 32)
    assert torch.equal(got[:, 1], torch.full_like(got[:, 1], -9999.0 * 32))
    assert torch.equal(got, stage2.fused_lut_maxsim(**a))


@pytest.mark.parametrize("lq", STAGE2_LQ)
def test_fused_lut_kernel_every_tile_width(lq):
    a = make_x1(37, 9, b=3, lq=lq, dim=64)
    _close(stage2.fused_lut_maxsim(**a), stage2.fused_lut_maxsim_torch(**a),
           lq)


def test_fused_lut_kernel_keeps_negative_maxima():
    a = make_x1(200, 64, negative=True)
    got = stage2.fused_lut_maxsim(**a)
    _close(got, stage2.fused_lut_maxsim_torch(**a), 32)
    valid = (a["mg"] != 0).any(-1)
    assert bool((got[valid] < 0).all()) and bool(valid.any())


def test_fused_lut_kernel_takes_w3_past_id_3():
    """Ids 4-255 (a 4-way select's last branch on the TPU) take w[3]: a
    clamp, not a mask of two bits."""
    a = make_x1(200, 64)
    g = torch.Generator(device="cuda").manual_seed(11)
    a["bits"] = torch.randint(256, a["bits"].shape, generator=g,
                              device="cuda", dtype=torch.uint8)
    got = stage2.fused_lut_maxsim(**a)
    _close(got, stage2.fused_lut_maxsim_torch(**a), 32)
    all_w3 = dict(a, bits=torch.full_like(a["bits"], 4))
    _close(stage2.fused_lut_maxsim(**all_w3),
           stage2.fused_lut_maxsim_torch(**dict(a, bits=torch.full_like(
               a["bits"], 3))), 32)


def test_fused_lut_kernel_ignores_masked_rows():
    """A masked row scores -9999 whatever its ids, centroid scores and
    scale hold (the kernel does not read them): NaN and ids past 3 there
    change no bit of the result."""
    a = make_x1(200, 64)
    masked = a["mg"] == 0
    junk = dict(a, cqg=a["cqg"].masked_fill(masked[..., None], float("nan")),
                sg=a["sg"].masked_fill(masked, float("nan")),
                bits=a["bits"].masked_fill(masked[..., None], 255))
    got = stage2.fused_lut_maxsim(**junk)
    assert torch.equal(got, stage2.fused_lut_maxsim(**a))
    _close(got, stage2.fused_lut_maxsim_torch(**junk), 32)


@pytest.mark.parametrize("dim", [8, 24, 64, 120])
def test_fused_lut_kernel_narrow_rows(dim):
    """dim <= 64 leaves the query's second k-panel all zeros; dim % 16 ==
    8 (8, 24, 120) rows are no multiple of 16 bytes, which a tensor map
    would need: the kernel loads them 8 bytes at a time."""
    a = make_x1(256, 64, dim=dim)
    _close(stage2.fused_lut_maxsim(**a), stage2.fused_lut_maxsim_torch(**a),
           32)


@pytest.mark.parametrize("b,c,ld", [(1, 256, 64), (32, 1024, 64),
                                    (2, 300, 220)])
def test_fused_lut_launch_alone_at_the_plan_shapes(b, c, ld):
    """The launch alone equals the wrapper bit for bit and counts on its
    counter."""
    a = make_x1(c, ld, b=b)
    before = stage2.fused_lut_maxsim.launches
    got = stage2.launch_fused_lut(**a)
    torch.cuda.synchronize()
    assert stage2.fused_lut_maxsim.launches == before + 1
    assert torch.equal(got, stage2.fused_lut_maxsim(**a))
    _close(got, stage2.fused_lut_maxsim_torch(**a), 32)


def test_fused_lut_wrapper_raises_on_bad_input():
    a = make_x1(16, 8, b=2)
    with pytest.raises(ValueError):                   # nbits
        stage2.fused_lut_maxsim(**a, nbits=4)
    with pytest.raises(TypeError):                    # int32 ids
        stage2.fused_lut_maxsim(**dict(a, bits=a["bits"].int()))
    with pytest.raises(TypeError):                    # int32 mask
        stage2.fused_lut_maxsim(**dict(a, mg=a["mg"].int()))
    with pytest.raises(TypeError):                    # bf16 query
        stage2.fused_lut_maxsim(**dict(a, q=a["q"].bfloat16()))
    with pytest.raises(ValueError):                   # weights padded
        stage2.fused_lut_maxsim(**dict(a, weights=torch.zeros(
            128, device="cuda")))
    with pytest.raises(ValueError):                   # device
        stage2.fused_lut_maxsim(**dict(a, cqg=a["cqg"].cpu()))
    with pytest.raises(ValueError):                   # Lq > 128
        stage2.fused_lut_maxsim(**make_x1(4, 4, b=1, lq=129, dim=8))


@pytest.mark.parametrize("c,ld", STAGE2_SHAPES)
def test_candidate_kernel_matches_plain(c, ld):
    """X2: bf16 products are exact in float32; only the sums' order
    differs."""
    q, tok, mask = make_x2(c, ld)
    before = stage2.candidate_maxsim.launches
    got = stage2.candidate_maxsim(q, tok, mask)
    torch.cuda.synchronize()
    assert stage2.candidate_maxsim.launches == before + 1
    _close(got, stage2.candidate_maxsim_torch(q, tok, mask), 32)
    assert torch.equal(got[:, 1], torch.full_like(got[:, 1], -9999.0 * 32))
    assert torch.equal(got, stage2.candidate_maxsim(q, tok, mask))


@pytest.mark.parametrize("c,ld", STAGE2_SHAPES)
def test_candidate_kernel_per_query_route(c, ld):
    """X3: the same kernel launched once per query with B = 1, as
    v_record_perq does, equals the batched plain version."""
    q, tok, mask = make_x2(c, ld, seed=10)
    before = stage2.candidate_maxsim.launches
    got = torch.cat([stage2.candidate_maxsim(q[i:i + 1], tok[i:i + 1],
                                             mask[i:i + 1])
                     for i in range(q.shape[0])])
    torch.cuda.synchronize()
    assert stage2.candidate_maxsim.launches == before + q.shape[0]
    _close(got, stage2.candidate_maxsim_torch(q, tok, mask), 32)


@pytest.mark.parametrize("lq", STAGE2_LQ)
def test_candidate_kernel_every_tile_width(lq):
    q, tok, mask = make_x2(37, 9, b=3, lq=lq, dim=64)
    _close(stage2.candidate_maxsim(q, tok, mask),
           stage2.candidate_maxsim_torch(q, tok, mask), lq)


def test_candidate_kernel_keeps_negative_maxima():
    q, tok, mask = make_x2(200, 64, negative=True)
    got = stage2.candidate_maxsim(q, tok, mask)
    _close(got, stage2.candidate_maxsim_torch(q, tok, mask), 32)
    valid = (mask != 0).any(-1)
    assert bool((got[valid] < 0).all()) and bool(valid.any())


@pytest.mark.parametrize("b,c,ld", [(1, 256, 64), (1, 200, 37),
                                    (32, 1024, 64), (2, 300, 220)])
def test_candidate_kernel_launch_alone_at_the_plan_shapes(b, c, ld):
    """The launch alone equals the wrapper bit for bit and counts on its
    counter; B = 1 (X3's launches) and Ld short of, equal to and past the
    64-row tile, several candidates a block at B = 32."""
    q, tok, mask = make_x2(c, ld, b=b, seed=11)
    before = stage2.candidate_maxsim.launches
    got = stage2.candidate_maxsim(q, tok, mask)
    alone = stage2.launch_candidate(q, tok, mask)
    assert stage2.candidate_maxsim.launches == before + 2
    assert torch.equal(got, alone)
    _close(got, stage2.candidate_maxsim_torch(q, tok, mask), 32)
    assert torch.equal(got[:, 1], torch.full_like(got[:, 1], -9999.0 * 32))


def test_candidate_wrapper_raises_on_bad_input():
    q, tok, mask = make_x2(16, 8, b=2)
    with pytest.raises(TypeError):                    # float32 tokens
        stage2.candidate_maxsim(q, tok.float(), mask)
    with pytest.raises(TypeError):                    # float mask
        stage2.candidate_maxsim(q, tok, mask.float())
    with pytest.raises(ValueError):                   # shapes
        stage2.candidate_maxsim(q, tok, mask[:, :-1].contiguous())
    with pytest.raises(ValueError):                   # device
        stage2.candidate_maxsim(q, tok.cpu(), mask)
    with pytest.raises(ValueError):                   # dim % 8
        stage2.candidate_maxsim(q[..., :4].contiguous(),
                                tok[..., :4].contiguous(), mask)


def test_stage2_experiment_rounds_on_the_card():
    """Every round of the experiment at a small size on the card: each
    kernel route equals its plain twin, and the launches are the calls."""
    from ravqa_tpu_torch.scripts import exp_residual_stage2 as exp
    fused, cand = stage2.fused_lut_maxsim, stage2.candidate_maxsim
    fused.launches = cand.launches = 0
    r = exp.run(n=4096, ld=16, dim=64, b=8, lq=32, n_cent=256,
                cands=(40, 128), n_big=8192, iters=2, device="cuda")
    assert r["launches"] == r["expected_launches"]
    assert r["expected_launches"] == {"X1": 7, "X2": 7, "X3": 7 * 8}
    assert fused.launches == r["launches"]["X1"]
    assert cand.launches == r["launches"]["X2"] + r["launches"]["X3"]
    assert max(r["twin_err"].values()) <= 1e-3


# -- training (no kernel of its own: the losses are plain PyTorch) -----------

@pytest.mark.parametrize("shape", [(4, 16, 10, 24, 32),
                                   (30, 64, 150, 220, 128)])
@pytest.mark.parametrize("block_n,bf16", [(0, False), (4, False),
                                          (64, True)])
def test_blocked_all_pairs_grad_on_cuda_matches_cpu(shape, block_n, bf16):
    """maxsim_all_pairs_blocked's value and gradient on the card against
    the CPU, (Bq, Lq, Bd, Ld, dim) up to the training step's in-batch
    shape; an all-masked doc scores -9999 x Lq and takes no gradient.
    Tolerance rtol 1e-5, atol 1e-5 (float32 sums of at most 128 products
    and 64 maxima, ordered differently); bf16 operands are rounded the same
    way on both, so the scores keep it. Under bf16 the gradients do not:
    each is a float32 sum, ordered differently on each device, that is
    then rounded to bf16 on its way through the cast, so a sum near a
    rounding boundary lands one bf16 step (2^-7 relative) apart (7 of
    245,760 at the training shape): rtol 1e-2, atol 1e-3 there, as
    tests/test_torch_losses.py holds the bf16 grads to JAX's."""
    from ravqa_tpu_torch.ops.maxsim import maxsim_all_pairs_blocked
    bq, lq, bd, ld, dim = shape
    g = torch.Generator().manual_seed(0)
    q = torch.nn.functional.normalize(torch.randn(bq, lq, dim, generator=g),
                                      dim=-1)
    d = torch.nn.functional.normalize(torch.randn(bd, ld, dim, generator=g),
                                      dim=-1)
    mask = (torch.rand(bd, ld, generator=g) > 0.3).float()
    mask[1] = 0
    cot = torch.randn(bq, bd, generator=g)
    out = {}
    for dev in ("cuda", "cpu"):
        qd = q.to(dev).requires_grad_()
        dd = d.to(dev).requires_grad_()
        s = maxsim_all_pairs_blocked(
            qd, dd, mask.to(dev), block_n=block_n,
            compute_dtype=torch.bfloat16 if bf16 else None)
        (s * cot.to(dev)).sum().backward()
        out[dev] = (s.detach().cpu(), qd.grad.cpu(), dd.grad.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    grad_tol = dict(rtol=1e-2, atol=1e-3) if bf16 else dict(rtol=1e-5,
                                                            atol=1e-5)
    for got, want in zip(out["cuda"][1:], out["cpu"][1:]):
        torch.testing.assert_close(got, want, **grad_tol)
    assert torch.equal(out["cuda"][0][:, 1],
                       torch.full((bq,), -9999.0 * lq))
    assert torch.count_nonzero(out["cuda"][2][1]) == 0


def test_train_step_on_cuda_matches_cpu():
    """FLMRExecutor.train_step at tiny width on the card and on the CPU
    from one state dict: loss and grad norm to rtol 1e-5; parameters after
    the Adam update within 2 lr (the first update moves a coordinate by up
    to lr whatever its grad's size, so a near-zero grad whose sign differs
    between the devices moves it the other way)."""
    from ravqa_tpu_torch.executors import FLMRExecutor, TrainConfig
    from ravqa_tpu_torch.models import FLMRModelConfig, FLMRRetriever
    cfg = FLMRModelConfig.tiny(nway=2)
    rng = np.random.default_rng(0)
    batch = dict(
        query_input_ids=rng.integers(5, 512, (3, 8)).astype(np.int32),
        query_attention_mask=np.ones((3, 8), np.int32),
        image_features=rng.normal(size=(3, 24)).astype(np.float32),
        doc_input_ids=rng.integers(5, 512, (6, 12)).astype(np.int32),
        doc_attention_mask=np.ones((6, 12), np.int32))
    lr = 1e-3
    ex = {}
    for dev in ("cuda", "cpu"):
        model = FLMRRetriever(cfg)
        model.reset_parameters(torch.Generator().manual_seed(0))
        ex[dev] = FLMRExecutor(model, TrainConfig(lr=lr), device=dev,
                               quiet=True)
    m = {dev: e.train_step(batch) for dev, e in ex.items()}
    assert m["cuda"]["loss"].device.type == "cuda"
    for key in ("loss", "grad_norm", "ib_loss"):
        torch.testing.assert_close(m["cuda"][key].cpu(), m["cpu"][key],
                                   rtol=1e-5, atol=1e-6)
    want = ex["cpu"].model.state_dict()
    for n, p in ex["cuda"].model.named_parameters():
        assert p.device.type == "cuda"
        torch.testing.assert_close(p.detach().cpu(), want[n], rtol=0,
                                   atol=2 * lr)


# -- the RAG serve: K1 at its shape, the T5 decode and beam search -------------

@pytest.mark.parametrize("negative", [False, True])
def test_maxsim_split_route_at_the_rag_shape(negative):
    """K1 on a float32 index at the RAG serve's query batch (B=8, Lq=64,
    Ld=220) against its plain version."""
    q, tok, mask = make((8, 64, 1031, 220, 128), torch.float32,
                        torch.float32, negative=negative)
    before = maxsim.maxsim_search.split_launches
    got = maxsim.maxsim_search(q, tok, mask,
                               planes=maxsim.split_index_bf16(tok))
    torch.cuda.synchronize()
    assert maxsim.maxsim_search.split_launches == before + 1
    _close(got, maxsim.maxsim_search_torch(q, tok, mask), 64)


def _t5_pair():
    """A tiny gated-GELU T5 (untied head) with one set of weights, on the
    card and on the CPU."""
    from ravqa_tpu_torch.models import T5Config, T5Model
    cfg = T5Config.tiny(feed_forward_proj="gated-gelu",
                        tie_word_embeddings=False, vocab_size=64)
    cpu = T5Model(cfg)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    card = T5Model(cfg).cuda()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 64, (3, 9))
    mask = np.ones((3, 9), np.int64)
    mask[1, 5:] = 0
    return {"cuda": card, "cpu": cpu}, ids, mask


def test_t5_decode_step_on_cuda_matches_cpu():
    """The encoder and five decode steps (self-attention cache, cached
    cross-attention keys and values) on the card against the CPU."""
    models, ids, mask = _t5_pair()
    tok = np.random.default_rng(1).integers(2, 64, (3, 5))
    out = {}
    with torch.no_grad():
        for dev, m in models.items():
            enc = m.encode(torch.tensor(ids, device=dev),
                           torch.tensor(mask, device=dev))
            kv, cache = m.cross_kv(enc), m.init_cache(3, 5)
            steps = []
            for t in range(5):
                logits, cache = m.decode_step(
                    torch.tensor(tok[:, t:t + 1], device=dev), kv,
                    torch.tensor(mask, device=dev), cache)
                steps.append(logits)
            out[dev] = [enc.cpu()] + [s.cpu() for s in steps]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_beams", [1, 5])
def test_t5_beam_search_on_cuda_matches_cpu(n_beams):
    """Greedy and 5-beam search over the same weights on the card and on
    the CPU: identical tokens, log-probs within 1e-4."""
    from ravqa_tpu_torch.models import beam_generate, greedy_generate
    models, ids, mask = _t5_pair()
    out = {}
    with torch.no_grad():
        for dev, m in models.items():
            mk = torch.tensor(mask, device=dev)
            kv = m.cross_kv(m.encode(torch.tensor(ids, device=dev), mk))

            def step(tok, cache, m=m, kv=kv, mk=mk):
                return m.decode_step(tok, kv, mk, cache)
            if n_beams == 1:
                toks, lp = greedy_generate(step, m.init_cache(3, 6), 3, 6,
                                           0, 1)
            else:
                toks, lp = beam_generate(step,
                                         lambda n, m=m: m.init_cache(n, 6),
                                         3, n_beams, 6, 0, 1)
            out[dev] = (toks.cpu(), lp.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["t5", "blip2"])
def test_rag_train_step_on_cuda_matches_cpu(kind):
    """A RAG training micro-batch on the card and on the CPU from the same
    weights (configs/synthetic_rag.json's tiny T5, or a tiny BLIP-2 cut of
    configs/synthetic_rag_blip2_train.json), the CPU's retrieved batch on
    both: two train steps (the loss, its parts and the grad norm rtol 1e-4;
    every LoRA and retriever grad within 1e-4 of the largest), then the
    parameters within 2 lr; retrieval on the card launched K1."""
    import os
    from ravqa_tpu_torch.config import apply_overrides, load_config
    from ravqa_tpu_torch.main import (build_pipeline, build_rag_executor,
                                      rag_batches)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if kind == "t5":
        cfg = load_config(os.path.join(repo, "configs", "synthetic_rag.json"))
    else:
        cfg = apply_overrides(load_config(os.path.join(
            repo, "configs", "synthetic_rag_blip2_train.json")), [
            "data_pipeline.raw.setup_kwargs.n_docs=64",
            "data_pipeline.raw.setup_kwargs.vision_dim=16",
            "data_pipeline.raw.setup_kwargs.emit_pixels=32",
            "data_pipeline.loaders.setup_kwargs.query_maxlen=16",
            "data_pipeline.loaders.setup_kwargs.doc_maxlen=16",
            "model_config.bert={'vocab_size': 512, 'hidden_size': 64, "
            "'num_layers': 2, 'num_heads': 4, 'intermediate_size': 128, "
            "'max_position_embeddings': 64}",
            "model_config.dim=32", "model_config.vision_embedding_size=16",
            "model_config.mapping_network_prefix_length=4",
            "model_config.generator={'type': 'blip2', "
            "'num_query_tokens': 4, 'vision': {'image_size': 32, "
            "'patch_size': 8, 'hidden_size': 32, 'num_layers': 2, "
            "'num_heads': 4, 'intermediate_size': 64}, 'qformer': "
            "{'hidden_size': 32, 'num_layers': 2, 'num_heads': 4, "
            "'intermediate_size': 64, 'encoder_hidden_size': 32}, 't5': "
            "{'vocab_size': 512, 'd_model': 64, 'd_kv': 16, 'd_ff': 128, "
            "'num_layers': 2, 'num_heads': 4, 'feed_forward_proj': "
            "'gated-gelu', 'tie_word_embeddings': False, 'remat': True}}",
            "model_config.rag.gen_maxlen=24",
            "model_config.rag.rag_weight=1.0",
            "model_config.rag.additional_weight=1.0",
            "train.accumulate_grad_batches=1"])
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    cpu = build_rag_executor(cfg, data, "cpu")
    card = build_rag_executor(cfg, data, "cuda")
    card.model.load_state_dict(cpu.model.state_dict())
    raw = rag_batches(data["train"], 4)
    maxsim.maxsim_search.launches = 0
    card.retrieve(next(raw))
    assert maxsim.maxsim_search.launches == 1
    before = {n: p.detach().clone() for n, p in cpu.model.named_parameters()}
    for _ in range(2):
        batch = cpu.make_train_batch(next(raw))
        on_card = {k: (v.cuda() if isinstance(v, torch.Tensor) else v)
                   for k, v in batch.items()}
        m_cpu, m = cpu.train_step(batch), card.train_step(on_card)
        for key in ("loss", "nll_loss", "rag_loss", "additional_loss",
                    "grad_norm"):
            torch.testing.assert_close(m[key].cpu(), m_cpu[key], rtol=1e-4,
                                       atol=1e-6, msg=key)
        grads = {n: p.grad for n, p in cpu.model.named_parameters()
                 if p.grad is not None}
        largest = max(g.abs().max().item() for g in grads.values())
        for n, p in card.model.named_parameters():
            if n in grads:
                torch.testing.assert_close(p.grad.cpu(), grads[n], rtol=1e-4,
                                           atol=1e-4 * largest, msg=n)
    tc = cpu.train_cfg
    for n, p in card.model.named_parameters():
        lr = tc.retriever_lr if (n.startswith("retriever.")
                                 and tc.retriever_lr is not None) else tc.lr
        torch.testing.assert_close(p.detach().cpu(),
                                   cpu.model.get_parameter(n).detach(),
                                   rtol=0, atol=2 * 2 * lr, msg=n)
    assert any(not torch.equal(p.detach(), before[n])
               for n, p in cpu.model.named_parameters())


# -- retriever pretraining: WIT vision-only, M2KR multi-task, DPR --------------

@pytest.mark.parametrize("negative", [False, True])
def test_maxsim_split_route_at_the_wit_shape(negative):
    """K1 on a float32 index at the WIT evaluation's query (the mapping
    network's 32 tokens alone, B=32, Ld=220) against its plain version."""
    q, tok, mask = make((32, 32, 1031, 220, 128), torch.float32,
                        torch.float32, negative=negative)
    before = maxsim.maxsim_search.split_launches
    got = maxsim.maxsim_search(q, tok, mask,
                               planes=maxsim.split_index_bf16(tok))
    torch.cuda.synchronize()
    assert maxsim.maxsim_search.split_launches == before + 1
    _close(got, maxsim.maxsim_search_torch(q, tok, mask), 32)


def test_pretraining_train_step_on_cuda_matches_cpu():
    """FLMRVisionPretrainingExecutor.train_step at tiny width under the WIT
    freezes, on the card and on the CPU from one state dict: loss and grad
    norm to rtol 1e-5; only the mapping network moves (within 2 lr of the
    CPU's), the rest bit-identical and without grads."""
    from ravqa_tpu_torch.executors import (FLMRVisionPretrainingExecutor,
                                           TrainConfig)
    from ravqa_tpu_torch.models import FLMRModelConfig, FLMRRetriever
    cfg = FLMRModelConfig.tiny(nway=2, query_mode="vision_only")
    rng = np.random.default_rng(0)
    batch = dict(
        image_features=rng.normal(size=(4, 24)).astype(np.float32),
        doc_input_ids=rng.integers(5, 512, (8, 12)).astype(np.int32),
        doc_attention_mask=np.ones((8, 12), np.int32))
    lr = 1e-3
    tc = TrainConfig(lr=lr, modules=("freeze_colbert_doc_encoder",
                                     "freeze_question_encoder"))
    ex, before = {}, None
    for dev in ("cuda", "cpu"):
        model = FLMRRetriever(cfg)
        model.reset_parameters(torch.Generator().manual_seed(0))
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        ex[dev] = FLMRVisionPretrainingExecutor(model, tc, device=dev,
                                                quiet=True)
    m = {dev: e.train_step(batch) for dev, e in ex.items()}
    for key in ("loss", "grad_norm", "ib_loss"):
        torch.testing.assert_close(m["cuda"][key].cpu(), m["cpu"][key],
                                   rtol=1e-5, atol=1e-6)
    want = ex["cpu"].model.state_dict()
    for n, p in ex["cuda"].model.named_parameters():
        got = p.detach().cpu()
        if n.startswith("vision_projection"):
            assert not torch.equal(got, before[n])
            torch.testing.assert_close(got, want[n], rtol=0, atol=2 * lr)
        else:
            assert p.grad is None and torch.equal(got, before[n]), n


def test_m2kr_on_cuda_matches_cpu():
    """train_m2kr (3 steps over two tiny tasks) and evaluate_m2kr on the
    card and on the CPU from one state dict: the per-task losses (rtol
    1e-5) and the evaluations' metrics; K1 launched once per task's
    evaluation."""
    from ravqa_tpu_torch.data import DataPipeline
    from ravqa_tpu_torch.executors import FLMRExecutor, TrainConfig
    from ravqa_tpu_torch.executors.m2kr import M2KRTask, train_m2kr
    from ravqa_tpu_torch.models import (BertConfig, FLMRModelConfig,
                                        FLMRRetriever)
    out = {}
    for dev in ("cuda", "cpu"):
        tasks = []
        for seed, name in enumerate(("okvqa", "wit")):
            w = DataPipeline({
                "raw": {"transform_name": "SyntheticOKVQA", "setup_kwargs": {
                    "n_docs": 40, "n_questions": 20, "vision_dim": 8,
                    "seed": seed}},
                "loaders": {"transform_name": "PrepareDataloaders",
                            "input_node": "raw", "setup_kwargs": {
                                "query_maxlen": 16, "doc_maxlen": 12}},
            }).get_data("loaders", explode=True)
            tasks.append(M2KRTask(name, w["test"],
                                  w["passages"]["full_passages"], ks=(1, 5),
                                  train_dataset=w["train"]))
        vocab = w["tokenizer"].vocab_size + 8
        model = FLMRRetriever(FLMRModelConfig.tiny(
            bert=BertConfig.tiny(vocab_size=vocab), vision_dim=8,
            prefix_len=2, dim=16))
        model.reset_parameters(torch.Generator().manual_seed(0))
        ex = FLMRExecutor(model, TrainConfig(lr=1e-3), device=dev,
                          quiet=True)
        before = maxsim.maxsim_search.launches
        res = train_m2kr(ex, tasks, steps=3, batch_size=4, val_every=3,
                         log_every=1)
        out[dev] = (res, maxsim.maxsim_search.launches - before,
                    [h for h in ex.logger.history if "step" in h])
    assert out["cuda"][1] == 2 and out["cpu"][1] == 0
    for t, c in zip(out["cuda"][2], out["cpu"][2]):
        for k in c:
            if k.endswith("/loss"):
                np.testing.assert_allclose(t[k], c[k], rtol=1e-5, err_msg=k)
    assert out["cuda"][0]["per_task_batches"] == \
        out["cpu"][0]["per_task_batches"]
    assert out["cuda"][0]["eval_history"][0]["_flat"].keys() == \
        out["cpu"][0]["eval_history"][0]["_flat"].keys()


def test_dpr_on_cuda_matches_cpu():
    """DPRExecutor.train_step and evaluate_retrieval at tiny width on the
    card and on the CPU from one state dict: loss and grad norm to rtol
    1e-5, the parameters within 2 lr, the retrieved ids and metrics equal
    (random embeddings: no ties)."""
    from ravqa_tpu_torch.executors import DPRExecutor, TrainConfig
    from ravqa_tpu_torch.models import (BertConfig, DPRModelConfig,
                                        DPRRetriever)
    rng = np.random.default_rng(0)
    batch = dict(query_input_ids=rng.integers(5, 512, (3, 8)),
                 query_attention_mask=np.ones((3, 8), np.int64),
                 doc_input_ids=rng.integers(5, 512, (6, 12)),
                 doc_attention_mask=np.ones((6, 12), np.int64))
    docs = [{"doc_input_ids": rng.integers(5, 512, (30, 12)),
             "doc_attention_mask": np.ones((30, 12), np.int64)}]
    queries = [{"query_input_ids": rng.integers(5, 512, (5, 8)),
                "query_attention_mask": np.ones((5, 8), np.int64)}]
    lr = 1e-3
    ex, m, ev = {}, {}, {}
    for dev in ("cuda", "cpu"):
        model = DPRRetriever(DPRModelConfig.tiny(bert=BertConfig.tiny()))
        model.reset_parameters(torch.Generator().manual_seed(0))
        ex[dev] = DPRExecutor(model, TrainConfig(lr=lr), device=dev,
                              quiet=True)
        m[dev] = ex[dev].train_step(batch)
        ev[dev] = ex[dev].evaluate_retrieval(
            queries, docs, passage_ids=list(range(30)),
            pos_item_ids=[[i] for i in range(5)], ks=(1, 5))
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m["cuda"][key].cpu(), m["cpu"][key],
                                   rtol=1e-5, atol=1e-6)
    want = ex["cpu"].model.state_dict()
    for n, p in ex["cuda"].model.named_parameters():
        torch.testing.assert_close(p.detach().cpu(), want[n], rtol=0,
                                   atol=2 * lr)
    assert ev["cuda"] == ev["cpu"]


# ---------------------------------------------------------------------------
# the offline extractors and the ROI features (plain PyTorch on the card:
# cuDNN convolutions, gathers, the greedy loops), card vs CPU
# ---------------------------------------------------------------------------

def _tiny_detector(device, **kw):
    from ravqa_tpu_torch.models.detection import (AttrRCNN, DetectorConfig,
                                                  convert_vinvl_params)
    from ravqa_tpu_torch.scripts.synthetic_okvqa import \
        synthetic_vinvl_state_dict
    cfg = DetectorConfig.tiny(**kw)
    model = AttrRCNN(cfg)
    model.load_state_dict(convert_vinvl_params(
        synthetic_vinvl_state_dict(cfg, seed=0), cfg))
    return model.to(device).eval()


def _detector_inputs():
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.normal(size=(2, 64, 96, 3)).astype(
        np.float32) * 50)
    return imgs, torch.tensor([[64, 96], [48, 80]], dtype=torch.int32)


def test_vision_ops_on_cuda_match_cpu():
    """nms (indices identical, a batch of images) and roi_align (1e-5 of
    the map's scale, boxes past the map's edge included) on the card
    against the CPU."""
    from ravqa_tpu_torch.ops.vision import nms, roi_align
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 80, (3, 200, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(2, 30, (3, 200, 2))], -1).astype(np.float32))
    scores = torch.from_numpy(rng.random((3, 200)).astype(np.float32))
    got = nms(boxes.cuda(), scores.cuda(), 0.5, 60)
    want = nms(boxes, scores, 0.5, 60)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    feat = torch.from_numpy(rng.normal(size=(12, 17, 32)).astype(np.float32))
    rois = torch.tensor([[0.0, 0.0, 40.0, 30.0], [-20.0, -8.0, 300.0, 9.0],
                         [100.0, 100.0, 260.0, 190.0], [5.5, 7.25, 6.0, 8.0]])
    torch.testing.assert_close(
        roi_align(feat.cuda(), rois.cuda(), 7, 2, 1 / 16).cpu(),
        roi_align(feat, rois, 7, 2, 1 / 16), rtol=0, atol=1e-5)


def test_detector_on_cuda_matches_cpu():
    """AttrRCNN (tiny widths, weights from a synthetic maskrcnn state dict)
    on the card and on the CPU: the feature map, the RPN's outputs and the
    box head's logits within 1e-4 of their scale; proposals, detections
    and attributes identical (boxes to 1e-3 px)."""
    imgs, hw = _detector_inputs()
    with torch.inference_mode():
        got = _tiny_detector("cuda")(imgs.cuda(), hw.cuda(),
                                     intermediates=True)
        want = _tiny_detector("cpu")(imgs, hw, intermediates=True)
    for key in ("feature_map", "rpn_logits", "rpn_deltas", "cls_logits",
                "box_deltas", "features", "scores", "attr_scores"):
        g, w = got[key].cpu(), want[key]
        assert (g - w).abs().max() <= 1e-4 * w.abs().max(), key
    for key in ("proposal_valid", "labels", "valid", "attr_labels",
                "num_detections"):
        assert torch.equal(got[key].cpu(), want[key]), key
    for key in ("proposals", "boxes"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0,
                                   atol=1e-3)


def test_detector_ignores_the_tf32_flags():
    """With torch.backends.cudnn.allow_tf32 and cuda.matmul.allow_tf32 set
    True by the caller, AttrRCNN.forward gives its float32 numbers (the
    model turns TF32 off inside and gives the flags back); the same
    backbone run under the caller's TF32 does differ, so the check can
    fail."""
    model = _tiny_detector("cuda", stem_channels=32, width_per_group=32,
                           res2_out_channels=128)
    imgs, hw = _detector_inputs()
    x, h = imgs.cuda(), hw.cuda()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        with torch.inference_mode():
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            ref = model(x, h, intermediates=True)
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            got = model(x, h, intermediates=True)
            assert torch.backends.cudnn.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32
            tf32 = model.backbone(x.permute(0, 3, 1, 2).contiguous())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    for key in ("feature_map", "cls_logits", "features"):
        w = ref[key]
        assert (got[key] - w).abs().max() <= 1e-6 * w.abs().max(), key
    w = ref["feature_map"]
    assert (tf32 - w).abs().max() > 1e-5 * w.abs().max()


def test_captioner_on_cuda_matches_cpu():
    """OscarCaptioner (tiny widths, weights from a synthetic Oscar state
    dict): the forward's logits within 1e-4 of their scale, and
    greedy_caption's tokens and lengths identical, card vs CPU."""
    from ravqa_tpu_torch.models import BertConfig
    from ravqa_tpu_torch.models.captioner import (
        CaptionerConfig, OscarCaptioner, caption_attention_mask,
        convert_oscar_captioner_params, greedy_caption)
    from ravqa_tpu_torch.scripts.synthetic_okvqa import \
        synthetic_oscar_state_dict
    cfg = CaptionerConfig.tiny(bert=BertConfig.tiny(vocab_size=300))
    sd = convert_oscar_captioner_params(synthetic_oscar_state_dict(cfg), cfg)
    rng = np.random.default_rng(0)
    tags = cfg.max_seq_len - cfg.max_seq_a_len
    tag_ids = torch.from_numpy(rng.integers(5, 300, (3, tags)))
    tag_mask = torch.ones(3, tags, dtype=torch.int64)
    tag_mask[1, 2:] = 0
    img = torch.from_numpy(rng.normal(size=(3, cfg.max_img_seq_len,
                                            cfg.img_feature_dim))
                           .astype(np.float32))
    img_mask = torch.ones(3, cfg.max_img_seq_len, dtype=torch.int64)
    img_mask[2, 3:] = 0
    out = {}
    for dev in ("cuda", "cpu"):
        model = OscarCaptioner(cfg).to(dev).eval()
        model.load_state_dict(sd)
        args = [t.to(dev) for t in (tag_ids, tag_mask, img, img_mask)]
        text = torch.cat([torch.full((3, cfg.max_seq_a_len),
                                     cfg.mask_token_id, device=dev),
                          args[0]], -1)
        segs = (torch.arange(cfg.max_seq_len, device=dev)
                >= cfg.max_seq_a_len).long().expand(3, -1)
        with torch.inference_mode():
            logits = model(text, segs, args[2], caption_attention_mask(
                cfg, args[1], args[3]))
            out[dev] = (logits.cpu(),) + tuple(
                t.cpu() for t in greedy_caption(model, *args))
    w = out["cpu"][0]
    assert (out["cuda"][0] - w).abs().max() <= 1e-4 * w.abs().max()
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert torch.equal(out["cuda"][2], out["cpu"][2])


def test_vit_features_node_on_cuda_matches_cpu():
    """ExtractImageFeaturesWithViT (the tiny ViT from the seed) over images
    and their ROI crops on the card and on the CPU: the features within
    1e-4 of their scale, the same rows."""
    from ravqa_tpu_torch.data.transforms import (CropRegionOfInterestImages,
                                                 ExtractImageFeaturesWithViT)
    rng = np.random.default_rng(0)
    images = {str(i): rng.integers(0, 255, (40 + i, 50, 3)).astype(np.uint8)
              for i in range(3)}
    out = {}
    for dev in ("cuda", "cpu"):
        data = {"train": [
            {"question_id": str(i), "question": "the cat", "image_id": i,
             "objects": [{"class": "cat", "rect": [2.0 * i, 3.0, 30.5, 33.0]},
                         {"class": "dog", "rect": [0.0, 0.0, 12.0, 10.0]}]}
            for i in range(3)]}
        crop = CropRegionOfInterestImages()
        crop.setup(max_objects=2)
        node = ExtractImageFeaturesWithViT()
        node.setup(image_loader=images.__getitem__, vit={"tiny": True},
                   image_size=32, num_rois=3, device=dev, batch_size=4)
        out[dev] = np.stack([it["image_features"]
                             for it in node(crop(data))["train"]])
    w = out["cpu"]
    assert out["cuda"].shape == w.shape == (3, 4, 64)
    assert np.abs(out["cuda"] - w).max() <= 1e-4 * np.abs(w).max()


# -- text-retrieval training: K1 at Ld=180, the rerankers, a triples step ----

@pytest.mark.parametrize("negative", [False, True])
def test_maxsim_split_route_at_the_triples_shape(negative):
    """K1 on a float32 index at the triples evaluation's shape (the ColBERT
    text defaults Lq=32, Ld=180; B=64) against its plain version."""
    q, tok, mask = make((64, 32, 1031, 180, 128), torch.float32,
                        torch.float32, negative=negative)
    before = maxsim.maxsim_search.split_launches
    got = maxsim.maxsim_search(q, tok, mask,
                               planes=maxsim.split_index_bf16(tok))
    torch.cuda.synchronize()
    assert maxsim.maxsim_search.split_launches == before + 1
    _close(got, maxsim.maxsim_search_torch(q, tok, mask), 32)


@pytest.mark.parametrize("head,emb", [("pooler_classifier", 64),
                                      ("linear_cls", 32)])
def test_reranker_on_cuda_matches_cpu(head, emb):
    """CrossEncoderReranker (both heads; ELECTRA's factorised embeddings)
    at tiny width on the card and on the CPU from one state dict, padded
    rows and an all-pad row included: scores within 1e-5 of their scale;
    the Scorer's length-sorted batches give the plain forward's scores."""
    from ravqa_tpu_torch.models import (CrossEncoderReranker,
                                        RerankerConfig, RerankerTokenizer)
    from ravqa_tpu_torch.models.flmr import init_normal_
    from ravqa_tpu_torch.retrieval import Scorer
    from ravqa_tpu_torch.tokenization import (WordPieceTokenizer,
                                              make_tiny_vocab)
    words = ["cat", "dog", "sun", "sky", "tree", "fish", "what", "is"]
    tok = WordPieceTokenizer(make_tiny_vocab(words))
    cfg = RerankerConfig.tiny(vocab_size=tok.vocab_size + 8, head=head,
                              embedding_size=emb)
    cpu = CrossEncoderReranker(cfg)
    with torch.no_grad():
        init_normal_(cpu, torch.Generator().manual_seed(0))
    card = CrossEncoderReranker(cfg).cuda().eval()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    qs = [" ".join(rng.choice(words, int(rng.integers(1, 6))))
          for _ in range(9)]
    ps = [" ".join(rng.choice(words, int(rng.integers(2, 30))))
          for _ in range(9)]
    rt = RerankerTokenizer(tok, 32)
    ids, mask, tt = (torch.from_numpy(x).long() for x in rt.tensorize(qs,
                                                                      ps))
    mask[-1] = 0
    with torch.no_grad():
        want = cpu(ids, mask, tt)
        got = card(ids.cuda(), mask.cuda(), tt.cuda())
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * scale)
    scores = Scorer(card, rt, bsize=4).score_pairs(qs[:8], ps[:8])
    np.testing.assert_allclose(scores, want[:8].numpy(), rtol=0,
                               atol=1e-5 * scale)


def test_triples_train_step_on_cuda_matches_cpu():
    """TriplesExecutor.train_step (nway 3, in-batch negatives, KL
    distillation against teacher scores) at tiny width on the card and on
    the CPU from one state dict: the loss, its parts and the grad norm to
    rtol 1e-5; parameters after the Adam update within 2 lr."""
    from ravqa_tpu_torch.executors import TrainConfig
    from ravqa_tpu_torch.executors.triples_executor import TriplesExecutor
    from ravqa_tpu_torch.models import FLMRModelConfig, FLMRRetriever
    from ravqa_tpu_torch.tokenization import (DocTokenizer, QueryTokenizer,
                                              WordPieceTokenizer,
                                              make_tiny_vocab)
    words = ["cat", "dog", "sun", "sky", "tree", "fish", "what", "is"]
    tok = WordPieceTokenizer(make_tiny_vocab(words))
    cfg = FLMRModelConfig.tiny(nway=3, query_mode="text_only")
    rng = np.random.default_rng(0)
    raw = {"queries": [" ".join(rng.choice(words, 4)) for _ in range(3)],
           "docs": [" ".join(rng.choice(words, 9)) for _ in range(9)],
           "target_scores": rng.normal(size=(3, 3)).astype(np.float32)}
    lr = 1e-3
    ex = {}
    for dev in ("cuda", "cpu"):
        model = FLMRRetriever(cfg)
        model.reset_parameters(torch.Generator().manual_seed(0))
        ex[dev] = TriplesExecutor(model, TrainConfig(lr=lr), device=dev,
                                  quiet=True, distill_weight=1.0,
                                  query_tokenizer=QueryTokenizer(tok, 8),
                                  doc_tokenizer=DocTokenizer(tok, 12))
    m = {dev: e.train_step(e.make_batch(raw)) for dev, e in ex.items()}
    assert m["cuda"]["loss"].device.type == "cuda"
    for key in ("loss", "grad_norm", "nway_loss", "ib_loss", "distill_kl"):
        torch.testing.assert_close(m["cuda"][key].cpu(), m["cpu"][key],
                                   rtol=1e-5, atol=1e-6)
    want = ex["cpu"].model.state_dict()
    for n, p in ex["cuda"].model.named_parameters():
        assert p.device.type == "cuda"
        torch.testing.assert_close(p.detach().cpu(), want[n], rtol=0,
                                   atol=2 * lr)


# -- sharded search and data parallelism: ranks sharing the card -------------
# The ranks join a gloo group on cuda:0 (NCCL refuses two ranks on one GPU);
# the same run on as many CPU ranks (the plain versions) is the reference.

def _clustered(n=512, ld=24, dim=128, topics=8, b=8, lq=16, seed=0):
    rng = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)
    centers = unit(rng.normal(size=(topics, dim)))
    embs = unit(centers[np.sort(rng.integers(topics, size=n))][:, None]
                + 0.35 * rng.normal(size=(n, ld, dim)))
    masks = np.ones((n, ld), np.float32)
    masks[:, -4:] = rng.random((n, 4)) > 0.5
    q = unit(embs[rng.integers(n, size=b), :lq]
             + 0.1 * rng.normal(size=(b, lq, dim)))
    return embs * masks[..., None], masks, q


@pytest.mark.parametrize("n_docs", [512, 384])
def test_sharded_searches_on_one_card_match_cpu_ranks(n_docs):
    """4 ranks on cuda:0 against 4 CPU ranks. At 512 docs a shard's 4
    blocks of 32 meet the TPU stage-1 lane rule (4 blocks); at 384 its 3
    do not: the CPU shard runs JAX's plain stage 1 over them, the CUDA
    shard K4 over the same blocks. The fast preset's search launches K4
    on every CUDA rank either way."""
    import _torch_ranks
    from ravqa_tpu_torch.parallel import launch
    embs, masks, q = _clustered(n=n_docs)
    pids = np.arange(len(embs))
    specs = [("exact", "f32", dict(use_pallas=True), 10),
             ("exact_int8", "int8", dict(use_pallas=True), 10),
             ("hier_fast", "f32", dict(mode="hierarchical", preset="fast",
                                       use_pallas=True), 10),
             ("two_stage", "f32", dict(mode="two_stage", n_candidates=64,
                                       use_pallas=True), 10)]
    runs = {dev: launch(_torch_ranks.search_rank, 4, specs, embs, masks,
                        pids, q, {}, 32, device=dev, timeout=120,
                        join_timeout=300)
            for dev in ("cuda", "cpu")}
    lq = q.shape[1]
    for name, *_ in specs:
        gs, gp, _ = runs["cuda"][0][name]
        ws, wp, _ = runs["cpu"][0][name]
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-4 * lq,
                                   err_msg=name)
        for b in range(len(gs)):
            hi = ws[b] > ws[b, -1] + 1e-4 * lq
            assert set(wp[b][hi]) <= set(gp[b]), (name, b)
    for r in runs["cuda"]:
        assert r["hier_fast"][2]["rows"] and r["hier_fast"][2]["k4"] >= 1
    assert runs["cpu"][0]["hier_fast"][2]["rows"] == (n_docs == 512)


@pytest.mark.parametrize("sharding", ["replicated", "fsdp"])
def test_data_parallel_step_on_one_card_matches_cpu_ranks(sharding):
    """A 2-rank FLMR step on cuda:0 (FSDP's all-gather and reduce-scatter
    through the host) against the same on 2 CPU ranks: loss, grad norm and
    grads at tests/test_torch_train.py's tolerances."""
    import dataclasses
    import _torch_ranks
    from ravqa_tpu_torch.models import FLMRModelConfig, FLMRRetriever
    from ravqa_tpu_torch.parallel import launch
    cfg = FLMRModelConfig.tiny(nway=2, use_ib_negatives=True)
    model = FLMRRetriever(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    cfg_kw["bert"] = dataclasses.asdict(cfg.bert)
    rng = np.random.default_rng(0)
    batch = dict(
        query_input_ids=rng.integers(5, 512, (8, 8)).astype(np.int32),
        query_attention_mask=np.ones((8, 8), np.int32),
        image_features=rng.normal(size=(8, cfg.vision_dim)).astype(
            np.float32),
        doc_input_ids=rng.integers(5, 512, (16, 10)).astype(np.int32),
        doc_attention_mask=np.ones((16, 10), np.int32))
    got, want = (launch(_torch_ranks.train_rank, 2, cfg_kw, state, [batch],
                        1e-3, sharding, 1024, device=dev, timeout=120,
                        join_timeout=300)[0] for dev in ("cuda", "cpu"))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][0][key],
                                   want["metrics"][0][key], rtol=1e-4)
    scale = max(np.abs(g).max() for g in want["grads"].values())
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name], g, rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)
