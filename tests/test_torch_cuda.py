"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA Hopper GPU:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Every test here needs the card and skips without one. This file imports
no jax, so it runs where only PyTorch is installed (`--noconftest` keeps
tests/conftest.py, which imports jax, out).

Tolerance: rtol 1e-5, atol 1e-4 * Lq. The kernel and the plain version get
the same values (bf16 inputs are upcast exactly) and differ only in the
order they sum products and per-token maxima in float32.
"""

import numpy as np
import pytest
import torch

from ravqa_tpu_torch.ops import maxsim
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
