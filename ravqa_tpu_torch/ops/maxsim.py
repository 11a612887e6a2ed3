"""Late-interaction (ColBERT/FLMR) MaxSim scoring ops.

Port of ravqa_tpu/ops/maxsim.py. Per query token, take the max dot product
over a doc's token embeddings (masked doc tokens filled with -9999 before
the max), then sum over query tokens.

- ``maxsim_reduce`` / ``maxsim_search_torch``: plain PyTorch. The CPU path
  and the tests use them; on the card they are the reference the kernel is
  checked against.
- ``maxsim_pair_xla``, ``maxsim_all_pairs_xla``, ``maxsim_all_pairs_blocked``
  and ``flipr_reduce``: the training scores under the losses (ops.losses),
  plain PyTorch with autograd on every device, as they are XLA (no Pallas
  kernel) in the JAX package.
- ``maxsim_search``: the serving entry (K1, port of ``maxsim_search_pallas``).
  On CUDA tensors it launches the hand-written Hopper tensor-core kernel
  ``csrc/maxsim_mma.cu`` or raises. A bfloat16 index is read as it is; a
  float32 index as two bfloat16 planes (``split_index_bf16``, made once per
  index by ``TokenIndex.token_planes``); a float32 query is split into
  bfloat16 parts (``split_query_bf16``). ``maxsim_route`` says how a call
  splits. On a CPU tensor it runs ``maxsim_search_torch``.
  ``mma_tile_plan`` is the kernel's tiling.

The pruned search modes' summary sweeps follow the same pattern:

- ``coarse_sweep`` (``csrc/coarse_sweep.cu``, port of
  ``coarse_sweep_pallas``): every query against every doc's S summary
  vectors in slot-major (S, N, dim) layout: K2 on bf16 summaries (tensor
  cores) or float32 ones (CUDA cores), K3 on int8 (tensor cores); plain
  version ``coarse_sweep_torch``.
- ``stage1_sweep`` (``csrc/stage1_sweep.cu``, port of
  ``stage1_sweep_pallas``): each query against the summaries of its own
  selected blocks in ``stage1_rows`` layout (K4: bf16 and int8 rows on the
  tensor cores, float32 rows on the CUDA cores); plain version
  ``stage1_sweep_torch`` (port of ``stage1_sweep_xla``).
  ``summary_plan`` is the tensor-core sweep's grid (``csrc/summary_tile.cuh``,
  K2 on bf16, K3 and K4).

Each wrapper counts its kernel launches in ``<wrapper>.launches``;
``launch_coarse_bf16``, ``launch_coarse_int8`` and ``launch_stage1`` are
the launches alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .quant import NEG_INF, quantize_queries_int8

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_DIM = 128                 # the kernels' k-steps cover 128 values
_MMA_PARTS_F32 = 2             # bf16 parts of a float32 query (see below)


def maxsim_reduce(scores: torch.Tensor, d_mask: torch.Tensor,
                  q_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., Ld, Lq) token scores -> (...,) MaxSim scores.

    d_mask: (..., Ld) nonzero for valid doc tokens; q_mask: optional
    (..., Lq) weights for query tokens."""
    scores = scores.masked_fill(~d_mask.bool()[..., :, None], NEG_INF)
    per_q = scores.amax(dim=-2)
    if q_mask is not None:
        per_q = per_q * q_mask.to(per_q.dtype)
    return per_q.sum(dim=-1)


# ---------------------------------------------------------------------------
# Training pair scores (port of maxsim_pair_xla, maxsim_all_pairs_xla,
# maxsim_all_pairs_blocked and flipr_reduce). The JAX package computes them
# in XLA with autodiff, so here they are plain PyTorch with autograd. The
# gradient of amax splits evenly among tied maxima, as JAX's max does, and
# reaches no masked doc token (masked_fill cuts it off, as jnp.where does).
# ---------------------------------------------------------------------------

def maxsim_pair_xla(q: torch.Tensor, d: torch.Tensor, d_mask: torch.Tensor,
                    q_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paired MaxSim: query i scores doc i. q (B, Lq, dim), d (B, Ld, dim),
    d_mask (B, Ld) -> (B,) float32."""
    scores = torch.einsum("bld,bqd->blq", d, q).float()
    return maxsim_reduce(scores, d_mask, q_mask)


def maxsim_all_pairs_xla(q: torch.Tensor, d: torch.Tensor,
                         d_mask: torch.Tensor,
                         q_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """All-pairs MaxSim (in-batch negatives): q (Bq, Lq, dim), d (Bd, Ld,
    dim), d_mask (Bd, Ld), q_mask (Bq, Lq) -> (Bq, Bd) float32. Holds the
    whole (Bd, Ld, Bq, Lq) token-score tensor for the backward."""
    return _score_block(d, d_mask.bool(), q, q_mask, None)


def _score_block(d: torch.Tensor, m: torch.Tensor, qc: torch.Tensor,
                 q_mask: Optional[torch.Tensor], compute_dtype):
    """(blk, Ld, dim) docs against every query -> (Bq, blk). Operands cast
    to compute_dtype, then multiplied and summed in float32 (bf16 values
    are exact in float32), as XLA's preferred_element_type=f32 does."""
    if compute_dtype is not None:
        d = d.to(compute_dtype)
    s = torch.einsum("nld,bqd->nlbq", d.float(), qc.float())
    s = s.masked_fill(~m[:, :, None, None], NEG_INF)
    per_q = s.amax(dim=1)                                # (blk, Bq, Lq)
    if q_mask is not None:
        per_q = per_q * q_mask.to(per_q.dtype)[None]
    return per_q.sum(dim=-1).T


def maxsim_all_pairs_blocked(q: torch.Tensor, d: torch.Tensor,
                             d_mask: torch.Tensor,
                             q_mask: Optional[torch.Tensor] = None, *,
                             block_n: int = 0,
                             compute_dtype: Optional[torch.dtype] = None
                             ) -> torch.Tensor:
    """maxsim_all_pairs_xla in doc blocks of `block_n` (0: one block), each
    run under torch.utils.checkpoint, so the backward keeps one block's
    (block_n, Ld, Bq, Lq) tensor, not the whole one. Bd is padded up to a
    multiple of block_n with masked docs, cut off again at the end.
    compute_dtype (e.g. torch.bfloat16) casts both operands before the
    product; accumulation is always float32. -> (Bq, Bd) float32."""
    from torch.utils.checkpoint import checkpoint
    bd = d.shape[0]
    qc = q.to(compute_dtype) if compute_dtype is not None else q
    if block_n <= 0 or block_n >= bd:
        block_n = bd
    pad = (-bd) % block_n
    m = d_mask.bool()
    if pad:
        d = torch.nn.functional.pad(d, (0, 0, 0, 0, 0, pad))
        m = torch.nn.functional.pad(m, (0, 0, 0, pad))
    out = [checkpoint(_score_block, d[s:s + block_n], m[s:s + block_n], qc,
                      q_mask, compute_dtype, use_reentrant=False)
           for s in range(0, d.shape[0], block_n)]
    return torch.cat(out, dim=1)[:, :bd]


def flipr_reduce(scores: torch.Tensor, d_mask: torch.Tensor,
                 query_part_len: int, k1: int, k2: int) -> torch.Tensor:
    """FLIPR interaction (PreFLMR): per-query-token maxima split into the
    question part (first `query_part_len`) and the context part; the sum of
    the question part's top-k1 plus, only when at least k2 context tokens
    exist, the context part's top-k2 (a shorter context part adds nothing).
    scores (..., Ld, Lq), d_mask (..., Ld) -> (...,)."""
    scores = scores.masked_fill(~d_mask.bool()[..., :, None], NEG_INF)
    per_q = scores.amax(dim=-2)                          # (..., Lq)
    first = per_q[..., :query_part_len]
    rest = per_q[..., query_part_len:]
    out = torch.topk(first, min(k1, first.shape[-1]), dim=-1)[0].sum(-1)
    if k2 > 0 and rest.shape[-1] >= k2:
        out = out + torch.topk(rest, k2, dim=-1)[0].sum(-1)
    return out


def maxsim_search_torch(q: torch.Tensor, tokens: torch.Tensor,
                        mask: torch.Tensor,
                        max_chunk_elems: int = 1 << 26) -> torch.Tensor:
    """Plain MaxSim of a query batch against every doc of an index.

    q (B, Lq, dim), tokens (N, Ld, dim), mask (N, Ld) -> (B, N) float32.
    Inputs are upcast to float32. Docs go in chunks so the (n, Ld, B, Lq)
    token-score intermediate holds at most `max_chunk_elems` floats."""
    b, lq, _ = q.shape
    n, ld, _ = tokens.shape
    qf = q.float()
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    step = max(1, max_chunk_elems // max(1, ld * b * lq))
    for s in range(0, n, step):
        scores = torch.einsum("nld,bqd->nlbq", tokens[s:s + step].float(), qf)
        scores = scores.masked_fill(
            ~mask[s:s + step].bool()[:, :, None, None], NEG_INF)
        out[:, s:s + step] = scores.amax(dim=1).sum(dim=-1).T
    return out


# library name -> (CUDA source, {C function: (pointer args, int args)})
_LIBRARIES = {
    "ravqa_maxsim_mma": ("maxsim_mma.cu", {"ravqa_maxsim_mma": (4, 15)}),
    "ravqa_coarse_sweep": ("coarse_sweep.cu", {
        "ravqa_coarse_sweep": (4, 5), "ravqa_coarse_sweep_bf16": (4, 11),
        "ravqa_coarse_sweep_int8": (6, 11)}),
    "ravqa_stage1_sweep": ("stage1_sweep.cu", {"ravqa_stage1_sweep": (5, 14)}),
    "ravqa_maxsim_int8": ("maxsim_int8.cu", {
        "ravqa_maxsim_search_int8": (5, 13)}),
    "ravqa_residual_maxsim": ("residual_maxsim.cu", {
        "ravqa_residual_maxsim": (7, 11)}),
    # the stage-2 experiment's scorers (ops/stage2.py): X1, and X2/X3
    "ravqa_residual_lut_maxsim": ("residual_lut_maxsim.cu", {
        "ravqa_residual_lut_maxsim": (7, 8)}),
    "ravqa_candidate_maxsim": ("candidate_maxsim.cu", {
        "ravqa_candidate_maxsim": (4, 8)}),
}


@functools.lru_cache(maxsize=None)
def _library(name: str):
    """Build and load one of the port's CUDA libraries once per process.
    Returns ({C function name: ctypes function}, build seconds, log)."""
    from .cuda_build import load_library
    source, fns = _LIBRARIES[name]
    lib, seconds, log = load_library(name, (source,))
    out = {}
    for fn_name, (n_ptr, n_int) in fns.items():
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int
        # every C function ends with the stream
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        out[fn_name] = fn
    return out, seconds, log


def _launch(lib: str, fn_name: str, device, *args) -> None:
    fn = _library(lib)[0][fn_name]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error "
                           f"{err}")


def build_kernels() -> dict:
    """Build (or find built) and load every CUDA library of the port, the
    nvcc runs side by side. Returns {library: {"seconds", "log"}}: the
    build time and the compiler's log (registers, shared memory, spills)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(_LIBRARIES)) as pool:
        built = dict(zip(_LIBRARIES, pool.map(_library, _LIBRARIES)))
    return {name: {"seconds": b[1], "log": b[2]}
            for name, b in built.items()}


# ---------------------------------------------------------------------------
# The MMA route (csrc/mma_tile.cuh): K1 and K5
# ---------------------------------------------------------------------------

_TILE_ROWS = 256               # doc tokens a ring stage holds, most
_TILE_DOCS = 8                 # docs per tile (per-row maxima in smem)
_TILES_PER_UNIT = 32           # most tiles in one unit of work
# doc tokens a ring stage holds, by index planes: two planes double a
# stage's bytes, so a split float32 index takes stages of 128 rows (3 of
# 64 KB at dim 128 fit the 227 KB of shared memory)
TILE_ROWS = {1: _TILE_ROWS, 2: 128}
# the MMA widths (columns a wgmma, N) the kernels are built for, by query
# rows per unit row chunk (one m-tile a consumer warpgroup: 128; two:
# 256), for token rows of more than 64 values; narrower rows take 64
_MMA_WIDTHS = {128: (64, 96, 112, 128), 256: (64, 112, 128)}


def mma_widths(block_rows: int, dim: int) -> tuple:
    """The MMA widths the kernel of `block_rows` query rows is built for at
    token rows of `dim` values (csrc/maxsim_mma.cu, csrc/maxsim_int8.cu)."""
    return _MMA_WIDTHS[block_rows] if dim > 64 else (64,)


class MmaPlan(NamedTuple):
    """How the MMA route covers a search; the kernels take these ints.

    A tile holds `docs_per_tile` whole docs, each padded to `doc_cols`
    columns (Ld rounded up to 8, so an 8-column MMA slab never straddles two
    docs), or part of one doc longer than a ring stage, which spans
    `tiles_per_doc` tiles. A tile goes to the MMA in `chunks` chunks of
    `width` columns. A unit of work is `queries_per_block` whole queries
    over `tiles_per_unit` consecutive tiles; unit u is query group
    u % groups over tile range u // groups, and persistent block x of
    `blocks` walks units x, x + blocks, ... `column_use` is the share of
    the MMA's columns that hold a token of a padded doc."""
    docs_per_tile: int
    doc_cols: int
    tiles_per_doc: int
    tiles_per_unit: int
    queries_per_block: int
    width: int
    chunks: int
    units: int
    blocks: int
    column_use: float

    @property
    def units_per_block(self) -> int:
        """The most units one persistent block walks."""
        return -(-self.units // self.blocks)


def mma_tile_plan(ld: int, n: int, b: int, lq: int, block_rows: int,
                  sm_count: int = 132, tile_rows: int = _TILE_ROWS,
                  dim: int = 128) -> MmaPlan:
    """The MMA route's plan for N docs of Ld tokens against B queries of Lq
    tokens of `dim` values, for a kernel whose unit row chunk holds
    `block_rows` query rows and whose ring stages hold `tile_rows` doc
    tokens (TILE_ROWS).

    Doc tile: floor(tile_rows / doc_cols) docs (at most 8) for Ld <=
    tile_rows, else one doc's tokens over ceil(Ld / tile_rows) tiles of
    equal width. MMA chunks: of the widths the kernel is built for
    (mma_widths), the width whose chunks cover a tile's columns with the
    fewest surplus columns, then in the fewest chunks. Queries: as many
    whole queries as fit the block's rows (one query over several row
    chunks when Lq is longer). Tiles per unit: at most 32, fewer when the
    card's `sm_count` SMs would walk less than eight units each; always
    whole docs. One persistent block an SM, at most one a unit."""
    if ld <= tile_rows:
        tiles_per_doc = 1
        doc_cols = -(-ld // 8) * 8
        docs_per_tile = min(_TILE_DOCS, tile_rows // doc_cols)
    else:
        tiles_per_doc = -(-ld // tile_rows)
        doc_cols = -(-ld // (8 * tiles_per_doc)) * 8
        docs_per_tile = 1
    tile_cols = docs_per_tile * doc_cols
    width, chunks = min(
        ((w, -(-tile_cols // w)) for w in mma_widths(block_rows, dim)
         if -(-tile_cols // w) * w <= tile_rows),
        key=lambda wc: (wc[0] * wc[1] - tile_cols, wc[1]))
    g = max(1, min(b, block_rows // max(lq, 1)))
    groups = -(-b // g)
    doc_groups = -(-n // docs_per_tile)
    per_unit = min(max(1, _TILES_PER_UNIT // tiles_per_doc),
                   max(1, doc_groups * groups // (8 * sm_count)))
    tiles_per_unit = per_unit * tiles_per_doc
    units = groups * -(-doc_groups * tiles_per_doc // tiles_per_unit)
    padded = -(-ld // 8) * 8 if tiles_per_doc > 1 else tile_cols
    column_use = padded / (tiles_per_doc * chunks * width)
    return MmaPlan(docs_per_tile, doc_cols, tiles_per_doc, tiles_per_unit, g,
                   width, chunks, units, min(units, sm_count), column_use)


def split_query_bf16(q: torch.Tensor, parts: int) -> torch.Tensor:
    """(B, Lq, dim) query -> (parts, B, Lq, dim) bfloat16 parts whose sum
    approximates q in float32: part i = bf16(q - the earlier parts). One
    part of a bfloat16 query is the query; two keep ~16 of float32's 24
    bits (|q - hi - lo| <= 2^-16 |q|), three all of them. The MMA route
    multiplies each part with the same bfloat16 doc values into one float32
    accumulator: every such product is exact in float32."""
    r = q.float()
    out = []
    for _ in range(parts):
        h = r.to(torch.bfloat16)
        out.append(h)
        r = r - h.float()
    return torch.stack(out)


def index_plane_dim(dim: int) -> int:
    """Values per bfloat16 plane of a split index row: dim rounded up to
    the kernel's k-steps of 16 values (1, 2, 4 or 8 of them), so plane 1
    starts on a k-step."""
    ks = 1
    while 16 * ks < dim:
        ks *= 2
    return 16 * ks


def split_index_bf16(tokens: torch.Tensor, parts: int = 2,
                     max_chunk_elems: int = 1 << 26) -> torch.Tensor:
    """(N, Ld, dim) float32 index -> (N, Ld, parts * dp) bfloat16 planes
    [part 0 | part 1 | ...], each part split_query_bf16's rule (part i =
    bf16(x - the earlier parts)) and zero-padded to dp = index_plane_dim
    values. Two parts take the float32 index's bytes at dim 128. Made in
    doc chunks of `max_chunk_elems` values, so the float32 temporaries stay
    bounded."""
    n, ld, dim = tokens.shape
    dp = index_plane_dim(dim)
    out = torch.zeros((n, ld, parts, dp), dtype=torch.bfloat16,
                      device=tokens.device)
    step = max(1, max_chunk_elems // max(1, ld * dim))
    for s in range(0, n, step):
        out[s:s + step, :, :, :dim] = split_query_bf16(
            tokens[s:s + step], parts).permute(1, 2, 0, 3)
    return out.reshape(n, ld, parts * dp)


class Route(NamedTuple):
    """How ``maxsim_search`` multiplies: `parts` bfloat16 parts of the
    query times `planes` bfloat16 planes of the index, the products whose
    part + plane < max(parts, planes) summed into one float32 accumulator
    (the terms below that order are smaller than float32's rounding)."""
    kernel: str
    parts: int
    planes: int


def maxsim_route(q_dtype: torch.dtype, tokens_dtype: torch.dtype) -> Route:
    """The split ``maxsim_search`` takes on the card (csrc/maxsim_mma.cu):
    bf16 x bf16 one product; a float32 query against a bf16 index two
    parts (2 products); float32 x float32 two parts against the index's
    two planes (hi.hi + lo.hi + hi.lo, 3 products)."""
    parts = 1 if q_dtype == torch.bfloat16 else _MMA_PARTS_F32
    planes = 1 if tokens_dtype == torch.bfloat16 else _MMA_PARTS_F32
    return Route("mma", parts, planes)


def route_products(route: Route) -> int:
    """The bf16 products per (query token, doc token) of a route."""
    top = max(route.parts, route.planes)
    return sum(1 for p in range(route.parts) for x in range(route.planes)
               if p + x < top)


# query rows per unit row chunk of the MMA kernels, by query parts
# (maxsim_mma.cu); K5 (maxsim_int8.cu) holds 256
MMA_BLOCK_ROWS = {1: 256, 2: 128}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan(device, ld: int, n: int, b: int, lq: int, block_rows: int,
                tile_rows: int = _TILE_ROWS, dim: int = 128) -> MmaPlan:
    """mma_tile_plan for the card `device` is on."""
    return mma_tile_plan(ld, n, b, lq, block_rows,
                         _sm_count(torch.device(device).index or 0),
                         tile_rows, dim)


def route_plan(device, route: Route, b: int, lq: int, n: int, ld: int,
               dim: int) -> MmaPlan:
    """The plan ``maxsim_search`` launches K1 with on `route`."""
    return launch_plan(device, ld, n, b, lq, MMA_BLOCK_ROWS[route.parts],
                       TILE_ROWS[route.planes], dim)


def _check_kernel_args(q, tokens, mask):
    if q.dim() != 3 or tokens.dim() != 3 or mask.dim() != 2:
        raise ValueError("expected q (B, Lq, dim), tokens (N, Ld, dim), "
                         f"mask (N, Ld); got {tuple(q.shape)}, "
                         f"{tuple(tokens.shape)}, {tuple(mask.shape)}")
    b, lq, dim = q.shape
    n, ld, dim2 = tokens.shape
    if dim != dim2 or tuple(mask.shape) != (n, ld):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, tokens "
                         f"{tuple(tokens.shape)}, mask {tuple(mask.shape)}")
    if dim % 8 or dim > _MAX_DIM or ld == 0:
        raise ValueError(f"kernel needs dim % 8 == 0, dim <= {_MAX_DIM} and "
                         f"Ld > 0; got dim={dim}, Ld={ld}")
    if q.dtype not in _KERNEL_DTYPES or tokens.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"q/tokens must be float32 or bfloat16; got "
                        f"{q.dtype}, {tokens.dtype}")
    if q.dtype == torch.bfloat16 and tokens.dtype == torch.float32:
        raise TypeError("a bfloat16 query needs a bfloat16 index; cast the "
                        "query to float32 for a float32 index")
    if mask.dtype != torch.int8:
        raise TypeError(f"mask must be int8; got {mask.dtype}")
    for name, t in (("q", q), ("tokens", tokens), ("mask", mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("tokens", tokens)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _plan_ints(plan: MmaPlan) -> tuple:
    """The plan's ints in the order the kernels' C interfaces take them."""
    return (plan.docs_per_tile, plan.doc_cols, plan.tiles_per_doc,
            plan.tiles_per_unit, plan.queries_per_block, plan.width,
            plan.chunks, plan.blocks)


def maxsim_search(q: torch.Tensor, tokens: torch.Tensor,
                  mask: torch.Tensor,
                  planes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Score a query batch against every doc of an index: (B, N) float32.

    q (B, Lq, dim) and tokens (N, Ld, dim) float32 or bfloat16 (f32 x f32,
    f32 x bf16 and bf16 x bf16), mask (N, Ld) int8. CUDA tensors launch
    csrc/maxsim_mma.cu on the current stream (no synchronisation), split
    as ``maxsim_route`` says, and count the launch in
    ``maxsim_search.launches``, a float32 index's also in
    ``maxsim_search.split_launches``. A float32 index is read as its bf16
    planes: `planes` (split_index_bf16 of `tokens`, as
    TokenIndex.token_planes keeps them), else split in this call. CPU
    tensors take ``maxsim_search_torch``."""
    if q.device.type == "cpu":
        return maxsim_search_torch(q, tokens, mask)
    if q.device.type != "cuda":
        raise ValueError(f"maxsim_search: unsupported device {q.device}")
    _check_kernel_args(q, tokens, mask)
    b, lq, dim = q.shape
    n, ld, _ = tokens.shape
    route = maxsim_route(q.dtype, tokens.dtype)
    idx = tokens
    if route.planes > 1:
        idx = split_index_bf16(tokens, route.planes) if planes is None \
            else planes
        want = (n, ld, route.planes * index_plane_dim(dim))
        if tuple(idx.shape) != want or idx.dtype != torch.bfloat16:
            raise ValueError(f"planes must be bf16 {want} (split_index_bf16 "
                             f"of the tokens); got {idx.dtype} "
                             f"{tuple(idx.shape)}")
        _check_cuda("maxsim_search", tokens=tokens, planes=idx)
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    qp = split_query_bf16(q, route.parts)
    plan = route_plan(q.device, route, b, lq, n, ld, dim)
    _launch("ravqa_maxsim_mma", "ravqa_maxsim_mma", q.device,
            qp.data_ptr(), idx.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, lq, n, ld, dim, route.parts, route.planes, *_plan_ints(plan))
    maxsim_search.launches += 1
    if route.planes > 1:
        maxsim_search.split_launches += 1
    return out


maxsim_search.launches = 0
maxsim_search.split_launches = 0


# ---------------------------------------------------------------------------
# Summary sweeps of the pruned search modes (K2, K3, K4)
# ---------------------------------------------------------------------------

def _check_cuda(where: str, **tensors) -> None:
    """Every tensor on one CUDA device, contiguous and 16-byte aligned."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{where}: {name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{where}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{where}: {name} must be 16-byte aligned")


def _check_dim(where: str, dim: int, int8: bool) -> None:
    step = 16 if int8 else 8
    if dim % step or dim > _MAX_DIM:
        raise ValueError(f"{where}: the kernel needs dim % {step} == 0 and "
                         f"dim <= {_MAX_DIM}; got dim={dim}")


def _valid_row(valid: Optional[torch.Tensor], n: int):
    if valid is None:
        return None
    if tuple(valid.shape) != (n,):
        raise ValueError(f"valid must have shape ({n},); got "
                         f"{tuple(valid.shape)}")
    return valid if valid.dtype == torch.int8 else (valid != 0).to(
        torch.int8)


# ---------------------------------------------------------------------------
# The tensor-core summary sweep (csrc/summary_tile.cuh): K2 on bf16, K3, K4
# ---------------------------------------------------------------------------

SUMMARY_TILE_ROWS = 64          # summary rows (the MMA's M) per tile
_SUMMARY_COLS = (16, 32, 64, 128)   # the MMA's N that the kernels take
_COARSE_COLS = 128              # K2's and K3's N: a group of whole queries
_SUMMARY_MAX_TILES = 32         # most tiles one block sweeps


class SummaryPlan(NamedTuple):
    """How the tensor-core summary sweep covers a launch; the kernels take
    these ints.

    Queries go in groups of `queries_per_group` whole queries, each padded
    to `lqp` columns (Lq rounded up to 8), `cols` columns (the MMA's N) a
    pass; a query longer than `cols` columns (then alone in its group)
    takes `passes` passes. A group's summaries go in `n_tiles` tiles of 64
    rows; block x sweeps group x % groups over tiles
    (x // groups) * tiles_per_block .. + tiles_per_block - 1, every slot of
    each. K2's and K3's tiles are docs 64 t .. 64 t + 63; K4's tile t is docs
    64 (t % chunks) .. + 63 of the query's selected block t // chunks,
    chunks = ceil(bs / 64)."""
    cols: int
    lqp: int
    queries_per_group: int
    passes: int
    n_tiles: int
    tiles_per_block: int

    def groups(self, b: int) -> int:
        return -(-b // self.queries_per_group)

    def blocks(self, b: int) -> int:
        return self.groups(b) * -(-self.n_tiles // self.tiles_per_block)


def summary_plan(b: int, lq: int, n_tiles: int, *, gathered: bool,
                 sm_count: int = 132) -> SummaryPlan:
    """The tensor-core sweep's plan for B queries of Lq tokens over n_tiles
    tiles of 64 summary rows per group.

    gathered (K4, each query its own blocks): one query a group, N the
    smallest of 16, 32, 64, 128 that covers it (passes of 128 past that).
    Else (K2, K3): groups of as many whole queries as fit 128 columns, or one
    query over several passes. Tiles per block: at most 32, fewer when the
    grid would give the card's `sm_count` SMs less than four blocks each."""
    lqp = -(-lq // 8) * 8
    if gathered:
        cols = next(c for c in _SUMMARY_COLS if c >= min(lqp, 128))
        g = 1
    else:
        cols = _COARSE_COLS
        g = max(1, min(b, cols // lqp))
    passes = -(-g * lqp // cols)
    groups = -(-b // g)
    per_block = max(1, min(_SUMMARY_MAX_TILES,
                           groups * n_tiles // (4 * sm_count)))
    return SummaryPlan(cols, lqp, g, passes, n_tiles, per_block)


def _summary_launch_plan(device, b: int, lq: int, n_tiles: int,
                         gathered: bool) -> SummaryPlan:
    return summary_plan(b, lq, n_tiles, gathered=gathered,
                        sm_count=_sm_count(torch.device(device).index or 0))


def _slot_max(q2: torch.Tensor, slots, max_chunk_elems: int):
    """max over s of q2 (R, dim) @ slots(s, lo, hi).T -> (R, N), in docs
    chunks so the (R, n) score block stays bounded. slots is (S, N, dim);
    every product in float32."""
    s_, n, _ = slots.shape
    out = torch.empty((q2.shape[0], n), dtype=torch.float32,
                      device=q2.device)
    step = max(1, max_chunk_elems // max(1, q2.shape[0]))
    for lo in range(0, n, step):
        m = None
        for si in range(s_):
            sc = q2 @ slots[si, lo:lo + step].float().T
            m = sc if m is None else torch.maximum(m, sc)
        out[:, lo:lo + step] = m
    return out


def coarse_sweep_int8_torch(q8: torch.Tensor, qscale: torch.Tensor,
                            summaries_t: torch.Tensor, dscale: torch.Tensor,
                            valid: Optional[torch.Tensor] = None,
                            max_chunk_elems: int = 1 << 26) -> torch.Tensor:
    """Plain int8 coarse sweep (K3's semantics): q8 (B, Lq, dim) int8 with
    qscale (B, Lq), summaries_t (S, N, dim) int8 with dscale (N,) ->
    (B, N) float32 = sum_t qscale * (dscale * max_s q8 . summ8), -9999 on
    invalid docs. The int8 dot products are exact in float32 (|sum| <=
    dim * 127^2 < 2^24 at dim <= 1024); on the card TF32 must be off."""
    b, lq, dim = q8.shape
    m = _slot_max(q8.reshape(b * lq, dim).float(), summaries_t,
                  max_chunk_elems)                       # (B*Lq, N)
    mf = m * dscale.float()[None, :]
    out = (qscale.float().reshape(b * lq, 1) * mf).reshape(
        b, lq, -1).sum(dim=1)
    if valid is not None:
        out = out.masked_fill(~valid.bool()[None, :], NEG_INF)
    return out


def coarse_sweep_torch(q: torch.Tensor, summaries_t: torch.Tensor,
                       valid: Optional[torch.Tensor] = None,
                       dscale: Optional[torch.Tensor] = None,
                       max_chunk_elems: int = 1 << 26) -> torch.Tensor:
    """Plain coarse summary sweep (K2/K3's semantics, port of
    coarse_sweep_pallas): q (B, Lq, dim) x slot-major summaries_t
    (S, N, dim) -> (B, N) float32 approximate MaxSim, sum over query tokens
    of the max over slots; docs with a falsy `valid` entry score exactly
    -9999. Float summaries: q is cast to their dtype, products in float32.
    int8 summaries need `dscale` (ops.quant.quantize_summaries_t_int8); q
    is quantized per token from float32 (quantize_queries_int8)."""
    if summaries_t.dtype == torch.int8:
        if dscale is None:
            raise ValueError("int8 summaries_t requires dscale")
        q8, qs = quantize_queries_int8(q.float())
        return coarse_sweep_int8_torch(q8, qs, summaries_t, dscale, valid,
                                       max_chunk_elems)
    b, lq, dim = q.shape
    qf = q.to(summaries_t.dtype).float().reshape(b * lq, dim)
    out = _slot_max(qf, summaries_t, max_chunk_elems).reshape(
        b, lq, -1).sum(dim=1)
    if valid is not None:
        out = out.masked_fill(~valid.bool()[None, :], NEG_INF)
    return out


def coarse_sweep_int8(q8: torch.Tensor, qscale: torch.Tensor,
                      summaries_t: torch.Tensor, dscale: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 coarse sweep (K3) on quantized queries: see
    coarse_sweep_int8_torch. CUDA tensors launch csrc/coarse_sweep.cu's
    int8 body on the tensor cores (counted in
    ``coarse_sweep_int8.launches``); CPU tensors take the plain version."""
    if q8.device.type == "cpu":
        return coarse_sweep_int8_torch(q8, qscale, summaries_t, dscale,
                                       valid)
    if q8.device.type != "cuda":
        raise ValueError(f"coarse_sweep_int8: unsupported device {q8.device}")
    b, lq, dim = q8.shape
    s_, n, dim2 = summaries_t.shape
    if dim != dim2 or tuple(qscale.shape) != (b, lq) \
            or tuple(dscale.shape) != (n,):
        raise ValueError(f"coarse_sweep_int8: shape mismatch q8 "
                         f"{tuple(q8.shape)}, qscale {tuple(qscale.shape)}, "
                         f"summaries_t {tuple(summaries_t.shape)}, dscale "
                         f"{tuple(dscale.shape)}")
    if q8.dtype != torch.int8 or summaries_t.dtype != torch.int8 \
            or qscale.dtype != torch.float32 or dscale.dtype != torch.float32:
        raise TypeError("coarse_sweep_int8: q8 and summaries_t must be int8, "
                        "qscale and dscale float32")
    if lq == 0:
        raise ValueError("coarse_sweep_int8: Lq must be > 0")
    _check_dim("coarse_sweep_int8", dim, int8=True)
    v = _valid_row(valid, n)
    _check_cuda("coarse_sweep_int8", q8=q8, qscale=qscale,
                summaries_t=summaries_t, dscale=dscale,
                **({} if v is None else {"valid": v}))
    return launch_coarse_int8(q8, qscale, summaries_t, dscale, v)


def launch_coarse_int8(q8, qscale, summaries_t, dscale, valid):
    """K3's launch alone (csrc/coarse_sweep.cu on the tensor cores), on the
    inputs coarse_sweep_int8 checks (`valid` int8 or None): (B, N) float32,
    counted in ``coarse_sweep_int8.launches``."""
    b, lq, dim = q8.shape
    s_, n, _ = summaries_t.shape
    out = torch.empty((b, n), dtype=torch.float32, device=q8.device)
    plan = _summary_launch_plan(q8.device, b, lq,
                                -(-n // SUMMARY_TILE_ROWS), gathered=False)
    _launch("ravqa_coarse_sweep", "ravqa_coarse_sweep_int8", q8.device,
            q8.data_ptr(), qscale.data_ptr(), summaries_t.data_ptr(),
            dscale.data_ptr(), None if valid is None else valid.data_ptr(),
            out.data_ptr(), b, lq, s_, n, dim, *plan)
    coarse_sweep_int8.launches += 1
    return out


coarse_sweep_int8.launches = 0


def coarse_sweep(q: torch.Tensor, summaries_t: torch.Tensor,
                 valid: Optional[torch.Tensor] = None,
                 dscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coarse summary sweep (port of coarse_sweep_pallas): see
    coarse_sweep_torch for the semantics. On CUDA tensors bfloat16
    summaries launch K2's tensor-core body (``launch_coarse_bf16``) and
    float32 ones its CUDA-core body, both counted in
    ``coarse_sweep.launches``; int8 summaries quantize q and go through
    ``coarse_sweep_int8`` (K3). CPU tensors take the plain version."""
    if summaries_t.dtype == torch.int8:
        if dscale is None:
            raise ValueError("int8 summaries_t requires dscale")
        q8, qs = quantize_queries_int8(q.float())
        return coarse_sweep_int8(q8, qs, summaries_t, dscale, valid)
    if q.device.type == "cpu":
        return coarse_sweep_torch(q, summaries_t, valid)
    if q.device.type != "cuda":
        raise ValueError(f"coarse_sweep: unsupported device {q.device}")
    if summaries_t.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"coarse_sweep: summaries_t must be float32, "
                        f"bfloat16 or int8; got {summaries_t.dtype}")
    if q.dim() != 3 or summaries_t.dim() != 3 \
            or q.shape[2] != summaries_t.shape[2]:
        raise ValueError(f"coarse_sweep: expected q (B, Lq, dim) and "
                         f"summaries_t (S, N, dim); got {tuple(q.shape)}, "
                         f"{tuple(summaries_t.shape)}")
    b, lq, dim = q.shape
    s_, n, _ = summaries_t.shape
    if lq == 0:
        raise ValueError("coarse_sweep: Lq must be > 0")
    _check_dim("coarse_sweep", dim, int8=False)
    qc = q.to(summaries_t.dtype).contiguous()
    v = _valid_row(valid, n)
    _check_cuda("coarse_sweep", q=qc, summaries_t=summaries_t,
                **({} if v is None else {"valid": v}))
    if summaries_t.dtype == torch.bfloat16:
        return launch_coarse_bf16(qc, summaries_t, v)
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    _launch("ravqa_coarse_sweep", "ravqa_coarse_sweep", q.device,
            qc.data_ptr(), summaries_t.data_ptr(),
            None if v is None else v.data_ptr(), out.data_ptr(), b, lq, s_,
            n, dim)
    coarse_sweep.launches += 1
    return out


def launch_coarse_bf16(qc, summaries_t, valid):
    """K2's launch alone on bf16 summaries (csrc/coarse_sweep.cu on the
    tensor cores), on the inputs coarse_sweep prepares and checks (q cast
    to bfloat16, `valid` int8 or None): (B, N) float32, counted in
    ``coarse_sweep.launches``."""
    b, lq, dim = qc.shape
    s_, n, _ = summaries_t.shape
    out = torch.empty((b, n), dtype=torch.float32, device=qc.device)
    plan = _summary_launch_plan(qc.device, b, lq,
                                -(-n // SUMMARY_TILE_ROWS), gathered=False)
    _launch("ravqa_coarse_sweep", "ravqa_coarse_sweep_bf16", qc.device,
            qc.data_ptr(), summaries_t.data_ptr(),
            None if valid is None else valid.data_ptr(), out.data_ptr(), b,
            lq, s_, n, dim, *plan)
    coarse_sweep.launches += 1
    return out


coarse_sweep.launches = 0


def stage1_rows(summaries: torch.Tensor, block_size: int) -> torch.Tensor:
    """(N, S, dim) doc summaries -> (N/bs, S, bs, dim) block-slot-major
    rows for stage1_sweep (each block's slot-s summaries are one contiguous
    (bs, dim) tile, as in the slot-major coarse-sweep layout)."""
    n, s, d = summaries.shape
    nb = n // block_size
    return summaries.reshape(nb, block_size, s, d).transpose(
        1, 2).contiguous()


def _stage1_dtype(summ_rows: torch.Tensor) -> torch.dtype:
    # the TPU kernel's cast: bfloat16 unless the rows are float32 (int8
    # rows upcast to bfloat16 exactly)
    return torch.float32 if summ_rows.dtype == torch.float32 \
        else torch.bfloat16


def _apply_dscale(out, dscale, blk, summ_rows):
    nb, _, bs, _ = summ_rows.shape
    scl = dscale.reshape(nb, bs)[blk]                    # (B, n_blocks, bs)
    return out * scl.reshape(out.shape)


def stage1_sweep_torch(q: torch.Tensor, summ_rows: torch.Tensor,
                       blk: torch.Tensor,
                       dscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain gathered stage-1 sweep (port of stage1_sweep_xla, K4's
    semantics): q (B, Lq, dim), summ_rows (NB, S, bs, dim) float32,
    bfloat16 or int8 (stage1_rows layout), blk (B, n_blocks) selected
    blocks -> (B, n_blocks * bs) float32 scores in gathered order: per doc
    of each query's own blocks, the sum over query tokens of the max over
    slots. q and the rows are cast to bfloat16 unless the rows are float32;
    products in float32. dscale ((NB*bs,) per-doc scales, int8 rows)
    multiplies the scores afterwards."""
    b = q.shape[0]
    cdt = _stage1_dtype(summ_rows)
    qc = q.to(cdt).float()
    sg = summ_rows[blk.long()]                       # (B, nbl, S, bs, d)
    m = None
    for si in range(summ_rows.shape[1]):
        sc = torch.einsum("gnbd,gqd->gnbq", sg[:, :, si].to(cdt).float(), qc)
        m = sc if m is None else torch.maximum(m, sc)
    out = m.sum(dim=-1).reshape(b, -1)
    if dscale is not None:
        out = _apply_dscale(out, dscale, blk.long(), summ_rows)
    return out


def stage1_sweep(q: torch.Tensor, summ_rows: torch.Tensor, blk: torch.Tensor,
                 tile_b: int = 8,
                 dscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gathered stage-1 sweep (port of stage1_sweep_pallas): see
    stage1_sweep_torch for the semantics. CUDA tensors launch
    csrc/stage1_sweep.cu (K4, counted in ``stage1_sweep.launches``): bf16
    and int8 rows on the tensor cores, with dscale applied in the kernel's
    epilogue; float32 rows on the CUDA cores, with dscale applied after.
    int8 rows require dscale. `tile_b` is the TPU kernel's blocks-per-step
    knob, accepted and unused: the CUDA kernel has no lane rule on
    n_blocks. CPU tensors take the plain version."""
    del tile_b
    if summ_rows.dtype == torch.int8 and dscale is None:
        raise ValueError("int8 summ_rows require dscale")
    if q.device.type == "cpu":
        return stage1_sweep_torch(q, summ_rows, blk, dscale)
    if q.device.type != "cuda":
        raise ValueError(f"stage1_sweep: unsupported device {q.device}")
    if summ_rows.dtype not in _KERNEL_DTYPES + (torch.int8,):
        raise TypeError(f"stage1_sweep: summ_rows must be float32, bfloat16 "
                        f"or int8; got {summ_rows.dtype}")
    if q.dim() != 3 or summ_rows.dim() != 4 or blk.dim() != 2 \
            or q.shape[2] != summ_rows.shape[3] or blk.shape[0] != q.shape[0]:
        raise ValueError(f"stage1_sweep: expected q (B, Lq, dim), summ_rows "
                         f"(NB, S, bs, dim), blk (B, n_blocks); got "
                         f"{tuple(q.shape)}, {tuple(summ_rows.shape)}, "
                         f"{tuple(blk.shape)}")
    nb, _, bs, _ = summ_rows.shape
    if q.shape[1] == 0:
        raise ValueError("stage1_sweep: Lq must be > 0")
    if dscale is not None:
        if tuple(dscale.shape) != (nb * bs,):
            raise ValueError(f"stage1_sweep: dscale must have shape "
                             f"({nb * bs},); got {tuple(dscale.shape)}")
        dscale = dscale.float().contiguous()
    _check_dim("stage1_sweep", q.shape[2],
               int8=summ_rows.dtype == torch.int8)
    qc = q.to(_stage1_dtype(summ_rows)).contiguous()
    blk32 = blk.to(torch.int32).contiguous()
    _check_cuda("stage1_sweep", q=qc, summ_rows=summ_rows, blk=blk32,
                **({} if dscale is None else {"dscale": dscale}))
    if summ_rows.dtype == torch.float32:
        out = launch_stage1(qc, summ_rows, blk32, None)
        return out if dscale is None else _apply_dscale(
            out, dscale, blk.long(), summ_rows)
    return launch_stage1(qc, summ_rows, blk32, dscale)


def launch_stage1(qc, summ_rows, blk32, dscale):
    """K4's launch alone (csrc/stage1_sweep.cu), on the inputs
    stage1_sweep prepares and checks (q in the rows' compute type, blk
    int32; dscale folded in for bf16 and int8 rows, None for float32
    ones): (B, n_blocks * bs) float32, counted in
    ``stage1_sweep.launches``."""
    b, lq, dim = qc.shape
    nb, s_, bs, _ = summ_rows.shape
    nbl = blk32.shape[1]
    out = torch.empty((b, nbl * bs), dtype=torch.float32, device=qc.device)
    rows_type = {torch.float32: 0, torch.bfloat16: 1,
                 torch.int8: 2}[summ_rows.dtype]
    plan = _summary_launch_plan(qc.device, b, lq,
                                nbl * -(-bs // SUMMARY_TILE_ROWS),
                                gathered=True)
    _launch("ravqa_stage1_sweep", "ravqa_stage1_sweep", qc.device,
            qc.data_ptr(), summ_rows.data_ptr(), blk32.data_ptr(),
            None if dscale is None else dscale.data_ptr(), out.data_ptr(),
            b, lq, s_, bs, nbl, nb, dim, rows_type, *plan)
    stage1_sweep.launches += 1
    return out


stage1_sweep.launches = 0
