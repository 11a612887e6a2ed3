"""Late-interaction search over a TokenIndex, on one device or sharded
over a mesh axis.

Port of ravqa_tpu/retrieval/search.py: ``mode="exact"``
scores the query batch against every doc and takes the top-k;
``"two_stage"`` and ``"hierarchical"`` prune with summary vectors first
(retrieval.coarse). A float index searches exactly through
``ops.maxsim_search`` (K1), an int8 index through ``ops.maxsim_search_int8``
(K5, on quantized queries); a residual index has no tokens and searches in
the pruned modes only, its fine stage decompressing the candidates (K6).
Zero query rows are scored like any other row, exactly as in
``ravqa_tpu/retrieval/search.py::search_single_device``.

``use_pallas`` picks the route, as in the JAX package: True builds the
kernels' copies of the summaries (slot-major, int8, stage1_rows) and runs
the sweeps, the int8 exact search and the residual fine stage through the
hand-written kernels on a CUDA index (their plain versions on a CPU
index); False runs the XLA route's math in plain PyTorch, on a CPU index
only. None means True on a CUDA index.

Sharded search (``mesh``; make_sharded_search, the JAX package's
search.py:75-382): each rank holds its shard of an index built or loaded
with the mesh, and every rank calls search() with the same queries. A
shard searches its rows through the single-device code with JAX's
per-shard cuts (k_local, c_local, cp_local, b_local; on the card the same
kernels as a single-device search), its rows are offset to global rows,
and the shards' (B, k_local) scores and rows are all-gathered and cut to
the top k of their shard-major concatenation. One stage differs from the
single-device program, as in the JAX package: a hierarchical search with
int8 pruning summaries runs stage 0 on an int8 copy of the block
summaries with per-block scales (JAX :571-585), swept by K2 as bfloat16
codes against the bf16-cast query (the JAX program's bf16 einsum; K3 would
quantize the query to int8, another function) with the scale applied
after the sum.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch

from ..ops.maxsim import maxsim_search, stage1_rows
from ..ops.quant import (maxsim_search_int8, maxsim_search_int8_torch,
                         quantize_queries_int8, quantize_summaries_int8,
                         quantize_summaries_t_int8)
from ..parallel.mesh import (all_gather, axis_group, axis_rank,
                             mesh_axis_size)
from .coarse import (block_summaries_t, doc_validity, hierarchical_search,
                     two_stage_search)
from .index import TokenIndex

_MODES = ("exact", "two_stage", "hierarchical")


def search_single_device(q: torch.Tensor, tokens: torch.Tensor,
                         mask: torch.Tensor,
                         scales: Optional[torch.Tensor] = None, *, k: int,
                         use_pallas: bool = False,
                         planes: Optional[torch.Tensor] = None):
    """Exact search on one device. Returns (scores (B, k), rows (B, k)).

    A float index runs ops.maxsim_search (K1; `planes`, a float32 index's
    TokenIndex.token_planes(), spare a CUDA call the split). An int8 index
    (`scales` given) runs, with use_pallas, K5 on queries quantized per
    token (ops.maxsim_search_int8), else the float-query XLA route's math
    (maxsim_search_int8_torch), the JAX function's default."""
    if scales is None:
        scores = maxsim_search(q, tokens, mask, planes=planes)
    elif use_pallas:
        q8, qs = quantize_queries_int8(q.float())
        scores = maxsim_search_int8(q8, qs, tokens, scales)
    else:
        scores = maxsim_search_int8_torch(q, tokens, scales, mask)
    return torch.topk(scores, k, dim=1)


def _stage1_lane_rule(block_size: int) -> int:
    # the TPU stage-1 kernel's output block is tb*bs lanes: n_blocks must
    # be a multiple of 128/gcd(bs, 128) (ravqa_tpu stage1_sweep_pallas).
    # The CUDA kernel has no such rule; the searcher keeps it so both
    # packages search the same blocks.
    return 128 // math.gcd(block_size, 128)


def make_sharded_search(mesh, n_pad: int, *, k: int, axis="index",
                        use_pallas: bool = False, two_stage: bool = False,
                        n_candidates: int = 1024,
                        hierarchical: bool = False,
                        n_blocks: Optional[int] = None,
                        block_size: int = 64,
                        coarse_query_len: Optional[int] = None,
                        residual_nbits: int = 0, group_size: int = 0,
                        centroid_prune: int = 0,
                        use_summ_rows: bool = False,
                        stage1_tile_b: int = 8):
    """The collective search over `mesh` (JAX search.py:75-382). Returns
    fn(q, **shard) -> (scores (B, k), global padded-index rows (B, k)),
    the same on every rank of `axis`: q (B, Lq, dim) the same on each,
    `shard` this rank's arrays, by the names of
    LateInteractionSearcher.shard_arrays() (tokens, mask, summaries,
    block_summaries, scales, the residual codec's records, centroids,
    bucket_weights, codec_coarse, codec_fine, and the kernel copies
    summ_t, summ_t_scale, summ_scale, block_summ_t, block_summ_t_scale,
    block_summ_scale, planes, doc_valid). The per-shard cuts are JAX's:
    k_local = min(k, n_local) results, c_local = n_candidates / nshards
    candidates (at least k_local), cp_local centroid-pruned ones, and
    b_local = n_blocks / nshards blocks, covering k_local docs and, with
    the stage-1 kernel's rows (use_summ_rows), aligned to the TPU kernel's
    lane rule 128 / gcd(bs, 128). Where no aligned count covers k_local
    docs (JAX's rows_fallback, which then runs its plain stage 1 over the
    unaligned b_local blocks), the shard keeps the rows and K4 (its plain
    version on a CPU shard) sweeps those same b_local blocks: K4 takes any
    block count, so no shard on the card leaves the kernel. Where the JAX
    function
    takes a flag for each optional array (quantized, use_summ_t, ...),
    this one reads the arrays passed; its TPU knobs (tile_d, approx_topk,
    approx_recall) are left out: every cut is an exact top-k."""
    nshards = mesh_axis_size(mesh, axis)
    group = axis_group(mesh, axis)
    rank = axis_rank(mesh, axis)
    n_local = n_pad // nshards
    k_local = min(k, n_local)
    c_local = min(max(n_candidates // nshards, k_local), n_local)
    cp_local = min(max(centroid_prune // nshards, k_local), c_local) \
        if centroid_prune else 0
    if cp_local >= c_local:
        cp_local = 0
    rows_fallback = False
    b_local = 0
    if hierarchical:
        nb_local = n_local // block_size
        if n_blocks is None:
            n_blocks = max(n_candidates // 2, nshards)
        b_need = -(-k_local // block_size)
        b_local = min(max(n_blocks // nshards, b_need, 1), nb_local)
        if use_summ_rows:
            req = _stage1_lane_rule(block_size)
            b_aligned = min(-(-b_local // req) * req,
                            (nb_local // req) * req)
            if nb_local >= req and b_aligned >= b_need:
                if b_aligned < b_local:
                    warnings.warn(
                        f"stage-1 kernel alignment reduced the per-shard "
                        f"block cut {b_local} -> {b_aligned} of {nb_local} "
                        f"blocks (multiple-of-{req} constraint): a recall "
                        "knob you set was narrowed; pass stage1_kernel="
                        "False to keep it exact", stacklevel=3)
                b_local = b_aligned
            else:
                rows_fallback = True
        c_local = min(c_local, b_local * block_size)

    def merge(s, i):
        i = i + rank * n_local
        b = s.shape[0]
        s_cat = all_gather(s.contiguous(), group).transpose(0, 1).reshape(
            b, nshards * k_local)
        i_cat = all_gather(i.contiguous(), group).transpose(0, 1).reshape(
            b, nshards * k_local)
        s_top, sel = torch.topk(s_cat, min(k, nshards * k_local), dim=1)
        return s_top, torch.gather(i_cat, 1, sel)

    def fn(q, *, mask, tokens=None, summaries=None, block_summaries=None,
           scales=None, records=None, centroids=None, bucket_weights=None,
           codec_coarse=None, codec_fine=None, summ_t=None,
           summ_t_scale=None, summ_int8=None, summ_scale=None,
           summ_rows=None, block_summ_t=None, block_summ_t_scale=None,
           block_summ_scale=None, planes=None, doc_valid=None):
        fine = dict(scales=scales, records=records, centroids=centroids,
                    bucket_weights=bucket_weights, nbits=residual_nbits,
                    use_pallas_residual=use_pallas, centroid_prune=cp_local,
                    codec_coarse=codec_coarse, codec_fine=codec_fine)
        if hierarchical:
            s, i = hierarchical_search(
                q, tokens, mask, block_summ=block_summaries, k=k_local,
                n_blocks=b_local, n_candidates=c_local,
                block_size=block_size, coarse_query_len=coarse_query_len,
                group_size=group_size, block_summ_t=block_summ_t,
                block_summ_t_scale=block_summ_t_scale,
                block_summ_scale=block_summ_scale,
                stage1_tile_b=stage1_tile_b, doc_valid=doc_valid,
                summaries=summaries, summ_int8=summ_int8,
                summ_scale=summ_scale, summ_rows=summ_rows, **fine)
        elif two_stage:
            s, i = two_stage_search(
                q, tokens, mask, summaries, k=k_local,
                n_candidates=c_local, coarse_query_len=coarse_query_len,
                use_pallas_coarse=use_pallas, group_size=group_size,
                summaries_t=summ_t, summaries_t_scale=summ_t_scale,
                doc_valid=doc_valid, **fine)
        else:
            s, i = search_single_device(q, tokens, mask, scales, k=k_local,
                                        use_pallas=use_pallas, planes=planes)
        return merge(s, i)

    fn.cuts = dict(k_local=k_local, c_local=c_local, cp_local=cp_local,
                   b_local=b_local, rows_fallback=rows_fallback,
                   n_local=n_local)
    return fn


class LateInteractionSearcher:
    """Searcher over a TokenIndex: mode dispatch, presets and pid mapping.

    mode: "exact", "two_stage" (needs index.build_summaries()) or
    "hierarchical" (also needs build_block_summaries()). preset
    "reference" keeps the reference's quality-first candidate rule;
    "fast" takes max(256, 4k) candidates, n_blocks covering them (>= 32),
    int8 pruning-stage summaries and the gathered stage-1 kernel for
    hierarchical indexes. Explicitly passed knobs win over the preset.
    ``tile_d``, ``approx_topk``, ``approx_recall``, ``stage1_tile_b`` are
    the JAX searcher's TPU knobs and are accepted as no-ops: every cut is
    an exact top-k. ``group_size`` sets the fine stage's query-group
    chunk. ``centroid_prune`` sets a residual index's centroid-only cut
    (resolve_centroid_prune). The arguments keep the JAX searcher's
    positions. ``mesh``: a sharded search over its ``axis``
    (make_sharded_search) of an index built or loaded with that mesh and
    axis; every rank of the axis builds the searcher and calls search()
    with the same queries, and the preset counts (resolve_candidates,
    resolve_blocks) are global, scaled by the shard count as the JAX
    searcher scales them."""

    def __init__(self, index: TokenIndex, mesh=None, axis: str = "index",
                 use_pallas: Optional[bool] = None,
                 tile_d: Optional[int] = None, mode: str = "exact",
                 n_candidates: Optional[int] = None,
                 n_blocks: Optional[int] = None,
                 coarse_query_len: Optional[int] = None,
                 group_size: int = 0,
                 approx_topk: Optional[bool] = None,
                 approx_recall: float = 0.95,
                 centroid_prune: Optional[int] = None,
                 coarse_int8: Optional[bool] = None,
                 stage1_kernel: Optional[bool] = None,
                 preset: str = "reference",
                 stage1_tile_b: int = 8):
        del tile_d, approx_topk, approx_recall
        if preset not in ("reference", "fast"):
            raise ValueError(f"unknown preset {preset!r} "
                             "(expected 'reference' or 'fast')")
        if mode not in _MODES:
            raise ValueError(f"unknown search mode {mode!r} "
                             f"(expected one of {_MODES})")
        if mesh is not None and (index.mesh is not mesh
                                 or index.axis != axis):
            raise ValueError("a sharded search needs the index built or "
                             "loaded with the same mesh and axis "
                             "(build_index_from_embeddings, encode_corpus, "
                             "load_index)")
        if mesh is None and index.mesh is not None:
            raise ValueError("a sharded index is searched with its mesh: "
                             "pass mesh= and axis=")
        if index.tokens is None and mode == "exact":
            raise ValueError("a residual-compressed index has no "
                             "full-precision tokens; use a pruned search "
                             "mode (two_stage or hierarchical)")
        on_cuda = index.device.type == "cuda"
        if use_pallas is None:
            use_pallas = on_cuda
        if on_cuda and not use_pallas:
            raise ValueError("use_pallas=False runs the plain versions of "
                             "the kernels, which serve only a CPU index; a "
                             "CUDA index searches through the kernels")
        if mode == "two_stage" and index.summaries is None:
            raise ValueError("call index.build_summaries() first")
        if mode == "hierarchical" and (index.summaries is None
                                       or index.block_summaries is None):
            raise ValueError("call index.build_summaries()"
                             ".build_block_summaries() first")
        self.index = index
        self.mesh, self.axis = mesh, axis
        self.mode = mode
        self.preset = preset
        self.use_pallas = use_pallas
        self.n_candidates = n_candidates
        self.n_blocks = n_blocks
        self.coarse_query_len = coarse_query_len
        self.group_size = group_size
        self.stage1_tile_b = stage1_tile_b
        self.centroid_prune = centroid_prune
        summ = index.summaries
        if preset == "fast":
            if coarse_int8 is None:
                coarse_int8 = summ is not None and (
                    mode == "hierarchical"
                    or (mode == "two_stage" and use_pallas))
            if stage1_kernel is None:
                stage1_kernel = (mode == "hierarchical" and summ is not None
                                 and index.block_summaries is not None)
                if stage1_kernel:
                    # on a CPU index an implicit preset keeps the JAX
                    # searcher's plain stage 1 where the lane rule cannot
                    # be met (tiny indexes; on a mesh, JAX :445-467's
                    # test of each shard); a CUDA index, sharded or not,
                    # always runs K4, which takes any block count
                    bs = index.block_size
                    ns = index.n_shards
                    stage1_kernel = index.n_pad % (ns * bs) == 0 and (
                        on_cuda
                        or index.n_pad // ns // bs >= _stage1_lane_rule(bs))
        self.coarse_int8 = coarse_int8 = bool(coarse_int8)
        stage1_kernel = bool(stage1_kernel)
        self._doc_valid = doc_validity(index.mask) if mode != "exact" \
            else None

        # two-stage coarse pass: one slot-major (S, N, dim) copy for the
        # coarse sweep, bfloat16 (K2) or int8 with per-doc scales (K3)
        self._summ_t = self._summ_t_scale = None
        if mode == "two_stage" and use_pallas:
            st = summ.transpose(0, 1)
            if coarse_int8:
                self._summ_t, self._summ_t_scale = \
                    quantize_summaries_t_int8(st)
            else:
                self._summ_t = st.to(torch.bfloat16).contiguous()
        # hierarchical stage 0: the block summaries' slot-major copy,
        # zero-padded to a multiple of 1024 blocks
        self._bsum_t = self._bsum_t_scale = self._bsum_i8_scale = None
        if mode == "hierarchical" and coarse_int8 and mesh is not None:
            # a shard's int8 stage 0 (JAX's use_bsum_i8): per-block int8
            # codes, swept by K2 as bf16 codes, the scales after the sum
            bi8, self._bsum_i8_scale = quantize_summaries_int8(
                index.block_summaries)
            self._bsum_t = block_summaries_t(bi8.to(torch.bfloat16),
                                             pad_multiple=1)
        elif mode == "hierarchical" and use_pallas:
            bsum = index.block_summaries
            if coarse_int8:
                self._bsum_t, self._bsum_t_scale = quantize_summaries_t_int8(
                    block_summaries_t(bsum, pad_multiple=1024))
            else:
                self._bsum_t = block_summaries_t(bsum.to(torch.bfloat16),
                                                 pad_multiple=1024)
        # hierarchical stage 1: a doc-major int8 copy with per-doc scales
        self._summ_i8 = self._summ_i8_scale = None
        if mode == "hierarchical" and coarse_int8:
            self._summ_i8, self._summ_i8_scale = quantize_summaries_int8(summ)
        # the gathered stage-1 kernel's stage1_rows layout (bfloat16, or
        # the int8 copy, which it then replaces)
        self._summ_rows = self._summ_rows_scale = None
        if stage1_kernel:
            if mode != "hierarchical":
                warnings.warn("stage1_kernel=True had no effect (hierarchical "
                              "mode only)", stacklevel=2)
            else:
                src = self._summ_i8 if self._summ_i8 is not None \
                    else summ.to(torch.bfloat16)
                self._summ_rows = stage1_rows(src, index.block_size)
                if self._summ_i8 is not None:
                    self._summ_rows_scale = self._summ_i8_scale
                    self._summ_i8 = self._summ_i8_scale = None
        if coarse_int8 and self._summ_t_scale is None \
                and self._bsum_t_scale is None and self._summ_i8 is None \
                and self._summ_rows_scale is None \
                and self._bsum_i8_scale is None:
            warnings.warn(
                "coarse_int8=True had no effect: the int8 paths exist on the "
                "kernel route's two_stage coarse sweep and the hierarchical "
                f"pruning stages (mode={mode!r}, use_pallas={use_pallas})",
                stacklevel=2)

    def resolve_candidates(self, k: int) -> int:
        """Candidate count: explicit, else the preset's rule (reference:
        1024 up to k = 100 and max(4k, 4096) above, the reference's ndocs
        rule; fast: max(256, 4k) per shard, times the shard count, as the
        sharded program divides it by the shard count)."""
        if self.n_candidates is not None:
            return self.n_candidates
        if self.preset == "fast":
            return max(256, 4 * k) * self.index.n_shards
        return 1024 if k <= 100 else max(4 * k, 4096)

    def resolve_blocks(self, k: int) -> int:
        """Selected-block count of hierarchical search: explicit, else the
        preset's rule (reference: half the candidates; fast: enough blocks
        to cover each shard's candidates and k docs, at least 32 a shard,
        times the shard count)."""
        if self.n_blocks is not None:
            return self.n_blocks
        c = self.resolve_candidates(k)
        if self.preset == "fast":
            bs = self.index.block_size
            ns = self.index.n_shards
            k_local = min(k, self.index.n_pad // ns)
            return max(32, -(-c // (bs * ns)), -(-k_local // bs)) * ns
        return max(c // 2, 1)

    def resolve_centroid_prune(self, k: int, n_candidates: int) -> int:
        """The residual fine stage's centroid-only cut (0 = off): the
        explicit `centroid_prune`, clamped to the candidates and off where
        it would not cut; off on other indexes and when not set (the JAX
        package's auto setting, measured slower on its chip at C <= 1024).
        k is accepted for the JAX signature."""
        del k
        cp = self.centroid_prune
        if self.index.nbits == 0 or cp is None:
            return 0
        cp = min(cp, n_candidates)
        return 0 if cp >= n_candidates else cp

    def _fine_kwargs(self, k: int, n_candidates: int) -> dict:
        """The index's codec arguments of the fine stage."""
        idx = self.index
        return dict(scales=idx.scales, records=idx.records,
                    centroids=idx.codec_centroids,
                    bucket_weights=idx.codec_weights, nbits=idx.nbits,
                    use_pallas_residual=self.use_pallas,
                    centroid_prune=self.resolve_centroid_prune(
                        k, n_candidates),
                    codec_coarse=idx.codec_coarse,
                    codec_fine=idx.codec_fine)

    def _hierarchical(self, q: torch.Tensor, k: int):
        idx = self.index
        nb = idx.block_summaries.shape[0]
        n_blocks = min(self.resolve_blocks(k), nb)
        summ_rows = self._summ_rows
        if summ_rows is not None:
            # keep the TPU kernel's lane rule: align the selected-block
            # count up (clamped to nb). Where no aligned count covers k
            # docs, a CPU index runs the plain stage 1 over the summaries
            # (as the JAX searcher does); K4 takes any count, so a CUDA
            # index keeps it at the resolved n_blocks
            bs = idx.block_size
            req = _stage1_lane_rule(bs)
            b_need = -(-min(k, idx.n_pad) // bs)
            aligned = min(-(-n_blocks // req) * req, (nb // req) * req)
            if nb >= req and aligned >= b_need:
                n_blocks = aligned
            elif idx.device.type != "cuda":
                summ_rows = None
        if summ_rows is None and self._summ_rows is not None:
            summaries, summ_int8, summ_scale = idx.summaries, None, None
        else:
            summaries = idx.summaries if (self._summ_i8 is None
                                          and summ_rows is None) else None
            summ_int8 = self._summ_i8
            summ_scale = (self._summ_rows_scale if summ_rows is not None
                          else self._summ_i8_scale)
        n_cand = min(self.resolve_candidates(k), idx.n_pad)
        return hierarchical_search(
            q, idx.tokens, idx.mask, summaries, idx.block_summaries, k=k,
            n_blocks=n_blocks, n_candidates=n_cand,
            block_size=idx.block_size,
            coarse_query_len=self.coarse_query_len,
            group_size=self.group_size,
            block_summ_t=self._bsum_t,
            block_summ_t_scale=self._bsum_t_scale,
            summ_int8=summ_int8, summ_scale=summ_scale, summ_rows=summ_rows,
            stage1_tile_b=self.stage1_tile_b, doc_valid=self._doc_valid,
            **self._fine_kwargs(k, n_cand))

    def _search_fn(self, k: int):
        fns = self.__dict__.setdefault("_sharded_fns", {})
        if k not in fns:
            idx = self.index
            fns[k] = make_sharded_search(
                self.mesh, idx.n_pad, k=k, axis=self.axis,
                use_pallas=self.use_pallas,
                two_stage=self.mode == "two_stage",
                n_candidates=self.resolve_candidates(k),
                hierarchical=self.mode == "hierarchical",
                n_blocks=(self.resolve_blocks(k)
                          if self.mode == "hierarchical" else self.n_blocks),
                block_size=idx.block_size,
                coarse_query_len=self.coarse_query_len,
                residual_nbits=idx.nbits, group_size=self.group_size,
                centroid_prune=self.resolve_centroid_prune(
                    k, self.resolve_candidates(k)),
                use_summ_rows=self._summ_rows is not None,
                stage1_tile_b=self.stage1_tile_b)
        return fns[k]

    def shard_arrays(self) -> dict:
        """This rank's arrays, as the function of make_sharded_search
        takes them."""
        idx = self.index
        planes = None
        if self.mode == "exact" and idx.scales is None \
                and idx.device.type == "cuda" \
                and idx.tokens.dtype == torch.float32:
            planes = idx.token_planes()       # made once, on first search
        summ_scale = (self._summ_rows_scale if self._summ_rows is not None
                      else self._summ_i8_scale)
        return dict(
            tokens=idx.tokens, mask=idx.mask,
            summaries=(idx.summaries if self._summ_i8 is None
                       and self._summ_rows is None else None),
            block_summaries=idx.block_summaries, scales=idx.scales,
            records=idx.records, centroids=idx.codec_centroids,
            bucket_weights=idx.codec_weights,
            codec_coarse=idx.codec_coarse, codec_fine=idx.codec_fine,
            summ_t=self._summ_t, summ_t_scale=self._summ_t_scale,
            summ_int8=self._summ_i8, summ_scale=summ_scale,
            summ_rows=self._summ_rows, block_summ_t=self._bsum_t,
            block_summ_t_scale=self._bsum_t_scale,
            block_summ_scale=self._bsum_i8_scale, planes=planes,
            doc_valid=self._doc_valid)

    def search_device(self, q: torch.Tensor, k: int):
        """(B, Lq, dim) on the index's device -> (scores (B, k), padded-index
        rows (B, k)), both left on the device; on a mesh the rows are the
        global index's and every rank gets the merged result."""
        idx = self.index
        if self.mesh is not None:
            return self._search_fn(k)(q, **self.shard_arrays())
        if self.mode == "hierarchical":
            return self._hierarchical(q, k)
        if self.mode == "two_stage":
            n_cand = min(self.resolve_candidates(k), idx.n_pad)
            return two_stage_search(
                q, idx.tokens, idx.mask, idx.summaries, k=k,
                n_candidates=n_cand,
                coarse_query_len=self.coarse_query_len,
                use_pallas_coarse=self.use_pallas,
                group_size=self.group_size, summaries_t=self._summ_t,
                summaries_t_scale=self._summ_t_scale,
                doc_valid=self._doc_valid, **self._fine_kwargs(k, n_cand))
        planes = None
        if idx.scales is None and idx.device.type == "cuda" \
                and idx.tokens.dtype == torch.float32:
            planes = idx.token_planes()       # made once, on first search
        return search_single_device(q, idx.tokens, idx.mask, idx.scales,
                                    k=k, use_pallas=self.use_pallas,
                                    planes=planes)

    def search(self, q, k: int):
        """Host-facing search: returns (scores (B, k) np, pids (B, k) np).

        Padded rows (pid -1) score -9999*Lq and only appear when
        k > num_docs."""
        q = torch.as_tensor(q, device=self.index.device)
        scores, rows = self.search_device(q, k)
        return scores.cpu().numpy(), self.index.pids[rows.cpu().numpy()]
