"""Pruned late-interaction search over a token index: two-stage (coarse ->
fine) and hierarchical (block summaries -> doc summaries -> exact).

Port of the token-index paths of ravqa_tpu/retrieval/coarse.py. Each doc
gets `n_summary` summary vectors (per-doc spherical k-means of its
tokens); the coarse stages score those summaries instead of every token,
keep the best candidates and re-score only them exactly. Hierarchical
search adds a level: k-means summaries of blocks of `block_size`
consecutive docs, scored densely first, so only the selected blocks' doc
summaries are scored.

The summary sweeps run through the wrappers of ops.maxsim: on CUDA
tensors the hand-written kernels (coarse_sweep: K2 float / K3 int8,
stage1_sweep: K4), on CPU tensors their plain versions. Callers pick the
route as the JAX package's `use_pallas` does: passing the slot-major copies
(`summaries_t`, `block_summ_t`) or `summ_rows` selects the kernels;
without them the XLA route's math runs in plain PyTorch. A token index's
fine stage (exact MaxSim over the gathered candidates' tokens, times an
int8 index's per-token `scales`) is plain PyTorch on both routes, as it is
XLA in the JAX package; it runs in query groups so the gathered
(g, C, Ld, dim) copy stays bounded. A residual
index passes its packed `records` and codec tables instead of tokens: its
fine stage (_fine_stage) decompresses and scores the candidates, through
ops.residual.maxsim_residual (K6) on the kernel route, or the XLA route's
decompress-to-bf16 math in plain PyTorch, optionally after the
centroid-only `centroid_prune` cut.

Every cut is an exact top-k: the JAX package's `approx_topk`
(lax.approx_max_k) has no counterpart here and is accepted as a no-op.

Spans (utils.profiling, while recording is on): search.stage0 (the block
or coarse sweep and its cut), search.stage1 (the doc-summary sweep and
its cut), search.fine (the exact re-score) and search.topk (the final
top-k), per query group where the stages run in groups.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.maxsim import NEG_INF, coarse_sweep, maxsim_search, stage1_sweep
from ..ops.residual import decompress, maxsim_residual, split_records
from ..utils.profiling import span


def summarize_docs(tokens: torch.Tensor, mask: torch.Tensor,
                   n_summary: int = 8, iters: int = 6,
                   chunk: int = 8192) -> torch.Tensor:
    """Per-doc spherical k-means over token embeddings.

    tokens (N, Ld, dim) L2-normalized; mask (N, Ld). Returns (N, n_summary,
    dim) float32 L2-normalized summary vectors. The centroids start at each
    doc's first n_summary valid tokens (a stable sort puts valid tokens
    first, as jnp.argsort does); docs with fewer valid tokens get
    duplicated or zero centroids (harmless: a max over duplicates equals a
    max over one). Docs go in chunks of `chunk` so the float32 upcast stays
    bounded."""
    n = tokens.shape[0]
    out = torch.empty((n, n_summary, tokens.shape[2]), dtype=torch.float32,
                      device=tokens.device)
    for lo in range(0, n, chunk):
        tok = tokens[lo:lo + chunk].float()
        m = mask[lo:lo + chunk].float()
        order = torch.argsort(-m, dim=1, stable=True)[:, :n_summary]
        cent = torch.gather(tok, 1, order[..., None].expand(
            -1, -1, tok.shape[2]))                          # (n, S, dim)
        for _ in range(iters):
            assign = torch.bmm(tok, cent.transpose(1, 2)).argmax(-1)
            onehot = F.one_hot(assign, n_summary).float() * m[..., None]
            tot = torch.bmm(onehot.transpose(1, 2), tok)    # (n, S, dim)
            cnt = onehot.sum(dim=1)[..., None]
            new = torch.where(cnt > 0, tot, cent)
            cent = new / new.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        out[lo:lo + chunk] = cent
    return out


def coarse_scores(q: torch.Tensor, summaries: torch.Tensor,
                  coarse_query_len: Optional[int] = None) -> torch.Tensor:
    """(B, Lq, dim) x (N, S, dim) -> (B, N) float32 approximate MaxSim (all
    summaries valid): the XLA route's coarse stage."""
    if coarse_query_len is not None:
        q = q[:, :coarse_query_len]
    s = torch.einsum("nsd,bqd->nsbq", summaries.float(), q.float())
    return s.amax(dim=1).sum(dim=-1).T


def _resolve_group(group_size: int, b: int) -> int:
    """Query-group size of the fine stage: 0 -> 8, clamped to a divisor of
    the batch (the JAX package's grouping; here it only bounds the
    gathered candidate copy)."""
    if group_size <= 0:
        group_size = 8
    g = min(group_size, b)
    while b % g:
        g -= 1
    return g


def _score_group_tokens(qi: torch.Tensor, cand_i: torch.Tensor,
                        tokens: torch.Tensor, mask: torch.Tensor,
                        scales: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(g, Lq, dim) float32 queries x (g, C) candidate rows -> (g, C) exact
    MaxSim over the gathered token rows (an int8 index's values times its
    per-token `scales`)."""
    tok = tokens[cand_i].float()                         # (g, C, Ld, dim)
    s = torch.einsum("gcld,gqd->gclq", tok, qi)
    if scales is not None:
        s = s * scales[cand_i].float()[..., None]
    s = s.masked_fill(~mask[cand_i].bool()[..., None], NEG_INF)
    return s.amax(dim=2).sum(dim=-1)


def _centroid_prune(q: torch.Tensor, cand: torch.Tensor,
                    records: torch.Tensor, mask: torch.Tensor,
                    centroids: torch.Tensor, keep: int,
                    group: int) -> torch.Tensor:
    """PLAID-style cut of a residual fine stage: score each candidate from
    its centroid ids alone, tok ~ centroid[code], in bf16 as the JAX
    package (a (B, K, Lq) q . centroids table rounded to bf16, times the
    bf16 record scales, -9999 on masked tokens, max over Ld, float32 sum
    over Lq), and keep each query's top `keep` candidates."""
    ld = mask.shape[1]
    table = torch.einsum("bqd,kd->bkq", q.float(),
                         centroids.float()).to(torch.bfloat16)
    out = []
    for lo in range(0, q.shape[0], group):
        ci = cand[lo:lo + group]
        codes, scl, _ = split_records(records[ci], ld)
        row = torch.arange(ci.shape[0], device=q.device)[:, None, None]
        s = table[lo:lo + group][row, codes.long()] \
            * scl.to(torch.bfloat16)[..., None]           # (g, C, Ld, Lq)
        s = s.masked_fill(~mask[ci].bool()[..., None], NEG_INF)
        sc = s.amax(dim=2).float().sum(dim=-1)
        out.append(torch.gather(ci, 1, torch.topk(sc, keep, dim=1)[1]))
    return torch.cat(out)


def _fine_stage(q: torch.Tensor, cand: torch.Tensor,
                tokens: Optional[torch.Tensor], mask: torch.Tensor, *,
                k: int, group_size: int = 0,
                scales: Optional[torch.Tensor] = None,
                records: Optional[torch.Tensor] = None,
                centroids: Optional[torch.Tensor] = None,
                bucket_weights: Optional[torch.Tensor] = None,
                nbits: int = 0, use_pallas_residual: bool = False,
                centroid_prune: int = 0,
                codec_coarse: Optional[torch.Tensor] = None,
                codec_fine: Optional[torch.Tensor] = None):
    """Exact re-score of per-query candidate sets -> (scores (B, k), rows
    (B, k)), in query groups of _resolve_group(group_size, B).

    A token index (float, or int8 with `scales`) scores the gathered token
    rows. A residual index passes `records` with its codec (centroids,
    bucket_weights, nbits, and codec_coarse / codec_fine when factored):
    centroid_prune first cuts each query's candidates to that many by
    centroid-only scores (_centroid_prune); then use_pallas_residual runs
    ops.residual.maxsim_residual (K6) where the JAX package runs its fused
    kernel, for a factored codec or a flat one of at most 1024 centroids
    (the TPU kernel's gate, kept for parity); otherwise the candidates are
    decompressed to bf16 and scored against the bf16 query, products
    summed in float32, times the reconstruction-norm scales."""
    b = q.shape[0]
    g = _resolve_group(group_size, b)
    if records is not None:
        with span("search.fine"):
            cp = min(centroid_prune, cand.shape[1]) if centroid_prune else 0
            if cp and cp < cand.shape[1]:
                cand = _centroid_prune(q, cand, records, mask, centroids, cp,
                                       g)
            fused = use_pallas_residual and (codec_coarse is not None
                                             or centroids.shape[0] <= 1024)
            if fused:
                sc = maxsim_residual(q, records, cand, mask, centroids,
                                     bucket_weights, nbits=nbits,
                                     coarse=codec_coarse, fine=codec_fine)
        if fused:
            with span("search.topk"):
                s, sel = torch.topk(sc, k, dim=1)
                return s, torch.gather(cand, 1, sel)
    qf = q.float()
    top_s, top_r = [], []
    for lo in range(0, b, g):
        cand_i = cand[lo:lo + g]
        with span("search.fine"):
            if records is None:
                sc = _score_group_tokens(qf[lo:lo + g], cand_i, tokens, mask,
                                         scales)
            else:
                codes, scl, packed = split_records(records[cand_i],
                                                   mask.shape[1])
                tok = decompress(codes, packed, centroids, bucket_weights,
                                 nbits)
                s = torch.einsum("gcld,gqd->gclq", tok.float(),
                                 q[lo:lo + g].to(torch.bfloat16).float())
                s = (s * scl[..., None]).masked_fill(
                    ~mask[cand_i].bool()[..., None], NEG_INF)
                sc = s.amax(dim=2).sum(dim=-1)
        with span("search.topk"):
            s, sel = torch.topk(sc, k, dim=1)
            top_s.append(s)
            top_r.append(torch.gather(cand_i, 1, sel))
    with span("search.topk"):
        return torch.cat(top_s), torch.cat(top_r)


def doc_validity(mask: torch.Tensor) -> torch.Tensor:
    """(N, Ld) token mask -> (N,) int8: 1 for docs with a valid token."""
    return (mask != 0).any(dim=1).to(torch.int8)


def two_stage_search(q: torch.Tensor, tokens: Optional[torch.Tensor],
                     mask: torch.Tensor, summaries: Optional[torch.Tensor],
                     *, k: int, n_candidates: int = 1024,
                     coarse_query_len: Optional[int] = None,
                     use_pallas_coarse: bool = False, group_size: int = 0,
                     summaries_t: Optional[torch.Tensor] = None,
                     approx_topk: bool = False, approx_recall: float = 0.95,
                     summaries_t_scale: Optional[torch.Tensor] = None,
                     doc_valid: Optional[torch.Tensor] = None, **fine):
    """Returns (scores (B, k), rows (B, k)): exact scores of the coarse
    stage's top `n_candidates` docs. `fine`: the index's codec for the
    fine stage (scales of an int8 index; records, centroids,
    bucket_weights, nbits, codec_coarse, codec_fine of a residual one,
    whose tokens are None), use_pallas_residual and centroid_prune: see
    _fine_stage.

    use_pallas_coarse with `summaries_t` (the slot-major (S, N, dim) copy,
    bfloat16 or int8 with `summaries_t_scale`) runs the coarse pass through
    ops.maxsim.coarse_sweep (K2/K3); without `summaries_t` through the
    exhaustive MaxSim (K1) over the summaries; otherwise the plain einsum
    (coarse_scores). Docs with no valid token score -9999 in the coarse
    pass, so padded rows never take a candidate slot. doc_valid: the (N,)
    validity row, computed from `mask` when not given. approx_topk and
    approx_recall are accepted; the cut is exact."""
    del approx_topk, approx_recall
    with span("search.stage0"):
        if doc_valid is None:
            doc_valid = doc_validity(mask)
        qc = q if coarse_query_len is None else q[:, :coarse_query_len]
        if use_pallas_coarse and summaries_t is not None:
            approx = coarse_sweep(qc, summaries_t, doc_valid,
                                  dscale=summaries_t_scale)
        else:
            if use_pallas_coarse:
                ones = torch.ones(summaries.shape[:2], dtype=torch.int8,
                                  device=summaries.device)
                approx = maxsim_search(qc.float().contiguous(),
                                       summaries.contiguous(), ones)
            else:
                approx = coarse_scores(qc, summaries)
            approx = approx.masked_fill(~doc_valid.bool()[None, :], NEG_INF)
        _, cand = torch.topk(approx, n_candidates, dim=1)
    return _fine_stage(q, cand, tokens, mask, k=k, group_size=group_size,
                       **fine)


def block_summaries(summaries: torch.Tensor, block_size: int = 64,
                    n_block_summary: int = 4, iters: int = 4) -> torch.Tensor:
    """Second summary level: k-means over each block of `block_size` docs'
    summary vectors. summaries (N, S, dim), N % block_size == 0 ->
    (N / block_size, n_block_summary, dim) float32."""
    n, s, d = summaries.shape
    blocks = summaries.reshape(n // block_size, block_size * s, d)
    ones = torch.ones(blocks.shape[:2], dtype=torch.int8,
                      device=blocks.device)
    return summarize_docs(blocks, ones, n_summary=n_block_summary,
                          iters=iters)


def block_summaries_t(block_summ: torch.Tensor,
                      pad_multiple: int = 1024) -> torch.Tensor:
    """Slot-major (S, NB_pad, dim) copy of (NB, S, dim) block summaries for
    the stage-0 coarse sweep, zero-padded on the block dim to a multiple of
    `pad_multiple` (the TPU kernel's tiling; kept for parity). Padded
    blocks are suppressed through the validity row."""
    bt = block_summ.transpose(0, 1)
    pad = (-bt.shape[1]) % pad_multiple
    if pad:
        bt = F.pad(bt, (0, 0, 0, pad))
    return bt.contiguous()


def _cand_rows(blk: torch.Tensor, loc: torch.Tensor, block_size: int):
    """Gathered positions `loc` (into each query's n_blocks * bs docs) ->
    index rows."""
    return torch.gather(blk, 1, loc // block_size) * block_size \
        + loc % block_size


def hierarchical_search(q: torch.Tensor, tokens: Optional[torch.Tensor],
                        mask: torch.Tensor,
                        summaries: Optional[torch.Tensor],
                        block_summ: torch.Tensor, *, k: int,
                        n_blocks: int = 1024, n_candidates: int = 1024,
                        block_size: int = 64,
                        coarse_query_len: Optional[int] = None,
                        group_size: int = 0, approx_topk: bool = False,
                        approx_recall: float = 0.95,
                        block_summ_t: Optional[torch.Tensor] = None,
                        block_summ_t_scale: Optional[torch.Tensor] = None,
                        block_summ_scale: Optional[torch.Tensor] = None,
                        summ_int8: Optional[torch.Tensor] = None,
                        summ_scale: Optional[torch.Tensor] = None,
                        summ_rows: Optional[torch.Tensor] = None,
                        stage1_tile_b: int = 8,
                        doc_valid: Optional[torch.Tensor] = None, **fine):
    """3-stage search: block summaries -> doc summaries -> exact MaxSim.

    Stage 0 scores the (NB, Sb, dim) block summaries densely: through
    ops.maxsim.coarse_sweep (K2, or K3 with `block_summ_t_scale`) when the
    slot-major padded copy `block_summ_t` is given, else with the plain
    einsum; fully padded blocks score -9999. With `block_summ_scale` (the
    JAX mesh program's int8 stage 0, search.py:571-585), `block_summ_t`
    holds int8 block-summary codes as bfloat16 (exact): K2 sweeps them
    against the bf16-cast query, as the JAX program's bf16 einsum does,
    and the positive per-block scale multiplies each sum after the max.
    The top `n_blocks` blocks go to stage 1, which scores their docs' summaries, per query: with
    `summ_rows` (stage1_rows layout, bfloat16 or int8 with `summ_scale`)
    through ops.maxsim.stage1_sweep (K4); with `summ_int8` + `summ_scale`
    (doc-major int8 copy) or the float `summaries` in plain PyTorch. Docs
    with no valid token score -9999. The top `n_candidates` docs are
    re-scored exactly (full query). coarse_query_len: only the first L
    query tokens drive stages 0 and 1. `fine`: the index's codec for the
    fine stage, as in two_stage_search; a residual index scores every
    query's stage-1 candidates in one fine stage. Returns (scores (B, k),
    rows (B, k)). approx_topk, approx_recall and stage1_tile_b are
    accepted; the cuts are exact."""
    del approx_topk, approx_recall
    if summ_rows is not None:
        nb, _, bs_, _ = summ_rows.shape
        if bs_ != block_size:
            raise ValueError(f"summ_rows block size {bs_} != {block_size}")
        if (summ_rows.dtype == torch.int8) != (summ_scale is not None):
            raise ValueError("int8 summ_rows require summ_scale (and float "
                             "rows take none)")
        summ_blocks = scale_blocks = None
    else:
        if (summ_int8 is None) != (summ_scale is None):
            raise ValueError("summ_int8 and summ_scale go together")
        src = summaries if summ_int8 is None else summ_int8
        n, s, d = src.shape
        nb = n // block_size
        summ_blocks = src.reshape(nb, block_size, s, d)
        scale_blocks = (None if summ_scale is None
                        else summ_scale.reshape(nb, block_size))
    b = q.shape[0]
    qc = q if coarse_query_len is None else q[:, :coarse_query_len]

    # stage 0: dense over block summaries; fully padded blocks out
    with span("search.stage0"):
        if doc_valid is None:
            doc_valid = doc_validity(mask)
        doc_valid_blocks = doc_valid.bool().reshape(nb, block_size)
        blk_valid = doc_valid_blocks.any(dim=1)                 # (nb,)
        if block_summ_scale is not None:
            s0 = (coarse_sweep(qc, block_summ_t)[:, :nb]
                  * block_summ_scale[None, :]).masked_fill(
                      ~blk_valid[None, :], NEG_INF)
        elif block_summ_t is not None:
            v = torch.zeros(block_summ_t.shape[1], dtype=torch.int8,
                            device=blk_valid.device)
            v[:nb] = blk_valid
            s0 = coarse_sweep(qc, block_summ_t, v,
                              dscale=block_summ_t_scale)
        else:
            s0 = coarse_scores(qc, block_summ).masked_fill(
                ~blk_valid[None, :], NEG_INF)
        _, blk = torch.topk(s0, n_blocks, dim=1)              # (B, n_blocks)
        # padded stage-0 columns are -9999 and can only surface when
        # n_blocks exceeds the valid blocks; clamp so the stage-1 gathers
        # stay in range
        blk = blk.clamp_max(nb - 1)

    def stage1_valid(scores, blk_i):
        valid = doc_valid_blocks[blk_i].reshape(blk_i.shape[0], -1)
        return scores.masked_fill(~valid, NEG_INF)

    if summ_rows is not None:
        with span("search.stage1"):
            approx = stage1_valid(stage1_sweep(qc, summ_rows, blk,
                                               tile_b=stage1_tile_b,
                                               dscale=summ_scale), blk)
            _, loc = torch.topk(approx, n_candidates, dim=1)
            cand = _cand_rows(blk, loc, block_size)
        return _fine_stage(q, cand, tokens, mask, k=k,
                           group_size=group_size, **fine)

    # plain stage 1 and the token fine stage, per query group, so the
    # gathered summaries and tokens stay bounded; a residual index collects
    # every group's candidates for one fine stage
    g = _resolve_group(group_size, b)
    qf = q.float()
    top_s, top_r, cands = [], [], []
    for lo in range(0, b, g):
        with span("search.stage1"):
            blk_i = blk[lo:lo + g]
            qci = qf[lo:lo + g] if coarse_query_len is None \
                else qf[lo:lo + g, :coarse_query_len]
            sg = summ_blocks[blk_i]                  # (g, nbl, bs, S, d)
            if scale_blocks is None:
                s1 = torch.einsum("gnbsd,gqd->gnbsq", sg.float(), qci)
                approx = s1.amax(dim=3).sum(dim=-1)
            else:
                # int8 stage 1: a bfloat16 dot over the int8 codes (exact
                # values); the positive per-doc scale commutes with the
                # max over slots and the sum over query tokens
                s1 = torch.einsum("gnbsd,gqd->gnbsq",
                                  sg.to(torch.bfloat16).float(),
                                  qci.to(torch.bfloat16).float())
                approx = s1.amax(dim=3).sum(dim=-1) * scale_blocks[blk_i]
            approx = stage1_valid(approx.reshape(blk_i.shape[0], -1), blk_i)
            _, loc = torch.topk(approx, n_candidates, dim=1)
            cand_i = _cand_rows(blk_i, loc, block_size)
        if fine.get("records") is not None:
            cands.append(cand_i)
            continue
        with span("search.fine"):
            sc = _score_group_tokens(qf[lo:lo + g], cand_i, tokens, mask,
                                     fine.get("scales"))
        with span("search.topk"):
            s, sel = torch.topk(sc, k, dim=1)
            top_s.append(s)
            top_r.append(torch.gather(cand_i, 1, sel))
    if cands:
        return _fine_stage(q, torch.cat(cands), tokens, mask, k=k,
                           group_size=group_size, **fine)
    with span("search.topk"):
        return torch.cat(top_s), torch.cat(top_r)


def cluster_order(summaries: torch.Tensor, n_clusters: int = 1024,
                  iters: int = 4, chunk: int = 65536) -> torch.Tensor:
    """Doc ordering that makes hierarchical search's blocks coherent: a
    global spherical k-means over per-doc mean-summary vectors, then docs
    sorted (stably) by cluster id. Returns the permutation (apply it to
    tokens/mask/summaries before block_summaries). Assignment goes in
    chunks of `chunk` docs so the (N, n_clusters) score matrix never fully
    materializes."""
    n, _, d = summaries.shape
    doc_vec = summaries.float().mean(dim=1)
    doc_vec = doc_vec * torch.rsqrt((doc_vec ** 2).sum(-1, keepdim=True)
                                    + 1e-9)
    stride = max(n // n_clusters, 1)
    cent = doc_vec[::stride][:n_clusters]

    def assign(c):
        return torch.cat([(doc_vec[lo:lo + chunk] @ c.T).argmax(dim=-1)
                          for lo in range(0, n, chunk)])

    for _ in range(iters):
        a = assign(cent)
        tot = torch.zeros((n_clusters, d), dtype=torch.float32,
                          device=doc_vec.device).index_add_(0, a, doc_vec)
        cnt = torch.zeros((n_clusters,), dtype=torch.float32,
                          device=doc_vec.device).index_add_(
            0, a, torch.ones_like(a, dtype=torch.float32))
        new = torch.where(cnt[:, None] > 0, tot, cent)
        cent = new * torch.rsqrt((new ** 2).sum(-1, keepdim=True) + 1e-9)
    return torch.argsort(assign(cent), stable=True)
