"""Plain late-interaction search: exact MaxSim over a token index, and a
frozen copy of the hierarchical pipeline's semantics.

Exact: score(q, d) = sum over query tokens of the max over d's valid
tokens of q . d (masked tokens -9999), float32, in doc blocks so the
(queries x docs x Ld x Lq) products stay bounded.

Hierarchical (the plain semantics of the port's `hierarchical` mode with
the `fast` preset, frozen here): per-doc spherical k-means summaries
(8 slots, 4 iterations, seeded by each doc's first valid tokens), block
summaries (k-means, 4 slots, over each 64-doc block's 512 doc summaries),
both kept in int8 with one scale per doc or block (max |x| / 127, round
half to even). Stage 0 scores every block with the query quantised per
token to int8: sum over query tokens of qscale * (bscale * max over slots
of the int32 dot); the top `n_blocks` blocks go on. Stage 1 scores their
docs' int8 summaries against the bfloat16-rounded query, max over slots,
sum over tokens, times the doc's scale; the top `n_candidates` docs are
scored exactly; the top k of those is the answer. Docs (blocks) with no
valid token score -9999 and are never taken.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .towers import einsum, matmul

NEG = -9999.0


def maxsim(q, tokens, mask, budget: int = 1 << 28):
    """(S, Lq, dim) x (N, Ld, dim) with (N, Ld) mask -> (S, N) float32."""
    s, lq, dim = q.shape
    n, ld, _ = tokens.shape
    out = torch.empty((s, n), dtype=torch.float32, device=q.device)
    qt = q.reshape(s * lq, dim).T.contiguous()
    step = max(1, budget // (s * lq * ld))
    for lo in range(0, n, step):
        t = tokens[lo:lo + step].float()
        c = t.shape[0]
        sc = matmul(t.reshape(c * ld, dim), qt).view(c, ld, s, lq)
        sc.masked_fill_(~mask[lo:lo + step].bool()[:, :, None, None], NEG)
        out[:, lo:lo + step] = sc.amax(dim=1).sum(dim=-1).T
    return out


def maxsim_rows(q, tokens, mask, rows):
    """Exact scores of each query's own docs: q (S, Lq, dim), rows (S, C)
    -> (S, C)."""
    out = []
    for i in range(q.shape[0]):
        t = tokens[rows[i]].float()
        sc = einsum("cld,qd->clq", t, q[i])
        sc = sc.masked_fill(~mask[rows[i]].bool()[..., None], NEG)
        out.append(sc.amax(dim=1).sum(dim=-1))
    return torch.stack(out)


def exact_topk(q, tokens, mask, k):
    return torch.topk(maxsim(q, tokens, mask), k, dim=1)


# -- hierarchical ----------------------------------------------------------

def kmeans_summaries(tokens, mask, n_summary, iters, chunk=8192):
    """(N, L, dim) L2-normalised rows -> (N, n_summary, dim): spherical
    k-means per row group, started at the first n_summary valid rows."""
    n = tokens.shape[0]
    out = torch.empty((n, n_summary, tokens.shape[2]), dtype=torch.float32,
                      device=tokens.device)
    for lo in range(0, n, chunk):
        tok = tokens[lo:lo + chunk].float()
        m = mask[lo:lo + chunk].float()
        order = torch.argsort(-m, dim=1, stable=True)[:, :n_summary]
        cent = torch.gather(tok, 1, order[..., None].expand(
            -1, -1, tok.shape[2]))
        for _ in range(iters):
            assign = torch.bmm(tok, cent.transpose(1, 2)).argmax(-1)
            onehot = F.one_hot(assign, n_summary).float() * m[..., None]
            tot = torch.bmm(onehot.transpose(1, 2), tok)
            cnt = onehot.sum(dim=1)[..., None]
            new = torch.where(cnt > 0, tot, cent)
            cent = new / new.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        out[lo:lo + chunk] = cent
    return out


def quantize(x, dims):
    """Symmetric int8 with one scale over `dims`: (codes, scales)."""
    x = x.float()
    scales = x.abs().amax(dim=dims).clamp_min(1e-8) * (1.0 / 127.0)
    shape = list(x.shape)
    for d in dims:
        shape[d] = 1
    return torch.round(x / scales.reshape(shape)).to(torch.int8), scales


class Hierarchical:
    """The pruning structures of an index, built once."""

    def __init__(self, tokens, mask, block_size=64, n_summary=8,
                 n_block_summary=4, iters=4):
        self.tokens, self.mask, self.bs = tokens, mask, block_size
        n = tokens.shape[0]
        summ = kmeans_summaries(tokens, mask, n_summary, iters)
        nb = n // block_size
        blocks = summ.reshape(nb, block_size * n_summary, -1)
        bsum = kmeans_summaries(blocks, torch.ones(blocks.shape[:2],
                                                   device=tokens.device),
                                n_block_summary, iters)
        self.bsum8, self.bscale = quantize(bsum, (1, 2))   # (NB, Sb, d)
        self.summ8, self.sscale = quantize(summ, (1, 2))   # (N, S, d)
        self.doc_valid = mask.bool().any(dim=1)
        self.blk_valid = self.doc_valid.reshape(nb, block_size).any(dim=1)

    def stage0(self, q):
        """(S, Lq, dim) -> (S, NB) block scores, -9999 on invalid blocks."""
        q8, qs = quantize(q, (2,))
        s0 = []
        for lo in range(0, q.shape[0], 8):
            dots = einsum("bqd,nsd->bqns", q8[lo:lo + 8].float(),
                          self.bsum8.float())
            s0.append((qs[lo:lo + 8, :, None] * (
                dots.amax(dim=3) * self.bscale[None, None])).sum(dim=1))
        return torch.cat(s0).masked_fill(~self.blk_valid[None], NEG)

    def stage1(self, qb, blocks):
        """One query's bf16-rounded tokens against the docs of `blocks` ->
        (rows, scores), -9999 on invalid docs."""
        nb, bs = self.blk_valid.shape[0], self.bs
        summ = self.summ8.reshape(nb, bs, *self.summ8.shape[1:])
        s1 = einsum("nbsd,qd->nbsq", summ[blocks].float(), qb)
        s1 = s1.amax(dim=2).sum(-1) * self.sscale.reshape(nb, bs)[blocks]
        s1 = s1.masked_fill(~self.doc_valid.reshape(nb, bs)[blocks], NEG)
        rows = (blocks[:, None] * bs
                + torch.arange(bs, device=blocks.device)).reshape(-1)
        return rows, s1.reshape(-1)

    def search(self, q, k, n_blocks, n_candidates, eps=1e-4):
        """(S, Lq, dim) -> (scores (S, k), rows (S, k)): the pipeline's
        answer, and bound (S, k): the r-th best exact score among the docs
        that any run of the pipeline whose stage scores differ from these
        by under `eps` of the cut's score (at least eps) must take as
        candidates (-inf past their count). A block within eps of the
        stage-0 cut may go either way; a doc is certain when its block is
        above the cut by more, and its stage-1 score is above, by more, the
        n_candidates-th best over every block that may be taken."""
        s0 = self.stage0(q)
        srt = torch.sort(s0, dim=1, descending=True)
        qb = q.to(torch.bfloat16).float()
        out_s, out_r, bound = [], [], []
        for i in range(q.shape[0]):
            cut0 = srt.values[i, n_blocks]
            tol0 = eps * cut0.abs().clamp_min(1.0)
            rows, s1 = self.stage1(qb[i], srt.indices[i, :n_blocks])
            loc = torch.topk(s1, n_candidates).indices
            sc = maxsim_rows(q[i:i + 1], self.tokens, self.mask,
                             rows[loc][None])[0]
            s, sel = torch.topk(sc, k)
            out_s.append(s)
            out_r.append(rows[loc][sel])
            may = torch.nonzero(s0[i] > cut0 - tol0)[:, 0]
            rows_m, s1_m = self.stage1(qb[i], may)
            v = torch.topk(s1_m, n_candidates).values[-1]
            sure_blk = s0[i][rows_m // self.bs] >= cut0 + tol0
            sure = rows_m[sure_blk & (s1_m >= v + eps * v.abs().clamp_min(
                1.0))]
            b = torch.full((k,), -float("inf"), device=q.device)
            if sure.numel():
                ex = maxsim_rows(q[i:i + 1], self.tokens, self.mask,
                                 sure[None])[0]
                top = torch.topk(ex, min(k, ex.numel())).values
                b[:top.numel()] = top
            bound.append(b)
        return torch.stack(out_s), torch.stack(out_r), torch.stack(bound)
