"""Device-resident late-interaction token index.

Port of ravqa_tpu/retrieval/index.py for one device and a token index:

    tokens:          (N_pad, Ld, dim)     float32 or bfloat16
    mask:            (N_pad, Ld)          int8 (0 on padded tokens and docs)
    pids:            (N_pad,)             int64 numpy, -1 on padded docs
    summaries:       (N_pad, S, dim)      two-stage / hierarchical search
    block_summaries: (N_pad/bs, Sb, dim)  hierarchical search

The int8 and residual codecs, sharding and save/load are not ported yet
(ROADMAP.md, Queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class TokenIndex:
    """A late-interaction token index on one device."""
    tokens: torch.Tensor       # (N_pad, Ld, dim)
    mask: torch.Tensor         # (N_pad, Ld) int8
    pids: np.ndarray           # (N_pad,) int64 passage ids; -1 = pad
    num_docs: int              # real (unpadded) doc count
    meta: dict = dataclasses.field(default_factory=dict)
    summaries: Optional[torch.Tensor] = None        # (N_pad, S, dim)
    block_summaries: Optional[torch.Tensor] = None  # (N_pad / bs, Sb, dim)
    block_size: int = 64

    def build_summaries(self, n_summary: int = 8,
                        iters: int = 4) -> "TokenIndex":
        """Attach per-doc summary vectors (coarse.summarize_docs) in the
        tokens' dtype, for two-stage and hierarchical search."""
        from .coarse import summarize_docs
        self.summaries = summarize_docs(self.tokens, self.mask,
                                        n_summary=n_summary,
                                        iters=iters).to(self.tokens.dtype)
        return self

    def build_block_summaries(self, block_size: int = 64,
                              n_block_summary: int = 4,
                              iters: int = 4) -> "TokenIndex":
        """Second summary level for hierarchical search, over blocks of
        `block_size` consecutive docs. For best recall, build the index
        with cluster-ordered docs (coarse.cluster_order)."""
        from .coarse import block_summaries
        if self.summaries is None:
            raise ValueError("build_summaries() first")
        if self.n_pad % block_size:
            raise ValueError(f"block_size {block_size} must divide the "
                             f"padded doc count {self.n_pad}")
        self.block_summaries = block_summaries(
            self.summaries, block_size=block_size,
            n_block_summary=n_block_summary,
            iters=iters).to(self.summaries.dtype)
        self.block_size = block_size
        return self

    @property
    def n_pad(self) -> int:
        return self.tokens.shape[0]

    @property
    def doc_maxlen(self) -> int:
        return self.tokens.shape[1]

    @property
    def dim(self) -> int:
        return self.tokens.shape[2]


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def build_index_from_embeddings(
    embs,
    masks,
    pids: Optional[Sequence[int]] = None,
    pad_multiple: int = 128,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> TokenIndex:
    """Assemble an index from per-doc token embeddings.

    embs: (N, Ld, dim) array or tensor, or a list of (Ld_i, dim) arrays
    (padded to the longest); embeddings must already be L2-normalized.
    masks: the matching validity masks. N is padded to a multiple of
    `pad_multiple` with masked docs whose pid is -1. device: where the index
    lives (None: where `embs` is, the CPU for numpy input)."""
    if isinstance(embs, (list, tuple)):
        n = len(embs)
        ld = max(e.shape[0] for e in embs)
        dim = embs[0].shape[1]
        tok = torch.zeros((n, ld, dim), dtype=torch.float32)
        msk = torch.zeros((n, ld), dtype=torch.int8)
        for i, (e, m) in enumerate(zip(embs, masks)):
            tok[i, :e.shape[0]] = torch.as_tensor(np.asarray(e, np.float32))
            msk[i, :m.shape[0]] = torch.as_tensor(np.asarray(m)).to(
                torch.int8)
    else:
        tok = torch.as_tensor(embs)
        msk = torch.as_tensor(masks)
        n, ld, dim = tok.shape
    if device is None:
        device = tok.device
    tok = tok.to(device=device, dtype=dtype)
    msk = msk.to(device=device).to(torch.int8)
    pids = (np.arange(n, dtype=np.int64) if pids is None
            else np.asarray(pids, np.int64))

    n_pad = pad_to(max(n, 1), pad_multiple)
    if n_pad != n:
        tok = torch.cat([tok, tok.new_zeros((n_pad - n, ld, dim))])
        msk = torch.cat([msk, msk.new_zeros((n_pad - n, ld))])
        pids = np.concatenate([pids, np.full((n_pad - n,), -1, np.int64)])
    return TokenIndex(tokens=tok.contiguous(), mask=msk.contiguous(),
                      pids=pids, num_docs=n,
                      meta={"doc_maxlen": ld, "dim": dim})


def encode_corpus(
    doc_encode_fn: Callable,
    batches: Iterable[dict],
    pad_multiple: int = 128,
    dtype: torch.dtype = torch.bfloat16,
    pids: Optional[Sequence[int]] = None,
    device=None,
) -> TokenIndex:
    """Encode a corpus into a TokenIndex.

    doc_encode_fn(batch) -> (D (B, Ld, dim), mask (B, Ld)) tensors. Each
    batch's embeddings are cast to `dtype` as they arrive and stay on their
    device, so the index never makes a round trip through the host (casting
    per batch gives the same values as casting the whole f32 stack)."""
    embs, msks = [], []
    for batch in batches:
        d, m = doc_encode_fn(batch)
        embs.append(d.to(dtype))
        msks.append(m.to(torch.int8))
    tok = torch.cat(embs)
    del embs
    return build_index_from_embeddings(tok, torch.cat(msks), pids=pids,
                                       pad_multiple=pad_multiple, dtype=dtype,
                                       device=device)
