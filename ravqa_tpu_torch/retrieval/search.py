"""Exact late-interaction search over a TokenIndex on one device.

Port of ravqa_tpu/retrieval/search.py, ``mode="exact"`` on one device:
score the query batch against every doc (``ops.maxsim_search``: the Hopper
kernel on a CUDA index, plain PyTorch on a CPU index), then take the
top-k. Zero query rows are scored like any other row, exactly as in
``ravqa_tpu/retrieval/search.py::search_single_device``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.maxsim import maxsim_search
from .index import TokenIndex

_NOT_PORTED = ("is not ported yet: ravqa_tpu_torch serves exact search on "
               "one device (see ROADMAP.md, Queue A: A3, A5, A10)")


def search_single_device(q: torch.Tensor, tokens: torch.Tensor,
                         mask: torch.Tensor, *, k: int):
    """Exact search on one device. Returns (scores (B, k), rows (B, k))."""
    scores = maxsim_search(q, tokens, mask)
    return torch.topk(scores, k, dim=1)


class LateInteractionSearcher:
    """Searcher over a TokenIndex: device dispatch and pid mapping.

    ``use_pallas``, ``tile_d``, ``approx_topk`` and ``preset`` are the JAX
    searcher's TPU knobs and are no-ops here: the index's device decides the
    kernel, and the top-k is always exact. ``mesh`` (sharded search) and the
    pruned modes ("two_stage", "hierarchical") raise NotImplementedError."""

    def __init__(self, index: TokenIndex, mesh=None,
                 use_pallas: Optional[bool] = None,
                 tile_d: Optional[int] = None, mode: str = "exact",
                 approx_topk: Optional[bool] = None,
                 preset: str = "reference"):
        if preset not in ("reference", "fast"):
            raise ValueError(f"unknown preset {preset!r} "
                             "(expected 'reference' or 'fast')")
        if mode != "exact":
            raise NotImplementedError(f"search mode {mode!r} {_NOT_PORTED}")
        if mesh is not None:
            raise NotImplementedError(f"sharded search {_NOT_PORTED}")
        self.index = index

    def search_device(self, q: torch.Tensor, k: int):
        """(B, Lq, dim) on the index's device -> (scores (B, k), padded-index
        rows (B, k)), both left on the device."""
        idx = self.index
        return search_single_device(q, idx.tokens, idx.mask, k=k)

    def search(self, q, k: int):
        """Host-facing search: returns (scores (B, k) np, pids (B, k) np).

        Padded rows (pid -1) score -9999*Lq and only appear when
        k > num_docs."""
        q = torch.as_tensor(q, device=self.index.tokens.device)
        scores, rows = self.search_device(q, k)
        return scores.cpu().numpy(), self.index.pids[rows.cpu().numpy()]
