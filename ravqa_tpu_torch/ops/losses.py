"""Training losses for late-interaction retrieval.

Port of ravqa_tpu/ops/losses.py (:29-109):
- nway_ce_loss: contrastive cross-entropy over each query's nway docs,
  positive first (colbert or flipr interaction);
- in_batch_negative_loss: cross-entropy over the full (B, B*nway) MaxSim
  matrix, query i's positive at column i*nway; blocked and rematerialized
  when block_n or compute_dtype is set;
- dpr_in_batch_loss: the DPR dot-product in-batch cross-entropy.

Scores are float32; F.cross_entropy's mean equals optax's
softmax_cross_entropy_with_integer_labels followed by a mean. The JAX
package computes all of this in XLA (no Pallas kernel), so the port is
plain PyTorch with autograd.

Data parallelism (`group`, a process group of the data axis): the JAX
package's mesh step computes the in-batch losses over the global batch.
Here each rank passes its own rows; the docs are all-gathered with
parallel.gather_rows (whose backward returns every rank's gradient of a
doc to its owner), each rank scores its queries against every doc, and
query i of rank r has its positive at global column (r * b + i) * nway.
The loss is the mean over the rank's queries, so the mean over ranks (the
data-parallel gradient average) is the global batch's loss; nothing is
scaled by the world size here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .maxsim import (flipr_reduce, maxsim_all_pairs_blocked,
                     maxsim_all_pairs_xla, maxsim_pair_xla)


def nway_ce_loss(q: torch.Tensor, d: torch.Tensor, d_mask: torch.Tensor,
                 nway: int, q_mask: Optional[torch.Tensor] = None,
                 interaction: str = "colbert",
                 flipr_query_part_len: int = 0, flipr_k1: int = 0,
                 flipr_k2: int = 0):
    """q (B, Lq, dim); d (B*nway, Ld, dim) grouped per query, positive at
    position 0; d_mask likewise. -> (loss, scores (B, nway))."""
    b, lq, dim = q.shape
    ld = d.shape[-2]
    q_flat = q[:, None].expand(b, nway, lq, dim).reshape(b * nway, lq, dim)
    d_flat = d.reshape(b * nway, ld, dim)
    m_flat = d_mask.reshape(b * nway, ld)
    if interaction == "flipr":
        s = torch.einsum("bld,bqd->blq", d_flat, q_flat).float()
        scores = flipr_reduce(s, m_flat, flipr_query_part_len, flipr_k1,
                              flipr_k2).reshape(b, nway)
    else:
        qm = None
        if q_mask is not None:
            qm = q_mask[:, None].expand(b, nway, lq).reshape(b * nway, lq)
        scores = maxsim_pair_xla(q_flat, d_flat, m_flat, qm).reshape(b, nway)
    labels = torch.zeros(b, dtype=torch.long, device=q.device)
    return F.cross_entropy(scores.float(), labels), scores


def _gathered_docs(group, *docs):
    """(docs gathered over `group`, this rank's first query's global
    index over `b` local queries), or the docs as given without a group."""
    if group is None:
        return docs, 0
    import torch.distributed as dist
    from ..parallel.partition import gather_rows
    return tuple(gather_rows(x, group) for x in docs), dist.get_rank(group)


def in_batch_negative_loss(q: torch.Tensor, d: torch.Tensor,
                           d_mask: torch.Tensor, nway: int,
                           q_mask: Optional[torch.Tensor] = None,
                           block_n: int = 0,
                           compute_dtype: Optional[torch.dtype] = None,
                           group=None):
    """Every query against every doc of the batch; query i's positive is
    doc row i*nway. block_n > 0 or a compute_dtype scores through
    maxsim_all_pairs_blocked. group: the data-parallel group whose ranks'
    docs join the batch (module docstring). -> (loss, scores (B,
    B_global*nway))."""
    (d, d_mask), rank = _gathered_docs(group, d, d_mask)
    if block_n or compute_dtype is not None:
        scores = maxsim_all_pairs_blocked(q, d, d_mask, q_mask,
                                          block_n=block_n,
                                          compute_dtype=compute_dtype)
    else:
        scores = maxsim_all_pairs_xla(q, d, d_mask, q_mask)
    b = q.shape[0]
    labels = (rank * b + torch.arange(b, device=q.device)) * nway
    return F.cross_entropy(scores, labels), scores


def dpr_in_batch_loss(q_pooled: torch.Tensor, d_pooled: torch.Tensor,
                      nway: int, group=None):
    """q_pooled (B, dim), d_pooled (B*nway, dim), positive at i*nway.
    group: as in_batch_negative_loss. -> (loss, scores (B,
    B_global*nway))."""
    (d_pooled,), rank = _gathered_docs(group, d_pooled)
    scores = q_pooled @ d_pooled.T
    b = q_pooled.shape[0]
    labels = (rank * b + torch.arange(b, device=q_pooled.device)) * nway
    return F.cross_entropy(scores.float(), labels), scores
