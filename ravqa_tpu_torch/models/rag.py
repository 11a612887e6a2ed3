"""RAVQA / RAVQA-v2: the RAG losses, the pseudo-relevance labels, the
generator's inputs and the joint answer pick.

Port of ravqa_tpu/models/rag.py (reference src/models/rag/
rag_model_blip.py):

- rag_loss_components == get_loss (:826-1026): the token NLL over the
  B * n_docs sequences; RAG-sequence marginalization (the doc log-softmax
  added at the first target token, T5 having no BOS, then the tokens
  summed, logsumexp over docs, the batch summed); the pseudo-relevance
  "additional" BCE over softmax(doc_scores) with the Approach1-6 / NoPR
  merged-label and ignore-mask tables (:946-1010), whose first-token
  argmax carries no gradient;
- get_retrieval_labels == :1030-1180's default path (case-insensitive
  substring match of any answer; the per-doc selected answer, the gold one
  unless it is absent and another answer is present: force_existence);
- GeneratorInputBuilder == prepare_inputs_for_generator (:591-647): strips
  the <BOQ>/<EOQ>/<BOV>... markers and renders
  "{prefix}Question: .. Knowledge: {doc} Answer:" per (question, doc);
- select_answers_by_joint_score == the answer pick of generate
  (:800-817): argmax over docs of log g(z|x) + log p(y|x,z).
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .transformer import upcast

# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _merged_and_ignore(loss_type: str, pred_ok: torch.Tensor,
                       rl: torch.Tensor):
    """The pseudo-relevance target and the ignore mask of each loss type
    (rag_model_blip.py:946-1010), from whether the first generated token is
    the target's (pred_ok) and the retrieval labels (rl), both bool."""
    if loss_type == "Approach1":
        merged = pred_ok | rl
        return merged, ~merged
    if loss_type == "Approach2":
        return pred_ok | rl, pred_ok & ~rl
    if loss_type == "Approach3":
        return pred_ok | rl, ~rl
    if loss_type == "Approach4":
        return rl, pred_ok & ~rl
    if loss_type == "Approach5":
        merged = pred_ok & rl
        return merged, ~merged
    if loss_type == "Approach6":
        return pred_ok & rl, (~pred_ok & rl) | (pred_ok & ~rl)
    if loss_type == "NoPR":
        return pred_ok, torch.zeros_like(pred_ok)
    raise ValueError(loss_type)


def _global_count(n: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return n
    from ..parallel.mesh import all_reduce
    return all_reduce(n.detach().clone(), group=group)


def rag_loss_components(seq_logits: torch.Tensor, doc_scores: torch.Tensor,
                        target: torch.Tensor,
                        retrieval_labels: Optional[torch.Tensor] = None,
                        loss_type: str = "Approach4",
                        rag_loss_weight: float = 1.0,
                        additional_loss_weight: float = 1.0,
                        nll_loss_weight: float = 1.0,
                        ignore_index: int = -100, group=None) -> dict:
    """seq_logits (B * n_docs, T, V); doc_scores (B, n_docs); target
    (B * n_docs, T) with ignore_index padding; retrieval_labels (B,
    n_docs) 1/0. Returns {"nll_loss", "rag_loss", "additional_loss",
    "loss"}, scalars; "loss" is the weighted sum. The softmaxes run in
    float32 (float64 inputs stay float64: a reference run).

    group: a data-parallel group whose ranks hold the other rows of the
    global batch. The NLL and the retrieval loss are means over counts of
    the whole batch (non-pad tokens, nonzero BCE terms) and the RAG loss a
    sum, so each rank divides by the global counts (summed over the
    group) and returns its share: the shares sum to the global batch's
    losses (the executor sums the grads, BaseExecutor.loss_is_sum)."""
    b, n_docs = doc_scores.shape
    t, v = seq_logits.shape[1], seq_logits.shape[-1]
    seq_logprobs = torch.log_softmax(upcast(seq_logits), -1).reshape(
        b, n_docs, t, v)
    doc_logprobs = torch.log_softmax(upcast(doc_scores), -1)

    new_target = target.reshape(b, n_docs, t).long()
    pad_mask = new_target == ignore_index
    safe_target = torch.where(pad_mask, 0, new_target)
    ll = seq_logprobs.gather(-1, safe_target[..., None])[..., 0]
    ll = torch.where(pad_mask, 0.0, ll)                 # (B, n_docs, T)

    out = {}
    # the mean NLL over non-pad tokens (the reference's reduce_loss path)
    denom = _global_count((~pad_mask).sum(), group).clamp_min(1)
    out["nll_loss"] = nll_loss = -ll.sum() / denom

    # RAG-sequence: the doc log-prob at the first token (T5: no BOS)
    first = ll[:, :, 0] + torch.where(pad_mask[:, :, 0], 0.0, doc_logprobs)
    rag_ll = torch.cat([first[..., None], ll[:, :, 1:]], -1).sum(-1)
    out["rag_loss"] = rag_loss = -torch.logsumexp(rag_ll, dim=1).sum()

    additional = torch.zeros((), device=seq_logits.device)
    if retrieval_labels is not None:
        first_pred = seq_logprobs[:, :, 0, :].detach().argmax(-1)
        pred_ok = first_pred == new_target[:, :, 0]
        merged, ignore = _merged_and_ignore(loss_type, pred_ok,
                                            retrieval_labels.bool())
        merged = merged.float()
        p = torch.softmax(upcast(doc_scores), -1)
        eps = 1e-7
        bce = -(merged * torch.log(p + eps)
                + (1 - merged) * torch.log(1 - p + eps))
        bce = torch.where(ignore, 0.0, bce)
        nz = _global_count((bce != 0).sum(), group)
        additional = torch.where(nz > 0, bce.sum() / nz.clamp_min(1), 0.0)
    out["additional_loss"] = additional
    out["loss"] = (nll_loss_weight * nll_loss + rag_loss_weight * rag_loss
                   + additional_loss_weight * additional)
    return out


# ---------------------------------------------------------------------------
# host side: labels and the generator's inputs (strings)
# ---------------------------------------------------------------------------

def most_frequent(items: Sequence[str]) -> str:
    # as the JAX package writes it: ties break by the set's order
    return max(set(items), key=list(items).count)


def get_retrieval_labels(batch_answers: Sequence[Sequence[str]],
                         batch_doc_texts: Sequence[Sequence[str]],
                         match_fn: Optional[Callable] = None):
    """Returns (labels (B, n_docs) float32 numpy, selected answers (B *
    n_docs)).

    Default match: a case-insensitive substring of any unique answer in the
    doc text. The selected answer of a doc: the gold (most frequent) answer
    unless it does not appear but another answer (by frequency) does."""
    labels, selected = [], []
    for answers, docs in zip(batch_answers, batch_doc_texts):
        filtered = [a for a in answers if a != ""]
        gold = most_frequent(filtered)
        unique = list(set(answers))
        counts = Counter(filtered)
        by_freq = sorted(filtered, key=lambda x: -counts[x])
        row = []
        for doc in docs:
            if match_fn is not None:
                hit = any(match_fn(a.lower(), doc) for a in unique)
            else:
                hit = any(a.lower() in doc.lower() for a in unique)
            row.append(1.0 if hit else 0.0)
            sel = gold
            if gold.lower() not in doc.lower():
                for a in by_freq:
                    if a == gold:
                        continue
                    if a.lower() in doc.lower():
                        sel = a
                        break
            selected.append(sel)
        labels.append(row)
    return np.asarray(labels, np.float32), selected


MARKER_REPLACEMENTS = {
    "<BOQ>": "", "<EOQ>": "",
    "<BOC>": "Caption: ", "<EOC>": "",
    "<BOV>": "Objects: ", "<EOV>": ". ", "<SOV>": ", ",
    "<BOK>": "", "<EOK>": "",
}
MARKER_RE = re.compile("|".join(re.escape(m) for m in MARKER_REPLACEMENTS))


@dataclasses.dataclass
class GeneratorInputBuilder:
    """prepare_inputs_for_generator (rag_model_blip.py:591-647).

    ignore_knowledge: the `ignore_knowledge_passages` module flag (:617) —
    render "Question: ... Answer:" without the retrieved passage.
    """
    template: str = "Question: {question} Knowledge: {knowledge} Answer:"
    no_knowledge_template: str = "Question: {question} Answer:"
    prefix: str = ""
    ignore_knowledge: bool = False

    def strip_markers(self, text: str) -> str:
        out = MARKER_RE.sub(lambda m: MARKER_REPLACEMENTS[m.group(0)], text)
        return " ".join(out.split())

    def build(self, questions: Sequence[str],
              batch_docs: Sequence[Sequence[str]]) -> list[str]:
        """-> B * n_docs generator input strings (doc-major per
        question)."""
        out = []
        for q, docs in zip(questions, batch_docs):
            q = self.strip_markers(q)
            for d in docs:
                if self.ignore_knowledge:
                    out.append(self.prefix
                               + self.no_knowledge_template.format(
                                   question=q))
                else:
                    out.append(self.prefix + self.template.format(
                        question=q, knowledge=d.strip()))
        return out


def select_answers_by_joint_score(doc_scores, seq_logprobs) -> np.ndarray:
    """argmax_doc [log g(z|x) + log p(y|x,z)] (reference generate
    :800-817): doc_scores (B, n_docs) raw retrieval scores, seq_logprobs
    (B, n_docs) the generated sequences' log-probs, both float32. Returns
    (B,) chosen doc indices, the first on ties."""
    doc_logprobs = torch.log_softmax(
        torch.as_tensor(np.asarray(doc_scores, np.float32)), dim=-1).numpy()
    joint = doc_logprobs + np.asarray(seq_logprobs, np.float32)
    return np.argmax(joint, axis=1)
