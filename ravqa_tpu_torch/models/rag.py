"""RAVQA answer serving: the generator's inputs and the joint answer pick.

The serving part of ravqa_tpu/models/rag.py (reference
src/models/rag/rag_model_blip.py):

- GeneratorInputBuilder == prepare_inputs_for_generator (:591-647): strips
  the <BOQ>/<EOQ>/<BOV>... markers and renders
  "{prefix}Question: .. Knowledge: {doc} Answer:" per (question, doc);
- select_answers_by_joint_score == the answer pick of generate
  (:800-817): argmax over docs of log g(z|x) + log p(y|x,z).

The training losses (rag_loss_components, get_retrieval_labels) come with
RAG training (ROADMAP.md A6).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np
import torch

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
