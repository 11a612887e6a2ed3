"""Inference-only FLMR executor: query/doc encoding and index building.

Port of the serving half of ravqa_tpu/executors/flmr_executor.py
(:35-96). It holds the model in inference form and builds no optimizer
state, so a checkpoint loads straight into a serving executor (the JAX
package's load_checkpoint needs optimizer state as its restore template,
executors/base.py:414-466; ROADMAP.md C5). Training and evaluation come
with the trainer (ROADMAP.md A8).
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..models.convert import load_params
from ..models.flmr import FLMRRetriever, skiplist_mask
from ..retrieval.index import TokenIndex, encode_corpus


# a checkpoint directory's params file, in the order load_checkpoint looks
CHECKPOINT_FILES = ("params.msgpack", "params.npz")


class FLMRExecutor:
    inference_only = True

    def __init__(self, model: FLMRRetriever, device=None,
                 skip_ids: Optional[Sequence[int]] = None):
        self.device = torch.device(
            device if device is not None
            else next(model.parameters()).device)
        self.model = model.to(self.device).eval()
        self.skip_ids = tuple(skip_ids or ())

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # -- checkpoints ---------------------------------------------------------
    def load_checkpoint(self, path: str) -> None:
        """Load parameters into the model: a params file (the JAX package's
        flax msgpack, or a flattened-key .npz; models.convert.load_params),
        or a checkpoint directory holding params.msgpack (the JAX package's
        save_checkpoint) or params.npz, in that order."""
        if os.path.isdir(path):
            found = [os.path.join(path, f) for f in CHECKPOINT_FILES
                     if os.path.exists(os.path.join(path, f))]
            if not found:
                raise FileNotFoundError(f"{path} holds none of "
                                        f"{CHECKPOINT_FILES}")
            path = found[0]
        self.model.load_state_dict(load_params(path), strict=True)

    def prepare_for_serving(self) -> None:
        """No-op: this executor never holds training-only state."""

    # -- encoding ------------------------------------------------------------
    @torch.inference_mode()
    def encode_query(self, input_ids, attention_mask,
                     image_features) -> torch.Tensor:
        """-> (B, Lq + n_vision, dim) float32 on the executor's device."""
        return self.model.query(self._t(input_ids, torch.long),
                                self._t(attention_mask),
                                self._t(image_features, torch.float32))

    @torch.inference_mode()
    def encode_doc(self, input_ids, attention_mask, skip_mask=None):
        ids = self._t(input_ids, torch.long)
        if skip_mask is None:
            skip_mask = skiplist_mask(ids, self.skip_ids)
        return self.model.doc(ids, self._t(attention_mask),
                              self._t(skip_mask, torch.float32))

    def encode_queries(self, batches: Iterable[dict]) -> np.ndarray:
        return np.concatenate([
            self.encode_query(b["query_input_ids"],
                              b["query_attention_mask"],
                              b["image_features"]).cpu().numpy()
            for b in batches], axis=0)

    def build_index(self, doc_batches: Iterable[dict],
                    pids: Optional[Sequence] = None,
                    dtype: torch.dtype = torch.float32,
                    pad_multiple: int = 8) -> TokenIndex:
        """Encode a corpus into a TokenIndex on the executor's device
        (float32 by default, as the JAX executor stores it)."""
        def encode_fn(b):
            return self.encode_doc(b["doc_input_ids"], b["doc_attention_mask"],
                                   b.get("doc_skip_mask"))

        return encode_corpus(encode_fn, doc_batches,
                             pad_multiple=pad_multiple, dtype=dtype,
                             pids=pids, device=self.device)
