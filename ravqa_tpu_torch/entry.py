"""The FLMR training loss at BERT-base width: the port's twin of the
repository's ``__graft_entry__.entry()``.

    from ravqa_tpu_torch.entry import entry
    fn, (model, batch) = entry()          # on "cuda"; entry("cpu") on CPU
    loss = fn(model, batch)
    loss.backward()

The same FLMRModelConfig (BERT-base, dim 128, vision 768, 32 mapping
tokens, nway 2, in-batch negatives) and the same numpy batch, drawn from
np.random.default_rng(0) by a copy of `_example_batch`. The weights come
from torch.Generator().manual_seed(0); PyTorch cannot reproduce Flax's
model.init, so tests/test_torch_train.py carries the JAX parameters across
(models.convert) to compare the two losses.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import BertConfig, FLMRModelConfig, FLMRRetriever


def _example_batch(rng, vocab, b, lq, ld, nway, vision_dim) -> dict:
    """The numpy batch __graft_entry__._example_batch draws, in its order."""
    return dict(
        query_input_ids=rng.integers(1, vocab, (b, lq)).astype(np.int32),
        query_attention_mask=np.ones((b, lq), np.int32),
        image_features=rng.normal(size=(b, vision_dim)).astype(np.float32),
        doc_input_ids=rng.integers(1, vocab, (b * nway, ld)).astype(np.int32),
        doc_attention_mask=np.ones((b * nway, ld), np.int32),
    )


def entry(device="cuda"):
    """Returns (fn, (model, batch)): fn(model, batch) is the training loss
    (nway + in-batch-negative cross-entropy) of FLMRRetriever on `device`;
    the batch's ids are int64 tensors there."""
    cfg = FLMRModelConfig(bert=BertConfig(), dim=128, vision_dim=768,
                          prefix_len=32, nway=2, use_ib_negatives=True)
    model = FLMRRetriever(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    batch = _example_batch(np.random.default_rng(0), cfg.bert.vocab_size,
                           b=2, lq=32, ld=128, nway=cfg.nway,
                           vision_dim=cfg.vision_dim)
    batch = {k: torch.as_tensor(v, device=device).long()
             if k.endswith("input_ids") else torch.as_tensor(v, device=device)
             for k, v in batch.items()}

    def fn(model, batch):
        return model(**batch)["loss"]

    return fn, (model.to(device), batch)
