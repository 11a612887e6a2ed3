"""The FLMR training loss at BERT-base width, and the multi-rank dry run:
the port's twins of the repository's ``__graft_entry__.entry()`` and
``dryrun_multichip``.

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

    from ravqa_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(4, "cpu")            # 4 gloo ranks; "cuda": the card

dryrun_multichip(n, device) runs, on n ranks (parallel.launch) at tiny
shapes: a data-parallel FSDP FLMR training step; with n >= 4 and even,
the query tower under tensor parallelism on a (data x model) mesh against
the replicated tower; and a sharded index build with exact, two-stage,
residual (flat with centroid pruning, and factored) two-stage,
hierarchical int8 and fast-preset searches.
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


def _dryrun_rank(n: int, device: str) -> dict:
    from .executors import FLMRExecutor, TrainConfig
    from .parallel import (apply_tp, local_device, make_mesh, shard_batch)
    from .retrieval import (LateInteractionSearcher,
                            build_index_from_embeddings)
    dev = local_device()
    mesh = make_mesh({"data": n}, device)
    cfg = FLMRModelConfig(
        bert=BertConfig(vocab_size=512, hidden_size=64, num_layers=2,
                        num_heads=4, intermediate_size=128,
                        max_position_embeddings=64),
        dim=32, vision_dim=16, prefix_len=2, nway=2, use_ib_negatives=True)

    def model():
        m = FLMRRetriever(cfg)
        m.reset_parameters(torch.Generator().manual_seed(0))
        return m

    rng = np.random.default_rng(0)
    batch = _example_batch(rng, 512, b=2 * n, lq=8, ld=12, nway=2,
                           vision_dim=cfg.vision_dim)
    ex = FLMRExecutor(model(), TrainConfig(lr=1e-4), device=dev, quiet=True,
                      mesh=mesh, param_sharding="fsdp", fsdp_min_size=4096)
    loss = float(ex.train_step(batch)["loss"])
    assert np.isfinite(loss), loss
    out = {"loss": loss}

    qkeys = ("query_input_ids", "query_attention_mask", "image_features")
    if n >= 4 and n % 2 == 0:
        # Megatron-style tensor parallelism over a (data x model) mesh:
        # the query tower's heads and MLP split over "model"
        mesh2 = make_mesh({"data": n // 2, "model": 2}, device)
        local = shard_batch({k: batch[k] for k in qkeys}, mesh2, "data")
        args = [torch.as_tensor(local[k], device=dev) for k in qkeys]
        args[0] = args[0].long()
        rep = model().to(dev).eval()
        tp = apply_tp(model().to(dev).eval(), mesh2, "model")
        with torch.no_grad():
            want, got = rep.query(*args), tp.query(*args)
        assert torch.isfinite(got).all()
        out["tp_max_abs_err"] = float((got - want).abs().max())
        assert out["tp_max_abs_err"] < 1e-4, out

    # sharded index build and collective searches over the mesh
    n_corpus = 8 * n
    doc_batches = [dict(doc_input_ids=rng.integers(1, 512, (n_corpus, 12)),
                        doc_attention_mask=np.ones((n_corpus, 12),
                                                   np.int64))]
    index = ex.build_index(doc_batches)
    q = ex.encode_queries([{k: batch[k] for k in qkeys}])
    b = q.shape[0]

    def search(idx, **kw):
        _, pids = LateInteractionSearcher(idx, mesh, "data",
                                          **kw).search(q, 3)
        assert pids.shape == (b, 3), pids.shape
        return pids

    out["exact"] = search(index)
    index.build_summaries(n_summary=2, iters=2, mesh=mesh, axis="data")
    out["two_stage"] = search(index, mode="two_stage", n_candidates=4)
    tokens = index._gathered(index.tokens).float().cpu().numpy()
    mask = index._gathered(index.mask).cpu().numpy()
    for name, cents, extra in (("residual", 16, {"centroid_prune": 2 * n}),
                               ("factored", (4, 8), {})):
        idx = build_index_from_embeddings(tokens, mask, pad_multiple=8 * n,
                                          dtype=torch.float32, mesh=mesh,
                                          axis="data", device=dev)
        idx.build_summaries(n_summary=2, iters=2, mesh=mesh, axis="data")
        idx.quantize_residual(n_centroids=cents, nbits=2, mesh=mesh,
                              axis="data")
        out[name] = search(idx, mode="two_stage", n_candidates=4 * n,
                           **extra)
    index.build_block_summaries(block_size=4, n_block_summary=2, mesh=mesh,
                                axis="data")
    out["hierarchical_int8"] = search(index, mode="hierarchical",
                                      n_candidates=4 * n, n_blocks=2 * n,
                                      coarse_int8=True)
    # the fast preset cannot meet the TPU stage-1 lane rule at 2 blocks a
    # shard: a CPU shard keeps JAX's plain stage 1 over its int8 pruning
    # summaries, a CUDA shard sweeps the same blocks' rows through K4
    from .ops import maxsim
    fast = LateInteractionSearcher(index, mesh, "data", mode="hierarchical",
                                   n_candidates=4 * n, n_blocks=2 * n,
                                   preset="fast")
    on_cuda = dev.type == "cuda"
    assert fast.coarse_int8 and (fast._summ_rows is not None) == on_cuda
    before = maxsim.stage1_sweep.launches
    _, out["fast"] = fast.search(q, 3)
    out["fast_k4_launches"] = maxsim.stage1_sweep.launches - before
    assert out["fast"].shape == (b, 3), out["fast"].shape
    assert out["fast_k4_launches"] >= on_cuda, out
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """The multi-rank dry run (module docstring) on `n_devices` ranks of
    `device` ("cuda": the card, shared under gloo unless there are
    n_devices cards; "cpu": gloo on the host). Returns rank 0's results:
    the training loss, the tensor-parallel tower's largest difference from
    the replicated one (n >= 4, even), each search's pids, and the
    launches of K4 in the fast preset's search (on the card: at least 1)."""
    from .parallel import launch
    out = launch(_dryrun_rank, n_devices, n_devices, device, device=device,
                 timeout=120.0, join_timeout=900.0)
    print(f"dryrun_multichip({n_devices}, {device!r}): loss "
          f"{out[0]['loss']:.4f} ok", flush=True)
    return out[0]
