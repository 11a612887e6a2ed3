#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ravqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. environment: torch/CUDA versions, the card's name and power limit;
     TF32 off for float32 matmuls and convolutions. No GPU -> exit 1.
  2. build: every CUDA library of the port (csrc/maxsim_mma.cu: K1 on the
     tensor cores, a bf16 index or a float32 one as two bf16 planes,
     csrc/coarse_sweep.cu: K2 + K3 (K2's bf16 body and K3 on the tensor
     cores, csrc/summary_tile.cuh), csrc/stage1_sweep.cu: K4 (bf16 and
     int8 rows on the same tensor-core sweep, float32 rows on the CUDA
     cores), csrc/maxsim_int8.cu: K5, csrc/residual_maxsim.cu: K6,
     csrc/residual_lut_maxsim.cu: X1, csrc/candidate_maxsim.cu: X2 and X3,
     both on the tensor cores)
     from the repo's sources, the nvcc runs side by side; ptxas
     registers/spills.
  3. K1 against its plain PyTorch version on the card: a bf16 index
     ("K1") with a bf16 query (Ld=128) and with a float32 query split in
     two bf16 parts (Ld=64); a float32 index ("K1-f32") at the float32
     serve shape, read as two bf16 planes (hi.hi + lo.hi + hi.lo; the run
     fails unless that split route launched): scores, tie-aware top-10,
     an all-masked doc at exactly -9999 x Lq, both times (median of 10
     after warm-up, CUDA events), TFLOP/s and the bound (bf16 operations
     of every product the split takes; the CUDA cores' float32 bound
     beside it).
  4. the exact slice: build_server on configs/synthetic_flmr_base_serve.json
     (FLMR at BERT-base width, 16,384 passages encoded on the card), 64
     requests from 4 threads, every answer checked against a plain search
     of the same index with the executor's own query embeddings, K1's
     launch count checked against the dispatches (every one on the float32
     index's split route), the planes' bytes beside the index's, and the
     towers on the card checked against the same module run on the CPU.
  5. K2, K3 and K4 against their plain versions at the bench.py shape
     (B=32, Lq=32, dim=128; 112,640 docs x 8 summaries; 1,760 x 4 block
     summaries padded to 2,048; bs=64, n_blocks 16 and 32) and K2, K3 and
     K4 at the hierarchical serve's (Lq=64; 256 of 1,024 padded blocks x 4
     summaries, K2 also on float32 ones, its CUDA-core body; int8 rows,
     n_blocks 32 of 256 blocks x 8 summaries):
     scores, tie-aware top-10, K3's pre-scale sums exactly, invalid docs at
     exactly -9999, the wrapper's and the plain version's times, each
     kernel's launch alone beside them ("kernel_ms", CUDA events) and its
     device time from torch.profiler's trace ("device_ms"); the run fails
     unless K2's wrapper ran the tensor-core body on bf16 summaries.
  6. pruned search at the bench scale: a clustered bf16 index of 112,640
     docs x 128 tokens made on the card (bench.py's recipe), summaries and
     block summaries, then LateInteractionSearcher in hierarchical (fast,
     reference) and two_stage (fast, reference) mode: recall@10 against
     exact search (K1, which must take the MMA route) and ms per batch of
     32 and each search's launches, the exact search's beside its bound;
     hierarchical fast must reach recall 0.95, K2, K3 and K4 must each
     launch, and both reference searches must launch K2.
  7. the hierarchical slice: build_server on
     configs/synthetic_flmr_base_serve_hier.json (preset fast), 64
     requests from 4 threads, every answer checked against the same
     search run by the plain versions on a CPU copy of the index, on the
     query embeddings each dispatch searched; K3 and
     K4 launches at least the dispatches; recall@10 against exact search
     printed (not gated: the weights are random).
  8. K5 and K6 against their plain versions: K5 at B=32, N=16,384, Lq=32
     with Ld 128 and 64, and Lq=64 with Ld 220 (TOP/s beside each); K6
     (on the tensor cores) at the 1M fine-stage shape (B=32, Lq=32,
     C=256, Ld=64, dim 128) with a flat codec of 1,024 centroids and a
     factored one of 64 x 128, nbits 2 and 4, and at the residual serve's
     shape (Lq=64, Ld=220, C=256, factored, nbits 2): max |err|, tie-aware
     top-10 and both times; K6's launch alone ("kernel_ms") and its device
     time ("device_ms").
  9. the 1M legs: 1,000,448 docs x 64 tokens x 128 dims, clustered over
     8,192 topics and cluster-ordered (scripts/synth1m.py's recipe), made
     on the card; S=4 summaries, block size 64; B=32, Lq=32 queries from
     docs 0-31 plus 0.1 noise, k=10, preset fast. Legs: exact K1 on the
     bf16 index (the oracle); the int8 index exact (K5) and hierarchical
     (K3, K4); the residual index (nbits 2, factored 64 x 128 codec)
     hierarchical (K3, K4, K6). Each: recall@10 against exact K1,
     self-top-1, ms per batch, bytes on the card; the exact K1 and K5
     legs beside their bounds (K1's counts the bf16 operations of both
     parts of the float32 query). Gates: recall >= 0.95 on both int8
     legs, self-top-1 >= 0.95 on every leg, every kernel of a leg
     launches, the exact leg's K1 on the MMA route.
 10. the compressed serve slice: phase 7's index copied into an int8 index
     served in exact mode (K5) and a residual one (factored 64 x 128,
     nbits 2) served hierarchical fast (K3, K4, K6), each behind
     RetrievalServer; 64 requests from 4 threads, every answer checked
     against the same search run by the plain versions on a CPU copy of
     the compressed index, on the query embeddings each dispatch searched
     (as in 7); each kernel launches at least once per dispatch;
     then the search alone, ms per batch of 32.
 11. X1, X2, X3 against their plain versions at the stage-2 experiment's
     shape (B=32, Lq=32, Ld=64, dim 128) at C = 1,024, 256 and 200 (a
     multiple of neither the TPU tiles' 32 nor 128), ~30 % of the tokens
     masked and one candidate of every query with none: max |err| and
     tie-aware top-10 at 1e-3; X2 batched, X3 the same kernel once per
     query (B launches of B = 1); both times (median of 10, CUDA events),
     X1's and X2's launches alone, and X1's, X2's and X3's device times
     from the profiler (X3's also per launch). X1's bound counts the bytes
     of the mask and of the scored rows only (a masked row's ids, centroid
     scores and scale do not change its -9999) and the bf16 operations of
     its three products (the weights and the query as two bf16 parts
     each); the CUDA cores' float32 bound beside it.
 12. the residual stage-2 experiment: ravqa_tpu_torch.scripts.
     exp_residual_stage2.run() with every round at the script's full
     widths (N = 200,064, then 1,000,448 docs of records made on the card,
     about 2.3 GB), every variant's ms per batch and rel-err line printed.
     Gates: each kernel route against its plain twin on the same inputs to
     1e-3; the launches of X1 (fused_lut_maxsim), X2 and X3
     (candidate_maxsim batched and once per query, B a batch) equal what
     the run called; no round raises.
 13. the training step on the card against the CPU: ravqa_tpu_torch.entry.
     entry()'s loss and backward at its BERT-base shape on both from one
     state dict (loss and grad norm to rtol 1e-4, each parameter's grad
     within 1e-4 of max(its scale, 1e-3 of the model's largest grad));
     then one FLMRExecutor.train_step on each on a batch of 2 from
     configs/synthetic_flmr_base_train.json (loss and grad norm to rtol
     1e-4, each grad as above; the update, on the coordinates whose grad is
     well above rounding, within 2 ulp of the parameter plus 1e-3 lr: a
     first Adam update moves every coordinate by about lr whatever its
     grad's size), and a second step on the same batch (its loss to rtol
     1e-4).
     Nothing of the card's run may sit on the CPU.
 14. the training slice: `main --mode train` in-process on
     configs/synthetic_flmr_base_train.json (configs/okvqa/flmr_base.json's
     widths: BERT-base, B=30, nway 5 with in-batch negatives, lr 1e-5 and
     1e-4 for the mapping network; 24 steps, a validation at 12 and 24 over
     16,384 passages indexed on the card), then `--mode eval` from the
     checkpoint it wrote, in exact mode and with
     model_config.search_mode=hierarchical. Gates: every loss finite; K1 on
     the float32 index's split route in every exact evaluation and K2/K3
     in the hierarchical one (each count set to 0 just before the run and
     read just after); the exact eval's ranking equals a plain search of
     the same index on the same query embeddings (16 queries on a CPU
     copy, all on the card's plain version; tie-aware top-10, 1e-3); the
     hierarchical eval's stage-0 sweep (K2 at B=192, Lq=64) against its
     plain version for every query and its answers against the plain
     versions' search of a CPU copy for 16 (both tie-aware top-10, 1e-3);
     the eval from the checkpoint reproduces the final validation's recall@K
     and precision@K; params.msgpack decodes with the port's reader.
     Prints the step's ms (median of steps 3-24) and steps/s, padded
     query+doc positions/s and attended (attention-mask) tokens/s, peak
     max_memory_allocated and the evaluations' seconds (corpus encode,
     search), each beside the card's name and power limit.
 15. the PreFLMR serve slices: build_server on
     configs/synthetic_preflmr_vitl_serve.json (exact) and
     configs/synthetic_preflmr_vitl_serve_hier.json (hierarchical fast):
     PreFLMR_ViT-L's query tower at its published widths (CLIP ViT-L/14,
     24 x 1024, in the graph; the separate BERT-base question encoder; the
     mapping MLP; the 1-layer 768-wide transformer mapping over the 256
     patches), random weights from the seed, 16,384 passages encoded on
     the card; a query of 32 + 32 + 256 = 320 tokens. Each: three bursts of
     128 requests, then 64 requests from 4 threads, each request with its
     own seeded 224 x 224 x 3 image; every answer against the plain
     versions' search on the query embeddings its dispatch searched (the
     hierarchical one on a CPU copy of the index; the exact one on the
     card's plain version for all 64, which 2 queries on a CPU copy
     check); K1-f32 (exact) or K3 and K4 (hierarchical) launched at least
     once per dispatch (counts set to 0 just before, read just after);
     the towers on the card against the CPU for 2 requests and 4
     passages (max abs 1e-4); K1-f32 at B=32, Lq=320 against its plain
     version (random inputs, an all-masked doc at exactly -9999 x 320),
     K3 and K4 on the hierarchical serve's own summaries and 32 of its
     queries (tie-aware top-10, 1e-3), each timed beside its bound;
     p50/p95, the bursts' req/s, the ViT's, the whole tower's, the
     search's and K1's ms per batch of 32 and peak memory beside the
     card's name and power limit.
 16. the RAVQA-v2 answer serve: build_server on
     configs/synthetic_rag_blip2_serve.json (a VQAServer: FLMR-base live
     retrieval through K1-f32 over 16,384 passages, then BLIP-2 with EVA
     ViT-g/14, the 12-layer Q-Former and Flan-T5-XL at their published
     widths, LoRA rank 8 merged, 5 passages, 5 beams, 512 + 32 encoder
     tokens, 10 decoded tokens; random weights drawn on the card), 16
     requests from 4 closed-loop clients, then 3 bursts of 8, each request
     with seeded 768-d features and its own seeded 224 x 224 image. Gates:
     every request answered with 5 finite doc_scores and 5 passages;
     K1-f32 launched once per dispatch on the split route (counts set to
     0 just before, read just after); each dispatch's retrieved rows
     against a plain search of its recorded query embeddings on a CPU copy
     of the index (tie-aware top-5, 1e-3), and generate's doc_scores (the
     re-encoded query, paired MaxSim) against the searcher's scores of
     those rows (1e-3); one (question, passage) sequence through the
     generator: every layer of the full-depth model on the card against
     its CPU copy on the card's own inputs (the encode and the first decode
     step; 1e-4 of each output's largest magnitude), and a copy with the
     same widths and the T5 stacks cut to their first 2 layers (the
     random T5 encoder amplifies float32 rounding ~1.6x a layer, so the
     whole model's two float32 runs differ by ~1e-3, printed) on the card
     and the CPU: its encoder output and first decode step's logits within
     1e-4 of the largest magnitude, its beam search's tokens identical;
     one dispatch decoded with cached cross-attention
     keys and values against keys and values projected at every step
     (the same tokens, log-probs within 1e-4); no non-finite value.
     Prints the dispatch split (device ms by stage, CUDA events), K1-f32
     at B=8, questions/s over the bursts, p50/p95 latency, peak memory
     and the phase's seconds beside the card's name and power limit.
 17. RAVQA-v2 joint training and answer evaluation: build_rag_executor on
     configs/synthetic_rag_blip2_train.json (the published recipe of
     configs/okvqa/rag_blip2_with_flmr.json: phase 16's BLIP-2 Flan-T5-XL
     with T5 remat, LoRA rank 8 on 144 adapters, 4,718,592 parameters, the
     3.94e9 base frozen; Approach6 with loss weights nll 1 / rag 0 /
     additional 0; freeze_question_encoder and force_existence; batch 8 x
     accumulation 4, lr 6e-4, retriever_lr 1e-4, weight decay 0.05, linear;
     FLMR-base live retrieval through K1-f32 over 16,384 passages).
     (a) two optimizer steps (8 micro-batches of 8 questions) through fit:
     every loss finite; K1-f32 launched exactly once per micro-batch, on the
     split route (counts set to 0 just before, read just after); every
     retrieved row against the plain search of the same query embeddings
     (all on the card's plain version, 8 on a CPU copy; tie-aware top-5,
     1e-3); every LoRA B nonzero after the first update; optimizer state
     for the trainable set only; the generator base bit-identical after
     (a), (b) and (d) (against a host copy). (b) one micro-batch with rag
     and additional weights 1: the loss and its parts finite, the query
     tower's trainable modules (linear, mapping network, its BERT) with
     finite, nonzero grads. (d) one fixed micro-batch, 3 optimizer steps on
     it (accumulation 1): its loss falls. (e) run_rag_eval over the 16 test
     questions through generate: the metrics JSON written, K1-f32 once a
     dispatch, the predictions equal to generate's called directly. (c) a
     copy with the T5 stacks cut to 4 + 4 layers (ViT-g, Q-Former and every
     width whole), rag and additional weights 1, on the card, on the CPU
     and on the CPU with the generator in float64, from the same weights,
     a micro-batch of 2 questions (10 sequences), one train_step each: the
     loss and its parts, card vs CPU (rtol 1e-4); the AdamW update (phase
     13's rule); the retriever's backward for one upstream gradient, card
     vs CPU (phase 13's 1e-4); the worst LoRA grad, the worst retriever
     grad and the grad norm no farther from float64 than 2x the CPU's
     float32 plus 1e-4 (the random T5's conditioning, as in phase 16); the
     second step's loss on the
     card's updated parameters, card vs CPU (rtol 1e-4; the runs' losses
     after their own updates printed); remat on and off on the card (loss
     rtol 1e-5, grads 1e-5 of the largest). (f) that copy's checkpoint
     saved and loaded into a fresh executor (random weights until then):
     identical answers, step and optimizer count (the full model's file
     would be 15.8 GB of the same format); refresh_index with the trained
     retriever, then one search on the new index through K1-f32 against
     the plain search. Prints each micro-batch's split by stage (CUDA
     events, profile_train.RagStageTimer) and the optimizer updates' ms,
     questions/s trained, peak memory, the evaluation's, the checkpoint's
     and the refresh's seconds and the phase's, beside the card's name and
     power limit.
 18. WIT mapping-network pretraining: a synthetic WIT dump in the real
     formats (ravqa_tpu_torch.scripts.synthetic_wit: 15,360 train and
     1,024 test rows, one passage each, 768-d features by image_url)
     written into a .chip_smoke_wit_* directory, then `main --mode train`
     (32 steps of 8, one validation) and `--mode test` from its
     checkpoint, in-process, on configs/synthetic_flmr_wit_pretrain.json
     (configs/wit/flmr_wit_pretraining.json at its widths: BERT-base
     frozen, vision-only queries of the mapping network's 32 tokens,
     16,384 passages). Gates: every loss finite; only vision_projection
     moves (the checkpoint against the seed's weights; Adam's state for it
     alone); the test run reads the wit node from the node cache
     (LoadWITData runs once); K1-f32 on the split route in each
     evaluation (counts set to 0 just before each run, read just after);
     the evaluation's ranking against a plain search (16 queries on a CPU
     copy of the index without the token columns no passage keeps, all on
     the card's plain version; tie-aware top-10, 1e-3); the test metrics
     equal the final validation's; the vision-only query tower card vs
     CPU (1e-4). Then DPR at BERT-base on the corpus' captions and
     passages: 8 train steps on the card, evaluate_retrieval on the card
     and on a CPU copy over 48 captions and 96 passages (ids equal but for
     ties). Prints the step ms, peak memory, the encode and search
     seconds, K1 at Lq = 32 (at the eval's B and against its plain version
     at B=64, beside its bound) and pos_item_ids_recall@K.
 19. PreFLMR multi-task training and evaluation: the model of
     configs/synthetic_preflmr_vitl_serve.json with freeze_image_encoder
     (ViT-L/14 frozen; the BERT-base towers and both mappings train) over
     three M2KR tasks (okvqa, wit, infoseek: SyntheticOKVQA worlds of
     4,096 passages, 256 train and 64 test questions with 224 x 224
     images, each with its instruction), one train_step card vs CPU (phase
     13's tolerances), then train_m2kr for 24 steps of 8 at temperature 4
     with evaluate_m2kr at 12 and 24. Gates: per-task losses finite; the
     sampled task names equal numpy default_rng(seed)'s draws; the ViT
     bit-identical without grads; each task evaluation's ranking against a
     plain search (as in 18); K1-f32 once per task evaluation (6; counts
     set to 0 just before, read just after); each task's metric keys.
     Prints the step ms, questions/s trained, peak memory, each
     evaluation's seconds and K1 at Lq = 320, N = 4,096 beside its bound.
 20. FLMR with ROIs from raw images (roi_slice): a synthetic OK-VQA world
     (128 images of 480 x 640, 256 + 64 questions, 16,384 GoogleSearch
     passages across the 112724 boundary, OCR JSONs); the VinVL detector
     at vinvl_x152c4 width and depth (ResNeXt-152 C4, batch 8 on a 1,024^2
     canvas, weights through convert_vinvl_params from a synthetic
     maskrcnn state dict) writes predictions.tsv; the Oscar-base
     captioner writes the caption JSON; then `main --mode train` on
     configs/synthetic_flmr_roi_train.json (OCR on the objects, ROI crops,
     the CLIP ViT-B/32 over every image and ROI, 24 steps of B = 30, a
     validation) and `--mode test`. Gates: the detector card vs CPU on one
     image (feature map, RPN outputs, box logits on fixed proposals: 1e-4
     of their scale; the selection redone on the CPU from the card's
     tensors equal; proposals and detections exact but for near-ties);
     the detector's numbers with the caller's TF32 flags on; the
     captioner's logits (1e-4) and greedy tokens card vs CPU; the ViT-B/32
     crop features card vs CPU (1e-4); every loss finite; K1-f32 once in
     each evaluation at Lq = 352; the ranking vs a plain search; the test
     metrics equal the validation's; K1-f32 vs its plain version at
     Lq = 352; one ROI train_step card vs CPU (phase 13's tolerances).
     Prints the detector's ms a batch, images/s and peak, the caption
     seconds, the ViT's crops/s, the step ms and peak, the evaluations'
     seconds (corpus encode, K1) and K1 at Lq = 352 beside its bound.
Every phase prints its seconds. The line before the last is the kernels'
JSON record: each kernel's launches on its path, its error against its
plain version, its time and its plain version's, and its bound, the least
time the card could take for the same work (the larger of the bytes it
must move over 3.35 TB/s and its operations over the data sheet's peak for
their type), at the shape its "ms" was taken; library_ms is null, since
no single PyTorch call computes any of these functions. The last line is
{"ok": true, "device": {...}}.
"""

import base64
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "configs", "synthetic_flmr_base_serve.json")
HIER_CONFIG = os.path.join(HERE, "configs",
                           "synthetic_flmr_base_serve_hier.json")
TRAIN_CONFIG = os.path.join(HERE, "configs",
                            "synthetic_flmr_base_train.json")
PREFLMR_CONFIG = os.path.join(HERE, "configs",
                              "synthetic_preflmr_vitl_serve.json")
PREFLMR_HIER_CONFIG = os.path.join(HERE, "configs",
                                   "synthetic_preflmr_vitl_serve_hier.json")
RAG_CONFIG = os.path.join(HERE, "configs", "synthetic_rag_blip2_serve.json")
RAG_TRAIN_CONFIG = os.path.join(HERE, "configs",
                                "synthetic_rag_blip2_train.json")
WIT_CONFIG = os.path.join(HERE, "configs", "synthetic_flmr_wit_pretrain.json")
# float32 scores of L2-normalized embeddings at Lq <= 64: the kernel and
# the plain version sum the same products in different orders, which moves
# a score by ~1e-5; 1e-3 leaves room without hiding a wrong max or mask
ATOL = 1e-3
TOWER_ATOL = 1e-4
# summary sweeps: the kernel and the plain version sum the same float32
# products (bf16 and int8 values are exact in float32) in another order;
# scores are sums of 32 maxima of unit-vector products, so the order moves
# them by ~1e-5, and 1e-3 leaves room without hiding a wrong max or slot
SWEEP_ATOL = 1e-3
K = 10


_PHASE_START = [time.perf_counter()]


def phase(name):
    now = time.perf_counter()
    print(f"(phase took {now - _PHASE_START[0]:.1f} s)\n== {name}",
          flush=True)
    _PHASE_START[0] = now


def check_topk(got_full, want_full, k=K, atol=ATOL):
    """Scores agree and the top-k agrees tie-aware: the rows the kernel
    picks carry, under the plain version, the scores the kernel gives."""
    import torch
    err = (got_full - want_full).abs().max().item()
    gv, gi = torch.topk(got_full, k, dim=1)
    wv, _ = torch.topk(want_full, k, dim=1)
    topk_err = max((gv - wv).abs().max().item(),
                   (want_full.gather(1, gi) - gv).abs().max().item())
    if not (err <= atol and topk_err <= atol):
        raise AssertionError(f"kernel disagrees with the plain version: "
                             f"max |score diff| {err}, top-{k} {topk_err}")
    return err


def time_ms(fn, iters=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# NVIDIA H100 SXM data sheet, dense: device memory rate and peak operation
# rates by the type the operations take (float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def bound(nbytes, ops, kind):
    """The least time the card could take for a kernel's work: bytes it
    must move (each input read once, each output written once) over the
    memory rate, or its operations over the peak rate of their type,
    whichever is larger. Returns {"bound_ms", "bound_by", "bytes", "ops"}."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "ops_type": kind}


def record_kernel(out, kernel, shape, err, fn, plain_fn, bnd, ops=None):
    """Time a kernel's wrapper and its plain version (median of 10, CUDA
    events) and keep them, its error and its bound in out[kernel]: under
    "shapes" for each shape, and the first shape's at the top. `ops`, the
    function's operations, adds the rate reached (tera_ops_per_s)."""
    ms, plain_ms = time_ms(fn), time_ms(plain_fn)
    o = out[kernel]
    o["err"] = max(o["err"], err)
    o["shapes"][shape] = {"ms": ms, "plain_ms": plain_ms, **bnd}
    if ops is not None:
        o["shapes"][shape]["tera_ops_per_s"] = ops / ms / 1e9
    for key, v in (("ms", ms), ("plain_ms", plain_ms),
                   ("bound_ms", bnd["bound_ms"]),
                   ("bound_by", bnd["bound_by"])):
        o.setdefault(key, v)                       # the first shape's
    print(f"{kernel} {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)


def device_ms(fn, pattern, launches=1):
    """The device time per call of the kernels whose lowercased name holds
    `pattern`, `launches` of them a call, from torch.profiler's trace of 10
    calls: the kernel's own time, where CUDA events around a small launch
    also count the host's enqueue. It is the mean of the launches the trace
    holds times `launches`: a trace late in a long run has been seen to
    keep 1 of a kernel's 10 launches (the run prints how many it kept)."""
    from ravqa_tpu_torch.profile_serve import kernel_events
    hit = [v for k, v in kernel_events(fn, n=10).items()
           if pattern in k.lower()]
    if not hit:
        raise AssertionError(f"the profiler saw no kernel like {pattern!r}")
    ms, events = (sum(x) for x in zip(*hit))
    if events != 10 * launches:
        print(f"  (the trace kept {events} of the {10 * launches} launches "
              f"like {pattern!r})", flush=True)
    return ms / events * launches


def maxsim_bound(maxsim, q, tok, mask):
    """K1's bound for q against tok: the bf16 operations of every product
    the route takes (a float32 query in two parts, a float32 index in two
    planes: hi.hi + lo.hi + hi.lo), with a note saying so; for a float32
    index also the CUDA cores' float32 bound of the same function
    ("f32_bound_ms"). Returns (bound dict, the function's FLOP)."""
    b, lq, dim = q.shape
    n, ld, _ = tok.shape
    flop = 2.0 * b * lq * n * ld * dim
    route = maxsim.maxsim_route(q.dtype, tok.dtype)
    products = maxsim.route_products(route)
    nbytes = _nbytes(q, tok, mask) + 4 * b * n
    bnd = bound(nbytes, flop * products, "bf16")
    if products > 1:
        bnd["bound_note"] = (f"bf16 operations of the {products} products "
                             f"of {route.parts} query parts and "
                             f"{route.planes} index planes")
    if route.planes > 1:
        bnd["f32_bound_ms"] = bound(nbytes, flop, "f32")["bound_ms"]
    return bnd, flop


def kernel_shape(out, key, shape, b, lq, n, ld, dim, q_dtype, t_dtype,
                 maxsim):
    """K1 against its plain version at one shape, kept in out[key] by
    record_kernel; an all-masked doc must score exactly -9999 * Lq."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)

    def normed(*shape, dtype):
        x = torch.randn(*shape, generator=g, device="cuda")
        return (x / x.norm(dim=-1, keepdim=True)).to(dtype)

    q = normed(b, lq, dim, dtype=q_dtype)
    q[:, -2:] = 0                                  # zero query rows
    tok = normed(n, ld, dim, dtype=t_dtype)
    mask = (torch.rand(n, ld, generator=g, device="cuda") > 0.3).to(
        torch.int8)
    mask[::997] = 0                                # docs with no tokens
    route = maxsim.maxsim_route(q_dtype, t_dtype)
    # a float32 index's planes, made once as the searcher keeps them
    planes = (maxsim.split_index_bf16(tok, route.planes)
              if route.planes > 1 else None)
    split0 = maxsim.maxsim_search.split_launches
    got = maxsim.maxsim_search(q, tok, mask, planes=planes)
    want = maxsim.maxsim_search_torch(q, tok, mask)
    torch.cuda.synchronize()
    if (maxsim.maxsim_search.split_launches - split0) != (route.planes > 1):
        raise AssertionError(f"{key}: K1 did not take the route {route}")
    empty = got[:, ::997]
    if not torch.equal(empty, torch.full_like(empty, -9999.0 * lq)):
        raise AssertionError("an all-masked doc must score -9999 * Lq")
    err = check_topk(got, want)
    print(f"{key} {shape}: route {tuple(route)}, max|err| {err:.3g}",
          flush=True)
    bnd, flop = maxsim_bound(maxsim, q, tok, mask)
    record_kernel(out, key, shape, err,
                  lambda: maxsim.maxsim_search(q, tok, mask, planes=planes),
                  lambda: maxsim.maxsim_search_torch(q, tok, mask), bnd,
                  ops=flop)
    print(f"  {out[key]['shapes'][shape]['tera_ops_per_s']:.1f} TFLOP/s"
          + (f"; the CUDA cores' float32 bound {bnd['f32_bound_ms']:.3f} ms"
             if "f32_bound_ms" in bnd else ""), flush=True)


def check_towers(ex, data, reqs, images=None):
    """The executor's towers on its device against the same module run by
    PyTorch on the CPU (the path the CPU tests hold to the JAX package), on
    at most 4 queries and 4 passages at full width; the queries take the
    requests' image features, or `images` (pixels, one per request) for an
    in-graph ViT. Returns max |error|."""
    import copy
    import torch
    cpu = copy.deepcopy(ex.model).cpu()
    reqs = reqs[:4]
    ids, mask = data["query_tokenizer"].tensorize(
        [r["question"] for r in reqs])
    vis = ({"image_features": np.stack([r["image_features"] for r in reqs])}
           if images is None else {"pixel_values": np.stack(images[:4])})
    di, dm = data["doc_tokenizer"].tensorize(
        data["passages"]["full_passages"].contents[:4])
    with torch.inference_mode():
        q_dev = ex.encode_query(ids, mask, **vis).cpu()
        d_dev, _ = ex.encode_doc(di, dm)
        t0 = time.perf_counter()
        q_cpu = cpu.query(torch.from_numpy(ids).long(),
                          torch.from_numpy(mask),
                          **{k: torch.from_numpy(v) for k, v in vis.items()})
        d_cpu, _ = cpu.doc(torch.from_numpy(di).long(), torch.from_numpy(dm))
    del cpu
    err = max((q_dev - q_cpu).abs().max().item(),
              (d_dev.cpu() - d_cpu).abs().max().item())
    print(f"towers on {ex.device} vs CPU ({len(reqs)} queries "
          f"{tuple(q_dev.shape)}, 4 passages; the CPU's run "
          f"{time.perf_counter() - t0:.1f} s): max|err| {err:.3g}",
          flush=True)
    # unit-norm rows in float32 on both sides (TF32 off): differences are
    # summation order through the layers (BERT's 12, ViT-L's 24), ~1e-6
    if not err <= TOWER_ATOL:
        raise AssertionError(f"towers disagree with their CPU run: {err}")
    return err


def _features(i, item):
    """A request's image as the FLMR serve slices send it: its features."""
    return {"image_features": item["image_features"]}


def drive_requests(server, data, index, wrappers, n=64, clients=4,
                   vision=_features):
    """Send n requests from `clients` closed-loop threads and stop the
    server; request i carries vision(i, its item) (submit's keyword
    arguments for its image). Every wrapper's launch count is set to 0
    just before and read just after. Returns (requests, scores (n, K),
    pids (n, K), launches per wrapper, dispatches)."""
    items = data["train"].items + data["test"].items
    reqs = [items[i % len(items)] for i in range(n)]
    lat = [0.0] * n
    results = [None] * n

    def client(ids):
        for i in ids:
            t = time.perf_counter()
            results[i] = server.submit(reqs[i]["question"],
                                       **vision(i, reqs[i])).result(300)
            lat[i] = time.perf_counter() - t

    try:
        for w in wrappers:
            w.launches = 0
        d0 = server.dispatches
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client,
                                    args=(range(c, n, clients),))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        launches = [w.launches for w in wrappers]
        dispatches = server.dispatches - d0
    finally:
        server.stop()
    if any(t.is_alive() for t in threads) or None in results:
        raise AssertionError("not every request was answered")
    print(f"{n} requests in {dispatches} dispatches: "
          f"{n / wall:.1f} req/s, latency p50 "
          f"{np.percentile(lat, 50) * 1e3:.1f} ms, p95 "
          f"{np.percentile(lat, 95) * 1e3:.1f} ms; kernel launches "
          f"{dict(zip((w.__name__ for w in wrappers), launches))}",
          flush=True)
    pids = np.stack([r.pids for r in results])
    scores = np.stack([r.scores for r in results])
    if pids.shape != (n, K) or not np.isfinite(scores).all() \
            or not ((pids >= 0) & (pids < index.num_docs)).all():
        raise AssertionError("served results are not k valid pids with "
                             "finite scores")
    return reqs, scores, pids, launches, dispatches


def encode_requests(server, data, reqs):
    """The executor's query embeddings of `reqs`, on its device."""
    import torch
    ids, mask = data["query_tokenizer"].tensorize(
        [r["question"] for r in reqs])
    feats = np.stack([r["image_features"] for r in reqs])
    with torch.inference_mode():
        return server.ex.encode_query(ids, mask, feats)


def start_server(config_path, device):
    """build_server from a config, as the entry point does. Returns (data,
    server, index)."""
    from ravqa_tpu_torch.main import build_pipeline, build_server, load_config
    cfg = load_config(config_path)
    t0 = time.perf_counter()
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    server = build_server(cfg, data, device)
    index = server.searcher.index
    index.tokens.sum().item()                      # wait for the encode
    print(f"setup (pipeline + corpus encode + index) "
          f"{time.perf_counter() - t0:.1f} s; index {index.num_docs} docs, "
          f"{index.tokens.numel() * index.tokens.element_size()} bytes "
          f"{index.tokens.dtype}; search mode {server.searcher.mode}",
          flush=True)
    return data, server, index


def serve_slice(config_path, device, maxsim):
    """Build the RetrievalServer from a config, answer 64 requests from 4
    threads, check every answer against a plain search of the same index.
    Returns (kernel launches, dispatches, max |score error|)."""
    import torch
    data, server, index = start_server(config_path, device)
    planes = index.token_planes()          # made by the warm-up's search
    print(f"index planes (bf16 hi | lo, made by the searcher's first "
          f"search): {_nbytes(planes)} bytes, {tuple(planes.shape)}",
          flush=True)
    maxsim.maxsim_search.split_launches = 0
    reqs, scores, pids, launches, dispatches = drive_requests(
        server, data, index, [maxsim.maxsim_search])
    launches = launches[0]
    if maxsim.maxsim_search.split_launches != launches:
        raise AssertionError(f"{maxsim.maxsim_search.split_launches} of "
                             f"{launches} K1 launches took the float32 "
                             f"index's split route")
    q = encode_requests(server, data, reqs)
    with torch.inference_mode():
        want = maxsim.maxsim_search_torch(q, index.tokens, index.mask)
        got = torch.from_numpy(scores).to(want.device)
        rows = torch.from_numpy(pids).to(want.device)  # pids are index rows
        wv, _ = torch.topk(want, K, dim=1)
        err = max((got - wv).abs().max().item(),
                  (want.gather(1, rows) - got).abs().max().item())
    print(f"served scores vs plain search of the same index: max|err| "
          f"{err:.3g}", flush=True)
    if err > ATOL:
        raise AssertionError(f"served results disagree with the plain "
                             f"search: {err}")
    check_towers(server.ex, data, reqs)
    return launches, dispatches, err


def _normed(g, *shape, dtype):
    import torch
    x = torch.randn(*shape, generator=g, device="cuda")
    return (x / x.norm(dim=-1, keepdim=True)).to(dtype)


def _compare(name, got, want, atol=SWEEP_ATOL):
    """check_topk plus the report line; returns max |error|."""
    err = check_topk(got, want, atol=atol)
    print(f"  {name}: max|err| {err:.3g}", flush=True)
    return err


def sweep_kernels(maxsim):
    """K2, K3 and K4 against their plain versions at the bench.py shapes
    and at the hierarchical serve's (Lq = 64), K2 there also on float32
    summaries (its CUDA-core body). Each also times the kernel alone
    ("kernel_ms", launch_coarse_bf16 / launch_coarse_int8 / launch_stage1
    on the inputs the wrapper prepares) and its device time from the
    profiler ("device_ms"); K2 fails unless the wrapper's trace holds the
    tensor-core body on bf16 summaries. Returns {kernel: {"err", "ms",
    "plain_ms", "shapes": {...}}}."""
    import torch
    from ravqa_tpu_torch.ops.quant import (quantize_queries_int8,
                                           quantize_summaries_int8,
                                           quantize_summaries_t_int8)
    g = torch.Generator(device="cuda").manual_seed(1)
    g32 = torch.Generator(device="cuda").manual_seed(2)
    b, dim, bs = 32, 128, 64
    queries = {}
    for lq in (32, 64):
        queries[lq] = _normed(g, b, lq, dim, dtype=torch.float32)
        queries[lq][:, -2:] = 0                    # zero query rows
    out = {k: {"err": 0.0, "shapes": {}} for k in ("K2", "K3", "K4")}

    # the tensor-core sweep's instances, by their Op's name
    ops_name = {"K2": "coarsebf16op", "K3": "coarseint8op",
                "K4": "stage1op"}

    def record(kernel, shape, err, fn, plain_fn, bnd, kernel_fn=None):
        record_kernel(out, kernel, shape, err, fn, plain_fn, bnd)
        if kernel_fn is not None:
            o = out[kernel]["shapes"][shape]
            o["kernel_ms"] = time_ms(kernel_fn)
            o["device_ms"] = device_ms(kernel_fn, ops_name[kernel])
            print(f"  {kernel} {shape}: the launch alone "
                  f"{o['kernel_ms']:.4f} ms, the kernel's device time "
                  f"{o['device_ms']:.4f} ms", flush=True)

    summ_docs = None
    # two-stage coarse pass: 112,640 docs x 8 summaries; hierarchical
    # stage 0: 1,760 blocks x 4 summaries, zero-padded to 2,048; the
    # hierarchical serve's stage 0: 256 blocks padded to 1,024, Lq = 64
    # (32 text + 32 mapping tokens), which the serve sweeps with K3 and
    # the reference preset's hierarchical eval (phase 14) with K2
    for shape, s_, n, n_valid, lq in (
            ("docs S=8 N=112640", 8, 112640, None, 32),
            ("blocks S=4 N=2048", 4, 2048, 1760, 32),
            ("serve blocks Lq=64 S=4 N=1024", 4, 1024, 256, 64)):
        q = queries[lq]
        summ_t = _normed(g, s_, n, dim, dtype=torch.bfloat16)
        valid = torch.ones(n, dtype=torch.int8, device="cuda")
        if n_valid is None:
            valid[::997] = 0                       # docs with no tokens
            summ_docs = summ_t.transpose(0, 1).contiguous()
        else:
            valid[n_valid:] = 0
            summ_t[:, n_valid:] = 0
        invalid = valid == 0
        ops = 2.0 * b * lq * s_ * n * dim
        got = maxsim.coarse_sweep(q, summ_t, valid)
        want = maxsim.coarse_sweep_torch(q, summ_t, valid)
        torch.cuda.synchronize()
        if not bool((got[:, invalid] == -9999.0).all()):
            raise AssertionError("K2: an invalid doc must score -9999")
        err = _compare(f"K2 bf16 {shape}", got, want)
        qc = q.bfloat16()
        record("K2", shape, err,
               lambda: maxsim.coarse_sweep(q, summ_t, valid),
               lambda: maxsim.coarse_sweep_torch(q, summ_t, valid),
               bound(_nbytes(q, summ_t, valid, got), ops, "bf16"),
               lambda: maxsim.launch_coarse_bf16(qc, summ_t, valid))
        # the wrapper's own trace: bf16 summaries on the tensor cores
        wrapper_dev = device_ms(
            lambda: maxsim.coarse_sweep(q, summ_t, valid),
            ops_name["K2"])
        out["K2"]["shapes"][shape]["wrapper_device_ms"] = wrapper_dev
        print(f"  K2 {shape}: the wrapper ran summary_kernel"
              f"<CoarseBf16Op>, {wrapper_dev:.4f} ms on the device",
              flush=True)
        if lq == 64:
            # K2's float32 body (CUDA cores), on float32 summaries
            summ_f = _normed(g32, s_, n, dim, dtype=torch.float32)
            summ_f[:, ~valid.bool()] = 0
            got = maxsim.coarse_sweep(q, summ_f, valid)
            want = maxsim.coarse_sweep_torch(q, summ_f, valid)
            torch.cuda.synchronize()
            if not bool((got[:, invalid] == -9999.0).all()):
                raise AssertionError("K2 f32: an invalid doc must score "
                                     "-9999")
            err = _compare(f"K2 f32 {shape}", got, want)
            record("K2", f"f32 {shape}", err,
                   lambda: maxsim.coarse_sweep(q, summ_f, valid),
                   lambda: maxsim.coarse_sweep_torch(q, summ_f, valid),
                   bound(_nbytes(q, summ_f, valid, got), ops, "f32"))

        st8, dsc = quantize_summaries_t_int8(summ_t)
        q8, qs = quantize_queries_int8(q)
        ones_q, ones_d = torch.ones_like(qs), torch.ones_like(dsc)
        raw = maxsim.coarse_sweep_int8(q8, ones_q, st8, ones_d, valid)
        raw_want = maxsim.coarse_sweep_int8_torch(q8, ones_q, st8, ones_d,
                                                  valid)
        torch.cuda.synchronize()
        if not torch.equal(raw, raw_want):
            raise AssertionError(
                f"K3: pre-scale sums of int32 maxima differ from the plain "
                f"version: max {(raw - raw_want).abs().max().item()}")
        print(f"  K3 int8 {shape}: pre-scale sums equal exactly (max "
              f"|sum| {raw_want[:, ~invalid].abs().max().item():.0f})",
              flush=True)
        got = maxsim.coarse_sweep(q, st8, valid, dscale=dsc)
        want = maxsim.coarse_sweep_torch(q, st8, valid, dscale=dsc)
        torch.cuda.synchronize()
        if not bool((got[:, invalid] == -9999.0).all()):
            raise AssertionError("K3: an invalid doc must score -9999")
        err = _compare(f"K3 int8 {shape}", got, want)
        record("K3", shape, err,
               lambda: maxsim.coarse_sweep(q, st8, valid, dscale=dsc),
               lambda: maxsim.coarse_sweep_torch(q, st8, valid, dscale=dsc),
               bound(_nbytes(q, st8, dsc, valid, got), ops, "int8"),
               lambda: maxsim.launch_coarse_int8(q8, qs, st8, dsc, valid))

    # hierarchical stage 1 over the docs' summaries: 1,760 blocks of 64,
    # and the serve's 256 blocks of 64 docs x 8 summaries at Lq = 64
    rows = maxsim.stage1_rows(summ_docs, bs)
    si8, ssc = quantize_summaries_int8(summ_docs)
    rows8 = maxsim.stage1_rows(si8, bs)
    serve_docs = _normed(g, 256 * bs, 8, dim, dtype=torch.float32)
    serve_i8, serve_sc = quantize_summaries_int8(serve_docs)
    serve_rows8 = maxsim.stage1_rows(serve_i8, bs)
    cases = [(f"{label} rows n_blocks={nbl}", 32, nbl, r, dscale)
             for nbl in (32, 16)
             for label, r, dscale in (("int8", rows8, ssc),
                                      ("bf16", rows, None))]
    cases.append(("serve int8 rows Lq=64 n_blocks=32 of 256", 64, 32,
                  serve_rows8, serve_sc))
    for shape, lq, nbl, r, dscale in cases:
        q = queries[lq]
        nb = r.shape[0]
        blk = torch.rand(b, nb, generator=g, device="cuda").argsort(
            dim=1)[:, :nbl]
        got = maxsim.stage1_sweep(q, r, blk, dscale=dscale)
        want = maxsim.stage1_sweep_torch(q, r, blk, dscale=dscale)
        err = _compare(f"K4 {shape}", got, want)
        # the rows of the blocks some query selected, each read once;
        # int8 rows are products in bf16 (the TPU kernel's cast)
        used = torch.unique(blk).numel()
        nbytes = (_nbytes(q, blk, got) + used * r[0].numel()
                  * r.element_size()
                  + (0 if dscale is None else used * bs * 4))
        qc, blk32 = q.bfloat16(), blk.to(torch.int32).contiguous()
        record("K4", shape, err,
               lambda: maxsim.stage1_sweep(q, r, blk, dscale=dscale),
               lambda: maxsim.stage1_sweep_torch(q, r, blk, dscale=dscale),
               bound(nbytes, 2.0 * b * lq * nbl * r.shape[1] * bs * dim,
                     "bf16"),
               lambda: maxsim.launch_stage1(qc, r, blk32, dscale))
    return out


def bench_index(n=112640, ld=128, dim=128, n_topics=2048, b=32, lq=32):
    """bench.py's clustered synthetic index, made on the card: each doc's
    tokens are its topic vector plus 0.3 noise, normalized, bf16, docs
    sorted by topic (the cluster order hierarchical search wants); queries
    are a random doc's first Lq tokens plus 0.1 noise. Returns (tokens,
    mask, q)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    topics = _normed(g, n_topics, dim, dtype=torch.float32)
    assign = torch.randint(n_topics, (n,), generator=g,
                           device="cuda").sort().values
    tok = torch.empty((n, ld, dim), dtype=torch.bfloat16, device="cuda")
    for lo in range(0, n, 8192):
        a = assign[lo:lo + 8192]
        t = topics[a][:, None, :] + 0.3 * torch.randn(
            len(a), ld, dim, generator=g, device="cuda")
        tok[lo:lo + 8192] = t / t.norm(dim=-1, keepdim=True)
    mask = torch.ones((n, ld), dtype=torch.int8, device="cuda")
    qidx = torch.randint(n, (b,), generator=g, device="cuda")
    qt = tok[qidx, :lq].float() + 0.1 * torch.randn(
        b, lq, dim, generator=g, device="cuda")
    return tok, mask, (qt / qt.norm(dim=-1, keepdim=True)).bfloat16()


def _recall(rows, exact_rows):
    rows, exact_rows = rows.cpu().tolist(), exact_rows.cpu().tolist()
    return float(np.mean([len(set(a) & set(e)) / len(e)
                          for a, e in zip(rows, exact_rows)]))


def pruned_search(maxsim):
    """Hierarchical and two-stage search at the bench scale (112,640 docs).
    Returns ({mode: {"recall", "ms"}}, {kernel: launches})."""
    import torch
    from ravqa_tpu_torch.retrieval import (LateInteractionSearcher,
                                           build_index_from_embeddings)
    t0 = time.perf_counter()
    tok, mask, q = bench_index()
    index = build_index_from_embeddings(tok, mask, pad_multiple=128,
                                        dtype=torch.bfloat16)
    del tok
    index.build_summaries(n_summary=8, iters=4)
    index.build_block_summaries(block_size=64)
    torch.cuda.synchronize()
    print(f"bench index {index.num_docs} docs x {index.doc_maxlen} tokens "
          f"bf16, summaries {tuple(index.summaries.shape)}, block summaries "
          f"{tuple(index.block_summaries.shape)}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    maxsim.maxsim_search.launches = 0
    exact = maxsim.maxsim_search(q, index.tokens, index.mask)
    exact_rows = torch.topk(exact, K, dim=1).indices
    torch.cuda.synchronize()
    oracle_launches = maxsim.maxsim_search.launches
    if oracle_launches == 0:
        raise AssertionError("the exact oracle did not launch K1")
    modes = [("hierarchical", "fast"), ("hierarchical", "reference"),
             ("two_stage", "fast"), ("two_stage", "reference")]
    searchers = {f"{m} {p}": LateInteractionSearcher(index, mode=m, preset=p)
                 for m, p in modes}
    wrappers = {"K2": maxsim.coarse_sweep, "K3": maxsim.coarse_sweep_int8,
                "K4": maxsim.stage1_sweep}
    rows, per_search = {}, {}
    for name, s in searchers.items():
        for w in wrappers.values():
            w.launches = 0
        rows[name] = s.search_device(q, K)[1]
        torch.cuda.synchronize()
        per_search[name] = {k: w.launches for k, w in wrappers.items()}
    launches = {k: sum(p[k] for p in per_search.values()) for k in wrappers}
    print(f"launches over the four searches: {launches}", flush=True)
    for k_, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k_} never launched on the pruned path")
    for name in ("hierarchical reference", "two_stage reference"):
        if per_search[name]["K2"] == 0:
            raise AssertionError(f"{name} search did not launch K2")
    out = {}
    for name, s in searchers.items():
        out[name] = {"recall": _recall(rows[name], exact_rows),
                     "ms": time_ms(lambda: s.search_device(q, K)),
                     "launches": per_search[name]}
        print(f"{name}: recall@10 vs exact {out[name]['recall']:.4f}, "
              f"{out[name]['ms']:.3f} ms per batch of 32 "
              f"(n_candidates {s.resolve_candidates(K)}"
              + (f", n_blocks {s.resolve_blocks(K)}"
                 if s.mode == "hierarchical" else "")
              + f"; launches {per_search[name]})", flush=True)
    bnd, _ = maxsim_bound(maxsim, q, index.tokens, index.mask)
    out["exact"] = {"recall": 1.0, "ms": time_ms(
        lambda: maxsim.maxsim_search(q, index.tokens, index.mask)),
        "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"]}
    print(f"exact (K1, bf16 index, {oracle_launches} launch): "
          f"{out['exact']['ms']:.3f} ms per batch, bound "
          f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']})", flush=True)
    launches["K1"] = oracle_launches
    if out["hierarchical fast"]["recall"] < 0.95:
        raise AssertionError("hierarchical fast search: recall@10 "
                             f"{out['hierarchical fast']['recall']} < 0.95")
    return out, launches


def _tie_aware(got_p, got_s, want_p, want_s, atol):
    """Scores agree; a pid that clears the k-th score by more than the
    tolerance on one side is in the other side's top-k."""
    if not np.allclose(got_s, want_s, rtol=0, atol=atol):
        return False
    return set(want_p[want_s > want_s[-1] + atol]) <= set(got_p) \
        and set(got_p[got_s > got_s[-1] + atol]) <= set(want_p)


def cpu_copy(index):
    """The index with every tensor moved to the CPU."""
    import torch
    return dataclasses.replace(index, **{
        f.name: getattr(index, f.name).cpu()
        for f in dataclasses.fields(index)
        if isinstance(getattr(index, f.name), torch.Tensor)})


def exact_cpu_copy(index):
    """A CPU copy of a float index for a plain exhaustive search, without
    the token columns past the last one any doc's mask keeps: a masked
    token never takes a max (an all-masked doc keeps its -9999 x Lq), so
    the answers are the same, and the CPU's work follows the longest
    passage, not doc_maxlen."""
    mask = index.mask.cpu()
    ld = int(mask.bool().any(dim=0).nonzero().max()) + 1
    return dataclasses.replace(
        cpu_copy(dataclasses.replace(index, tokens=None)),
        tokens=index.tokens[:, :ld].contiguous().cpu(),
        mask=mask[:, :ld].contiguous())


def record_searches(server):
    """Keep every dispatch's query embeddings and search result: wraps the
    server's searcher.search_device until check_served. Returns the list
    that (q, scores, rows) go into."""
    s = server.searcher
    search = s.search_device
    record = []

    def recording(q, k):
        scores, rows = search(q, k)
        record.append((q, scores, rows))
        return scores, rows

    s.search_device = recording
    return record


def check_served(server, index, record, scores, pids):
    """Every served answer is one of the dispatches' search results, and
    each of those agrees with the same search run by the plain versions on
    a CPU copy of the index, on the query embeddings the dispatch searched.
    (Encoding the requests again in other batches moves the embeddings by
    ~1e-6, which flips the int8 or bf16 rounding of some query values and
    moves a compressed index's scores by up to ~1e-3.) Returns (the
    dispatches' query embeddings on the card, their result rows, max |score
    error|)."""
    import torch
    from ravqa_tpu_torch.retrieval import LateInteractionSearcher
    s = server.searcher
    del s.search_device                          # drop record_searches' wrap
    q = torch.cat([r[0] for r in record])
    got_s = torch.cat([r[1] for r in record]).cpu().numpy()
    got_r = torch.cat([r[2] for r in record]).cpu().numpy()
    served = sorted((p.tolist(), v.tobytes()) for p, v in zip(pids, scores))
    searched = sorted((index.pids[r].tolist(), v.tobytes())
                      for r, v in zip(got_r, got_s))
    if served != searched:
        raise AssertionError("the served answers are not the dispatches' "
                             "search results")
    # a CUDA searcher takes the kernel route (use_pallas True), which the
    # CPU copy runs through the kernels' plain versions; an exact search of
    # a float index runs on exact_cpu_copy
    float_exact = s.mode == "exact" and index.scales is None \
        and index.tokens is not None and index.tokens.is_floating_point()
    cpu = LateInteractionSearcher(
        exact_cpu_copy(index) if float_exact else cpu_copy(index),
        use_pallas=s.use_pallas, mode=s.mode,
        preset=s.preset,
        n_candidates=s.n_candidates, n_blocks=s.n_blocks,
        coarse_query_len=s.coarse_query_len, group_size=s.group_size,
        coarse_int8=s.coarse_int8, stage1_kernel=s._summ_rows is not None,
        centroid_prune=s.centroid_prune)
    t0 = time.perf_counter()
    want_s, want_r = (t.numpy() for t in cpu.search_device(q.cpu(), K))
    print(f"plain search of a CPU copy of the index: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    bad = [i for i in range(len(q)) if not _tie_aware(
        got_r[i], got_s[i], want_r[i], want_s[i], ATOL)]
    err = float(np.abs(got_s - want_s).max())
    print(f"served answers vs the plain versions' search on the same query "
          f"embeddings: max|score err| {err:.3g}, {len(bad)} of {len(q)} "
          f"queries differ", flush=True)
    if bad:
        raise AssertionError(f"served answers disagree with the plain "
                             f"versions' search on queries {bad}")
    return q, torch.from_numpy(got_r), err


def hier_serve_slice(maxsim):
    """The hierarchical serve slice (preset fast). Returns (launches of K3
    and K4, dispatches, recall@10 vs exact, max |score error|, (data,
    server, index) for the compressed slice)."""
    import torch
    data, server, index = start_server(HIER_CONFIG, "cuda")
    record = record_searches(server)
    _, scores, pids, launches, dispatches = drive_requests(
        server, data, index, [maxsim.coarse_sweep_int8, maxsim.stage1_sweep])
    q, rows, err = check_served(server, index, record, scores, pids)
    with torch.inference_mode():
        exact = torch.topk(maxsim.maxsim_search(q, index.tokens,
                                                index.mask), K, dim=1)[1]
    recall = _recall(rows, exact)
    print(f"recall@10 vs exact search (random weights, not gated): "
          f"{recall:.4f}", flush=True)
    return launches, dispatches, recall, err, (data, server, index)


def random_records(g, n, ld, dim, nbits, n_cent):
    """Residual records of n docs with random codes below n_cent, bf16
    scales in [0.5, 1.5), random residual bytes; about 30 % of the tokens
    and every 997th doc masked. Returns (records, mask)."""
    import torch
    from ravqa_tpu_torch.ops.residual import pack_records
    codes = torch.randint(n_cent, (n, ld), generator=g, device="cuda")
    scales = 0.5 + torch.rand(n, ld, generator=g, device="cuda")
    packed = torch.randint(256, (n, ld, dim * nbits // 8), generator=g,
                           device="cuda").to(torch.uint8)
    mask = (torch.rand(n, ld, generator=g, device="cuda") > 0.3).to(
        torch.int8)
    mask[::997] = 0
    return pack_records(codes, scales, packed), mask


def compressed_kernels():
    """K5 and K6 against their plain versions. Returns {kernel: {"err",
    "ms", "plain_ms", "shapes"}}: ms and plain_ms of the first shape."""
    import torch
    from ravqa_tpu_torch.ops import quant, residual
    g = torch.Generator(device="cuda").manual_seed(2)
    b, lq, dim = 32, 32, 128
    q = _normed(g, b, lq, dim, dtype=torch.float32)
    q[:, -2:] = 0                                  # zero query rows
    out = {k: {"err": 0.0, "shapes": {}} for k in ("K5", "K6")}

    def record(kernel, shape, got, want, fn, plain_fn, bnd):
        record_kernel(out, kernel, shape, _compare(f"{kernel} {shape}", got,
                                                   want), fn, plain_fn, bnd)

    for lq_k5, ld in ((lq, 128), (lq, 64), (64, 220)):
        n = 16384
        if lq_k5 == lq:
            q8, qs = quant.quantize_queries_int8(q)
        else:                                      # the serve query length
            q64 = _normed(g, b, lq_k5, dim, dtype=torch.float32)
            q64[:, -2:] = 0
            q8, qs = quant.quantize_queries_int8(q64)
        tok = _normed(g, n, ld, dim, dtype=torch.float32)
        mask = (torch.rand(n, ld, generator=g, device="cuda") > 0.3).to(
            torch.int8)
        mask[::997] = 0                            # docs with no tokens
        t8, ds = quant.quantize_index_int8(tok, mask)
        del tok
        got = quant.maxsim_search_int8(q8, qs, t8, ds)
        want = quant.maxsim_search_int8_q8_torch(q8, qs, t8, ds)
        torch.cuda.synchronize()
        empty = got[:, ::997]
        if not torch.allclose(empty, (-9999.0 * qs.sum(1))[:, None]
                              .expand_as(empty), rtol=1e-6, atol=0):
            raise AssertionError("K5: a doc with no valid token must score "
                                 "-9999 * sum of the query scales")
        ops = 2.0 * b * lq_k5 * n * ld * dim
        shape = f"Lq={lq_k5} N=16384 Ld={ld}"
        record_kernel(out, "K5", shape, _compare(f"K5 {shape}", got, want),
                      lambda: quant.maxsim_search_int8(q8, qs, t8, ds),
                      lambda: quant.maxsim_search_int8_q8_torch(q8, qs, t8,
                                                                ds),
                      bound(_nbytes(q8, qs, t8, ds, got), ops, "int8"),
                      ops=ops)
        print(f"  {out['K5']['shapes'][shape]['tera_ops_per_s']:.1f} TOP/s",
              flush=True)
        del t8, ds, got, want

    def k6(shape, q, ld, n, k1, k2, nbits, c=256):
        """K6 at one shape: C random candidates per query over n docs of
        ld tokens, candidate 0 with no valid token."""
        b, lq, dim = q.shape
        cand = torch.randint(n, (b, c), generator=g, device="cuda")
        cand[:, 0] = 0                             # doc 0 has no valid token
        if k2:
            coarse = 0.3 * _normed(g, k1, dim, dtype=torch.float32)
            fine = 0.1 * torch.randn(k2, dim, generator=g, device="cuda")
            cent = (coarse[:, None] + fine[None]).reshape(-1, dim)
        else:
            coarse = fine = None
            cent = _normed(g, k1, dim, dtype=torch.float32)
        w = 0.05 * torch.randn(2 ** nbits, generator=g,
                               device="cuda").sort().values
        records, mask = random_records(g, n, ld, dim, nbits, cent.shape[0])
        args = (q, records, cand, mask, cent, w)
        kw = dict(nbits=nbits, coarse=coarse, fine=fine)
        got = residual.maxsim_residual(*args, **kw)
        want = residual.maxsim_residual_torch(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got[:, 0], torch.full_like(got[:, 0],
                                                      -9999.0 * lq)):
            raise AssertionError("K6: a doc with no valid token must "
                                 "score -9999 * Lq")
        # the candidates' record and mask rows, each read once; the
        # residual dots and the centroid-score table, in bf16
        used = torch.unique(cand).numel()
        rows = k1 + k2 if k2 else k1
        nbytes = (_nbytes(q, cand, w, coarse, fine, got)
                  + (0 if k2 else _nbytes(cent))
                  + used * (records.shape[1] + mask.shape[1]))
        ops = 2.0 * b * lq * dim * (c * ld + rows)
        record("K6", shape, got, want,
               lambda: residual.maxsim_residual(*args, **kw),
               lambda: residual.maxsim_residual_torch(*args, **kw),
               bound(nbytes, ops, "bf16"))
        # the kernel alone, without the wrapper's table and casts
        prep = (q.bfloat16().contiguous(),
                residual.centroid_scores(q, cent, coarse, fine).contiguous(),
                records, cand.to(torch.int32).contiguous(), mask,
                w.bfloat16().float().contiguous())
        def alone():
            return residual.launch_residual_kernel(
                *prep, nbits=nbits, k1=k1 if k2 else 0, k2=k2)
        o = out["K6"]["shapes"][shape]
        o["kernel_ms"] = time_ms(alone)
        o["device_ms"] = device_ms(alone, "residual_maxsim_kernel")
        print(f"  K6 {shape}: the kernel alone {o['kernel_ms']:.4f} ms, "
              f"its device time {o['device_ms']:.4f} ms", flush=True)

    # the 1M fine stage's shape: 256 candidates per query, 64 tokens
    for name, k1, k2 in (("factored 64x128", 64, 128),
                         ("flat 1024", 1024, 0)):
        for nbits in (2, 4):
            k6(f"{name} nbits={nbits}", q, 64, 65536, k1, k2, nbits)
    # the residual serve's: Lq = 64, 220-token docs, factored, nbits 2
    q64 = _normed(g, b, 64, dim, dtype=torch.float32)
    q64[:, -2:] = 0
    k6("serve factored 64x128 nbits=2 Lq=64 Ld=220", q64, 220, 16384, 64,
       128, 2)
    return out


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def synth_1m(n=1_000_448, ld=64, dim=128, n_topics=8192, slab=62_528, b=32,
             lq=32):
    """scripts/synth1m.py's corpus, made on the card slab by slab: doc i's
    topic is floor(i * n_topics / n) (cluster-ordered runs of ~122 docs),
    each token its topic plus 0.3 noise, normalized, stored bf16; queries
    are docs 0-31's first Lq tokens plus 0.1 noise. Returns (tokens,
    queries float32)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(7)
    topics = _normed(g, n_topics, dim, dtype=torch.float32)
    tok = torch.empty((n, ld, dim), dtype=torch.bfloat16, device="cuda")
    for lo in range(0, n, slab):
        idx = torch.arange(lo, min(lo + slab, n), device="cuda")
        assign = (idx * n_topics // n).clamp_max(n_topics - 1)
        t = topics[assign][:, None, :] + 0.3 * torch.randn(
            len(idx), ld, dim, generator=g, device="cuda")
        tok[lo:lo + slab] = t / t.norm(dim=-1, keepdim=True)
    qt = tok[:b, :lq].float() + 0.1 * torch.randn(b, lq, dim, generator=g,
                                                  device="cuda")
    return tok, qt / qt.norm(dim=-1, keepdim=True)


def one_million_legs(maxsim):
    """The 1M legs (phase 9). Returns ({leg: {"recall", "self_top1", "ms",
    "bytes"}}, {leg: {kernel: launches}})."""
    import torch
    from ravqa_tpu_torch.ops import quant, residual
    from ravqa_tpu_torch.retrieval import (LateInteractionSearcher,
                                           TokenIndex,
                                           build_index_from_embeddings)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tok, q = synth_1m()
    index = build_index_from_embeddings(
        tok, torch.ones(tok.shape[:2], dtype=torch.int8, device="cuda"),
        pad_multiple=128, dtype=torch.bfloat16)
    del tok
    index.build_summaries(n_summary=4, iters=2)
    index.build_block_summaries(block_size=64)
    torch.cuda.synchronize()
    print(f"1M bf16 index {index.num_docs} docs x {index.doc_maxlen} "
          f"tokens, summaries {tuple(index.summaries.shape)}, block "
          f"summaries {tuple(index.block_summaries.shape)}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    b = q.shape[0]
    self_rows = torch.arange(b, device="cuda")
    wrappers = {"K1": maxsim.maxsim_search, "K3": maxsim.coarse_sweep_int8,
                "K4": maxsim.stage1_sweep, "K5": quant.maxsim_search_int8,
                "K6": residual.maxsim_residual}
    out, launches = {}, {}
    exact_rows = None

    def leg(name, search, nbytes, kernels, bnd=None):
        nonlocal exact_rows
        for w in wrappers.values():
            w.launches = 0
        rows = search()[1]
        torch.cuda.synchronize()
        launches[name] = {k: wrappers[k].launches for k in kernels}
        if min(launches[name].values()) == 0:
            raise AssertionError(f"1M {name}: a kernel of the leg never "
                                 f"launched: {launches[name]}")
        if exact_rows is None:
            exact_rows = rows
        r = {"recall": _recall(rows, exact_rows),
             "self_top1": float((rows[:, 0] == self_rows).float().mean()),
             "ms": time_ms(search, iters=3, warmup=1), "bytes": nbytes}
        if bnd is not None:
            r.update({k: v for k, v in bnd.items()
                      if k in ("bound_ms", "bound_by", "bound_note")})
            print(f"1M {name}: {r['ms']:.3f} ms per batch against a bound of "
                  f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']}"
                  + (f"; {bnd['bound_note']}" if "bound_note" in bnd else "")
                  + ")", flush=True)
        out[name] = r
        print(f"1M {name}: recall@10 vs exact {r['recall']:.4f}, self-top-1 "
              f"{r['self_top1']:.4f}, {r['ms']:.3f} ms per batch of {b}, "
              f"{nbytes} bytes on the card; launches {launches[name]}",
              flush=True)

    k1_bound, k1_flop = maxsim_bound(maxsim, q, index.tokens, index.mask)
    one_part = bound(k1_bound["bytes"], k1_flop, "bf16")["bound_ms"]
    k1_bound["bound_note"] += f" (one part: {one_part:.3f} ms)"
    leg("exact bf16 (K1)",
        lambda: torch.topk(maxsim.maxsim_search(q, index.tokens, index.mask),
                           K, dim=1),
        _nbytes(index.tokens, index.mask), ("K1",), k1_bound)

    t0 = time.perf_counter()
    t8, s8 = quant.quantize_index_int8(index.tokens, index.mask)
    i8 = dataclasses.replace(index, tokens=t8, scales=s8)
    del t8, s8
    torch.cuda.synchronize()
    print(f"int8 index: {time.perf_counter() - t0:.1f} s", flush=True)
    nb8 = _nbytes(i8.tokens, i8.scales, i8.mask)
    s = LateInteractionSearcher(i8, mode="exact")
    n_, ld_, dim_ = i8.tokens.shape
    lq_ = q.shape[1]
    # codes and scales of the index, the int8 query and its scales, out
    leg("int8 exact (K5)", lambda: s.search_device(q, K), nb8, ("K5",),
        bound(_nbytes(i8.tokens, i8.scales) + b * lq_ * (dim_ + 4)
              + 4 * b * n_, 2.0 * b * lq_ * n_ * ld_ * dim_, "int8"))
    s = LateInteractionSearcher(i8, mode="hierarchical", preset="fast")
    leg("int8 hierarchical fast (K3, K4)", lambda: s.search_device(q, K),
        nb8, ("K3", "K4"))
    del s, i8
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = dataclasses.replace(index)
    index.tokens = None
    res.quantize_residual(n_centroids=(64, 128), nbits=2)
    torch.cuda.synchronize()
    print(f"residual index (factored 64 x 128, nbits 2; codec trained on "
          f"the card): {time.perf_counter() - t0:.1f} s", flush=True)
    s = LateInteractionSearcher(res, mode="hierarchical", preset="fast")
    leg("residual hierarchical fast (K3, K4, K6)",
        lambda: s.search_device(q, K),
        _nbytes(res.records, res.mask, res.codec_centroids,
                res.codec_weights, res.codec_coarse, res.codec_fine),
        ("K3", "K4", "K6"))
    print(f"summaries {_nbytes(res.summaries)} bytes, block summaries "
          f"{_nbytes(res.block_summaries)} bytes (every leg)", flush=True)
    del s, res, index
    torch.cuda.empty_cache()
    for name, r in out.items():
        if r["self_top1"] < 0.95:
            raise AssertionError(f"1M {name}: self-top-1 {r['self_top1']}")
        if name.startswith("int8") and r["recall"] < 0.95:
            raise AssertionError(f"1M {name}: recall@10 {r['recall']}")
    return out, launches


def compressed_serve_slice(maxsim, data, server, index):
    """Phase 7's index as an int8 copy served in exact mode (K5) and a
    residual copy (factored 64 x 128, nbits 2) served hierarchical fast
    (K3, K4, K6), each behind RetrievalServer. Returns {slice: {"launches",
    "dispatches", "err", "search_ms_b32"}}."""
    from ravqa_tpu_torch.ops import quant, residual
    from ravqa_tpu_torch.retrieval import LateInteractionSearcher
    from ravqa_tpu_torch.serving import RetrievalServer
    t0 = time.perf_counter()
    i8 = dataclasses.replace(index, meta=dict(index.meta)).quantize_int8()
    res = dataclasses.replace(index, meta=dict(index.meta)).quantize_residual(
        n_centroids=(64, 128), nbits=2)
    print(f"int8 and residual copies of the serve index: "
          f"{time.perf_counter() - t0:.1f} s; bytes int8 "
          f"{_nbytes(i8.tokens, i8.scales)}, residual "
          f"{_nbytes(res.records)} (float32 "
          f"{_nbytes(index.tokens)})", flush=True)
    out = {}
    for name, idx, kw, wrappers in (
            ("int8 exact", i8, dict(mode="exact"),
             [quant.maxsim_search_int8]),
            ("residual hierarchical fast", res,
             dict(mode="hierarchical", preset="fast"),
             [maxsim.coarse_sweep_int8, maxsim.stage1_sweep,
              residual.maxsim_residual])):
        srv = RetrievalServer(server.ex, LateInteractionSearcher(idx, **kw),
                              data["query_tokenizer"],
                              image_feature_dim=server.image_feature_dim,
                              id2content=server.id2content,
                              config=server.cfg)
        srv.warm_up()
        print(f"-- {name}", flush=True)
        record = record_searches(srv)
        _, scores, pids, launches, dispatches = drive_requests(
            srv, data, idx, wrappers)
        if dispatches == 0 or min(launches) < dispatches:
            raise AssertionError(f"{name}: launches {launches} for "
                                 f"{dispatches} dispatches")
        q, _, err = check_served(srv, idx, record, scores, pids)
        ms = time_ms(lambda: srv.searcher.search_device(q[:32], K))
        print(f"search alone: {ms:.3f} ms per batch of 32", flush=True)
        out[name] = {"launches": dict(zip((w.__name__ for w in wrappers),
                                          launches)),
                     "dispatches": dispatches, "err": err,
                     "search_ms_b32": ms}
    return out


def stage2_inputs(lq=32):
    """Phase 11's inputs, made on the card from seed 3, shape by shape:
    B=32 queries of Lq unit tokens (float32), Ld=64, dim 128, C = 1,024,
    256 and 200 (a multiple of neither of the TPU tiles, 32 and 128); ~30 %
    of the tokens masked and candidate 1 of every query with none. Yields
    (shape, X1's keyword arguments, X2's bf16 candidate tokens): the mask
    (X1's mg, X2's too), X1's pre-gathered centroid scores (dot products of unit vectors, here
    0.1 N(0, 1)), 2-bit bucket ids and scales near 1."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(3)
    b, ld, dim = 32, 64, 128
    q = _normed(g, b, lq, dim, dtype=torch.float32)
    w = torch.tensor([-0.05, -0.01, 0.01, 0.05], device="cuda")
    for c in (1024, 256, 200):
        mask = (torch.rand(b, c, ld, generator=g, device="cuda") > 0.3).to(
            torch.int8)
        mask[:, 1] = 0
        x1 = dict(q=q, cqg=0.1 * torch.randn(b, c, ld, lq, generator=g,
                                             device="cuda"),
                  bits=torch.randint(4, (b, c, ld, dim), generator=g,
                                     device="cuda", dtype=torch.uint8),
                  sg=1.0 + 0.01 * torch.randn(b, c, ld, generator=g,
                                              device="cuda"),
                  mg=mask, weights=w)
        yield f"C={c}", x1, _normed(g, b, c, ld, dim, dtype=torch.bfloat16)


def x1_bound(x1, out):
    """X1's bound on these inputs: the bytes it must move (the mask, the
    query, the weights, the scores and, of each scored row (mg != 0) only,
    its ids, centroid scores and scale: a masked row scores -9999 whatever
    they hold) and the bf16 operations of its three products (hi.hi + lo.hi
    + hi.lo) over the scored rows; the CUDA cores' float32 bound of the
    same function beside it ("f32_bound_ms")."""
    q, mg = x1["q"], x1["mg"]
    _, lq, dim = q.shape
    scored = int((mg != 0).sum().item())
    nbytes = (_nbytes(mg, q, x1["weights"], out)
              + scored * (dim + 4 * lq + 4))
    flop = 2.0 * lq * dim * scored
    bnd = bound(nbytes, 3 * flop, "bf16")
    bnd["bound_note"] = ("bytes and bf16 operations of the 3 products "
                         "(hi.hi + lo.hi + hi.lo) of the scored rows")
    bnd["scored_rows"] = scored
    bnd["f32_bound_ms"] = bound(nbytes, flop, "f32")["bound_ms"]
    return bnd


def stage2_kernels():
    """X1, X2 and X3 against their plain versions on phase 11's inputs
    (stage2_inputs). Returns {kernel: {"err", "ms", "plain_ms", "bound_ms",
    "bound_by", "shapes"}}: the first shape's times and bound at the top.
    X1 and X2 also time the launch alone ("kernel_ms", launch_fused_lut /
    launch_candidate) and X1, X2 and X3 the device time of their kernels
    from the profiler ("device_ms" a call of the route,
    "device_ms_per_launch": X3's call is B launches). X1's bound is
    x1_bound's."""
    import torch
    from ravqa_tpu_torch.ops import stage2
    out = {k: {"err": 0.0, "shapes": {}} for k in ("X1", "X2", "X3")}

    def per_query(mask, tok):
        return torch.cat([stage2.candidate_maxsim(qb[i:i + 1], tok[i:i + 1],
                                                  mask[i:i + 1])
                          for i in range(b)])

    def check(kernel, shape, got, want, fn, plain_fn, bnd):
        torch.cuda.synchronize()
        if not torch.equal(got[:, 1], torch.full_like(got[:, 1],
                                                      -9999.0 * lq)):
            raise AssertionError(f"{kernel}: a candidate with no valid token "
                                 f"must score -9999 * Lq")
        record_kernel(out, kernel, shape, _compare(f"{kernel} {shape}", got,
                                                   want), fn, plain_fn, bnd)

    for shape, x1, tok in stage2_inputs():
        b, lq, dim = x1["q"].shape
        mask = x1["mg"]
        qb = x1["q"].bfloat16()
        got = stage2.fused_lut_maxsim(**x1)
        check("X1", shape, got, stage2.fused_lut_maxsim_torch(**x1),
              lambda: stage2.fused_lut_maxsim(**x1),
              lambda: stage2.fused_lut_maxsim_torch(**x1), x1_bound(x1, got))
        x1s = out["X1"]["shapes"][shape]
        x1s["kernel_ms"] = time_ms(lambda: stage2.launch_fused_lut(**x1))
        x1s["device_ms"] = device_ms(lambda: stage2.fused_lut_maxsim(**x1),
                                     "lut_maxsim_kernel")
        print(f"  X1 {shape}: the launch alone {x1s['kernel_ms']:.4f} ms, "
              f"device {x1s['device_ms']:.4f} ms; {x1s['scored_rows']} rows "
              f"scored; the CUDA cores' float32 bound "
              f"{x1s['f32_bound_ms']:.4f} ms", flush=True)
        del x1, got
        # X2 batched, X3 the same kernel once per query (B launches)
        flop = 2.0 * lq * dim * mask.numel()
        want = stage2.candidate_maxsim_torch(qb, tok, mask)
        got = stage2.candidate_maxsim(qb, tok, mask)
        bnd = bound(_nbytes(qb, tok, mask, got), flop, "bf16")
        check("X2", shape, got, want,
              lambda: stage2.candidate_maxsim(qb, tok, mask),
              lambda: stage2.candidate_maxsim_torch(qb, tok, mask), bnd)
        check("X3", shape, per_query(mask, tok), want,
              lambda: per_query(mask, tok),
              lambda: stage2.candidate_maxsim_torch(qb, tok, mask), bnd)
        x2, x3 = out["X2"]["shapes"][shape], out["X3"]["shapes"][shape]
        x2["kernel_ms"] = time_ms(
            lambda: stage2.launch_candidate(qb, tok, mask))
        for o, fn, n in ((x2, lambda: stage2.candidate_maxsim(qb, tok, mask),
                          1),
                         (x3, lambda: per_query(mask, tok), b)):
            o["device_ms"] = device_ms(fn, "candidate_kernel", launches=n)
            o["device_ms_per_launch"] = o["device_ms"] / n
        # the host's enqueue of X3's launches (the clock stops before the
        # card is waited for)
        host = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            per_query(mask, tok)
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        x3["host_ms_per_launch"] = float(np.median(host)) * 1e3 / b
        print(f"  X2 {shape}: the launch alone {x2['kernel_ms']:.4f} ms, "
              f"device {x2['device_ms']:.4f} ms; X3: device "
              f"{x3['device_ms']:.4f} ms for {b} launches, "
              f"{x3['device_ms_per_launch'] * 1e3:.2f} us a launch on the "
              f"device, {x3['host_ms_per_launch'] * 1e3:.2f} us a launch "
              f"on the host", flush=True)
        del tok, want, got
    return out


def stage2_experiment():
    """The residual stage-2 experiment (phase 12): every round of
    ravqa_tpu_torch.scripts.exp_residual_stage2.run() at the script's full
    widths, with the launch counts set to 0 just before. Returns its report
    and {kernel: launches} as the wrappers counted them."""
    import torch
    from ravqa_tpu_torch.ops import stage2
    from ravqa_tpu_torch.scripts import exp_residual_stage2 as exp
    torch.cuda.empty_cache()
    fused, cand = stage2.fused_lut_maxsim, stage2.candidate_maxsim
    fused.launches = cand.launches = 0
    report = exp.run()
    torch.cuda.synchronize()
    routes, want = report["launches"], report["expected_launches"]
    if routes != want or min(want.values()) == 0 \
            or fused.launches != routes["X1"] \
            or cand.launches != routes["X2"] + routes["X3"]:
        raise AssertionError(f"stage-2 launches: routes {routes}, expected "
                             f"{want}, counted X1 {fused.launches}, X2 + X3 "
                             f"{cand.launches}")
    twin = report["twin_err"]
    if set(twin) != {"X1", "X2", "X3"} or max(twin.values()) > SWEEP_ATOL:
        raise AssertionError(f"stage-2 kernel routes against their plain "
                             f"twins: {twin}")
    bad = [k for k, v in {**report["times"], **report["rel_err"]}.items()
           if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"stage-2 experiment: not finite: {bad}")
    print(f"launches {routes} (expected {want}); plain twins max |err| "
          f"{twin}", flush=True)
    return report


# ---------------------------------------------------------------------------
# phases 13-14: FLMR retriever training
# ---------------------------------------------------------------------------

# gradients on the card against the CPU, per parameter: max |diff| over
# max(the CPU grad's max |value|, 1e-3 of the model's largest grad) (the
# attention key biases' grads are 0 in exact arithmetic, rounding alone)
GRAD_RTOL = 1e-4


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def grad_errors(model, ref) -> dict:
    """Each parameter's gradient error of `model` against `ref` (the same
    module run on the CPU), as GRAD_RTOL measures it: max |grad - ref
    grad| over max(the ref grad's largest |value|, 1e-3 of ref's largest
    grad), in float64."""
    got = {n: p.grad for n, p in model.named_parameters()
           if p.grad is not None}
    want = {n: p.grad.double() for n, p in ref.named_parameters()
            if p.grad is not None}
    if set(got) != set(want):
        raise AssertionError("the card and the CPU grads cover different "
                             "parameters")
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    return {n: (got[n].cpu().double() - g).abs().max().item()
            / max(g.abs().max().item(), floor) for n, g in want.items()}


def grad_agreement(model, ref):
    """Worst grad_errors of `model` against `ref`. Returns (error,
    parameter name, the models' grad norms)."""
    from ravqa_tpu_torch.executors.base import global_norm
    errs = grad_errors(model, ref)
    name = max(errs, key=errs.get)
    norms = [global_norm([p.grad for p in m.parameters()
                          if p.grad is not None]).item()
             for m in (model, ref)]
    return errs[name], name, tuple(norms)


def update_agreement(model, ref, before, lr_of):
    """A first Adam update on the card against the CPU's. It moves a
    coordinate by lr * g / (|g| + eps): about lr whatever the grad's size,
    so a grad near 0 that rounds to the other sign on one device moves it
    the other way. Where the CPU's grad is well above rounding (over 1e-3
    of its parameter's largest and 1e-6, far past eps), both devices must
    make the same move: within 2 ulp of the parameter (one rounding of the
    update each) plus 1e-3 lr. A wrong learning rate, a skipped update or
    a flipped sign is ~lr off. `before`: the CPU parameters before the
    update by name (the others are not checked); lr_of(name). Returns
    (worst past 2 ulp in lr, the least move in lr, coordinates checked,
    coordinates of the parameters checked, coordinates past 1e-3 lr)."""
    import torch
    want_sd = ref.state_dict()
    worst, moved, n_sig, n_all, far = 0.0, np.inf, 0, 0, 0
    for n, p in model.named_parameters():
        g = ref.get_parameter(n).grad
        if n not in before or g is None:
            continue
        got, want, lr = p.detach().cpu(), want_sd[n], lr_of(n)
        d = (got - want).abs()
        ulp = torch.nextafter(want.abs(), torch.full_like(want, np.inf)) \
            - want.abs()
        sig = g.abs() > max(1e-3 * g.abs().max().item(), 1e-6)
        if sig.any():
            worst = max(worst, (d - 2 * ulp)[sig].max().item() / lr)
            moved = min(moved, (want - before[n]).abs()[sig].min().item()
                        / lr)
        n_sig += int(sig.sum())
        n_all += sig.numel()
        far += int((d > 1e-3 * lr).sum())
    return worst, moved, n_sig, n_all, far


def training_step_vs_cpu(config_path, device="cuda"):
    """Phase 13: entry()'s loss and backward at its BERT-base shape on the
    card and on the CPU from one state dict (loss, grad norm, every
    parameter's grad); then two FLMRExecutor.train_step on the card and on
    the CPU on one batch of 2 from the training config (loss, grad norm,
    grads, the first update, the second step's loss). Nothing of the
    card's run may sit on the CPU."""
    import copy
    import torch
    from ravqa_tpu_torch.entry import entry
    from ravqa_tpu_torch.main import build_executor, build_pipeline, load_config
    fn, (model, batch) = entry(device=device)
    cpu = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    loss = fn(model, batch)
    loss.backward()
    _sync(device)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_cpu = fn(cpu, {k: v.cpu() for k, v in batch.items()})
    loss_cpu.backward()
    t_cpu = time.perf_counter() - t0
    on_card = {p.device.type for p in model.parameters()} | {
        p.grad.device.type for p in model.parameters() if p.grad is not None}
    if on_card != {torch.device(device).type} \
            or loss.device.type != torch.device(device).type:
        raise AssertionError(f"entry() on {device} ran on {on_card}")
    err, name, (norm, norm_cpu) = grad_agreement(model, cpu)
    loss_err = abs(loss.item() - loss_cpu.item())
    print(f"entry() BERT-base loss {loss.item():.6f} on {device}, "
          f"{loss_cpu.item():.6f} on the CPU (|diff| {loss_err:.3g}); grad "
          f"norm {norm:.6f} vs {norm_cpu:.6f}; worst grad {err:.3g} "
          f"({name}); forward+backward {t_dev * 1e3:.1f} ms on {device} "
          f"(first call), {t_cpu * 1e3:.0f} ms on the CPU", flush=True)
    if not (loss_err <= 1e-4 * abs(loss_cpu.item()) and err <= GRAD_RTOL
            and abs(norm - norm_cpu) <= 1e-4 * norm_cpu):
        raise AssertionError("entry()'s loss or grads on the card disagree "
                             "with the CPU")
    del model, cpu, batch, loss, loss_cpu

    cfg = load_config(config_path)
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    out = {"entry_loss": loss_err, "entry_grad_rel_err": err,
           "entry_grad_worst": name}
    out.update(executor_step_vs_cpu(
        build_executor(cfg, device), build_executor(cfg, "cpu"),
        data["train"].collate([0, 1]), f"batch of 2, {config_path}",
        device))
    return out


def executor_step_vs_cpu(ex, ex_cpu, batch, label, device="cuda"):
    """One train_step of an executor on the card and of its copy (the same
    weights) on the CPU, on one batch: the loss and the grad norm (rtol
    1e-4), every grad (grad_agreement), the first Adam update
    (update_agreement: within 2 ulp plus 1e-3 lr where the grad is well
    above rounding); then a second step on the same batch, its loss (rtol
    1e-4). Returns the errors."""
    import torch
    before = {n: p.detach().cpu().clone()
              for n, p in ex_cpu.model.named_parameters()}
    m = ex.train_step(batch)
    m_cpu = ex_cpu.train_step(batch)
    if m["loss"].device.type != torch.device(device).type or {
            p.device.type for p in ex.model.parameters()} != {
            torch.device(device).type}:
        raise AssertionError(f"train_step on {device} left the card")
    g_err, g_name, _ = grad_agreement(ex.model, ex_cpu.model)
    lr = {n: (ex.train_cfg.mapping_lr if n.startswith("vision_projection")
              and ex.train_cfg.mapping_lr is not None else ex.train_cfg.lr)
          for n in before}
    worst, moved, n_sig, n_all, far = update_agreement(
        ex.model, ex_cpu.model, before, lr.get)
    dl = abs(float(m["loss"]) - float(m_cpu["loss"]))
    dn = abs(float(m["grad_norm"]) - float(m_cpu["grad_norm"]))
    # a second step on the same batch: its loss reads the first update
    m2, m2_cpu = ex.train_step(batch), ex_cpu.train_step(batch)
    dl2 = abs(float(m2["loss"]) - float(m2_cpu["loss"]))
    print(f"train_step ({label}): loss "
          f"{float(m['loss']):.6f} on {device}, {float(m_cpu['loss']):.6f} on "
          f"the CPU; grad norm {float(m['grad_norm']):.6f} vs "
          f"{float(m_cpu['grad_norm']):.6f}; worst grad {g_err:.3g} "
          f"({g_name}); the update on the {n_sig} of {n_all} coordinates "
          f"whose grad is well above rounding: max |diff| past 2 ulp "
          f"{worst:.3g} lr (each moved at least {moved:.3g} lr); "
          f"{far} coordinates in all past 1e-3 lr", flush=True)
    print(f"second train_step on the same batch: loss "
          f"{float(m2['loss']):.6f} on {device}, {float(m2_cpu['loss']):.6f} "
          f"on the CPU (|diff| {dl2:.3g}; the first update moved it by "
          f"{abs(float(m2_cpu['loss']) - float(m_cpu['loss'])):.3g})",
          flush=True)
    if not (dl <= 1e-4 * abs(float(m_cpu["loss"]))
            and dn <= 1e-4 * float(m_cpu["grad_norm"]) and g_err <= GRAD_RTOL
            and n_sig > 0 and worst <= 1e-3
            and dl2 <= 1e-4 * abs(float(m2_cpu["loss"]))):
        raise AssertionError("train_step on the card disagrees with the CPU")
    return {"step_loss_err": dl, "step_grad_norm_err": dn,
            "step_grad_rel_err": g_err, "step_grad_worst": g_name,
            "step_update_err_lr": worst, "step_update_coords": n_sig,
            "step_coords_past_1e-3_lr": far, "step2_loss_err": dl2}


class _Recorder:
    """Wraps FLMRExecutor.train_step / build_index / evaluate_retrieval and
    LateInteractionSearcher.search for phase 14: each train step's seconds
    (to the card's finish), loss, grad norm and attended tokens, each
    corpus encode's and search's seconds, each evaluation's result and
    each search's query embeddings, answers and searcher. restore() puts
    the methods back."""

    def __init__(self, device):
        import torch
        from ravqa_tpu_torch.executors import FLMRExecutor
        from ravqa_tpu_torch.retrieval import LateInteractionSearcher
        self.steps, self.encodes, self.searches, self.evals = [], [], [], []
        self.peak_after_2 = None
        self._orig = [(FLMRExecutor, "train_step"),
                      (FLMRExecutor, "build_index"),
                      (FLMRExecutor, "evaluate_retrieval"),
                      (LateInteractionSearcher, "search")]
        self._orig = [(c, n, getattr(c, n)) for c, n in self._orig]
        rec = self
        step, build, evaluate, search = (f for _, _, f in self._orig)

        def timed(fn, out):
            def run(*a, **k):
                _sync(device)
                t0 = time.perf_counter()
                r = fn(*a, **k)
                _sync(device)
                out.append(time.perf_counter() - t0)
                return r
            return run

        def train_step(self, batch):
            _sync(device)
            t0 = time.perf_counter()
            m = step(self, batch)
            loss = float(m["loss"])                # waits for the card
            seconds = time.perf_counter() - t0
            # the positions the attention masks keep (the rest is padding)
            attended = sum(int(batch[k].sum()) for k in (
                "query_attention_mask", "doc_attention_mask"))
            rec.steps.append((seconds, loss, float(m["grad_norm"]),
                              attended))
            if len(rec.steps) == 2 and torch.device(device).type == "cuda":
                rec.peak_after_2 = torch.cuda.max_memory_allocated()
            return m

        def searched(self, q, k):
            _sync(device)
            t0 = time.perf_counter()
            scores, pids = search(self, q, k)
            rec.searches.append({"s": time.perf_counter() - t0,
                                 "q": torch.as_tensor(q).detach(),
                                 "scores": scores, "pids": pids,
                                 "searcher": self})
            return scores, pids

        def evaluated(self, *a, **k):
            t0 = time.perf_counter()
            r = evaluate(self, *a, **k)
            rec.evals.append((time.perf_counter() - t0, r))
            return r

        FLMRExecutor.train_step = train_step
        FLMRExecutor.build_index = timed(build, self.encodes)
        FLMRExecutor.evaluate_retrieval = evaluated
        LateInteractionSearcher.search = searched

    def restore(self):
        for cls, name, fn in self._orig:
            setattr(cls, name, fn)


def _drive_main(maxsim, argv, key, device="cuda"):
    """main(argv) in-process under a _Recorder, with the counts of K1-K4
    set to 0 just before and read just after ("K1 split": the float32
    index's route). Returns (the recorder, {wall_s, launches, encode_s,
    search_s, eval_s, peak_bytes on the card})."""
    import torch
    from ravqa_tpu_torch.main import main as port_main
    counted = (maxsim.maxsim_search, maxsim.coarse_sweep,
               maxsim.coarse_sweep_int8, maxsim.stage1_sweep)
    for w in counted:
        w.launches = 0
    maxsim.maxsim_search.split_launches = 0
    rec = _Recorder(device)
    card = torch.device(device).type == "cuda"
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        if port_main(argv) != 0:
            raise AssertionError(f"main {argv} failed")
    finally:
        rec.restore()
    out = {"wall_s": time.perf_counter() - t0,
           "launches": dict(zip(("K1", "K2", "K3", "K4"),
                                (w.launches for w in counted))),
           "encode_s": rec.encodes,
           "search_s": [x["s"] for x in rec.searches],
           "eval_s": [e[0] for e in rec.evals]}
    out["launches"]["K1 split"] = maxsim.maxsim_search.split_launches
    if card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"{key}: {out['wall_s']:.1f} s; launches {out['launches']}; "
          f"corpus encodes {[round(x, 2) for x in rec.encodes]} s, searches "
          f"{[round(x, 3) for x in out['search_s']]} s", flush=True)
    return rec, out


def _recall_precision(m):
    return {k: v for k, v in m.items()
            if k.startswith(("recall_at_", "precision_at_"))}


def check_eval_search(search, index, n_check=16):
    """The exact evaluation's answers against a plain search of a CPU copy
    of the same index on the same query embeddings (tie-aware top-10, max
    abs 1e-3), for the first n_check queries; all of them against the
    plain version on the index's own device (exact_cpu_copy). Returns max
    |score error|."""
    import torch
    from ravqa_tpu_torch.ops import maxsim
    q, scores, pids = search["q"], search["scores"][:, :K], \
        search["pids"][:, :K]
    n_check = min(n_check, len(q))
    with torch.inference_mode():
        dev = maxsim.maxsim_search_torch(q, index.tokens, index.mask)
        dv, dr = (t.cpu().numpy() for t in torch.topk(dev, K, dim=1))
        cpu = exact_cpu_copy(index)
        t0 = time.perf_counter()
        want = maxsim.maxsim_search_torch(q[:n_check].cpu(), cpu.tokens,
                                          cpu.mask)
        wv, wr = (t.numpy() for t in torch.topk(want, K, dim=1))
    t_cpu = time.perf_counter() - t0
    rows = [np.flatnonzero(index.pids == p) for p in pids.ravel()]
    if any(len(r) != 1 for r in rows):
        raise AssertionError("an evaluated pid is not one row of the index")
    bad = [i for i in range(n_check) if not _tie_aware(
        pids[i], scores[i], index.pids[wr[i]], wv[i], ATOL)]
    bad += [i for i in range(len(q)) if not _tie_aware(
        pids[i], scores[i], index.pids[dr[i]], dv[i], ATOL)]
    err = max(float(np.abs(scores[:n_check] - wv).max()),
              float(np.abs(scores - dv).max()))
    print(f"exact evaluation vs plain search: {n_check} queries on a CPU "
          f"copy ({t_cpu:.1f} s), {len(q)} on the card's plain version; "
          f"max |score err| {err:.3g}, {len(set(bad))} queries differ",
          flush=True)
    if bad:
        raise AssertionError(f"the evaluation's ranking disagrees with the "
                             f"plain search on queries {sorted(set(bad))}")
    return err


def check_hier_eval(search, n_check=16):
    """The hierarchical evaluation against the plain versions on the query
    embeddings it searched: its stage-0 sweep (K2 over the searcher's
    bf16 block summaries, or K3 over int8 ones) against coarse_sweep_torch
    for every query (check_topk: top-10 tie-aware, max abs 1e-3), timed
    beside its bound; and the first n_check queries' answers against the
    same search of a CPU copy of the index, which runs the kernels' plain
    versions (tie-aware top-10, max abs 1e-3). Returns (the stage-0
    kernel's name, {shape: its record as record_kernel keeps a shape},
    max |score error| of the answers)."""
    import torch
    from ravqa_tpu_torch.ops import maxsim
    from ravqa_tpu_torch.retrieval import LateInteractionSearcher
    s = search["searcher"]
    idx = s.index
    q = search["q"].to(idx.device)
    if s.mode != "hierarchical" or s._bsum_t is None:
        raise AssertionError("the hierarchical eval's stage 0 took no kernel")
    kernel = "K2" if s._bsum_t_scale is None else "K3"
    # stage 0's inputs as hierarchical_search makes them
    nb = idx.block_summaries.shape[0]
    v = torch.zeros(s._bsum_t.shape[1], dtype=torch.int8, device=idx.device)
    v[:nb] = s._doc_valid.bool().reshape(nb, idx.block_size).any(dim=1)
    qc = q if s.coarse_query_len is None else q[:, :s.coarse_query_len]
    args = (qc, s._bsum_t, v)
    kw = {"dscale": s._bsum_t_scale}
    got = maxsim.coarse_sweep(*args, **kw)
    want = maxsim.coarse_sweep_torch(*args, **kw)
    torch.cuda.synchronize()
    b, lq, dim = qc.shape
    s_, n, _ = s._bsum_t.shape
    dtype = str(s._bsum_t.dtype).removeprefix("torch.")
    shape = (f"phase 14 hierarchical eval stage 0 {dtype} B={b} Lq={lq} "
             f"S={s_} N={n}")
    err0 = _compare(f"{kernel} {shape}", got, want)
    stage0 = {kernel: {"err": err0, "shapes": {}}}
    record_kernel(stage0, kernel, shape, err0,
                  lambda: maxsim.coarse_sweep(*args, **kw),
                  lambda: maxsim.coarse_sweep_torch(*args, **kw),
                  bound(_nbytes(qc, s._bsum_t, v, got)
                        + (0 if s._bsum_t_scale is None
                           else _nbytes(s._bsum_t_scale)),
                        2.0 * b * lq * s_ * n * dim,
                        "bf16" if kernel == "K2" else "int8"))

    n_check = min(n_check, len(q))
    cpu = LateInteractionSearcher(
        cpu_copy(idx), use_pallas=s.use_pallas, mode=s.mode,
        preset=s.preset, n_candidates=s.n_candidates, n_blocks=s.n_blocks,
        coarse_query_len=s.coarse_query_len, group_size=s.group_size,
        coarse_int8=s.coarse_int8, stage1_kernel=s._summ_rows is not None,
        centroid_prune=s.centroid_prune)
    k = search["scores"].shape[1]
    t0 = time.perf_counter()
    want_s, want_r = (t.numpy() for t in cpu.search_device(
        q[:n_check].cpu(), k))
    t_cpu = time.perf_counter() - t0
    got_s, got_p = search["scores"][:n_check, :K], search["pids"][:n_check, :K]
    want_s, want_p = want_s[:, :K], idx.pids[want_r[:, :K]]
    bad = [i for i in range(n_check) if not _tie_aware(
        got_p[i], got_s[i], want_p[i], want_s[i], ATOL)]
    err = float(np.abs(got_s - want_s).max())
    print(f"hierarchical evaluation vs the plain versions' search of a CPU "
          f"copy ({n_check} queries, {t_cpu:.1f} s): max |score err| "
          f"{err:.3g}, {len(bad)} queries differ", flush=True)
    if bad:
        raise AssertionError(f"the hierarchical evaluation disagrees with "
                             f"the plain versions' search on queries {bad}")
    return kernel, {shape: {**stage0[kernel]["shapes"][shape],
                            "err": err0}}, err


def training_slice(config_path, smi, device="cuda"):
    """Phase 14: `main --mode train` in-process on the BERT-base training
    config (validation in the middle and at the end, then ckpt/), then
    `--mode eval` from that checkpoint in exact mode and with
    model_config.search_mode=hierarchical. Gates: every loss finite; K1 on
    the float32 index's split route in every exact evaluation, K2/K3/K4 in
    the hierarchical one (each count set to 0 just before the run and read
    just after); the exact evaluation's ranking against a plain search
    (check_eval_search), and the hierarchical one's stage-0 sweep and
    answers against the plain versions (check_hier_eval); the eval from
    the checkpoint reproduces the final validation's recall_at_* and
    precision_at_*; params.msgpack decodes with the port's reader. Prints
    the step time, steps/s, padded positions/s and attended tokens/s, peak
    memory and the evaluations' seconds beside the card's name and power
    limit."""
    import tempfile
    from ravqa_tpu_torch.main import load_config
    from ravqa_tpu_torch.models import read_flax_msgpack
    from ravqa_tpu_torch.ops import maxsim
    cfg = load_config(config_path)
    tc, pc = cfg.train, cfg.data_pipeline.loaders.setup_kwargs
    out = {}

    def drive(argv, key):
        rec, out[key] = _drive_main(maxsim, argv, key, device)
        return rec

    with tempfile.TemporaryDirectory(dir=HERE,
                                     prefix=".chip_smoke_train_") as tmp:
        common = ["--config", config_path, "--device", device, "--log_dir",
                  tmp, "--experiment_name", "train"]
        rec = drive(common + ["--mode", "train"], "train")
        steps = rec.steps
        losses = [s[1] for s in steps]
        if len(steps) != tc.total_steps or not np.all(np.isfinite(
                losses + [s[2] for s in steps])):
            raise AssertionError(f"{len(steps)} train steps, losses {losses}")
        if len(rec.evals) != tc.total_steps // tc.val_every:
            raise AssertionError(f"{len(rec.evals)} validations")
        final = _recall_precision(rec.evals[-1][1])
        tr = out["train"]
        if tr["launches"]["K1"] < len(rec.evals) or \
                tr["launches"]["K1 split"] != tr["launches"]["K1"]:
            raise AssertionError(f"validation launches {tr['launches']}")
        ms = [s[0] * 1e3 for s in steps[2:]]
        step_ms = float(np.median(ms))
        # the towers run every padded position; the attention masks keep
        # far fewer (SyntheticOKVQA's passages and questions are short)
        toks = tc.batch_size * (pc.query_maxlen + pc.nway * pc.doc_maxlen)
        attended = float(np.mean([s[3] for s in steps[2:]]))
        tr.update(step_ms_median=step_ms, step_ms_min=min(ms),
                  step_ms_max=max(ms), first_steps_ms=[
                      s[0] * 1e3 for s in steps[:2]],
                  steps_per_s=1e3 / step_ms, padded_positions_per_step=toks,
                  padded_positions_per_s=toks / step_ms * 1e3,
                  attended_tokens_per_step=attended,
                  attended_tokens_per_s=attended / step_ms * 1e3,
                  losses=losses,
                  peak_bytes_after_2_steps=rec.peak_after_2,
                  validation_s=[e[0] for e in rec.evals],
                  final_validation=final)
        print(f"{smi}: train step {step_ms:.1f} ms median over steps 3-"
              f"{len(steps)} (min {min(ms):.1f}, max {max(ms):.1f}; the first "
              f"two {tr['first_steps_ms'][0]:.0f}, "
              f"{tr['first_steps_ms'][1]:.0f}), {tr['steps_per_s']:.3f} "
              f"steps/s", flush=True)
        print(f"{smi}: {toks} padded query+doc positions a step "
              f"(B={tc.batch_size} x ({pc.query_maxlen} + {pc.nway} x "
              f"{pc.doc_maxlen})), {tr['padded_positions_per_s']:.0f} "
              f"positions/s; of them {attended:.0f} attended (the attention "
              f"masks' ones, mean over steps 3-{len(steps)}), "
              f"{tr['attended_tokens_per_s']:.0f} attended tokens/s",
              flush=True)
        print(f"{smi}: peak torch.cuda.max_memory_allocated "
              f"{tr.get('peak_bytes', 0) / 2**30:.2f} GiB over the run, "
              f"{(rec.peak_after_2 or 0) / 2**30:.2f} GiB after 2 steps",
              flush=True)
        print(f"{smi}: validations {[round(e[0], 1) for e in rec.evals]} s "
              f"(corpus encodes {[round(s, 1) for s in rec.encodes]} s, "
              f"searches {tr['search_s']} s); losses {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}", flush=True)
        ckpt = os.path.join(tmp, "train", "ckpt")
        with open(os.path.join(ckpt, "params.msgpack"), "rb") as f:
            tree = read_flax_msgpack(f.read())
        n_leaves = sum(1 for _ in _leaves(tree))
        if not all(np.isfinite(a).all() for a in _leaves(tree)):
            raise AssertionError("params.msgpack holds non-finite values")
        print(f"params.msgpack: {n_leaves} arrays decoded by "
              f"models.read_flax_msgpack", flush=True)

        rec = drive(common + ["--mode", "eval"], "eval exact")
        ev = out["eval exact"]
        if ev["launches"]["K1"] < 1 or \
                ev["launches"]["K1 split"] != ev["launches"]["K1"]:
            raise AssertionError(f"exact eval launches {ev['launches']}")
        got = _recall_precision(rec.evals[-1][1])
        if got != final:
            raise AssertionError(f"eval from the checkpoint {got} differs "
                                 f"from the final validation {final}")
        ev["err"] = check_eval_search(rec.searches[-1],
                                      rec.evals[-1][1]["_index"])
        ev["metrics"] = got
        ev["seconds"] = rec.evals[-1][0]
        print(f"{smi}: exact eval {ev['seconds']:.1f} s (corpus encode "
              f"{ev['encode_s'][0]:.1f} s, search {ev['search_s'][0]:.3f} "
              f"s); recall@5/10/100 {got['recall_at_5']:.4f} "
              f"{got['recall_at_10']:.4f} {got['recall_at_100']:.4f}",
              flush=True)
        del rec

        rec = drive(common + ["--mode", "eval", "--opts",
                              "model_config.search_mode=hierarchical"],
                    "eval hierarchical")
        eh = out["eval hierarchical"]
        lh = eh["launches"]
        if lh["K2"] + lh["K3"] < 1:
            raise AssertionError(f"hierarchical eval launches {lh}")
        eh["stage0_kernel"], eh["stage0"], eh["err"] = check_hier_eval(
            rec.searches[-1])
        eh["metrics"] = _recall_precision(rec.evals[-1][1])
        eh["seconds"] = rec.evals[-1][0]
        print(f"{smi}: hierarchical eval {eh['seconds']:.1f} s (corpus "
              f"encode {eh['encode_s'][0]:.1f} s, search "
              f"{eh['search_s'][0]:.3f} s); recall@5/10 "
              f"{eh['metrics']['recall_at_5']:.4f} "
              f"{eh['metrics']['recall_at_10']:.4f}", flush=True)
        del rec
    return out


# ---------------------------------------------------------------------------
# phase 15: PreFLMR retrieval serving (CLIP ViT-L/14 in the graph)
# ---------------------------------------------------------------------------

LQ_PREFLMR = 320      # 32 text + 32 mapping + 256 patch tokens (224 / 14)


def request_image(i):
    """Request i's own 224 x 224 x 3 image (pixel values 0-255), seeded
    by i."""
    return np.random.default_rng(10_000 + i).integers(
        0, 256, (224, 224, 3)).astype(np.float32)


def _pixels(i, item):
    return {"pixel_values": request_image(i)}


def preflmr_sweeps(maxsim, sweeps, s, q):
    """K3 and K4 at Lq=320 on the hierarchical serve's own data: stage 0
    over the searcher's int8 block summaries and stage 1 over its int8
    stage1_rows for the blocks stage 0 selects, on 32 queries the
    dispatches searched, each against its plain version (check_topk:
    tie-aware top-10, max abs 1e-3), timed beside its bound into
    sweeps["K3"] / sweeps["K4"]."""
    import torch
    from ravqa_tpu_torch.retrieval.coarse import doc_validity
    idx = s.index
    q = q[:32].contiguous()
    b, lq, dim = q.shape
    bs, nb = idx.block_size, idx.block_summaries.shape[0]
    st8, dsc = s._bsum_t, s._bsum_t_scale
    valid = torch.zeros(st8.shape[1], dtype=torch.int8, device=q.device)
    valid[:nb] = doc_validity(idx.mask).bool().reshape(nb, bs).any(dim=1)
    with torch.inference_mode():
        got = maxsim.coarse_sweep(q, st8, valid, dscale=dsc)
        want = maxsim.coarse_sweep_torch(q, st8, valid, dscale=dsc)
        torch.cuda.synchronize()
        shape = (f"preflmr serve blocks Lq={lq} S={st8.shape[0]} "
                 f"N={st8.shape[1]} ({nb} valid)")
        err = _compare(f"K3 {shape}", got, want)
        record_kernel(sweeps, "K3", shape, err,
                      lambda: maxsim.coarse_sweep(q, st8, valid, dscale=dsc),
                      lambda: maxsim.coarse_sweep_torch(q, st8, valid,
                                                        dscale=dsc),
                      bound(_nbytes(q, st8, dsc, valid, got),
                            2.0 * b * lq * st8.shape[0] * st8.shape[1] * dim,
                            "int8"))
        nbl = s.resolve_blocks(K)
        blk = torch.topk(got, nbl, dim=1).indices.clamp_max(nb - 1)
        r, rsc = s._summ_rows, s._summ_rows_scale
        got = maxsim.stage1_sweep(q, r, blk, dscale=rsc)
        want = maxsim.stage1_sweep_torch(q, r, blk, dscale=rsc)
        shape = (f"preflmr serve int8 rows Lq={lq} n_blocks={nbl} of {nb} "
                 f"x {r.shape[1]} summaries")
        err = _compare(f"K4 {shape}", got, want)
        used = torch.unique(blk).numel()
        nbytes = (_nbytes(q, blk, got) + used * r[0].numel()
                  * r.element_size() + used * bs * 4)
        record_kernel(sweeps, "K4", shape, err,
                      lambda: maxsim.stage1_sweep(q, r, blk, dscale=rsc),
                      lambda: maxsim.stage1_sweep_torch(q, r, blk,
                                                        dscale=rsc),
                      bound(nbytes, 2.0 * b * lq * nbl * r.shape[1] * bs
                            * dim, "bf16"))


def preflmr_slice(config_path, maxsim, k1, sweeps, smi):
    """One PreFLMR serve slice (phase 15): build_server on the config (the
    published ViT-L/14 and BERT-base widths, random weights from the seed,
    16,384 passages encoded on the card), three bursts of 128 requests,
    then 64 requests from 4 threads, each with its own seeded 224 x 224 x 3
    image; every answer against the plain versions' search on the query
    embeddings its dispatch searched; K1-f32 (exact) or K3 and K4
    (hierarchical) launched at least once per dispatch; the towers on the
    card against the CPU for 2 requests and 4 passages; K1-f32 at Lq=320
    against its
    plain version (kernel_shape, into k1) or K3 and K4 on the serve's own
    data (preflmr_sweeps, into sweeps); the ViT's and K1's ms per batch of
    32, peak memory. Returns the slice's numbers."""
    import torch
    f32 = torch.float32
    torch.cuda.reset_peak_memory_stats()
    data, server, index = start_server(config_path, "cuda")
    s, ex = server.searcher, server.ex
    mc = ex.model.cfg
    lq = (data["query_tokenizer"].query_maxlen + mc.prefix_len
          + mc.vit.num_patches)
    if lq != LQ_PREFLMR or server.pixel_shape != (224, 224, 3):
        raise AssertionError(f"PreFLMR query of {lq} tokens, images "
                             f"{server.pixel_shape}")
    hier = s.mode == "hierarchical"
    out = {"mode": s.mode, "preset": s.preset, "lq": lq}
    from ravqa_tpu_torch.profile_serve import bursts
    out["bursts"] = bursts(server, data, n=128)
    print(f"bursts of 128: {out['bursts']}", flush=True)
    record = record_searches(server)
    wrappers = ([maxsim.coarse_sweep_int8, maxsim.stage1_sweep] if hier
                else [maxsim.maxsim_search])
    maxsim.maxsim_search.split_launches = 0
    reqs, scores, pids, launches, dispatches = drive_requests(
        server, data, index, wrappers, vision=_pixels)
    if dispatches == 0 or min(launches) < dispatches:
        raise AssertionError(f"{[w.__name__ for w in wrappers]} launched "
                             f"{launches} times for {dispatches} dispatches")
    if not hier and maxsim.maxsim_search.split_launches != launches[0]:
        raise AssertionError("K1 left the float32 index's split route")
    out["launches"] = dict(zip(("K3", "K4") if hier else ("K1-f32",),
                               launches))
    out["dispatches"] = dispatches
    q, _, out["serve_err"] = check_served(server, index, record, scores,
                                          pids)
    out["tower_err"] = check_towers(ex, data, reqs[:2],
                                    [request_image(i) for i in range(2)])
    px = torch.as_tensor(np.stack([request_image(i) for i in range(32)]),
                         device="cuda")
    with torch.inference_mode():
        out["vit_ms"] = time_ms(lambda: ex.model.vision_model(px), iters=5)
        q_all = ex.encode_query(*data["query_tokenizer"].tensorize(
            [r["question"] for r in reqs[:32]]), pixel_values=px)
        out["encode_ms"] = time_ms(lambda: ex.encode_query(
            *data["query_tokenizer"].tensorize(
                [r["question"] for r in reqs[:32]]), pixel_values=px),
            iters=5)
        out["search_ms"] = time_ms(lambda: s.search_device(q_all, K),
                                   iters=5)
    print(f"ms per batch of 32: ViT-L {out['vit_ms']:.2f}, the whole query "
          f"tower {out['encode_ms']:.2f}, the search {out['search_ms']:.2f}",
          flush=True)
    if hier:
        preflmr_sweeps(maxsim, sweeps, s, q)
    else:
        planes = index.token_planes()
        qb = q[:32].contiguous()
        out["k1_ms"] = time_ms(lambda: maxsim.maxsim_search(
            qb, index.tokens, index.mask, planes=planes))
        print(f"K1-f32 on the served index and queries (B=32, Lq={lq}): "
              f"{out['k1_ms']:.2f} ms", flush=True)
        kernel_shape(k1, "K1-f32",
                     f"preflmr serve f32 B=32 Lq={lq} N=16387 Ld=220",
                     32, lq, 16387, 220, 128, f32, f32, maxsim)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"peak max_memory_allocated {out['peak_bytes'] / 2**30:.2f} GiB "
          f"({smi})", flush=True)
    del server, index, q, px
    return out


# ---------------------------------------------------------------------------
# phase 16: RAVQA-v2 answer serving (BLIP-2 Flan-T5-XL over FLMR retrieval)
# ---------------------------------------------------------------------------

def record_dispatches(server):
    """Keep each dispatch's search (q, scores, rows) and generate output,
    in dispatch order: wraps the executor's searcher.search_device and
    generate until the returned undo() is called."""
    ex = server.ex
    s = ex.searcher
    search, generate = s.search_device, ex.generate
    searches, outputs = [], []

    def recording_search(q, k):
        scores, rows = search(q, k)
        searches.append((q, scores, rows))
        return scores, rows

    def recording_generate(batch):
        out = generate(batch)
        outputs.append(out)
        return out

    s.search_device, ex.generate = recording_search, recording_generate

    def undo():
        del s.search_device, ex.generate
    return searches, outputs, undo


def drive_vqa(server, data, n=16, clients=4, bursts=3, burst=8):
    """n requests from `clients` closed-loop threads, then `bursts` bursts
    of `burst` requests submitted at once; request i carries
    profile_serve.vqa_request's seeded features and the i-th item's image
    (seeded 224 x 224). Returns (results, latencies of the closed loop,
    questions/s of each burst)."""
    from ravqa_tpu_torch.profile_serve import vqa_request
    items = data["train"].items + data["test"].items
    total = n + bursts * burst
    reqs = [(items[i % len(items)]["question"],
             vqa_request(i, items[i % len(items)], server))
            for i in range(total)]
    results = [None] * total
    lat = [0.0] * n

    def client(ids):
        for i in ids:
            t = time.perf_counter()
            results[i] = server.submit(reqs[i][0], **reqs[i][1]).result(600)
            lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=client, args=(range(c, n, clients),))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if any(t.is_alive() for t in threads):
        raise AssertionError("the closed-loop clients did not finish")
    rates = []
    for k in range(bursts):
        ids = range(n + k * burst, n + (k + 1) * burst)
        t0 = time.perf_counter()
        futs = [server.submit(reqs[i][0], **reqs[i][1]) for i in ids]
        for i, f in zip(ids, futs):
            results[i] = f.result(600)
        rates.append(burst / (time.perf_counter() - t0))
    return results, lat, rates


def check_rag_retrieval(ex, searches, outputs):
    """Each dispatch's rows against the same search by the plain versions
    on a CPU copy of the index, on the query embeddings the dispatch
    searched (tie-aware top-5, 1e-3); generate's doc_scores against the
    searcher's scores of those rows (1e-3). Returns (max |score error| of
    the search, of doc_scores)."""
    import torch
    from ravqa_tpu_torch.retrieval import LateInteractionSearcher
    s = ex.searcher
    if len(searches) != len(outputs):
        raise AssertionError(f"{len(searches)} searches for "
                             f"{len(outputs)} dispatches")
    cpu = LateInteractionSearcher(cpu_copy(ex.index), use_pallas=True,
                                  mode=s.mode, preset=s.preset)
    search_err = doc_err = 0.0
    t0 = time.perf_counter()
    for (q, scores, rows), out in zip(searches, outputs):
        got_s, got_r = scores.cpu().numpy(), rows.cpu().numpy()
        want_s, want_r = (t.numpy() for t in
                          cpu.search_device(q.cpu(), ex.rag_cfg.n_docs))
        bad = [i for i in range(len(q)) if not _tie_aware(
            got_r[i], got_s[i], want_r[i], want_s[i], ATOL)]
        if bad:
            raise AssertionError(f"retrieved rows disagree with the plain "
                                 f"search on queries {bad}")
        search_err = max(search_err, float(np.abs(got_s - want_s).max()))
        doc_err = max(doc_err, float(np.abs(out["doc_scores"]
                                            - got_s).max()))
    print(f"retrieval: {len(searches)} dispatches' rows vs the plain "
          f"search of a CPU copy ({time.perf_counter() - t0:.1f} s): max"
          f"|score err| {search_err:.3g}; generate's doc_scores vs the "
          f"searcher's: max|err| {doc_err:.3g}", flush=True)
    if doc_err > ATOL:
        raise AssertionError(f"doc_scores disagree with the search: "
                             f"{doc_err}")
    return search_err, doc_err


# the random generator's T5 encoder is ill-conditioned in float32: 24
# self-attention layers without 1/sqrt(d_kv) over lecun-normal weights
# (attention logits of std ~8) grow a rounding difference about 1.3x a
# layer. Against a float64 run on the CPU, float32 on an H100 and float32 on
# the CPU both sit ~1e-3 off on the encoder output and ~1.5e-2 on the first
# logits, and neither gives float64's beam tokens, so the two float32 runs
# differ by as much (1.7e-3, 2.1e-2) however right each is. The check holds
# every layer of the full model to its CPU twin on the card's own inputs,
# runs end to end a copy with the T5 stacks cut to their first
# RAG_CUT_LAYERS layers (at 4 + 4 the first logits differ by 7.6e-5 of
# their largest magnitude), and holds the full model on the card to no
# farther from float64 than F64_FACTOR times the CPU's float32 (1.4x on the
# encoder output, 0.95x on the logits, measured on an H100).
RAG_CUT_LAYERS = 4
GEN_RTOL = 1e-4
F64_FACTOR = 2.0


def _to_cpu(x):
    """A copy of x on the CPU: tensors, and tuples, lists and dicts of
    them."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _gen_layers(gen):
    """The generator's layers by name: the vision tower and the Q-Former
    whole (float32 runs of them agree to ~1e-6), the projection, every T5
    encoder and decoder block, each decoder layer's cross-attention key and
    value projections (T5Model.cross_kv calls them outside the blocks), the
    final norms and the LM head."""
    lm = gen.language_model
    layers = {"vision_model": gen.vision_model, "qformer": gen.qformer,
              "language_projection": gen.language_projection,
              "encoder_final_ln": lm.encoder_final_ln,
              "decoder_final_ln": lm.decoder_final_ln,
              "lm_head": lm.lm_head}
    for stack in ("encoder", "decoder"):
        for i, blk in enumerate(getattr(lm, stack)):
            layers[f"{stack}.{i}"] = blk
    for i, blk in enumerate(lm.decoder):
        layers[f"decoder.{i}.cross_k"] = blk.cross_attn.k
        layers[f"decoder.{i}.cross_v"] = blk.cross_attn.v
    return {k: m for k, m in layers.items() if m is not None}


def _stage_outputs(model, run):
    """run() with the vision tower, the Q-Former and each T5 encoder block
    recording the output of its first call. Returns {name: output} on the
    CPU in float64."""
    import torch
    mods = {"vision_model": model.vision_model, "qformer": model.qformer}
    mods.update((f"encoder.{i}", blk)
                for i, blk in enumerate(model.language_model.encoder))
    seen = {}

    def keep(name, out):
        if name not in seen:
            seen[name] = _first(out).detach().to("cpu", torch.float64)

    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: keep(name, out))
        for name, m in mods.items()]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return seen


def layers_vs_cpu(gen, run):
    """run() on the card with every layer of _gen_layers recording the
    inputs and output of its first call; each layer's CPU copy then runs on
    those inputs. Returns {layer: |card - CPU| / max |card|}."""
    import copy
    import torch
    records = {}

    def record(mod, args, kwargs, out, name):
        if name not in records:
            records[name] = (_to_cpu(args), _to_cpu(kwargs),
                             _to_cpu(_first(out)))

    hooks = [m.register_forward_hook(
        lambda mod, args, kwargs, out, name=name: record(mod, args, kwargs,
                                                         out, name),
        with_kwargs=True) for name, m in _gen_layers(gen).items()]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    layers = _gen_layers(gen)
    errs = {}
    for name, (args, kwargs, want) in records.items():
        cpu = copy.deepcopy(layers[name]).cpu()
        got = _first(cpu(*args, **kwargs))
        del cpu
        if not torch.isfinite(want).all():
            raise AssertionError(f"{name} gave non-finite values")
        errs[name] = ((got - want).abs().max() / want.abs().max()).item()
    if len(errs) != len(layers):
        raise AssertionError(f"{len(layers) - len(errs)} layers never ran")
    return errs


def _one_sequence(model, dev, px, gi, gm, cfg, gcfg):
    """encode, the first decode step and the beam search of one (question,
    passage) sequence. Returns (encoder output, first logits, beams,
    scores), on the CPU."""
    import torch
    from ravqa_tpu_torch.models.generation import beam_generate
    enc, m = model.encode(torch.as_tensor(px, device=dev),
                          torch.as_tensor(gi, dtype=torch.long, device=dev),
                          torch.as_tensor(gm, device=dev))
    kv = model.cross_kv(enc)
    start = torch.full((1, 1), gcfg.decoder_start_token_id,
                       dtype=torch.long, device=dev)
    logits, _ = model.decode_step(start, kv, m, model.init_cache(1, 1))
    seqs, scores = beam_generate(
        lambda tok, cache: model.decode_step(tok, kv, m, cache),
        lambda n: model.init_cache(n, cfg.max_decode_len), 1, cfg.num_beams,
        cfg.max_decode_len, gcfg.decoder_start_token_id, gcfg.eos_token_id,
        gcfg.pad_token_id)
    return [t.cpu() for t in (enc, logits, seqs, scores)]


def generator_vs_cpu(ex, server, question, features, image):
    """One (question, passage) sequence, float32 with TF32 off: (1) every
    layer of the full-depth generator on the card against its CPU copy on
    the card's own inputs (the encode, the cross-attention keys and values
    and the first decode step; within 1e-4 of each output's largest
    magnitude); (2) a copy with the same widths, the full vision tower and
    Q-Former and the T5 stacks cut to their first RAG_CUT_LAYERS layers
    (the card's own weights), on the card and on the CPU: its encoder
    output and first logits within 1e-4 of the largest magnitude, its beam
    search's tokens identical; (3) the full model end to end in float32 on
    the card and on the CPU, each against a float64 run on the CPU: the
    vision tower's, the Q-Former's and every T5 encoder layer's output, the
    encoder output, the first logits and the beam tokens (the conditioning,
    above); the card's vision tower and Q-Former within 1e-4 of float64, its
    encoder output and first logits no farther from float64 than F64_FACTOR
    times the CPU's float32 plus 1e-4. Returns the errors."""
    import dataclasses as dc
    import torch
    from ravqa_tpu_torch.models.blip2 import Blip2T5
    gen = ex.model.generator
    cfg, gcfg = ex.rag_cfg, gen.cfg.t5
    cpu = torch.device("cpu")
    ids, mask = server.qt.tensorize([question])
    batch = server.gen_batch([(question, np.asarray(ids)[0],
                               np.asarray(mask)[0], features, image, None)])
    t0 = time.perf_counter()
    out, full, stages = {}, {}, {}

    def copy_of(gen_cfg, dev, dtype):
        m = Blip2T5(gen_cfg, device="meta")
        keep = m.state_dict().keys()
        m.load_state_dict({k: v.to(dev, dtype) if v.is_floating_point()
                           else v.to(dev)
                           for k, v in gen.state_dict().items() if k in keep},
                          assign=True)
        return m

    with torch.inference_mode():
        ret = ex.retrieve(batch)
        text = ex.input_builder.build([question], ret["contents"])[:1]
        gi, gm = ex._tensorize(text, cfg.gen_maxlen)
        px = image[None]

        def traced(model, dev, key):
            def run():
                full[key] = _one_sequence(model, dev, px, gi, gm, cfg, gcfg)
            stages[key] = _stage_outputs(model, run)

        errs = layers_vs_cpu(gen, lambda: traced(gen, ex.device, "card"))
        worst = max(errs, key=errs.get)
        kv_worst = max(v for k, v in errs.items() if k.endswith(
            ("cross_k", "cross_v")))
        out["layer_rel_err"] = errs[worst]
        print(f"every layer of the full generator ({len(errs)} layers, the "
              f"encode, the cross-attention keys and values and the first "
              f"decode step) on the card vs its CPU copy on the card's "
              f"inputs: max {errs[worst]:.3g} of the largest magnitude "
              f"({worst}); vision tower {errs['vision_model']:.3g}, Q-Former "
              f"{errs['qformer']:.3g}, cross-attention K/V {kv_worst:.3g}, "
              f"LM head {errs['lm_head']:.3g}", flush=True)
        if errs[worst] > GEN_RTOL:
            raise AssertionError(f"layer {worst} disagrees with its CPU run: "
                                 f"{errs[worst]}")
        cut_cfg = dc.replace(gen.cfg, t5=dc.replace(
            gcfg, num_layers=RAG_CUT_LAYERS,
            num_decoder_layers=RAG_CUT_LAYERS))
        cut = {}
        for name, dev in (("card", ex.device), ("cpu", cpu)):
            m = copy_of(cut_cfg, dev, torch.float32)
            cut[name] = _one_sequence(m, dev, px, gi, gm, cfg, gcfg)
            del m
        t_ref = time.perf_counter()
        for key, dtype in (("cpu", torch.float32), ("float64", torch.float64)):
            m = copy_of(gen.cfg, cpu, dtype)
            traced(m, cpu, key)
            del m
        t_ref = time.perf_counter() - t_ref

    def rel(a, b):
        a, b = a.double(), b.double()
        return ((a - b).abs().max() / b.abs().max()).item()

    (enc_d, log_d, seq_d, sc_d), (enc_c, log_c, seq_c, sc_c) = \
        cut["card"], cut["cpu"]
    for t in (enc_d, log_d, sc_d, *full["card"]):
        if not torch.isfinite(t.float()).all():
            raise AssertionError("the generator gave non-finite values")
    out.update(cut_enc_rel_err=rel(enc_d, enc_c),
               cut_logits_rel_err=rel(log_d, log_c),
               cut_beam_tokens_equal=bool(torch.equal(seq_d, seq_c)),
               cut_beam_lp_err=(sc_d - sc_c).abs().max().item(),
               full_enc_rel_err=rel(full["card"][0], full["cpu"][0]),
               full_logits_rel_err=rel(full["card"][1], full["cpu"][1]),
               full_beam_tokens_equal=bool(torch.equal(full["card"][2],
                                                       full["cpu"][2])))
    print(f"the generator with its T5 stacks cut to {RAG_CUT_LAYERS} + "
          f"{RAG_CUT_LAYERS} layers (ViT-g {gen.cfg.vision.num_layers}, "
          f"Q-Former {gen.cfg.qformer.num_layers}; the card's own weights), "
          f"one sequence of {gen.cfg.num_query_tokens} + "
          f"{cfg.gen_maxlen} tokens, card vs CPU: encoder output "
          f"{out['cut_enc_rel_err']:.3g}, first logits "
          f"{out['cut_logits_rel_err']:.3g} of the largest magnitude, beam "
          f"tokens identical: {out['cut_beam_tokens_equal']} (log-probs "
          f"{out['cut_beam_lp_err']:.3g} apart). The full model end to end, "
          f"card vs CPU: encoder output {out['full_enc_rel_err']:.3g}, "
          f"first logits {out['full_logits_rel_err']:.3g}, beam tokens "
          f"identical: {out['full_beam_tokens_equal']}", flush=True)
    ref, n_enc = full["float64"], gcfg.num_layers
    vs64 = {}
    for key, where in (("card", "the card"), ("cpu", "the CPU")):
        e = {name: rel(got, stages["float64"][name])
             for name, got in stages[key].items()}
        e.update(encoder_output=rel(full[key][0], ref[0]),
                 first_logits=rel(full[key][1], ref[1]),
                 beam_tokens_equal=bool(torch.equal(full[key][2], ref[2])),
                 growth_per_layer=(e[f"encoder.{n_enc - 1}"]
                                   / e["encoder.0"]) ** (1 / (n_enc - 1)))
        vs64[key] = e
        print(f"the full model in float32 on {where} vs float64 on the CPU, "
              f"of the largest magnitude: ViT-g {e['vision_model']:.3g}, "
              f"Q-Former {e['qformer']:.3g}, T5 encoder layer "
              + ", ".join(f"{i + 1} {e[f'encoder.{i}']:.3g}"
                          for i in range(n_enc))
              + f" ({e['growth_per_layer']:.3g}x a layer); encoder output "
              f"{e['encoder_output']:.3g}, first logits "
              f"{e['first_logits']:.3g}; beam tokens equal to float64's: "
              f"{e['beam_tokens_equal']}", flush=True)
    out["vs_float64"] = vs64
    print(f"the CPU's float32 and float64 runs {t_ref:.1f} s; the check "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    card64, cpu64 = vs64["card"], vs64["cpu"]
    for name in ("vision_model", "qformer"):
        if card64[name] > GEN_RTOL:
            raise AssertionError(f"{name} on the card is {card64[name]} from "
                                 f"float64")
    for name in ("encoder_output", "first_logits"):
        if card64[name] > F64_FACTOR * cpu64[name] + GEN_RTOL:
            raise AssertionError(
                f"the full model's {name} on the card is {card64[name]} from "
                f"float64, the CPU's float32 {cpu64[name]}")
    if not (out["cut_enc_rel_err"] <= GEN_RTOL
            and out["cut_logits_rel_err"] <= GEN_RTOL
            and out["cut_beam_tokens_equal"]):
        raise AssertionError("the cut generator on the card disagrees with "
                             "its CPU run")
    return out


def rag_serve_slice(maxsim, k1, smi):
    """The RAVQA-v2 answer serve (phase 16). Returns the phase's numbers
    (launches of K1-f32 under "launches")."""
    import torch
    from ravqa_tpu_torch.main import build_pipeline, build_server, load_config
    from ravqa_tpu_torch.profile_serve import vqa_request, vqa_stages
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = load_config(RAG_CONFIG)
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    server = build_server(cfg, data, "cuda")
    ex = server.ex
    gen = ex.model.generator
    gc, rc = gen.cfg, ex.rag_cfg
    widths = (gc.vision.hidden_size, gc.vision.num_layers,
              gc.qformer.num_layers, gc.num_query_tokens, gc.t5.d_model,
              gc.t5.num_layers, gc.t5.n_dec, gc.t5.d_ff, gc.t5.vocab_size,
              gc.t5.tie_word_embeddings, rc.n_docs, rc.num_beams,
              rc.gen_maxlen, rc.max_decode_len, rc.lora_rank)
    if widths != (1408, 39, 12, 32, 2048, 24, 24, 5120, 32128, False, 5, 5,
                  512, 10, 8) or ex.lora is not None \
            or server.pixel_shape != (224, 224, 3) \
            or ex.searcher.mode != "exact":
        raise AssertionError(f"the RAG serve is not the published recipe: "
                             f"{widths}")
    n_params = sum(p.numel() for p in gen.parameters())
    print(f"set-up {time.perf_counter() - t_phase:.1f} s: generator "
          f"{n_params / 1e9:.3f}e9 parameters on {next(gen.parameters()).device}"
          f", {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    out = {"generator_params": n_params}
    searches, outputs, undo = record_dispatches(server)
    maxsim.maxsim_search.launches = 0
    maxsim.maxsim_search.split_launches = 0
    d0 = server.dispatches
    try:
        results, lat, rates = drive_vqa(server, data)
        launches = maxsim.maxsim_search.launches
        split = maxsim.maxsim_search.split_launches
        dispatches = server.dispatches - d0
    finally:
        undo()
    print(f"{len(results)} questions in {dispatches} dispatches: closed loop "
          f"p50 {np.percentile(lat, 50) * 1e3:.1f} ms, p95 "
          f"{np.percentile(lat, 95) * 1e3:.1f} ms; bursts of 8 "
          f"{', '.join(f'{r:.3f}' for r in rates)} questions/s; K1-f32 "
          f"launches {launches} ({split} on the split route)", flush=True)
    if dispatches == 0 or launches != dispatches or split != launches:
        raise AssertionError(f"K1-f32 launched {launches} times ({split} "
                             f"split) for {dispatches} dispatches")
    for r in results:
        if not (isinstance(r.answer, str) and r.doc_scores.shape == (5,)
                and np.isfinite(r.doc_scores).all()
                and len(r.passages) == 5):
            raise AssertionError(f"a malformed answer: {r}")
    out.update(launches={"K1-f32": launches}, dispatches=dispatches,
               p50_ms=float(np.percentile(lat, 50) * 1e3),
               p95_ms=float(np.percentile(lat, 95) * 1e3),
               questions_per_s=rates,
               answers=[r.answer for r in results[:4]])
    out["search_err"], out["doc_scores_err"] = check_rag_retrieval(
        ex, searches, outputs)
    item = data["train"].items[0]
    req = vqa_request(0, item, server)
    out["generator_vs_cpu"] = generator_vs_cpu(
        ex, server, item["question"], req["image_features"],
        req["pixel_values"])
    stages, rows = vqa_stages(server, data, 8)
    with torch.inference_mode():
        batch = server.gen_batch(rows)
        ret = ex.retrieve(batch)
        gi, gm = ex._tensorize(ex.input_builder.build(batch["questions"],
                                                      ret["contents"]),
                               rc.gen_maxlen)
        enc, m = ex.encode_generator(gi, gm, batch["pixel_values"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cached = ex.decode(gen.cross_kv(enc), m)
        torch.cuda.synchronize()
        t_cached = time.perf_counter() - t0
        t0 = time.perf_counter()
        recomputed = ex.decode(enc, m)
        torch.cuda.synchronize()
        t_rec = time.perf_counter() - t0
        same = torch.equal(cached[0], recomputed[0])
        lp_err = (cached[1] - recomputed[1]).abs().max().item()
        print(f"decode of one dispatch ({enc.shape[0]} sequences x "
              f"{rc.num_beams} beams): cross-attention keys and values "
              f"cached {t_cached * 1e3:.1f} ms vs projected every step "
              f"{t_rec * 1e3:.1f} ms (the beams' rows grouped); tokens "
              f"identical: {same}, log-probs {lp_err:.3g} apart", flush=True)
        if not same or lp_err > 1e-4 or not torch.isfinite(cached[1]).all():
            raise AssertionError("cached cross-attention K/V disagree with "
                                 "K/V projected every step")
        out["kv_cache_lp_err"] = lp_err
        split_ms = {name: time_ms(fn, iters=3, warmup=1)
                    for name, fn in stages.items()}
        out["whole_generate_ms"] = time_ms(lambda: ex.generate(batch),
                                           iters=3, warmup=1)
    out["dispatch_split_ms"] = split_ms
    print(f"dispatch of 8 questions, ms by stage (CUDA events): "
          + ", ".join(f"{n} {v:.2f}" for n, v in split_ms.items())
          + f"; the whole generate {out['whole_generate_ms']:.1f}",
          flush=True)
    kernel_shape(k1, "K1-f32", "rag serve f32 B=8 Lq=64 N=16387 Ld=220",
                 8, 64, 16387, 220, 128, torch.float32, torch.float32,
                 maxsim)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"peak max_memory_allocated {out['peak_bytes'] / 2**30:.2f} GiB; "
          f"phase {out['seconds']:.1f} s ({smi})", flush=True)
    server.stop()
    del server, ex, gen, enc, searches, outputs
    return out


# ---------------------------------------------------------------------------
# phase 17: RAVQA-v2 joint training and answer evaluation
# ---------------------------------------------------------------------------

def record_rag_searches(ex):
    """Keep each live retrieval's (query embeddings, scores, rows): wraps
    the executor's searcher.search_device until the returned undo() is
    called (refresh_index replaces the searcher: record again after it)."""
    s = ex.searcher
    search = s.search_device
    searches = []

    def recording(q, k):
        scores, rows = search(q, k)
        searches.append((q.detach(), scores, rows))
        return scores, rows

    s.search_device = recording

    def undo():
        del s.search_device
    return searches, undo


def check_rows(searches, index, k, n_cpu=8):
    """Each recorded search's rows against the plain MaxSim of the same
    query embeddings over the same index (tie-aware top-k, 1e-3): every
    query on the card's plain version, the first n_cpu on a CPU copy.
    Returns (max |score error|, seconds of the CPU search)."""
    import torch
    from ravqa_tpu_torch.ops import maxsim
    q = torch.cat([x[0] for x in searches])
    scores = torch.cat([x[1] for x in searches]).cpu().numpy()
    rows = torch.cat([x[2] for x in searches]).cpu().numpy()
    with torch.inference_mode():
        dv, dr = (t.cpu().numpy() for t in torch.topk(
            maxsim.maxsim_search_torch(q, index.tokens, index.mask), k,
            dim=1))
        cpu = cpu_copy(index)
        t0 = time.perf_counter()
        wv, wr = (t.numpy() for t in torch.topk(maxsim.maxsim_search_torch(
            q[:n_cpu].cpu(), cpu.tokens, cpu.mask), k, dim=1))
        t_cpu = time.perf_counter() - t0
    bad = [i for i in range(len(q))
           if not _tie_aware(rows[i], scores[i], dr[i], dv[i], ATOL)]
    bad += [i for i in range(min(n_cpu, len(q)))
            if not _tie_aware(rows[i], scores[i], wr[i], wv[i], ATOL)]
    if bad:
        raise AssertionError(f"retrieved rows disagree with the plain search "
                             f"on queries {sorted(set(bad))}")
    err = max(float(np.abs(scores - dv).max()),
              float(np.abs(scores[:n_cpu] - wv).max()))
    return err, t_cpu


def _cut_executor(ex, gen_cfg, device, seed, weights=True, **rag):
    """A RagExecutor on `device` over a copy of ex's retriever and a
    generator of gen_cfg (the full model's own weights where they exist,
    shared with it on the card; with weights=False a fresh random draw),
    ex's index and corpus, rag_cfg with the changes `rag`, and
    accumulation 1."""
    import copy
    import torch
    from ravqa_tpu_torch.executors import RagExecutor
    from ravqa_tpu_torch.models.blip2 import Blip2T5
    gen = Blip2T5(gen_cfg, device="meta")
    if weights:
        keep = gen.state_dict().keys()
        gen.load_state_dict({k: v.to(device) for k, v in
                             ex.model.generator.state_dict().items()
                             if k in keep}, assign=True)
    else:
        gen = gen.to_empty(device=device)
        gen.reset_parameters(torch.Generator(device=device).manual_seed(
            seed + 7))
    retriever = copy.deepcopy(ex.model.retriever).to(device)
    index = ex.index if torch.device(device) == ex.device else None
    return RagExecutor(
        retriever, gen, ex.gen_tokenizer,
        dataclasses.replace(ex.rag_cfg, **rag),
        train_cfg=dataclasses.replace(ex.train_cfg, accumulate_grad_batches=1,
                                      modules=tuple(
                                          m for m in ex.train_cfg.modules
                                          if m != "freeze_generator_base")),
        query_tokenizer=ex.query_tokenizer, index=index,
        passage_contents=ex.passage_contents, passage_ids=ex.passage_ids,
        device=device, seed=seed, quiet=True)


def _to_device(batch, device):
    import torch
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def rag_train_vs_cpu(ex, raw2):
    """Phase 17 (c): the generator with its T5 stacks cut to RAG_CUT_LAYERS
    + RAG_CUT_LAYERS layers (ViT-g and Q-Former whole, every width full),
    rag and additional loss weights 1, from the same weights: float32 on
    the card, float32 on the CPU, and a CPU reference with the generator
    and the LoRA in float64 (the retriever float32). A micro-batch of 2
    questions (retrieved on the card), one train_step each. Gates: the
    loss and its parts, card vs CPU rtol 1e-4; the AdamW update, card vs
    CPU (update_agreement); the retriever's backward for one upstream
    gradient of the doc scores, card vs CPU (phase 13's GRAD_RTOL); the
    step's worst LoRA grad, its worst retriever grad (which carries the
    generator's rounding through the doc scores) and the grad norm: the
    card no farther from the float64 run than F64_FACTOR times the CPU's
    float32 plus GRAD_RTOL (the random model's conditioning parts two
    float32 runs, as in phase 16); the second step's loss on the
    card's updated parameters, card vs CPU rtol 1e-4 (each run's own
    update moves the coordinates whose grads are below float32's rounding
    by about lr in a direction the rounding picks, so the three runs'
    second losses are printed, not held to each other); remat on and off
    on the card (loss rtol 1e-5, grads 1e-5 of the largest). Returns the
    errors and the trained card executor."""
    import torch
    gen_cfg = ex.model.generator.cfg
    cut_cfg = dataclasses.replace(gen_cfg, t5=dataclasses.replace(
        gen_cfg.t5, num_layers=RAG_CUT_LAYERS,
        num_decoder_layers=RAG_CUT_LAYERS))
    weights = dict(rag_weight=1.0, additional_weight=1.0)
    card = _cut_executor(ex, cut_cfg, "cuda", 11, **weights)
    cpu = _cut_executor(ex, cut_cfg, "cpu", 11, **weights)
    ref = _cut_executor(ex, cut_cfg, "cpu", 11, **weights)
    ref.model.generator.double()
    ref.model.lora.double()
    batch = card.make_train_batch(next(raw2))
    on_cpu = _to_device(batch, "cpu")
    out = {"sequences": int(batch["gen_input_ids"].shape[0])}
    # remat on and off on the card, on the same batch and weights
    lm = card.model.generator.language_model
    remat = {}
    for on in (True, False):
        lm.cfg = dataclasses.replace(lm.cfg, remat=on)
        card.model.zero_grad(set_to_none=True)
        loss, _ = card.loss_fn(batch)
        loss.backward()
        remat[on] = (loss.item(), {n: p.grad.clone() for n, p in
                                   card.model.named_parameters()
                                   if p.grad is not None})
    lm.cfg = dataclasses.replace(lm.cfg, remat=True)
    card.model.zero_grad(set_to_none=True)
    largest = max(g.abs().max().item() for g in remat[False][1].values())
    out["remat_loss_rel_err"] = abs(remat[True][0] - remat[False][0]) / abs(
        remat[False][0])
    out["remat_grad_rel_err"] = max(
        (remat[True][1][n] - g).abs().max().item()
        for n, g in remat[False][1].items()) / largest
    del remat
    # the retriever's backward alone: the paired doc scores' grads for one
    # upstream gradient, card vs CPU (phase 13's GRAD_RTOL)
    g_up = torch.from_numpy(np.random.default_rng(3).normal(
        size=tuple(batch["doc_tokens"].shape[:2])).astype(np.float32))
    for e, b in ((card, batch), (cpu, on_cpu)):
        e.model.zero_grad(set_to_none=True)
        ds = e.doc_scores(b, b["doc_tokens"], b["doc_masks"])
        ds.backward(g_up.to(ds.device))
    r_err, r_name, _ = grad_agreement(card.model.retriever,
                                      cpu.model.retriever)
    card.model.zero_grad(set_to_none=True)
    cpu.model.zero_grad(set_to_none=True)
    before = {n: p.detach().clone() for n, p in cpu.model.named_parameters()
              if p.requires_grad}
    t0 = time.perf_counter()
    m = card.train_step(batch)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_cpu = cpu.train_step(on_cpu)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_ref = ref.train_step(on_cpu)
    t_ref = time.perf_counter() - t0
    for key in ("loss", "nll_loss", "rag_loss", "additional_loss"):
        a, b = float(m[key]), float(m_cpu[key])
        if not np.isfinite(a):
            raise AssertionError(f"a non-finite {key} on the card: {a}")
        out[f"{key}_rel_err"] = abs(a - b) / max(abs(b), 1e-30)
    tc = card.train_cfg
    worst, moved, n_sig, _, _ = update_agreement(
        card.model, cpu.model, before,
        lambda n: tc.retriever_lr if n.startswith("retriever.") else tc.lr)
    # the step's grads against the float64 run, the worst of each part:
    # the retriever's carry the generator's rounding through the doc
    # scores' upstream gradient
    vs64 = {}
    for part in ("lora", "retriever"):
        e_card = grad_errors(card.model.get_submodule(part),
                              ref.model.get_submodule(part))
        e_cpu = grad_errors(cpu.model.get_submodule(part),
                             ref.model.get_submodule(part))
        worst_n = max(e_card, key=e_card.get)
        vs64[part] = {"card": e_card[worst_n], "param": worst_n,
                      "cpu_same_param": e_cpu[worst_n],
                      "cpu": max(e_cpu.values())}
    norm = {k: float(v["grad_norm"]) for k, v in
            (("card", m), ("cpu", m_cpu), ("ref", m_ref))}
    with torch.no_grad():
        l2 = {"card": float(card.loss_fn(batch)[0]),
              "cpu": float(cpu.loss_fn(on_cpu)[0]),
              "ref": float(ref.loss_fn(on_cpu)[0])}
        # the card's updated parameters, run on the CPU
        trained = dict(card.model.named_parameters())
        for n, p in cpu.model.named_parameters():
            if p.requires_grad:
                p.copy_(trained[n])
        l2_same = abs(l2["card"] - float(cpu.loss_fn(on_cpu)[0])) / abs(
            l2["card"])

    def vs_ref(d):
        return {k: abs(d[k] - d["ref"]) / abs(d["ref"])
                for k in ("card", "cpu")}
    norm_err, l2_err = vs_ref(norm), vs_ref(l2)
    out.update(grad_rel_err_vs_f64=vs64,
               retriever_backward_rel_err=r_err,
               retriever_backward_worst=r_name,
               grad_norm_rel_err_vs_f64=norm_err,
               step2_loss_rel_err_vs_f64=l2_err,
               step2_loss_rel_err_same_params=l2_same, update_err_lr=worst,
               update_least_move_lr=moved, update_coords=n_sig,
               card_step_s=t_card, cpu_step_s=t_cpu, f64_step_s=t_ref)
    print(f"the generator with its T5 stacks cut to {RAG_CUT_LAYERS} + "
          f"{RAG_CUT_LAYERS} (ViT-g, Q-Former whole), rag and additional "
          f"weights 1, a micro-batch of {out['sequences']} sequences, card vs "
          f"CPU: loss {float(m['loss']):.6f} vs {float(m_cpu['loss']):.6f}; "
          f"rel err loss {out['loss_rel_err']:.3g}, nll "
          f"{out['nll_loss_rel_err']:.3g}, rag {out['rag_loss_rel_err']:.3g}"
          f", additional {out['additional_loss_rel_err']:.3g}; the AdamW "
          f"update on {n_sig} coordinates: max past 2 ulp {worst:.3g} lr "
          f"(each moved >= {moved:.3g} lr); the retriever's backward for "
          f"one upstream gradient, card vs CPU {r_err:.3g} ({r_name}). "
          f"Against the float64 run, card / CPU float32: " + "; ".join(
              f"worst {k} grad {v['card']:.3g} ({v['param']}; "
              f"{v['cpu_same_param']:.3g} on the CPU) / {v['cpu']:.3g}"
              for k, v in vs64.items()) + f"; grad norm "
          f"{norm_err['card']:.3g} / {norm_err['cpu']:.3g}; the second "
          f"step's loss after each run's own update {l2_err['card']:.3g} / "
          f"{l2_err['cpu']:.3g} ({l2['card']:.6f}, {l2['cpu']:.6f}, float64 "
          f"{l2['ref']:.6f}), on the card's updated parameters card vs CPU "
          f"{l2_same:.3g}; "
          f"remat on vs off: loss {out['remat_loss_rel_err']:.3g} apart "
          f"(relative), grads {out['remat_grad_rel_err']:.3g} of the "
          f"largest; train_step {t_card:.2f} s on the card, {t_cpu:.1f} s "
          f"on the CPU, {t_ref:.1f} s in float64", flush=True)
    gates = {
        "loss and parts": all(out[f"{k}_rel_err"] <= 1e-4 for k in (
            "loss", "nll_loss", "rag_loss", "additional_loss")),
        "update": n_sig > 0 and worst <= 1e-3,
        "retriever backward": r_err <= GRAD_RTOL,
        "grads vs float64": all(v["card"] <= F64_FACTOR * v["cpu"]
                                + GRAD_RTOL for v in vs64.values()),
        "grad norm": norm_err["card"] <= F64_FACTOR * norm_err["cpu"] + 1e-4,
        "second step's loss": l2_same <= 1e-4,
        "remat": out["remat_loss_rel_err"] <= 1e-5
        and out["remat_grad_rel_err"] <= 1e-5}
    if not all(gates.values()):
        raise AssertionError(f"RAG training on the card disagrees with the "
                             f"CPU, or remat changes it: "
                             f"{[k for k, v in gates.items() if not v]}")
    del cpu, ref
    return out, card


def rag_train_slice(maxsim, smi):
    """Phase 17: RAVQA-v2 joint training and answer evaluation at the
    published recipe (configs/synthetic_rag_blip2_train.json). Returns the
    phase's numbers (K1-f32's launches under "launches")."""
    import gc
    import shutil
    import tempfile
    import torch
    from ravqa_tpu_torch.data import corpus_doc_batches
    from ravqa_tpu_torch.executors import FLMRExecutor, refresh_index
    from ravqa_tpu_torch.executors.base import make_optimizer
    from ravqa_tpu_torch.main import (build_pipeline, build_rag_executor,
                                      load_config, rag_batches,
                                      rag_eval_batches, run_rag_eval)
    from ravqa_tpu_torch.profile_train import RagStageTimer
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = load_config(RAG_TRAIN_CONFIG)
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    ex = build_rag_executor(cfg, data, "cuda", quiet=True)
    gen, rc, tc = ex.model.generator, ex.rag_cfg, ex.train_cfg
    gc_ = gen.cfg
    lora = ex.lora
    n_lora = sum(t.numel() for e in lora.values() for t in e.values())
    trainable = {id(p) for p in ex.optimizer.trainable}
    recipe = (gc_.vision.hidden_size, gc_.vision.num_layers,
              gc_.qformer.num_layers, gc_.num_query_tokens, gc_.t5.d_model,
              gc_.t5.num_layers, gc_.t5.n_dec, gc_.t5.d_ff, gc_.t5.remat,
              rc.n_docs, rc.gen_maxlen, rc.label_maxlen, rc.lora_rank,
              rc.lora_alpha, rc.loss_type, rc.nll_weight, rc.rag_weight,
              rc.additional_weight, rc.force_existence, tc.lr, tc.retriever_lr,
              tc.weight_decay, tc.schedule, tc.accumulate_grad_batches,
              cfg.train.batch_size, len(lora), n_lora)
    if recipe != (1408, 39, 12, 32, 2048, 24, 24, 5120, True, 5, 512, 10, 8,
                  32.0, "Approach6", 1.0, 0.0, 0.0, True, 6e-4, 1e-4, 0.05,
                  "linear", 4, 8, 144, 4718592) \
            or "freeze_question_encoder" not in tc.modules \
            or ex.searcher.mode != "exact":
        raise AssertionError(f"RAG training is not the published recipe: "
                             f"{recipe}")
    if any(p.requires_grad or id(p) in trainable
           for p in gen.parameters()):
        raise AssertionError("a generator base weight is trainable")
    bs, accum = cfg.train.batch_size, tc.accumulate_grad_batches
    print(f"set-up {time.perf_counter() - t_phase:.1f} s: {len(lora)} LoRA "
          f"adapters, {n_lora} LoRA parameters, "
          f"{sum(p.numel() for p in ex.optimizer.trainable)} trainable in "
          f"all; generator base {sum(p.numel() for p in gen.parameters())} "
          f"frozen; {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the "
          f"card", flush=True)
    out = {"lora_params": n_lora,
           "trainable_params": sum(p.numel() for p in ex.optimizer.trainable)}
    t0 = time.perf_counter()
    base = [p.detach().cpu() for p in gen.parameters()]
    out["base_snapshot_s"] = time.perf_counter() - t0
    raw = rag_batches(data["train"], bs, seed=cfg.get("seed", 0))

    # (a) the published step: two optimizer steps of 4 micro-batches of 8
    n_micro = 2 * accum
    searches, undo = record_rag_searches(ex)
    timer = RagStageTimer(ex)
    maxsim.maxsim_search.launches = 0
    maxsim.maxsim_search.split_launches = 0
    batches = (ex.make_train_batch(b) for b in raw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        ex.fit(batches, steps=accum, log_every=1)
        b_after_first = min(float(e["lora_b"].detach().abs().max())
                            for e in ex.lora.values())
        ex.fit(batches, steps=accum, log_every=1)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        launches = maxsim.maxsim_search.launches
        split = maxsim.maxsim_search.split_launches
        steps = timer.steps()
    finally:
        timer.close()
        undo()
    logged = [r for r in ex.logger.history if "train/loss" in r]
    losses = [r["train/loss"] for r in logged]
    print(f"{n_micro} micro-batches of {bs} questions ({n_micro // accum} "
          f"optimizer steps) through fit in {t_fit:.1f} s: "
          f"{n_micro * bs / t_fit:.3f} questions/s trained; losses "
          f"{[round(x, 4) for x in losses]}; K1-f32 launches {launches} "
          f"({split} on the split route); the smallest LoRA B's largest "
          f"|value| after the first update {b_after_first:.3g}", flush=True)
    for i, st in enumerate(steps):
        print(f"  micro-batch {i}: " + ", ".join(
            f"{k} {v:.1f}" for k, v in st.items()) + " ms", flush=True)
    if len(losses) != n_micro or not np.all(np.isfinite(
            losses + [r["train/grad_norm"] for r in logged])):
        raise AssertionError(f"{len(losses)} logged steps, losses {losses}")
    if launches != n_micro or split != launches:
        raise AssertionError(f"K1-f32 launched {launches} times ({split} "
                             f"split) for {n_micro} micro-batches")
    if not b_after_first > 0:
        raise AssertionError("a LoRA B is still zero after the first update")
    state = ex.optimizer.adamw.state
    held = {id(p) for p in state}
    if held != trainable or ex.optimizer.updates != 2 or any(
            a.shape != p.shape for a, p in zip(ex.optimizer.acc,
                                               ex.optimizer.trainable)) \
            or len(ex.optimizer.acc) != len(ex.optimizer.trainable):
        raise AssertionError("optimizer state is held outside the trainable "
                             "set")
    out["search_err"], out["search_cpu_s"] = check_rows(
        searches, ex.index, rc.n_docs)
    print(f"live retrieval: {len(searches)} searches' rows vs the plain "
          f"search (all on the card, 8 on a CPU copy in "
          f"{out['search_cpu_s']:.1f} s): max |score err| "
          f"{out['search_err']:.3g}", flush=True)
    out.update(launches={"K1-f32": launches}, micro_batches=n_micro,
               losses=losses, fit_s=t_fit,
               questions_per_s=n_micro * bs / t_fit,
               micro_batch_stages_ms=steps,
               update_ms=[st["optimizer step"] for st in
                          steps[accum - 1::accum]],
               peak_bytes_train=torch.cuda.max_memory_allocated())
    del searches

    # (b) the loss paths at full width: rag and additional weights 1
    ex.rag_cfg = dataclasses.replace(rc, rag_weight=1.0,
                                     additional_weight=1.0)
    batch = ex.make_train_batch(next(raw))
    ex.model.zero_grad(set_to_none=True)
    loss, parts = ex.loss_fn(batch)
    loss.backward()
    ex.rag_cfg = rc
    r = ex.model.retriever
    tower = {"linear": r.linear, "vision_projection": r.vision_projection,
             "query BERT": r.query_bert}
    norms = {}
    for name, mod in tower.items():
        # (the BERT's pooler, which the query does not read, has none)
        grads = [p.grad for p in mod.parameters()
                 if id(p) in trainable and p.grad is not None]
        if not grads or any(not torch.isfinite(g).all() for g in grads):
            raise AssertionError(f"the query tower's {name} has no grad or "
                                 f"a non-finite one")
        norms[name] = float(torch.sqrt(sum(g.square().sum() for g in grads)))
    parts = {k: float(v) for k, v in parts.items()}
    loss = float(loss.detach())
    print(f"the loss paths at full width (rag and additional weights 1): "
          f"loss {loss:.6f}, " + ", ".join(
              f"{k} {v:.6f}" for k, v in parts.items())
          + "; the query tower's trainable grads' norms " + ", ".join(
              f"{k} {v:.3g}" for k, v in norms.items()), flush=True)
    if not (np.isfinite(loss) and all(np.isfinite(list(parts.values())))
            and all(v > 0 for v in norms.values())):
        raise AssertionError("a loss path gave a non-finite value or no "
                             "grad")
    out["loss_paths"] = dict(parts, loss=loss, tower_grad_norms=norms)
    ex.model.zero_grad(set_to_none=True)
    del batch, loss

    # (d) learning: 3 optimizer steps on one fixed micro-batch
    ex.optimizer = make_optimizer(dataclasses.replace(
        tc, accumulate_grad_batches=1), ex.model)
    fixed = ex.make_train_batch(next(raw))
    learn = [float(ex.train_step(fixed)["loss"]) for _ in range(3)]
    with torch.no_grad():
        learn.append(float(ex.loss_fn(fixed)[0]))
    print(f"one fixed micro-batch, 3 optimizer steps (accumulation 1): loss "
          f"{' -> '.join(f'{x:.6f}' for x in learn)}", flush=True)
    if not learn[-1] < learn[0]:
        raise AssertionError(f"the loss did not fall: {learn}")
    out["learning_losses"] = learn
    del fixed
    if not all(torch.equal(p.detach().cpu(), b)
               for p, b in zip(gen.parameters(), base)):
        raise AssertionError("a generator base weight changed in training")
    del base
    print("the generator base weights are bit-identical after training",
          flush=True)

    tmp = tempfile.mkdtemp(dir=HERE, prefix=".chip_smoke_rag_")
    try:
        # (e) evaluation through generate (K1 once a dispatch)
        evaluated, generate = [], ex.generate

        def recording(b):
            o = generate(b)
            evaluated.append((b, o["predictions"]))
            return o
        ex.generate = recording
        maxsim.maxsim_search.launches = 0
        maxsim.maxsim_search.split_launches = 0
        t0 = time.perf_counter()
        try:
            metrics = run_rag_eval(cfg, ex, data, tmp, "test")
        finally:
            del ex.generate
        out["eval_s"] = time.perf_counter() - t0
        eval_launches = maxsim.maxsim_search.launches
        eval_split = maxsim.maxsim_search.split_launches
        n_test = len(data["test"].items)
        with open(os.path.join(tmp, "test_rag_metrics.json")) as f:
            written = json.load(f)
        direct = [ex.generate(b)["predictions"] for b, _ in evaluated]
        print(f"run_rag_eval: {n_test} questions in {len(evaluated)} "
              f"dispatches, {out['eval_s']:.1f} s; metrics {metrics}; "
              f"K1-f32 launches {eval_launches} ({eval_split} split)",
              flush=True)
        if written != metrics or eval_launches != len(evaluated) \
                or eval_split != eval_launches or n_test < 16 \
                or direct != [p for _, p in evaluated] \
                or len(evaluated) != -(-n_test // bs):
            raise AssertionError("the RAG evaluation disagrees with generate "
                                 "or missed K1")
        out.update(eval_metrics=metrics, eval_dispatches=len(evaluated),
                   eval_launches=eval_launches,
                   eval_answers=evaluated[0][1][:4])

        # (c) the card against the CPU, at full width and 4 + 4 T5 layers
        raw2 = rag_batches(data["train"], 2, seed=1)
        out["vs_cpu"], card = rag_train_vs_cpu(ex, raw2)

        # (f) the 4 + 4 copy's checkpoint, loaded by a fresh executor
        t0 = time.perf_counter()
        card.save_checkpoint(os.path.join(tmp, "ckpt"))
        t_save = time.perf_counter() - t0
        fresh = _cut_executor(ex, card.model.generator.cfg, "cuda", 12,
                              weights=False)
        t0 = time.perf_counter()
        fresh.load_checkpoint(os.path.join(tmp, "ckpt"))
        t_load = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(tmp, "ckpt", "params.msgpack"))
        qb = next(rag_eval_batches(data["test"], bs))
        want, got = card.generate(qb), fresh.generate(qb)
        same = (got["predictions"] == want["predictions"]
                and np.array_equal(got["all_generations"],
                                   want["all_generations"])
                and np.array_equal(got["doc_scores"], want["doc_scores"]))
        print(f"checkpoint of the {RAG_CUT_LAYERS} + {RAG_CUT_LAYERS} copy: "
              f"params.msgpack "
              f"{size / 1e9:.2f} GB, saved in {t_save:.1f} s, loaded into a "
              f"fresh executor in {t_load:.1f} s; the same answers: {same} "
              f"(step {fresh.step}, optimizer updates "
              f"{fresh.optimizer.updates})", flush=True)
        if not same or fresh.step != card.step \
                or fresh.optimizer.updates != card.optimizer.updates:
            raise AssertionError("the reloaded checkpoint answers "
                                 "differently")
        out["checkpoint"] = {"bytes": size, "save_s": t_save,
                             "load_s": t_load}
        del card, fresh
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (f) refresh_index with the trained retriever, then K1 on it
    t0 = time.perf_counter()
    old = ex.index
    refresh_index(ex, FLMRExecutor(ex.model.retriever, device="cuda",
                                   inference_only=True),
                  corpus_doc_batches(data["passages"]["full_passages"],
                                     data["doc_tokenizer"], batch_size=64))
    torch.cuda.synchronize()
    out["refresh_s"] = time.perf_counter() - t0
    if ex.index is old or torch.equal(ex.index.tokens, old.tokens):
        raise AssertionError("refresh_index left the index as it was")
    del old
    searches, undo = record_rag_searches(ex)
    maxsim.maxsim_search.launches = 0
    maxsim.maxsim_search.split_launches = 0
    try:
        ex.retrieve(next(raw))
    finally:
        undo()
    refreshed = (maxsim.maxsim_search.launches,
                 maxsim.maxsim_search.split_launches)
    out["refreshed_search_err"], _ = check_rows(searches, ex.index,
                                                rc.n_docs)
    print(f"refresh_index: {out['refresh_s']:.1f} s ({ex.index.num_docs} "
          f"passages re-encoded); one search on the new index: K1-f32 launches "
          f"{refreshed[0]} ({refreshed[1]} split), rows vs the plain search "
          f"max |score err| {out['refreshed_search_err']:.3g}", flush=True)
    if refreshed != (1, 1):
        raise AssertionError(f"the refreshed search launched K1 "
                             f"{refreshed}")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"peak max_memory_allocated {out['peak_bytes'] / 2**30:.2f} GiB "
          f"({out['peak_bytes_train'] / 2**30:.2f} in the published step); "
          f"phase {out['seconds']:.1f} s ({smi})", flush=True)
    del ex, gen, lora, batches, raw
    return out


# ---------------------------------------------------------------------------
# phase 18: WIT mapping-network pretraining (and DPR on the same corpus)
# ---------------------------------------------------------------------------

WIT_TRAIN_ROWS, WIT_TEST_ROWS = 15360, 1024


def wit_pretrain_slice(maxsim, k1, smi):
    """Phase 18: `main --mode train`, then `--mode test` from its
    checkpoint, in-process on configs/synthetic_flmr_wit_pretrain.json at
    its widths over a synthetic WIT dump written into a .chip_smoke_wit_*
    directory (ravqa_tpu_torch.scripts.synthetic_wit: 15,360 train and
    1,024 test rows, one passage each, 768-d features by image_url). Gates:
    every loss finite; only vision_projection moves (the checkpoint
    against the seed's weights: the BERT tower and the linear
    bit-identical; Adam's state for the mapping network only); the test
    run reads the wit node from the cache (LoadWITData runs once); K1-f32
    launched in each evaluation (counts set to 0 just before each run,
    read just after; all on the split route); the evaluation's ranking
    against a plain search (check_eval_search, 16 queries on a trimmed
    CPU copy); the test metrics equal the final validation's; the
    vision-only query tower card vs CPU on 16 items (max abs 1e-4). Then
    DPR (dpr_on_wit). Prints the step ms, peak memory, the encode and
    search seconds, K1 at Lq = 32 beside its bound, recall."""
    import tempfile
    import torch
    from ravqa_tpu_torch.config import apply_overrides
    from ravqa_tpu_torch.data import TRANSFORM_REGISTRY, query_eval_batches
    from ravqa_tpu_torch.main import (build_executor, build_pipeline,
                                      load_config)
    from ravqa_tpu_torch.models import load_params
    from ravqa_tpu_torch.scripts.synthetic_wit import write_synthetic_wit
    out = {}
    with tempfile.TemporaryDirectory(dir=HERE,
                                     prefix=".chip_smoke_wit_") as tmp:
        t0 = time.perf_counter()
        paths = write_synthetic_wit(os.path.join(tmp, "data"),
                                    WIT_TRAIN_ROWS, WIT_TEST_ROWS, 768)
        out["write_s"] = time.perf_counter() - t0
        opts = [f"data_pipeline.wit.setup_kwargs.tsv_path.train="
                f"{paths['train']}",
                f"data_pipeline.wit.setup_kwargs.tsv_path.test="
                f"{paths['test']}",
                f"data_pipeline.features.setup_kwargs.features_path="
                f"{paths['features']}"]
        cfg = apply_overrides(load_config(WIT_CONFIG), opts)
        tc = cfg.train
        common = ["--config", WIT_CONFIG, "--device", "cuda", "--log_dir",
                  tmp, "--experiment_name", "wit", "--opts"] + opts
        load, runs = TRANSFORM_REGISTRY["LoadWITData"], []
        orig = load.__call__

        def counted(self, *a):
            runs.append(1)
            return orig(self, *a)
        load.__call__ = counted
        try:
            rec, tr = _drive_main(maxsim, common + ["--mode", "train"],
                                  "wit train")
            wit_runs_train = len(runs)
            rec_t, te = _drive_main(maxsim, common + ["--mode", "test"],
                                    "wit test")
            wit_runs = len(runs)
        finally:
            load.__call__ = orig
        out.update(train=tr, test=te)
        if wit_runs_train != 1 or wit_runs != 1:
            raise AssertionError(f"LoadWITData ran {wit_runs} times (the "
                                 "test run must read the cache)")
        cached = os.listdir(os.path.join(tmp, "wit", "cache"))
        if len(cached) != 1 or not cached[0].endswith(".torch.pkl"):
            raise AssertionError(f"node cache holds {cached}")
        steps = rec.steps
        losses = [x[1] for x in steps]
        if len(steps) != tc.total_steps or not np.all(np.isfinite(
                losses + [x[2] for x in steps])):
            raise AssertionError(f"{len(steps)} steps, losses {losses}")
        if len(rec.evals) != tc.total_steps // tc.val_every \
                or len(rec_t.evals) != 1:
            raise AssertionError("WIT evaluations missing")
        for key, r in (("train", tr), ("test", te)):
            ln = r["launches"]
            if ln["K1"] < 1 or ln["K1 split"] != ln["K1"]:
                raise AssertionError(f"WIT {key} launches {ln}")
        final = rec.evals[-1][1]
        got = rec_t.evals[-1][1]
        strip = lambda m: {k: v for k, v in m.items()  # noqa: E731
                           if not k.startswith("_")}
        if strip(got) != strip(final):
            raise AssertionError("the test metrics differ from the final "
                                 "validation's")
        out["recall"] = {k: v for k, v in strip(final).items()
                         if k.startswith("pos_item_ids_recall_at_")}
        q = rec_t.searches[-1]["q"]
        if q.shape[1:] != (cfg.model_config.mapping_network_prefix_length,
                           cfg.model_config.dim):
            raise AssertionError(f"vision-only queries of shape {q.shape}")
        index = got["_index"]
        te["err"] = check_eval_search(rec_t.searches[-1], index)
        # K1 at the evaluation's own launch, and against its plain
        # version at B=64 (random inputs, kernel_shape)
        planes = index.token_planes()
        te["k1_eval_ms"] = time_ms(lambda: maxsim.maxsim_search(
            q, index.tokens, index.mask, planes=planes), iters=5)
        shape = (f"wit eval f32 vision-only B=64 Lq={q.shape[1]} "
                 f"N={index.tokens.shape[0]} Ld={index.tokens.shape[1]}")
        kernel_shape(k1, "K1-f32", shape, 64, q.shape[1],
                     index.tokens.shape[0], index.tokens.shape[1],
                     q.shape[2], torch.float32, torch.float32, maxsim)
        out["k1_shape"] = shape
        del index, planes, got, final, rec_t

        # only the mapping network moved; Adam's state is its alone
        init = build_executor(cfg, "cpu", inference_only=True)
        start = {n: p.detach() for n, p in init.model.named_parameters()}
        ckpt = os.path.join(tmp, "wit", "ckpt")
        trained = load_params(os.path.join(ckpt, "params.msgpack"))
        moved = sorted(n for n in start if not torch.equal(trained[n],
                                                           start[n]))
        if not moved or any(not n.startswith("vision_projection")
                            for n in moved):
            raise AssertionError(f"WIT pretraining moved {moved}")
        n_mapping = sum(1 for n in start if n.startswith("vision_projection"))
        opt = torch.load(os.path.join(ckpt, "optimizer.pt"),
                         map_location="cpu", weights_only=False)
        if len(opt["adamw"]["state"]) != n_mapping:
            raise AssertionError("optimizer state beyond the mapping network")
        # the vision-only query tower, card vs CPU, on the trained weights
        data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                            explode=True)
        card = build_executor(cfg, "cuda", inference_only=True)
        init.model.load_state_dict(trained)
        card.model.load_state_dict(trained)
        batch = next(query_eval_batches(data["test"], 16))
        q_card = card.encode_queries([batch])
        q_cpu = init.encode_queries([batch])
        out["tower_err"] = float(np.abs(q_card - q_cpu).max())
        if out["tower_err"] > TOWER_ATOL:
            raise AssertionError(f"the vision-only tower on the card differs "
                                 f"from the CPU by {out['tower_err']}")
        del card, init, trained, start
        ms = [x[0] * 1e3 for x in steps[2:]]
        tr.update(step_ms_median=float(np.median(ms)), step_ms_min=min(ms),
                  step_ms_max=max(ms), losses=losses, moved=moved,
                  questions_per_s=tc.batch_size / float(np.median(ms)) * 1e3)
        out["corpus"] = len(data["passages"]["full_passages"])
        print(f"{smi}: WIT train step {tr['step_ms_median']:.1f} ms median "
              f"(min {min(ms):.1f}, max {max(ms):.1f}; batch "
              f"{tc.batch_size}, nway 2, frozen towers), peak "
              f"{tr.get('peak_bytes', 0) / 2**30:.2f} GiB; corpus of "
              f"{out['corpus']} passages: encodes "
              f"{[round(x, 2) for x in tr['encode_s'] + te['encode_s']]} s, "
              f"searches {tr['search_s'] + te['search_s']} s; K1 at the "
              f"eval's launch (B={q.shape[0]}) {te['k1_eval_ms']:.2f} ms; "
              f"moved {len(moved)} tensors (vision_projection), tower "
              f"card vs CPU {out['tower_err']:.3g}", flush=True)
        print(f"WIT pos_item_ids_recall@K {out['recall']}; losses "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
        del rec, q
        out["dpr"] = dpr_on_wit(data, smi)
    return out


DPR_STEPS, DPR_EVAL_DOCS, DPR_EVAL_QUERIES = 8, 96, 48


def dpr_on_wit(data, smi):
    """DPR at BERT-base on the WIT corpus' text: a caption is the query and
    its row's passage the positive (nway 2, in-batch negatives), 8 train
    steps of 8 on the card; then the trained model's evaluate_retrieval on
    the card and on a CPU copy over the first 48 test items and a corpus of
    their 48 passages and 48 others (the CPU's BERT-base encode is what
    limits the size): retrieved ids equal except at ties (a swap of two
    scores within 1e-4), metrics printed."""
    import copy
    import torch
    from ravqa_tpu_torch.executors import DPRExecutor, TrainConfig
    from ravqa_tpu_torch.models import BertConfig, DPRModelConfig, DPRRetriever
    qt, dt = data["query_tokenizer"], data["doc_tokenizer"]
    corpus = data["passages"]["full_passages"]
    model = DPRRetriever(DPRModelConfig(bert=BertConfig(), nway=2))
    model.reset_parameters(torch.Generator().manual_seed(0))
    ex = DPRExecutor(model, TrainConfig(lr=2e-5), device="cuda", quiet=True)
    rng = np.random.default_rng(0)
    items = data["train"].items
    losses, ms = [], []
    for _ in range(DPR_STEPS):
        pick = [items[i] for i in rng.choice(len(items), 8, replace=False)]
        docs = []
        for it in pick:
            docs += [corpus.content_of(it["pos_item_ids"][0]),
                     corpus.contents[int(rng.integers(len(corpus)))]]
        qi, qm = qt.tensorize([it["img_caption"] for it in pick])
        di, dm = dt.tensorize(docs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = ex.train_step({"query_input_ids": qi, "query_attention_mask": qm,
                           "doc_input_ids": di, "doc_attention_mask": dm})
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"DPR losses {losses}")
    test = data["test"].items[:DPR_EVAL_QUERIES]
    pids = [it["pos_item_ids"][0] for it in test]
    pids += [p for p in corpus.ids if p not in set(pids)][
        :DPR_EVAL_DOCS - len(pids)]
    contents = [corpus.content_of(p) for p in pids]
    qi, qm = qt.tensorize([it["img_caption"] for it in test])
    di, dm = dt.tensorize(contents)
    queries = [{"query_input_ids": qi, "query_attention_mask": qm}]
    docs = [{"doc_input_ids": di[s:s + 32], "doc_attention_mask": dm[s:s + 32]}
            for s in range(0, len(pids), 32)]
    kw = dict(passage_ids=pids, pos_item_ids=[[p] for p in pids[:len(test)]],
              ks=(1, 5, 10))
    t0 = time.perf_counter()
    got = ex.evaluate_retrieval(queries, docs, **kw)
    t_card = time.perf_counter() - t0
    cpu = DPRExecutor(copy.deepcopy(ex.model).cpu(), TrainConfig(),
                      device="cpu", quiet=True, inference_only=True)
    t0 = time.perf_counter()
    want = cpu.evaluate_retrieval(queries, docs, **kw)
    t_cpu = time.perf_counter() - t0
    q_cpu, d_cpu = cpu.encode_queries(queries), cpu.encode_items(docs)
    scores = q_cpu @ d_cpu.T
    col = {p: i for i, p in enumerate(pids)}
    bad = []
    for i, (g, w) in enumerate(zip(got["_retrieved_pids"],
                                   want["_retrieved_pids"])):
        gs = scores[i, [col[p] for p in g]]
        ws = scores[i, [col[p] for p in w]]
        if g != w and not np.allclose(gs, ws, rtol=0, atol=1e-4):
            bad.append(i)
    if bad:
        raise AssertionError(f"DPR retrieval on the card differs from the "
                             f"CPU on queries {bad}")
    metrics = {k: v for k, v in got.items() if not k.startswith("_")}
    out = {"losses": losses, "step_ms": float(np.median(ms[2:])),
           "eval_card_s": t_card, "eval_cpu_s": t_cpu, "metrics": metrics,
           "same_ids": sum(g == w for g, w in zip(got["_retrieved_pids"],
                                                   want["_retrieved_pids"])),
           "queries": len(test)}
    print(f"{smi}: DPR (BERT-base x 2) train step {out['step_ms']:.1f} ms "
          f"median, losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"evaluate_retrieval {t_card:.2f} s on the card, {t_cpu:.1f} s on "
          f"the CPU, {out['same_ids']} of {len(test)} queries' ids "
          f"identical (the rest tie); {metrics}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 19: PreFLMR multi-task training and evaluation over M2KR tasks
# ---------------------------------------------------------------------------

M2KR_TASKS = ("okvqa", "wit", "infoseek")
M2KR_STEPS, M2KR_BATCH, M2KR_VAL_EVERY, M2KR_SEED = 24, 8, 12, 0


def _m2kr_world(cfg, seed):
    """A SyntheticOKVQA world of 4,096 docs, 256 train and 64 test
    questions with 224 x 224 images, through the config's loaders."""
    from ravqa_tpu_torch.config import apply_overrides
    from ravqa_tpu_torch.main import build_pipeline
    c = apply_overrides(cfg, [
        "data_pipeline.raw.setup_kwargs.n_docs=4096",
        "data_pipeline.raw.setup_kwargs.n_questions=320",
        f"data_pipeline.raw.setup_kwargs.seed={seed}"])
    return build_pipeline(c).get_data(c.data_pipeline_output_node,
                                      explode=True)


def m2kr_slice(maxsim, k1, smi):
    """Phase 19: PreFLMR (configs/synthetic_preflmr_vitl_serve.json's
    model: CLIP ViT-L/14 in the graph, frozen by freeze_image_encoder; the
    BERT-base towers, the mapping and the transformer mapping train)
    trained by train_m2kr over three M2KR tasks (okvqa, wit, infoseek:
    SyntheticOKVQA worlds of seeds 0-2, each with its DEFAULT_INSTRUCTIONS
    prompt), 24 steps of 8 at temperature 4 with evaluate_m2kr every 12
    (two rounds of 3 indexes and 3 K1 launches). Gates: one train_step
    card vs CPU first (executor_step_vs_cpu); every per-task loss finite;
    the sampled task names equal numpy default_rng(seed)'s draws over the
    mixture weights; the ViT bit-identical and without grads; each task's
    evaluation against a plain search of a trimmed CPU copy of its index
    (check_eval_search); K1-f32 launched once per task evaluation (counts
    set to 0 just before, read just after; the split route); each task's
    metric keys and "_flat". Prints the step ms, questions/s, peak memory,
    each evaluation's seconds and K1 at Lq = 320 beside its bound."""
    import torch
    from ravqa_tpu_torch.config import apply_overrides
    from ravqa_tpu_torch.executors import FLMRExecutor, m2kr
    from ravqa_tpu_torch.main import build_executor, load_config
    from ravqa_tpu_torch.retrieval import LateInteractionSearcher
    cfg = load_config(PREFLMR_CONFIG)
    cfg = apply_overrides(cfg, [
        "model_config.modules=" + repr(list(cfg.model_config.modules)
                                       + ["freeze_image_encoder"])])
    t0 = time.perf_counter()
    worlds = [_m2kr_world(cfg, s) for s in range(len(M2KR_TASKS))]
    tasks = [m2kr.M2KRTask(name, w["test"], w["passages"]["full_passages"],
                           train_dataset=w["train"])
             for name, w in zip(M2KR_TASKS, worlds)]
    m2kr.apply_task_instructions(tasks)
    out = {"data_s": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ex = build_executor(cfg, "cuda", quiet=True)
    vit = {n: p.detach().clone()
           for n, p in ex.model.vision_model.named_parameters()}
    if any(p.requires_grad for p in ex.model.vision_model.parameters()):
        raise AssertionError("the frozen ViT requires grad")
    # one full-width step on the card against the CPU, from the seed's
    # weights, on two okvqa questions with their instruction
    cpu = build_executor(cfg, "cpu", quiet=True)
    out["step_vs_cpu"] = executor_step_vs_cpu(
        ex, cpu, tasks[0].train_dataset.collate([0, 1]),
        "PreFLMR ViT-L, batch of 2 with the okvqa instruction", "cuda")
    del cpu
    # the run: every task's sampled name, each step, each evaluation
    names, probs = [], m2kr.task_mixture_weights(tasks, temperature=4.0)
    loader = m2kr.multitask_loader

    def recorded(*a, **k):
        for name, batch in loader(*a, **k):
            names.append(name)
            yield name, batch
    evals, checks = [], []
    orig_eval = FLMRExecutor.evaluate_retrieval
    orig_search = LateInteractionSearcher.search
    searched = []

    def search(self, q, k):
        r = orig_search(self, q, k)
        searched.append({"q": torch.as_tensor(q).detach(), "scores": r[0],
                         "pids": r[1], "s": 0.0})
        return r

    def evaluate(self, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = orig_eval(self, *a, **k)
        torch.cuda.synchronize()
        evals.append(time.perf_counter() - t)
        checks.append(check_eval_search(searched[-1], r["_index"]))
        searched.clear()
        return r
    step_s = []
    orig_step = FLMRExecutor.train_step

    def step(self, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = orig_step(self, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return m
    maxsim.maxsim_search.launches = 0
    maxsim.maxsim_search.split_launches = 0
    m2kr.multitask_loader = recorded
    FLMRExecutor.evaluate_retrieval = evaluate
    LateInteractionSearcher.search = search
    FLMRExecutor.train_step = step
    t0 = time.perf_counter()
    try:
        res = m2kr.train_m2kr(ex, tasks, steps=M2KR_STEPS,
                              batch_size=M2KR_BATCH, temperature=4.0,
                              seed=M2KR_SEED, val_every=M2KR_VAL_EVERY,
                              log_every=M2KR_VAL_EVERY)
    finally:
        m2kr.multitask_loader = loader
        FLMRExecutor.evaluate_retrieval = orig_eval
        LateInteractionSearcher.search = orig_search
        FLMRExecutor.train_step = orig_step
    out["wall_s"] = time.perf_counter() - t0
    launches = maxsim.maxsim_search.launches
    split = maxsim.maxsim_search.split_launches
    n_evals = len(tasks) * (M2KR_STEPS // M2KR_VAL_EVERY)
    if launches != n_evals or split != launches or len(evals) != n_evals:
        raise AssertionError(f"K1 launched {launches} times ({split} split) "
                             f"for {len(evals)} task evaluations")
    rng = np.random.default_rng(M2KR_SEED)
    want = [M2KR_TASKS[int(rng.choice(len(tasks), p=probs))]
            for _ in range(M2KR_STEPS)]
    if names != want:
        raise AssertionError(f"sampled tasks {names}, host draws {want}")
    losses = [v for h in ex.logger.history for k, v in h.items()
              if k.endswith("/loss")]
    if not losses or not all(np.isfinite(losses)) or not all(
            np.isfinite(v) for v in res["per_task_loss"].values()):
        raise AssertionError(f"per-task losses {res['per_task_loss']}")
    for n, p in ex.model.vision_model.named_parameters():
        if p.grad is not None or not torch.equal(p.detach(), vit[n]):
            raise AssertionError(f"the frozen ViT's {n} moved or has a grad")
    for r in res["eval_history"]:
        for t in tasks:
            keys = {f"pos_item_ids_recall_at_{k}" for k in t.ks}
            if t.use_answers:
                keys |= {f"recall_at_{k}" for k in t.ks}
            if not keys <= set(r[t.name]) or any(
                    f"{t.name}/{k}" not in r["_flat"] for k in r[t.name]):
                raise AssertionError(f"{t.name} metrics {sorted(r[t.name])}")
    del vit
    ms = [x * 1e3 for x in step_s[2:]]
    out.update(
        launches={"K1-f32": launches, "K1 split": split},
        sampled=names, per_task_loss=res["per_task_loss"],
        per_task_batches=res["per_task_batches"],
        step_ms_median=float(np.median(ms)), step_ms_min=min(ms),
        step_ms_max=max(ms),
        questions_per_s=M2KR_BATCH / float(np.median(ms)) * 1e3,
        eval_s=evals, eval_err=max(checks),
        peak_bytes=torch.cuda.max_memory_allocated(),
        metrics=[{t: r[t] for t in M2KR_TASKS} for r in res["eval_history"]])
    lq = (worlds[0]["query_tokenizer"].query_maxlen + ex.model.cfg.prefix_len
          + ex.model.cfg.vit.num_patches)
    if lq != LQ_PREFLMR:
        raise AssertionError(f"PreFLMR query of {lq} tokens")
    ld = worlds[0]["doc_tokenizer"].doc_maxlen
    shape = f"m2kr eval f32 B=64 Lq={lq} N=4096 Ld={ld}"
    kernel_shape(k1, "K1-f32", shape, 64, lq, 4096, ld, 128,
                 torch.float32, torch.float32, maxsim)
    out["k1_shape"] = shape
    print(f"{smi}: M2KR train step {out['step_ms_median']:.1f} ms median "
          f"(min {min(ms):.1f}, max {max(ms):.1f}; batch {M2KR_BATCH}, "
          f"nway {ex.model.cfg.nway}, Lq {lq}), "
          f"{out['questions_per_s']:.1f} questions/s trained; peak "
          f"{out['peak_bytes'] / 2**30:.2f} GiB; task evaluations "
          f"{[round(x, 2) for x in evals]} s; K1-f32 {launches} launches "
          f"(split {split}); sampled {res['per_task_batches']}", flush=True)
    recall = [{t: r[t]["pos_item_ids_recall_at_10"] for t in M2KR_TASKS}
              for r in res["eval_history"]]
    print(f"M2KR per-task loss {res['per_task_loss']}; "
          f"pos_item_ids_recall@10 by round {recall}", flush=True)
    del ex, worlds, tasks
    return out


# ---------------------------------------------------------------------------
# phase 20: FLMR with ROIs from raw images (VinVL detection, Oscar
# captioning, OCR, CLIP ViT-B/32 ROI features, training and test at
# Lq = 352)
# ---------------------------------------------------------------------------

ROI_CONFIG = os.path.join(HERE, "configs", "synthetic_flmr_roi_train.json")
ROI_IMAGES, ROI_TRAIN_Q, ROI_TEST_Q, ROI_PASSAGES = 128, 256, 64, 16384
LQ_ROI = 352          # 32 text + (1 global + 9 ROI) x 32 mapping tokens
DET_CANVAS = (1024, 1024)
DET_CPU_CANVAS = (1024, 1024)      # the card-vs-CPU image's canvas
DET_RTOL = 1e-4                    # of each tensor's largest magnitude
TIE = 1e-5


def _rel_err(got, want):
    """max |got - want| over the largest |want| (a tensor's scale)."""
    import torch
    got, want = (torch.as_tensor(x).detach().float().cpu()
                 for x in (got, want))
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def _discrete_agree(name, got, want, keys, thresh):
    """Discrete picks (proposals or detections: `valid` and `labels`
    exact, the boxes within 1e-3 px), card against CPU. Where they part,
    the first row that differs must be a near-tie: its two picks' scores
    (`keys`, the card's and the CPU's) within 1e-5, or one of the two
    boxes within 1e-5 of the NMS threshold `thresh` in IoU with a box kept
    before it (of its class, for detections). Returns the first differing
    row or None."""
    import torch
    from ravqa_tpu_torch.ops.vision import box_iou
    g = {k: v.detach().cpu() for k, v in got.items()}
    w = {k: v.detach().cpu() for k, v in want.items()}
    same = g["valid"] == w["valid"]
    if "labels" in g:
        same &= g["labels"] == w["labels"]
    same &= (g["boxes"] - w["boxes"]).abs().amax(-1) <= 1e-3
    if bool(same.all()):
        return None
    n_diff = int((~same).sum())
    same, rows = same.flatten(), g["valid"].flatten()
    row = int((~same).nonzero()[0])
    gs, ws = (float(keys[0].flatten()[row]), float(keys[1].flatten()[row]))
    boxes = w["boxes"].reshape(-1, 4)
    before = torch.arange(len(rows)) < row
    if "labels" in w:
        labels = w["labels"].flatten()
    margin = float("inf")
    for pick in (g["boxes"].reshape(-1, 4)[row], boxes[row]):
        kept = before & w["valid"].flatten()
        if "labels" in w:
            kept &= labels == labels[row]
        if bool(kept.any()):
            iou = box_iou(pick[None], boxes[kept])[0]
            margin = min(margin, float((iou - thresh).abs().min()))
    print(f"{name}: card and CPU part at pick {row} of {len(rows)} "
          f"({n_diff} differ): scores {gs:.9g} vs {ws:.9g}, the nearest "
          f"IoU to the threshold {thresh} {margin:.3g} away", flush=True)
    if abs(gs - ws) > TIE and margin > TIE:
        raise AssertionError(f"{name} on the card differ from the CPU at "
                             f"pick {row}, not at a near-tie")
    return row


def detector_vs_cpu(ex, state_dict, image):
    """The full-width detector on one image, card vs CPU from one state
    dict at DET_CPU_CANVAS: the C4 feature map, the RPN's logits and
    deltas, and the box head's logits and deltas on the card's proposals
    (fixed) within DET_RTOL of their largest magnitudes; the card's
    proposal and detection selection redone on the CPU from the card's own
    continuous tensors, equal; the proposals and detections card vs CPU
    (_discrete_agree: exact but for near-ties). Then the cuDNN TF32 check:
    with torch.backends.cudnn.allow_tf32 and cuda.matmul.allow_tf32 set
    True the card's forward gives the same float32 numbers (the model turns
    TF32 off inside). Returns the errors and the CPU leg's seconds."""
    import torch
    from ravqa_tpu_torch.data.extraction import preprocess_for_detection
    from ravqa_tpu_torch.models.detection import (AttrRCNN, rpn_proposals,
                                                  select_detections)
    cfg = ex.cfg
    canvas, hw, _ = preprocess_for_detection(
        image, DET_CPU_CANVAS, ex.min_size, ex.max_size)
    x, h = torch.from_numpy(canvas)[None], torch.tensor([hw])
    cpu = AttrRCNN(cfg, device="meta")
    cpu.load_state_dict(state_dict, assign=True)
    cpu.eval()
    with torch.inference_mode():
        card = ex.model(x.cuda(), h.cuda(), intermediates=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = cpu(x, h, intermediates=True)
        cls_fixed, box_fixed = cpu.box_head(ref["feature_map"],
                                            card["proposals"].cpu())
        t_cpu = time.perf_counter() - t0
        out = {"cpu_s": t_cpu}
        for key, got, want in (
                ("feature_map", card["feature_map"], ref["feature_map"]),
                ("rpn_logits", card["rpn_logits"], ref["rpn_logits"]),
                ("rpn_deltas", card["rpn_deltas"], ref["rpn_deltas"]),
                ("cls_logits_fixed_proposals", card["cls_logits"],
                 cls_fixed),
                ("box_deltas_fixed_proposals", card["box_deltas"],
                 box_fixed)):
            out[key] = _rel_err(got, want)
            if not out[key] <= DET_RTOL:
                raise AssertionError(f"detector {key} card vs CPU "
                                     f"{out[key]:.3g} of its scale")
        # the selection on the CPU from the card's continuous tensors
        c = {k: v.cpu() for k, v in card.items()}
        props, pvalid, pscores = rpn_proposals(
            c["rpn_logits"], c["rpn_deltas"],
            cpu.anchors(c["feature_map"].shape[2], c["feature_map"].shape[3],
                        "cpu"), h, cfg)
        dets = dict(zip(("boxes", "scores", "labels", "valid"),
                        select_detections(c["probs"], c["box_deltas"].float(),
                                          c["proposals"],
                                          c["proposal_valid"], h, cfg)))
        out["selection_proposals_part_at"] = _discrete_agree(
            "proposals selected on the CPU from the card's RPN outputs",
            {"boxes": c["proposals"], "valid": c["proposal_valid"]},
            {"boxes": props, "valid": pvalid},
            (c["proposal_scores"], pscores), cfg.rpn_nms_thresh)
        out["selection_detections_part_at"] = _discrete_agree(
            "detections selected on the CPU from the card's box head", c,
            dets, (c["scores"], dets["scores"]), cfg.box_nms_thresh)
        out["proposals_part_at"] = _discrete_agree(
            "proposals", {"boxes": card["proposals"],
                          "valid": card["proposal_valid"]},
            {"boxes": ref["proposals"], "valid": ref["proposal_valid"]},
            (card["proposal_scores"], ref["proposal_scores"]),
            cfg.rpn_nms_thresh)
        out["detections_part_at"] = _discrete_agree(
            "detections", card, ref, (card["scores"], ref["scores"]),
            cfg.box_nms_thresh)
        out["num_detections"] = int(card["num_detections"][0])
        # TF32 on in the caller: the same float32 numbers
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = ex.model(x.cuda(), h.cuda(), intermediates=True)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        out["tf32_flag_err"] = max(_rel_err(tf32[k], card[k]) for k in (
            "feature_map", "cls_logits", "features"))
        if out["tf32_flag_err"] > 1e-6 or not torch.equal(
                tf32["labels"], card["labels"]):
            raise AssertionError(f"the detector's numbers move with the "
                                 f"caller's TF32 flags "
                                 f"({out['tf32_flag_err']:.3g})")
    print(f"detector card vs CPU on one {DET_CPU_CANVAS[0]}x"
          f"{DET_CPU_CANVAS[1]} canvas ({t_cpu:.1f} s on the CPU): feature "
          f"map {out['feature_map']:.3g}, RPN logits {out['rpn_logits']:.3g}"
          f", deltas {out['rpn_deltas']:.3g}, box logits on fixed proposals "
          f"{out['cls_logits_fixed_proposals']:.3g}, deltas "
          f"{out['box_deltas_fixed_proposals']:.3g} (of each one's scale); "
          f"{out['num_detections']} detections; the card's selection redone "
          f"on the CPU parts at {out['selection_proposals_part_at']} / "
          f"{out['selection_detections_part_at']}; proposals part at "
          f"{out['proposals_part_at']}, detections at "
          f"{out['detections_part_at']}; with the caller's TF32 flags on "
          f"{out['tf32_flag_err']:.3g}", flush=True)
    return out


def roi_detection(p, smi):
    """The VinVL detector at vinvl_x152c4 widths and depth (ResNeXt-152
    32x8d C4, 1,595 classes, 525 attributes, 6,000 -> 300 proposals, 100
    detections with a floor of 10) on a 1,024^2 canvas, batch 8, its
    weights through convert_vinvl_params from a synthetic maskrcnn state
    dict, over every image of the world through the extraction script's
    `extract`; predictions.tsv per split. Gates: at least the floor of
    detections an image, finite 2,048-d features, rects inside their image;
    detector_vs_cpu. Returns the numbers."""
    import torch
    from ravqa_tpu_torch.data.extraction import (VinVLFeatureExtractor,
                                                 load_vg_labelmap,
                                                 write_predictions_tsv)
    from ravqa_tpu_torch.models.detection import (DetectorConfig,
                                                  convert_vinvl_params)
    from ravqa_tpu_torch.scripts.extract_vinvl_features import extract
    from ravqa_tpu_torch.scripts.synthetic_okvqa import \
        synthetic_vinvl_state_dict
    cfg = DetectorConfig.vinvl_x152c4()
    t0 = time.perf_counter()
    sd = convert_vinvl_params(synthetic_vinvl_state_dict(cfg, seed=0), cfg)
    lab, attr = load_vg_labelmap(p["labelmap"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ex = VinVLFeatureExtractor(cfg, sd, lab, attr, canvas_hw=DET_CANVAS,
                               batch_size=8, device="cuda")
    out = {"build_s": time.perf_counter() - t0,
           "parameters": sum(v.numel() for v in sd.values())}
    store = np.load(p["images"])
    keys = [str(i) for i in p["image_ids"]]
    images = {k: store[k] for k in keys}
    batch_s = []
    run_batch = ex.predict_batch

    def timed(canvases, hws):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = run_batch(canvases, hws)             # ends in a copy to host
        batch_s.append(time.perf_counter() - t)
        return r
    ex.predict_batch = timed
    t0 = time.perf_counter()
    preds = extract(ex, keys, images.__getitem__, log=lambda m: None)
    out["extract_s"] = time.perf_counter() - t0
    ex.predict_batch = run_batch
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    by_key = dict(zip(keys, preds))
    for s in ("train", "test"):
        ks = [str(i) for i in p["splits"][s]]
        write_predictions_tsv(p[f"vinvl_{s}"], [k.zfill(12) for k in ks],
                              [by_key[k] for k in ks])
    for k, pred in by_key.items():
        h, w = images[k].shape[:2]
        objs = pred["objects"]
        feats = [np.frombuffer(base64.b64decode(o["feature"]), np.float32)
                 for o in objs]
        if len(objs) < cfg.min_detections_per_img or any(
                f.shape != (cfg.res5_out_channels,)
                or not np.isfinite(f).all() for f in feats) or any(
                not (0 <= o["rect"][0] <= o["rect"][2] <= w + 1
                     and 0 <= o["rect"][1] <= o["rect"][3] <= h + 1)
                for o in objs):
            raise AssertionError(f"image {k}: {len(objs)} detections "
                                 "outside the contract")
    ms = [s * 1e3 for s in batch_s[1:]]
    out.update(batch_ms_median=float(np.median(ms)), batch_ms_min=min(ms),
               batch_ms_max=max(ms), first_batch_ms=batch_s[0] * 1e3,
               images_per_s=8 / float(np.median(ms)) * 1e3,
               detections=int(np.mean([len(v["objects"])
                                       for v in preds])))
    out["vs_cpu"] = detector_vs_cpu(ex, sd, images[keys[0]])
    print(f"{smi}: VinVL X152-C4 ({out['parameters'] / 1e6:.1f}M "
          f"parameters, built in {out['build_s']:.1f} s) over {len(keys)} "
          f"480x640 images: {out['batch_ms_median']:.1f} ms a batch of 8 "
          f"on a {DET_CANVAS[0]}^2 canvas (median of {len(ms)}; min "
          f"{min(ms):.1f}, max {max(ms):.1f}; the first "
          f"{out['first_batch_ms']:.0f}), {out['images_per_s']:.2f} "
          f"images/s; peak {out['peak_bytes'] / 2**30:.2f} GiB; "
          f"{out['detections']} detections an image", flush=True)
    del ex
    torch.cuda.empty_cache()
    return out


def roi_captioning(p, smi):
    """The Oscar captioner at Oscar-base widths (BERT-base, 2,054-d
    regions, 40 / 70 / 50) over every image's TSV row, through the
    captioning script's `caption_rows` (batches of 16); the caption JSON
    per split, keyed str(image_id) as LoadOKVQAData reads it (the script
    keys it by the TSV's zero-padded key: ROADMAP C23). Gates: a batch's
    first forward card vs CPU (1e-4 of the largest logit); the greedy
    tokens of 4 rows identical card vs CPU, but where the CPU's own logits
    at the first differing slot hold the two tokens within 1e-5 of the
    largest logit (a near-tie). Returns the numbers."""
    import torch
    from ravqa_tpu_torch.models.captioner import (
        CaptionerConfig, OscarCaptioner, caption_attention_mask,
        convert_oscar_captioner_params, greedy_caption,
        write_caption_predictions)
    from ravqa_tpu_torch.scripts.run_captioning import (caption_inputs,
                                                        caption_rows,
                                                        load_tsv)
    from ravqa_tpu_torch.scripts.synthetic_okvqa import \
        synthetic_oscar_state_dict
    from ravqa_tpu_torch.tokenization import WordPieceTokenizer
    cfg = CaptionerConfig()
    sd = convert_oscar_captioner_params(synthetic_oscar_state_dict(cfg), cfg)
    model = OscarCaptioner(cfg, device="meta")
    model.load_state_dict(sd, assign=True)
    cpu = model.eval()
    model = OscarCaptioner(cfg, device="cuda")
    model.load_state_dict(sd)
    model.eval()
    tok = WordPieceTokenizer(p["vocab"])
    rows = {}
    for s in ("train", "test"):
        rows.update(load_tsv(p[f"vinvl_{s}"]))
    rows = list(rows.items())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caps = caption_rows(model, tok, rows, batch=16, log=lambda m: None)
    torch.cuda.synchronize()
    out = {"caption_s": time.perf_counter() - t0, "images": len(rows)}
    for s in ("train", "test"):
        write_caption_predictions(p[f"captions_{s}"], {
            str(i): caps[str(i).zfill(12)] for i in p["splits"][s]})
    x = caption_inputs(rows[:4], tok, cfg, 4)
    xc = {k: torch.from_numpy(v) for k, v in x.items()}
    xg = {k: v.cuda() for k, v in xc.items()}
    with torch.inference_mode():
        a = cfg.max_seq_a_len
        text = np.concatenate([np.full((4, a), cfg.mask_token_id),
                               x["tag_ids"]], -1)
        text[:, 0] = cfg.cls_token_id
        segs = np.concatenate([np.zeros((4, a)), np.ones(
            (4, cfg.max_seq_len - a))], -1)
        t, sg = torch.from_numpy(text).long(), torch.from_numpy(segs).long()
        attn = caption_attention_mask(cfg, xc["tag_mask"], xc["img_mask"])
        want = cpu(t, sg, xc["img_feats"], attn)
        got = model(t.cuda(), sg.cuda(), xg["img_feats"], attn.cuda())
        out["logits_err"] = _rel_err(got, want)
        if not out["logits_err"] <= 1e-4:
            raise AssertionError(f"captioner logits card vs CPU "
                                 f"{out['logits_err']:.3g}")
        args = ("tag_ids", "tag_mask", "img_feats", "img_mask")
        cap_g, len_g = greedy_caption(model, *(xg[k][:2] for k in args))
        t0 = time.perf_counter()
        cap_c, len_c = greedy_caption(cpu, *(xc[k][:2] for k in args))
        out["cpu_greedy_s"] = time.perf_counter() - t0
        cap_g = cap_g.cpu()
        out["tokens_part"] = []
        for r in range(2):
            diff = (cap_g[r] != cap_c[r]).nonzero()
            if not len(diff):
                continue
            slot = int(diff[0])
            # the CPU's logits at that slot, on the shared prefix
            prefix = torch.cat([cap_c[r:r + 1, :slot], torch.full(
                (1, a - slot), cfg.mask_token_id)], -1)
            lg = cpu(torch.cat([prefix, xc["tag_ids"][r:r + 1].long()], -1),
                     sg[:1], xc["img_feats"][r:r + 1], attn[r:r + 1])[0, slot]
            gap = float(lg[cap_c[r, slot]] - lg[cap_g[r, slot]])
            out["tokens_part"].append((r, slot, gap))
            if gap > TIE * float(lg.abs().max()):
                raise AssertionError(f"greedy tokens card vs CPU differ at "
                                     f"row {r} slot {slot}, not at a tie")
        same = [r for r in range(2)
                if r not in {x[0] for x in out["tokens_part"]}]
        if not torch.equal(len_g.cpu()[same], len_c[same]):
            raise AssertionError("greedy caption lengths differ")
    print(f"{smi}: Oscar-base captioner, {len(rows)} images in "
          f"{out['caption_s']:.2f} s (batches of 16, 39 forwards each); "
          f"logits card vs CPU {out['logits_err']:.3g}; greedy tokens of 2 "
          f"rows card vs CPU {'identical' if not out['tokens_part'] else out['tokens_part']} "
          f"(CPU greedy {out['cpu_greedy_s']:.1f} s)", flush=True)
    del model, cpu
    return out


def vit_crops_vs_cpu(cfg, data_cpu, cache_path, n_items=4):
    """The ViT-B/32 ROI features card vs CPU: the features node on the CPU
    over n_items test items (their images and ROI crops) against the
    card's features in the run's cache (1e-4 of their scale)."""
    from ravqa_tpu_torch.data import TRANSFORM_REGISTRY
    node = TRANSFORM_REGISTRY["ExtractImageFeaturesWithViT"]()
    node.setup(**dict(cfg.data_pipeline.features.setup_kwargs,
                      cache_path=None, device="cpu"))
    items = [dict(it) for it in data_cpu["test"][:n_items]]
    t0 = time.perf_counter()
    node({"test": items, "roi_crops": data_cpu["roi_crops"]})
    t_cpu = time.perf_counter() - t0
    card = np.load(cache_path)
    errs, n = [], 0
    for it in items:
        want = it["image_features"]
        got = np.stack([card[str(it["image_id"])]]
                       + [card[r] for r in it["ROIs"]])
        got = np.concatenate([got, np.repeat(got[-1:], len(want) - len(got),
                                             0)])[:len(want)]
        errs.append(_rel_err(got, want))
        n += 1 + len(it["ROIs"])
    err = max(errs)
    if not err <= 1e-4:
        raise AssertionError(f"ViT-B/32 crop features card vs CPU {err:.3g}")
    return {"err": err, "cpu_crops": n, "cpu_s": t_cpu}


def roi_slice(maxsim, k1, smi):
    """Phase 20: the FLMR-with-ROI user path from raw images. A synthetic
    OK-VQA world from the seed (scripts/synthetic_okvqa.py: 128 RGB images
    of 480 x 640, 256 train and 64 test questions, a GoogleSearch CSV of
    16,384 passages across the 112724 boundary, annotations and OCR
    JSONs); the VinVL detector (roi_detection) writes predictions.tsv; the
    Oscar captioner (roi_captioning) writes the caption JSON; then `main
    --mode train` on configs/synthetic_flmr_roi_train.json (OCR attached to
    the objects, ROI crops, the CLIP ViT-B/32 over every image and its <= 9
    ROIs on the card, 24 steps of B = 30 with nway 5, one validation) and
    `--mode test` from its checkpoint. Gates: every loss finite; K1-f32
    once in each exact evaluation, at Lq = 352, all on the split route;
    the evaluation's ranking against a plain search (check_eval_search);
    the test metrics equal the final validation's; K1-f32 held to its
    plain version at Lq = 352 (kernel_shape); the ViT-B/32 crop features
    card vs CPU (vit_crops_vs_cpu); one ROI train_step card vs CPU on a
    batch of 2 (executor_step_vs_cpu). Prints the detector's ms a batch
    and images/s, peak memory, the caption seconds, the ViT's crops/s, the
    step ms and peak, the evaluation's seconds with the corpus encode and
    K1 within them, K1 at Lq = 352 beside its bound, and the phase's
    seconds."""
    import tempfile
    import torch
    from ravqa_tpu_torch.config import apply_overrides
    from ravqa_tpu_torch.data import TRANSFORM_REGISTRY
    from ravqa_tpu_torch.main import (build_executor, build_pipeline,
                                      load_config)
    from ravqa_tpu_torch.scripts.synthetic_okvqa import (config_opts,
                                                         write_synthetic_okvqa)
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(dir=HERE,
                                     prefix=".chip_smoke_roi_") as tmp:
        t0 = time.perf_counter()
        p = write_synthetic_okvqa(os.path.join(tmp, "data"), ROI_IMAGES,
                                  ROI_TRAIN_Q, ROI_TEST_Q, ROI_PASSAGES)
        out["write_s"] = time.perf_counter() - t0
        out["detector"] = roi_detection(p, smi)
        out["captioner"] = roi_captioning(p, smi)
        cache_path = os.path.join(tmp, "vit_features.npz")
        opts = config_opts(p) + [
            f"data_pipeline.features.setup_kwargs.cache_path={cache_path}"]
        cfg = apply_overrides(load_config(ROI_CONFIG), opts)
        tc = cfg.train
        common = ["--config", ROI_CONFIG, "--device", "cuda", "--log_dir",
                  tmp, "--experiment_name", "roi", "--opts"] + opts
        node = TRANSFORM_REGISTRY["ExtractImageFeaturesWithViT"]
        vit_runs, orig = [], node.__call__

        def timed(self, data):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = orig(self, data)
            vit_runs.append((time.perf_counter() - t,
                             len(np.load(cache_path).files)))
            return r
        node.__call__ = timed
        try:
            rec, tr = _drive_main(maxsim, common + ["--mode", "train"],
                                  "roi train")
            rec_t, te = _drive_main(maxsim, common + ["--mode", "test"],
                                    "roi test")
        finally:
            node.__call__ = orig
        out.update(train=tr, test=te)
        steps = rec.steps
        losses = [x[1] for x in steps]
        if len(steps) != tc.total_steps or not np.all(np.isfinite(
                losses + [x[2] for x in steps])):
            raise AssertionError(f"{len(steps)} steps, losses {losses}")
        if len(rec.evals) != tc.total_steps // tc.val_every \
                or len(rec_t.evals) != 1:
            raise AssertionError("ROI evaluations missing")
        for key, r, n in (("train", tr, len(rec.evals)), ("test", te, 1)):
            ln = r["launches"]
            if ln["K1"] != n or ln["K1 split"] != ln["K1"]:
                raise AssertionError(f"ROI {key} launches {ln}")
        for search in rec.searches + rec_t.searches:
            if search["q"].shape[1] != LQ_ROI:
                raise AssertionError(f"ROI queries of {search['q'].shape[1]}"
                                     " tokens")
        strip = lambda m: {k: v for k, v in m.items()  # noqa: E731
                           if not k.startswith("_")}
        final, got = strip(rec.evals[-1][1]), strip(rec_t.evals[-1][1])
        if got != final:
            raise AssertionError("the test metrics differ from the final "
                                 "validation's")
        index = rec_t.evals[-1][1]["_index"]
        te["err"] = check_eval_search(rec_t.searches[-1], index)
        q = rec_t.searches[-1]["q"]
        planes = index.token_planes()
        te["k1_eval_ms"] = time_ms(lambda: maxsim.maxsim_search(
            q, index.tokens, index.mask, planes=planes), iters=5)
        n_docs, ld = index.tokens.shape[:2]
        shape = f"roi eval f32 B=64 Lq={LQ_ROI} N={n_docs} Ld={ld}"
        kernel_shape(k1, "K1-f32", shape, 64, LQ_ROI, n_docs, ld,
                     q.shape[2], torch.float32, torch.float32, maxsim)
        out["k1_shape"] = shape
        out["metrics"] = final
        del index, planes, rec_t
        # the ViT's run in training (the test run reads its cache)
        vit_s, n_crops = vit_runs[0]
        if vit_runs[1][1] != n_crops:
            raise AssertionError("the test run encoded crops again")
        out["vit"] = {"s": vit_s, "crops": n_crops,
                      "crops_per_s": n_crops / vit_s}
        data_cpu = build_pipeline(cfg, os.path.join(tmp, "roi", "cache"),
                                  "cpu").get_data("crops", explode=True)
        out["vit"].update(vit_crops_vs_cpu(cfg, data_cpu, cache_path))
        del data_cpu
        # one ROI training step, card vs CPU, on a batch of 2
        data = build_pipeline(cfg, os.path.join(tmp, "roi", "cache"),
                              "cuda").get_data(cfg.data_pipeline_output_node,
                                               explode=True)
        batch = data["train"].collate([0, 1])
        if batch["image_features"].shape[1:] != (10, 768):
            raise AssertionError(f"ROI features of shape "
                                 f"{batch['image_features'].shape}")
        out["step_vs_cpu"] = executor_step_vs_cpu(
            build_executor(cfg, "cuda"), build_executor(cfg, "cpu"), batch,
            "FLMR with 9 ROIs, batch of 2", "cuda")
        out["corpus"] = len(data["passages"]["full_passages"])
        out["questions"] = {s: len(data[s].items) for s in ("train", "test")}
        del data
    ms = [x[0] * 1e3 for x in steps[2:]]
    tr.update(step_ms_median=float(np.median(ms)), step_ms_min=min(ms),
              step_ms_max=max(ms), losses=losses,
              peak_bytes_after_2=rec.peak_after_2)
    out["seconds"] = time.perf_counter() - t_phase
    d, c, v = out["detector"], out["captioner"], out["vit"]
    print(f"{smi}: ViT-B/32 {v['crops']} images and ROI crops in "
          f"{v['s']:.2f} s ({v['crops_per_s']:.1f} crops/s with the host "
          f"crop and resize); card vs CPU {v['err']:.3g} on "
          f"{v['cpu_crops']} of them", flush=True)
    print(f"{smi}: ROI train step {tr['step_ms_median']:.1f} ms median "
          f"(min {min(ms):.1f}, max {max(ms):.1f}; batch {tc.batch_size}, "
          f"nway {cfg.data_pipeline.loaders.setup_kwargs.nway}, Lq "
          f"{LQ_ROI}), peak {tr.get('peak_bytes', 0) / 2**30:.2f} GiB "
          f"({(rec.peak_after_2 or 0) / 2**30:.2f} after 2 steps); "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    print(f"{smi}: ROI evaluations {[round(e, 1) for e in tr['eval_s']]} s "
          f"(train) and {[round(e, 1) for e in te['eval_s']]} s (test): "
          f"corpus encodes {[round(x, 1) for x in tr['encode_s'] + te['encode_s']]}"
          f" s, searches {tr['search_s'] + te['search_s']} s; K1-f32 at "
          f"the eval's own launch (B={q.shape[0]}, Lq={LQ_ROI}) "
          f"{te['k1_eval_ms']:.2f} ms; corpus {out['corpus']}, questions "
          f"{out['questions']}; metrics {final}", flush=True)
    print(f"{smi}: phase 20: world {out['write_s']:.1f} s, detector "
          f"{d['extract_s']:.1f} s (+ {d['vs_cpu']['cpu_s']:.1f} s CPU "
          f"leg), captions {c['caption_s']:.1f} s, train {tr['wall_s']:.1f}"
          f" s, test {te['wall_s']:.1f} s; the phase "
          f"{out['seconds']:.1f} s", flush=True)
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main():
    if not os.path.isdir(os.path.join(HERE, "ravqa_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the repo")
    sys.path.insert(0, HERE)
    import torch

    phase("1 environment")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA GPU visible: chip_smoke.py needs one")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul False, cudnn False", flush=True)

    phase("2 build")
    from ravqa_tpu_torch.ops import maxsim
    t0 = time.perf_counter()
    for name, built in maxsim.build_kernels().items():
        print(f"{name} built and loaded in {built['seconds']:.2f} s",
              flush=True)
        for line in built["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip(), flush=True)
    print(f"all libraries: {time.perf_counter() - t0:.2f} s", flush=True)

    phase("3 K1 vs plain")
    # K1 on a bf16 index ("K1") and on a float32 one, read as two bf16
    # planes ("K1-f32"): the same tensor-core kernel, two rows
    k1 = {k: {"err": 0.0, "shapes": {}} for k in ("K1", "K1-f32")}
    f32, bf16 = torch.float32, torch.bfloat16
    for key, shape, args in (
            ("K1", "bf16 B=32 Lq=32 N=16384 Ld=128",
             (32, 32, 16384, 128, 128, bf16, bf16)),
            ("K1", "f32 query x bf16 index B=32 Lq=32 N=16384 Ld=64",
             (32, 32, 16384, 64, 128, f32, bf16)),
            ("K1-f32", "serve f32 B=32 Lq=64 N=16387 Ld=220",
             (32, 64, 16387, 220, 128, f32, f32))):
        kernel_shape(k1, key, shape, *args, maxsim)
    phase("4 exact serve slice")
    launches, dispatches, serve_err = serve_slice(CONFIG, "cuda", maxsim)
    if launches < dispatches or launches == 0:
        raise AssertionError(f"maxsim kernel launched {launches} times "
                             f"for {dispatches} dispatches")

    phase("5 K2, K3, K4 vs plain at the bench and serve shapes")
    sweeps = sweep_kernels(maxsim)
    phase("6 pruned search at 112,640 docs")
    searches, pruned_launches = pruned_search(maxsim)
    phase("7 hierarchical serve slice")
    (l3, l4), hier_dispatches, hier_recall, hier_serve_err, served = \
        hier_serve_slice(maxsim)
    if min(l3, l4) < hier_dispatches or hier_dispatches == 0:
        raise AssertionError(f"K3/K4 launched {l3}/{l4} times for "
                             f"{hier_dispatches} dispatches")
    phase("8 K5 and K6 vs plain")
    compressed = compressed_kernels()
    phase("9 the 1M legs")
    legs_1m, launches_1m = one_million_legs(maxsim)
    phase("10 compressed serve slice")
    comp_serve = compressed_serve_slice(maxsim, *served)
    del served
    phase("11 X1, X2, X3 vs plain")
    stage2_k = stage2_kernels()
    phase("12 the residual stage-2 experiment")
    experiment = stage2_experiment()
    phase("13 the training step on the card against the CPU")
    train_step = training_step_vs_cpu(TRAIN_CONFIG)
    phase("14 the training slice")
    train_slice = training_slice(TRAIN_CONFIG, smi)
    phase("15 PreFLMR serve slices (ViT-L/14 in the graph, Lq=320)")
    preflmr = {name: preflmr_slice(path, maxsim, k1, sweeps, smi)
               for name, path in (("exact", PREFLMR_CONFIG),
                                  ("hierarchical", PREFLMR_HIER_CONFIG))}
    phase("16 RAVQA-v2 answer serve (BLIP-2 Flan-T5-XL over FLMR, K1-f32)")
    rag_serve = rag_serve_slice(maxsim, k1, smi)
    phase("17 RAVQA-v2 joint training and evaluation (BLIP-2 Flan-T5-XL "
          "LoRA + FLMR, K1-f32)")
    rag_train = rag_train_slice(maxsim, smi)
    phase("18 WIT mapping-network pretraining (BERT-base frozen, vision-only "
          "queries, K1-f32) and DPR")
    wit = wit_pretrain_slice(maxsim, k1, smi)
    phase("19 PreFLMR multi-task training and evaluation over M2KR tasks "
          "(ViT-L/14 frozen, Lq=320, K1-f32)")
    m2kr_run = m2kr_slice(maxsim, k1, smi)
    phase("20 FLMR with ROIs from raw images (VinVL X152-C4, Oscar, OCR, "
          "ViT-B/32 crops; train and test, K1-f32 at Lq=352)")
    roi = roi_slice(maxsim, k1, smi)
    phase("report")

    def entry(name, source, replaces, launches, measured):
        return {"name": name, "route": "cuda",
                "source": "ravqa_tpu_torch/csrc/" + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": measured["err"], "ms": measured["ms"],
                "plain_ms": measured["plain_ms"],
                "bound_ms": measured["bound_ms"],
                "bound_by": measured["bound_by"],
                "shapes": measured["shapes"]}

    k1_replaces = "ravqa_tpu/ops/maxsim.py:196 (_maxsim_kernel :162)"
    kernels = {
        "K1": entry("maxsim_search (bf16 index, tensor cores)",
                    "maxsim_mma.cu", k1_replaces, pruned_launches["K1"],
                    k1["K1"]),
        "K1-f32": entry("maxsim_search (float32 index as two bf16 planes, "
                        "tensor cores)", "maxsim_mma.cu", k1_replaces,
                        launches, k1["K1-f32"])}
    kernels["K1"]["launches_note"] = (
        "phase 6's exact oracle (bf16 query); the exact serve slice's "
        "float32 index runs K1-f32")
    kernels["K1"]["launches_1m"] = launches_1m["exact bf16 (K1)"]["K1"]
    kernels["K1-f32"]["launches_note"] = (
        "phase 4, the exact serve slice; launches_train_eval: phase 14's "
        "validations during training and its exact eval from the "
        "checkpoint, all on the split route")
    kernels["K1-f32"]["launches_train_eval"] = {
        k: train_slice[k]["launches"]["K1"] for k in ("train", "eval exact")}
    kernels["K1-f32"]["f32_bound_ms"] = k1["K1-f32"]["shapes"][
        next(iter(k1["K1-f32"]["shapes"]))]["f32_bound_ms"]
    kernels["K1-f32"]["launches_preflmr_serve"] = \
        preflmr["exact"]["launches"]["K1-f32"]
    kernels["K1-f32"]["launches_rag_serve"] = rag_serve["launches"]["K1-f32"]
    # phase 17: once per training micro-batch's live retrieval, once per
    # evaluation dispatch
    kernels["K1-f32"]["launches_rag_train"] = rag_train["launches"]["K1-f32"]
    kernels["K1-f32"]["launches_rag_eval"] = rag_train["eval_launches"]
    # phase 18: once per WIT validation (training) and in the test run;
    # phase 19: once per M2KR task evaluation (3 tasks, 2 rounds)
    kernels["K1-f32"]["launches_wit_pretrain"] = {
        k: wit[k]["launches"]["K1"] for k in ("train", "test")}
    kernels["K1-f32"]["launches_m2kr"] = m2kr_run["launches"]["K1-f32"]
    # phase 20: once per ROI evaluation (the validation, the test run),
    # at Lq = 352
    kernels["K1-f32"]["launches_roi"] = {
        k: roi[k]["launches"]["K1"] for k in ("train", "test")}

    for key, name, source, replaces, launches in (
            ("K2", "coarse_sweep (bf16, tensor cores)", "coarse_sweep.cu",
             "ravqa_tpu/ops/maxsim.py:336 (_coarse_sweep_kernel :252)",
             pruned_launches["K2"]),
            ("K3", "coarse_sweep_int8", "coarse_sweep.cu",
             "ravqa_tpu/ops/maxsim.py:336 (_coarse_sweep_int8_kernel "
             ":293)", l3),
            ("K4", "stage1_sweep", "stage1_sweep.cu",
             "ravqa_tpu/ops/maxsim.py:510", l4)):
        kernels[key] = entry(name, source, replaces, launches, sweeps[key])
    kernels["K2"]["launches_note"] = (
        "phase 6 (hierarchical and two-stage search under the reference "
        "preset); the fast serve slice runs K3 and K4; "
        "launches_train_eval: phase 14's hierarchical eval (reference)")
    eh = train_slice["eval hierarchical"]
    kernels["K2"]["launches_train_eval"] = eh["launches"]["K2"]
    # the hierarchical eval's stage 0, held to its plain version at its
    # own shape (check_hier_eval)
    k0 = kernels[eh["stage0_kernel"]]
    for shape, measured in eh["stage0"].items():
        k0["shapes"][shape] = measured
        k0["max_abs_err"] = max(k0["max_abs_err"], measured["err"])
    kernels["K3"]["pruned_search_launches"] = pruned_launches["K3"]
    kernels["K4"]["pruned_search_launches"] = pruned_launches["K4"]
    for key in ("K3", "K4"):
        kernels[key]["launches_preflmr_serve"] = \
            preflmr["hierarchical"]["launches"][key]
    res_launches = comp_serve["residual hierarchical fast"]["launches"]
    for key, name, source, replaces, launches in (
            ("K5", "maxsim_search_int8", "maxsim_int8.cu",
             "ravqa_tpu/ops/quant.py:138 (_maxsim_int8_kernel :113)",
             comp_serve["int8 exact"]["launches"]["maxsim_search_int8"]),
            ("K6", "maxsim_residual", "residual_maxsim.cu",
             "ravqa_tpu/ops/residual.py:524 (_residual_maxsim_kernel :447)",
             res_launches["maxsim_residual"])):
        kernels[key] = entry(name, source, replaces, launches,
                             compressed[key])
    kernels["K5"]["launches_1m"] = launches_1m["int8 exact (K5)"]["K5"]
    kernels["K6"]["launches_1m"] = launches_1m[
        "residual hierarchical fast (K3, K4, K6)"]["K6"]
    script = "scripts/exp_residual_stage2.py"
    for key, name, source, replaces in (
            ("X1", "fused_lut_maxsim", "residual_lut_maxsim.cu",
             f"{script}:189 (v_pallas :173, _fused_kernel :151)"),
            ("X2", "candidate_maxsim (batched, tensor cores)",
             "candidate_maxsim.cu",
             f"{script}:268 (maxsim_candidates_pallas :261, _cand_kernel "
             f":251)"),
            ("X3", "candidate_maxsim (once per query)", "candidate_maxsim.cu",
             f"{script}:405 (v_record_perq_pallas :388, _perq_kernel "
             f":379)")):
        x = dict(stage2_k[key])
        x["err"] = max(x["err"], experiment["twin_err"][key])
        kernels[key] = entry(name, source, replaces,
                             experiment["launches"][key], x)
    kernels["X3"]["ms_note"] = ("the batch's B launches of B = 1, as "
                                "v_record_perq runs them")
    kernels["X1"]["f32_bound_ms"] = stage2_k["X1"]["shapes"][
        next(iter(stage2_k["X1"]["shapes"]))]["f32_bound_ms"]
    for k in kernels.values():
        # no single PyTorch call computes any of these functions
        k["library_ms"] = None
    # the served answers' error against the same search by the plain
    # versions, apart from each kernel's own error above
    print(json.dumps({"kernels": [kernels[k] for k in sorted(kernels)],
                      "searches": searches,
                      "exact_serve_err": serve_err,
                      "hier_serve_err": hier_serve_err,
                      "hier_serve_recall": hier_recall,
                      "searches_1m": legs_1m,
                      "compressed_serve": comp_serve,
                      "stage2_experiment": experiment,
                      "train_step_vs_cpu": train_step,
                      "train_slice": train_slice,
                      "preflmr_serve": preflmr,
                      "rag_serve": rag_serve,
                      "rag_train": rag_train,
                      "wit_pretrain": wit,
                      "m2kr": m2kr_run,
                      "roi": roi}, default=str), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
