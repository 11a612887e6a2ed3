"""RAVQA-v2 executor, inference half: retrieve, then generate an answer.

Port of the inference half of ravqa_tpu/executors/rag_executor.py
(reference RagBlipExecutor + RagModelForBlip, src/models/rag/
rag_model_blip.py):

- live retrieval: the FLMR query tower, then LateInteractionSearcher over
  the corpus index (K1 on a float32 index on the card; the pruned modes'
  kernels with `search_mode`); the retrieved docs' tokens and masks are
  gathered on the device for the in-graph re-scoring;
- static retrieval: a precomputed {question_id: [(row, score), ...]} map
  (FLMR prediction dumps, load_static_retrieval_from_predictions);
- generate: the query encoded again and each (question, doc) pair scored
  by paired MaxSim (ops.maxsim.maxsim_pair_xla); a T5 or BLIP-2 generator
  encodes "Question: .. Knowledge: .. Answer:" per pair (BLIP-2 with the
  question's image); greedy or beam decoding; the answer is the one of
  the doc maximizing log g(z|x) + log p(y|x,z).

BLIP-2 encodes each image once and repeats its projected query tokens for
the question's docs, where the JAX package repeats the image n_docs times
before the vision tower: the rows are independent, so the output is the
same. The decoder reads each layer's cross-attention keys and values
computed once per (question, doc) sequence (models/t5.py cross_kv), which
the beams of that sequence share, where the JAX step recomputes them from
the encoder output repeated over the beams at every step.

LoRA stays a separate dict until prepare_for_serving merges it into the
generator once, in place; before that, each generate runs the generator
on the merged weights (torch.func.functional_call), as the JAX package
merges per call. Training (make_train_batch, the RAG losses,
train_step_rag, refresh_index) is not ported: fit and train_step raise
(ROADMAP.md A6).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.convert import (generator_to_flax, lora_to_flax,
                              rag_params_to_torch, read_params_tree,
                              state_dict_to_flax, write_flax_msgpack)
from ..models.generation import beam_generate, greedy_generate
from ..models.lora import init_lora, lora_delta, merge_lora
from ..models.rag import GeneratorInputBuilder, select_answers_by_joint_score
from ..ops.maxsim import maxsim_pair_xla
from ..retrieval import LateInteractionSearcher, TokenIndex
from .base import CHECKPOINT_FILES, BaseExecutor, TrainConfig, _num_heads

_TRAINING = ("RAG training is not ported yet to ravqa_tpu_torch (see "
             "ROADMAP.md, Queue A: A6)")
LORA_TARGETS = ("self_attn/q", "self_attn/v", "cross_attn/q", "cross_attn/v")


@dataclasses.dataclass(frozen=True)
class RagConfig:
    n_docs: int = 5
    loss_type: str = "Approach4"          # RAVQA_loss_type
    nll_weight: float = 1.0
    rag_weight: float = 1.0               # loss_ratio.rag_loss
    additional_weight: float = 1.0        # loss_ratio.additional_loss
    use_lora: bool = True
    lora_rank: int = 8
    lora_alpha: float = 32.0
    max_decode_len: int = 10
    gen_maxlen: int = 96
    label_maxlen: int = 8
    generator_type: str = "t5"            # "t5" | "blip2" (RAVQA-v2)
    num_beams: int = 1                    # reference RAVQA-v2 uses 2
    search_mode: str = "exact"            # | "two_stage" | "hierarchical"
    n_candidates: Optional[int] = None    # pruned-mode candidate count
    #   (None -> the searcher's k-dependent preset)
    approx_topk: Optional[bool] = None    # the JAX searcher's TPU knobs:
    approx_recall: float = 0.95           #   no-ops here (exact cuts)
    centroid_prune: Optional[int] = None  # residual fine stage cut
    coarse_query_len: Optional[int] = None  # only the first L query rows
    #   drive the pruning stages
    search_preset: str = "reference"      # LateInteractionSearcher preset
    coarse_int8: Optional[bool] = None    # int8 pruning-stage summaries
    # published-config behaviours (reference rag_model_blip.py), read by
    # RAG training (A6); generation does not use them:
    n_docs_in_training: Optional[int] = None  # :552-557
    use_gt_docs_for_training: bool = False    # :559-573
    ignore_knowledge_passages: bool = False   # :617 (the input builder's)
    force_existence: bool = False             # :678-690


def _make_searcher(index: TokenIndex, mesh, rag_cfg: RagConfig):
    """Searcher for live retrieval, honouring rag_cfg.search_mode: the
    pruned modes build the summaries, hierarchical the block summaries of
    the largest block size in (64, 32, ..., 1) dividing the padded doc
    count. One device: a mesh raises (ROADMAP.md A4)."""
    mode = rag_cfg.search_mode
    if mode in ("two_stage", "hierarchical") and index.summaries is None:
        index.build_summaries()
    if mode == "hierarchical" and index.block_summaries is None:
        bs = max(b for b in (64, 32, 16, 8, 4, 2, 1) if index.n_pad % b == 0)
        index.build_block_summaries(block_size=bs)
    return LateInteractionSearcher(
        index, mesh=mesh, mode=mode, n_candidates=rag_cfg.n_candidates,
        approx_topk=rag_cfg.approx_topk, approx_recall=rag_cfg.approx_recall,
        centroid_prune=rag_cfg.centroid_prune,
        coarse_query_len=rag_cfg.coarse_query_len,
        coarse_int8=rag_cfg.coarse_int8, preset=rag_cfg.search_preset)


class RagModel(nn.Module):
    """The retriever and the generator as one module: the executor's
    model (state_dict names retriever.* and generator.*)."""

    def __init__(self, retriever: nn.Module, generator: nn.Module):
        super().__init__()
        self.retriever = retriever
        self.generator = generator


class _Method(nn.Module):
    """Calls a method of `module` through forward, so that
    torch.func.functional_call can run any generator method on other
    weights (keys "module.<name>")."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, method: str, *args):
        return getattr(self.module, method)(*args)


class RagExecutor(BaseExecutor):
    """Retrieve-then-generate on one device. retriever: an FLMRRetriever;
    generator: a T5Model, or a Blip2T5 with rag_cfg.generator_type
    "blip2"; both carry their weights. The executor holds no optimizer.
    With rag_cfg.use_lora, LoRA is initialized (B = 0, A from a CPU
    generator seeded seed + 1) on the q and v projections of the
    generator's self- and cross-attention (the JAX executor's targets)."""

    def __init__(self, retriever: nn.Module, generator: nn.Module,
                 gen_tokenizer, rag_cfg: RagConfig,
                 train_cfg: Optional[TrainConfig] = None,
                 query_tokenizer=None,
                 index: Optional[TokenIndex] = None,
                 passage_contents: Optional[Sequence[str]] = None,
                 static_retrieval: Optional[dict] = None,
                 input_builder: Optional[GeneratorInputBuilder] = None,
                 mesh=None, device=None, log_dir: Optional[str] = None,
                 seed: int = 0, quiet: bool = False):
        # prepare_for_serving runs inside BaseExecutor.__init__ (no
        # optimizer): no LoRA exists then, so it only drops the optimizer
        self.lora = None
        self._lora_premerged = False
        self.gen_tokenizer = gen_tokenizer
        self.query_tokenizer = query_tokenizer
        self.rag_cfg = rag_cfg
        self.index = index
        self.passage_contents = passage_contents
        self.static_retrieval = static_retrieval
        self.input_builder = input_builder or GeneratorInputBuilder(
            ignore_knowledge=rag_cfg.ignore_knowledge_passages)
        super().__init__(RagModel(retriever, generator), train_cfg, device,
                         log_dir, seed, quiet=quiet, inference_only=True)
        self.searcher = (_make_searcher(index, mesh, rag_cfg)
                         if index is not None else None)
        if rag_cfg.use_lora:
            self.lora = init_lora(
                generator, rank=rag_cfg.lora_rank, targets=LORA_TARGETS,
                generator=torch.Generator().manual_seed(seed + 1))
        self._call = _Method(generator)

    @property
    def _gcfg(self):
        cfg = self.model.generator.cfg
        return cfg.t5 if self.rag_cfg.generator_type == "blip2" else cfg

    # -- parameters -----------------------------------------------------------
    def _gen(self, method: str, *args):
        """generator.<method>(*args), on the LoRA-merged weights while the
        LoRA is not merged in place."""
        if self.lora is None:
            return getattr(self.model.generator, method)(*args)
        cfg = self.rag_cfg
        params = dict(self.model.generator.named_parameters())
        merged = merge_lora({k: params[k] for k in self.lora}, self.lora,
                            alpha=cfg.lora_alpha, rank=cfg.lora_rank)
        return torch.func.functional_call(
            self._call, {f"module.{k}": v for k, v in merged.items()},
            (method,) + args)

    def prepare_for_serving(self) -> None:
        """The deployment form: the LoRA merged into the generator's
        weights once, in place (generate then runs the generator as it is,
        with no per-call merge), and the optimizer dropped."""
        if self.lora is not None:
            cfg = self.rag_cfg
            params = dict(self.model.generator.named_parameters())
            with torch.no_grad():       # one weight's update alive at a time
                for name, entry in self.lora.items():
                    params[name].add_(lora_delta(entry, cfg.lora_alpha,
                                                 cfg.lora_rank))
            self.lora = None
            self._lora_premerged = True
        super().prepare_for_serving()

    def train_step(self, batch) -> dict:
        raise NotImplementedError(_TRAINING)

    def fit(self, *args, **kwargs):
        raise NotImplementedError(_TRAINING)

    # -- checkpoints ----------------------------------------------------------
    def load_params_tree(self, params: dict) -> None:
        """Load the JAX RagExecutor's params tree: {"retriever", "generator":
        {"base", "lora"}} (training form) or {"retriever", "generator"}
        (LoRA merged by prepare_for_serving). A merged tree leaves the
        executor merged; an unmerged one replaces the LoRA (merged at once
        if this executor is already merged)."""
        retriever_sd, generator_sd, lora = rag_params_to_torch(params)
        self.model.retriever.load_state_dict(retriever_sd, strict=True)
        self.model.generator.load_state_dict(generator_sd, strict=True)
        if lora is None:
            self.lora = None
            self._lora_premerged = self.rag_cfg.use_lora
            return
        if not self.rag_cfg.use_lora:
            raise ValueError("the checkpoint holds LoRA parameters; "
                             "rag.use_lora is false")
        self.lora = {name: {k: t.to(self.device) for k, t in entry.items()}
                     for name, entry in lora.items()}
        if self._lora_premerged:
            self._lora_premerged = False
            self.prepare_for_serving()

    def load_checkpoint(self, path: str) -> None:
        """A params file (flax msgpack or flattened-key .npz) or a
        checkpoint directory's params.msgpack / params.npz, written by the
        JAX RagExecutor or by save_checkpoint."""
        if os.path.isdir(path):
            found = [os.path.join(path, f) for f in CHECKPOINT_FILES
                     if os.path.exists(os.path.join(path, f))]
            if not found:
                raise FileNotFoundError(f"{path} holds none of "
                                        f"{CHECKPOINT_FILES}")
            path = found[0]
        self.load_params_tree(read_params_tree(path))

    def params_tree(self) -> dict:
        """The JAX RagExecutor's params tree of this executor's weights."""
        gen = generator_to_flax(self.model.generator)
        if self.lora is not None:
            gen = {"base": gen, "lora": lora_to_flax(self.lora)}
        return {"retriever": state_dict_to_flax(
                    self.model.retriever.state_dict(), _num_heads(self.model.retriever)),
                "generator": gen}

    def save_checkpoint(self, path: str, backend: str = "msgpack"):
        """params.msgpack (the JAX package's format) and step.json."""
        if backend != "msgpack":
            raise NotImplementedError(f"checkpoint backend {backend!r} is "
                                      "not ported (msgpack only)")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "params.msgpack"), "wb") as f:
            f.write(write_flax_msgpack(self.params_tree()))
        with open(os.path.join(path, "step.json"), "w") as f:
            json.dump({"step": self.step}, f)

    # -- retrieval ------------------------------------------------------------
    def encode_query(self, batch) -> torch.Tensor:
        """The batch's FLMR query embeddings (B, Lq, dim) on the device."""
        feats = batch.get("image_features")
        return self.model.retriever.query(
            self._t(batch["query_input_ids"], torch.long),
            self._t(batch["query_attention_mask"]),
            None if feats is None else self._t(feats, torch.float32))

    @torch.inference_mode()
    def retrieve(self, batch) -> dict:
        """rows (B, n_docs) numpy (-1: a dummy passage), the docs' token
        embeddings (B, n_docs, Ld, dim) and masks (B, n_docs, Ld), float32
        on the index's device (dummy docs all zero), and their contents
        ("" for a dummy)."""
        n_docs = self.rag_cfg.n_docs
        if self.static_retrieval is not None:
            rows = []
            for q in batch["question_ids"]:
                ann = self.static_retrieval.get(str(q))
                if ann is None:
                    ann = self.static_retrieval.get(q)
                if not ann:
                    # a missing question id gets dummy passages (the
                    # reference substitutes empty docs, :541-548)
                    rows.append([-1] * n_docs)
                else:
                    row = [p for p, _ in ann[:n_docs]]
                    rows.append(row + [-1] * (n_docs - len(row)))
            rows = np.asarray(rows, np.int64)
        else:
            _, found = self.searcher.search_device(self.encode_query(batch),
                                                   k=n_docs)
            rows = found.cpu().numpy()
        # dummies: static -1 rows, and live rows on index padding (pid -1,
        # when n_docs > num_docs), which would otherwise serve
        # passage_contents[-1]
        pids_of = self.index.pids[np.where(rows < 0, 0, rows)]
        dummy = (rows < 0) | (pids_of < 0)
        dev = self.index.device
        rows_dev = torch.as_tensor(np.where(dummy, 0, rows), device=dev)
        keep = torch.as_tensor(~dummy, device=dev)
        doc_tokens = self.index.gather_tokens(rows_dev) \
            * keep[..., None, None]
        doc_masks = self.index.mask[rows_dev].float() * keep[..., None]
        contents = [[self.passage_contents[self.index.pids[r]]
                     if not d else "" for r, d in zip(row, drow)]
                    for row, drow in zip(rows, dummy)]
        return {"rows": rows, "doc_tokens": doc_tokens,
                "doc_masks": doc_masks, "contents": contents}

    def _tensorize(self, texts, maxlen):
        tk = self.gen_tokenizer
        ids = np.full((len(texts), maxlen), tk.pad_token_id, np.int32)
        mask = np.zeros((len(texts), maxlen), np.int32)
        for i, t in enumerate(texts):
            row = tk.encode(t, add_special_tokens=False)[:maxlen]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask

    # -- generation -----------------------------------------------------------
    def doc_scores(self, batch, doc_tokens, doc_masks) -> torch.Tensor:
        """(B, n_docs) paired MaxSim of the re-encoded query and each of its
        retrieved docs."""
        b, n_docs = doc_tokens.shape[:2]
        q = self.encode_query(batch).repeat_interleave(n_docs, dim=0)
        return maxsim_pair_xla(q, doc_tokens.flatten(0, 1),
                               doc_masks.flatten(0, 1)).reshape(b, n_docs)

    def encode_generator(self, gen_ids, gen_mask, pixel_values=None):
        """The generator's encoder over the B * n_docs (question, doc)
        inputs -> (encoder hidden, its mask). BLIP-2 encodes each of the B
        images once and repeats its tokens for the question's docs."""
        ids = self._t(gen_ids, torch.long)
        mask = self._t(gen_mask)
        if self.rag_cfg.generator_type != "blip2":
            return self._gen("encode", ids, mask), mask
        px = self._t(pixel_values, torch.float32)
        vis = self._gen("encode_image", px).repeat_interleave(
            ids.shape[0] // px.shape[0], dim=0)
        return self._gen("encode_tokens", vis, ids, mask)

    def decode(self, enc_side, enc_mask):
        """Greedy or beam decoding of every sequence (the best beam).
        enc_side: the encoder output (its cross-attention keys and values
        then computed at every step) or cross_kv's pairs. Returns
        (tokens (N, max_decode_len), log-probs (N,))."""
        cfg, gcfg = self.rag_cfg, self._gcfg
        n = enc_mask.shape[0]
        ids = dict(max_len=cfg.max_decode_len,
                   start_id=gcfg.decoder_start_token_id,
                   eos_id=gcfg.eos_token_id, pad_id=gcfg.pad_token_id)

        def step(tok, cache):
            return self._gen("decode_step", tok, enc_side, enc_mask, cache)

        def cache_fn(rows):
            return self.model.generator.init_cache(rows, cfg.max_decode_len)

        if cfg.num_beams > 1:
            seqs, scores = beam_generate(step, cache_fn, batch=n,
                                         n_beams=cfg.num_beams, **ids)
            return seqs[:, 0], scores[:, 0]
        return greedy_generate(step, cache_fn(n), batch=n, **ids)

    @torch.inference_mode()
    def generate(self, batch) -> dict:
        """Greedy or beam decoding per (question, doc); the answer by joint
        score. batch: questions, query_input_ids, query_attention_mask,
        image_features, pixel_values (BLIP-2), question_ids (static
        retrieval)."""
        cfg, gcfg = self.rag_cfg, self._gcfg
        ret = self.retrieve(batch)
        gen_texts = self.input_builder.build(batch["questions"],
                                             ret["contents"])
        gi, gm = self._tensorize(gen_texts, cfg.gen_maxlen)
        b, n_docs = ret["rows"].shape
        doc_scores = self.doc_scores(batch, ret["doc_tokens"],
                                     ret["doc_masks"])
        enc, enc_mask = self.encode_generator(gi, gm,
                                              batch.get("pixel_values"))
        toks, seq_lp = self.decode(self._gen("cross_kv", enc), enc_mask)
        doc_scores = doc_scores.cpu().numpy()
        toks = toks.cpu().numpy().reshape(b, n_docs, -1)
        seq_lp = seq_lp.cpu().numpy().reshape(b, n_docs)
        sel = select_answers_by_joint_score(doc_scores, seq_lp)
        preds = []
        for i in range(b):
            ids = [int(t) for t in toks[i, sel[i]]
                   if t not in (gcfg.pad_token_id, gcfg.eos_token_id)]
            preds.append(self.gen_tokenizer.decode(ids))
        return {"predictions": preds, "doc_scores": doc_scores,
                "retrieved_contents": ret["contents"],
                "all_generations": toks, "selected_docs": sel,
                "seq_logprobs": seq_lp}


def load_static_retrieval_from_predictions(json_path: str,
                                           corpus_ids: Sequence) -> dict:
    """A static-retrieval map from an FLMR test-mode prediction dump (the
    `<split>_predictions.json` of main.py's run_eval; the reference's
    *_test_*_predictions_rank_*.json handoff, FLMR_executor.py:1012-1018).
    Returns {question_id: [(corpus_row, score), ...]}; a passage without a
    score scores -rank."""
    id2row = {str(pid): i for i, pid in enumerate(corpus_ids)}
    with open(json_path) as f:
        preds = json.load(f)
    out = {}
    for p in preds:
        rows = []
        for rank, passage in enumerate(p["top_ranking_passages"]):
            row = id2row.get(str(passage["passage_id"]))
            if row is not None:
                rows.append((row, float(passage.get("score",
                                                    -float(rank)))))
        out[str(p["question_id"])] = rows
    return out
