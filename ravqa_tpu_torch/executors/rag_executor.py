"""RAVQA-v2 executor: retrieve-then-generate training, and generation.

Port of ravqa_tpu/executors/rag_executor.py (reference RagBlipExecutor +
RagModelForBlip, src/models/rag/rag_model_blip.py):

- live retrieval: the FLMR query tower, then LateInteractionSearcher over
  the corpus index (K1 on a float32 index on the card; the pruned modes'
  kernels with `search_mode`); the retrieved docs' tokens and masks are
  gathered on the device for the in-graph re-scoring. In training
  (retrieve(training=True)) the published recipe's flags apply:
  use_gt_docs_for_training draws each passage slot from the question's
  positives, n_docs_in_training keeps a random subset of the top n_docs,
  both from the executor's numpy default_rng(seed) in the JAX order;
- static retrieval: a precomputed {question_id: [(row, score), ...]} map
  (FLMR prediction dumps, load_static_retrieval_from_predictions);
- training: make_train_batch (live retrieval, the retrieval labels, the
  labels: force_existence's per-doc selected answers or the gold answer
  repeated), loss_fn (the query re-encoded with gradients and each
  (question, doc) pair scored by paired MaxSim, ops.maxsim.maxsim_pair_xla;
  the generator's teacher-forced logits; models.rag.rag_loss_components),
  train_step_rag and fit through BaseExecutor's trainer, refresh_index;
- generate: the query encoded again and each (question, doc) pair scored
  by paired MaxSim; a T5 or BLIP-2 generator encodes "Question: ..
  Knowledge: .. Answer:" per pair (BLIP-2 with the question's image);
  greedy or beam decoding; the answer is the one of the doc maximizing
  log g(z|x) + log p(y|x,z).

BLIP-2 encodes each image once and repeats its projected query tokens for
the question's docs, in training and generation, where the JAX package
repeats the image n_docs times before the vision tower: the rows are
independent, so the output is the same. The decoder reads each layer's
cross-attention keys and values computed once per (question, doc)
sequence (models/t5.py cross_kv), which the beams of that sequence share,
where the JAX step recomputes them from the encoder output repeated over
the beams at every step.

LoRA (rag_cfg.use_lora) lives in model.lora (models.lora.LoRAParams) and
trains with the retriever; the generator's own weights are frozen: they
take no grad (requires_grad False, the JAX executor's stop_gradient) and
no optimizer state (freeze_generator_base). Each generator call runs on
the merged weights W + (alpha / rank) * (A @ B)^T
(torch.func.functional_call), the JAX package's arithmetic, and gradients
reach A and B through the merge; T5's remat recomputes a block on the same
merged tensors. prepare_for_serving merges the LoRA into the weights once,
in place, and drops the optimizer; an executor built inference_only
starts merged (a fresh LoRA has B = 0) and cannot train.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.convert import (generator_to_flax, lora_to_flax,
                              rag_params_to_torch, state_dict_to_flax)
from ..models.generation import beam_generate, greedy_generate
from ..models.lora import LoRAParams, init_lora, lora_delta, merge_lora
from ..models.rag import (GeneratorInputBuilder, get_retrieval_labels,
                          most_frequent, rag_loss_components,
                          select_answers_by_joint_score)
from ..models.t5 import shift_right
from ..ops.maxsim import maxsim_pair_xla
from ..retrieval import LateInteractionSearcher, TokenIndex
from .base import BaseExecutor, TrainConfig, _num_heads, make_optimizer

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
    # published-config behaviours (reference rag_model_blip.py), read in
    # training; generation does not use them:
    n_docs_in_training: Optional[int] = None  # :552-557
    use_gt_docs_for_training: bool = False    # :559-573
    ignore_knowledge_passages: bool = False   # :617 (the input builder's)
    force_existence: bool = False             # :678-690


def _make_searcher(index: TokenIndex, mesh, rag_cfg: RagConfig):
    """Searcher for live retrieval, honouring rag_cfg.search_mode: the
    pruned modes build the summaries, hierarchical the block summaries of
    the largest block size in (64, 32, ..., 1) dividing the per-shard doc
    count. On a mesh the index is sharded over its "data" axis (JAX
    rag_executor.py:89-104)."""
    mode = rag_cfg.search_mode
    if mode in ("two_stage", "hierarchical") and index.summaries is None:
        index.build_summaries()
    if mode == "hierarchical" and index.block_summaries is None:
        bs = max(b for b in (64, 32, 16, 8, 4, 2, 1)
                 if index.n_local % b == 0)
        index.build_block_summaries(block_size=bs)
    return LateInteractionSearcher(
        index, mesh, "data" if mesh is not None else "index", mode=mode,
        n_candidates=rag_cfg.n_candidates,
        approx_topk=rag_cfg.approx_topk, approx_recall=rag_cfg.approx_recall,
        centroid_prune=rag_cfg.centroid_prune,
        coarse_query_len=rag_cfg.coarse_query_len,
        coarse_int8=rag_cfg.coarse_int8, preset=rag_cfg.search_preset)


class RagModel(nn.Module):
    """The retriever and the generator as one module: the executor's
    model (state_dict names retriever.* and generator.*, and lora.* while
    the executor trains a LoRA)."""

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
    """Retrieve-then-generate, on one device or a "data" mesh (`mesh`:
    the index sharded over it, the training data parallel). retriever: an
    FLMRRetriever; generator: a T5Model, or a Blip2T5 with
    rag_cfg.generator_type "blip2"; both carry their weights. With
    rag_cfg.use_lora, LoRA is initialized (B = 0, A from a CPU generator seeded seed + 1) on the q
    and v projections of the generator's self- and cross-attention (the
    JAX executor's targets). passage_ids (the corpus' ids, in index order)
    serve use_gt_docs_for_training. inference_only builds no optimizer and
    no LoRA (see the module docstring)."""

    # on a mesh each rank's loss is its share of the global batch's
    # (rag_loss_components with the data-parallel group)
    loss_is_sum = True

    def __init__(self, retriever: nn.Module, generator: nn.Module,
                 gen_tokenizer, rag_cfg: RagConfig,
                 train_cfg: Optional[TrainConfig] = None,
                 query_tokenizer=None,
                 index: Optional[TokenIndex] = None,
                 passage_contents: Optional[Sequence[str]] = None,
                 passage_ids: Optional[Sequence] = None,
                 static_retrieval: Optional[dict] = None,
                 input_builder: Optional[GeneratorInputBuilder] = None,
                 mesh=None, device=None, log_dir: Optional[str] = None,
                 seed: int = 0, quiet: bool = False,
                 inference_only: bool = False):
        self.gen_tokenizer = gen_tokenizer
        self.query_tokenizer = query_tokenizer
        self.rag_cfg = rag_cfg
        self.mesh = mesh
        self.passage_contents = passage_contents
        self.passage_ids = passage_ids
        self.static_retrieval = static_retrieval
        self.input_builder = input_builder or GeneratorInputBuilder(
            ignore_knowledge=rag_cfg.ignore_knowledge_passages)
        self._rng = np.random.default_rng(seed)
        model = RagModel(retriever, generator)
        # a fresh LoRA has B = 0, so merged it is the base itself: an
        # inference executor starts merged and draws none
        self._lora_premerged = rag_cfg.use_lora and inference_only
        train_cfg = train_cfg or TrainConfig()
        if rag_cfg.use_lora:
            if not inference_only:
                model.lora = LoRAParams(init_lora(
                    generator, rank=rag_cfg.lora_rank, targets=LORA_TARGETS,
                    generator=torch.Generator().manual_seed(seed + 1)))
            generator.requires_grad_(False)
            train_cfg = dataclasses.replace(
                train_cfg, modules=tuple(train_cfg.modules)
                + ("freeze_generator_base",))
        super().__init__(model, train_cfg, device, log_dir, seed,
                         quiet=quiet, inference_only=inference_only,
                         mesh=mesh)
        self._set_index(index)
        self._call = _Method(generator)

    def _set_index(self, index: Optional[TokenIndex]) -> None:
        """Use `index`: its searcher, and the corpus passage id -> index
        row map of use_gt_docs_for_training."""
        self.index = index
        self.searcher = (_make_searcher(index, self.mesh, self.rag_cfg)
                         if index is not None else None)
        self._pid2row = None
        if self.passage_ids is not None and index is not None:
            corpus2row = {int(c): r for r, c in enumerate(
                np.asarray(index.pids).tolist()) if c >= 0}
            self._pid2row = {str(pid): corpus2row[i]
                             for i, pid in enumerate(self.passage_ids)
                             if i in corpus2row}

    @property
    def _gcfg(self):
        cfg = self.model.generator.cfg
        return cfg.t5 if self.rag_cfg.generator_type == "blip2" else cfg

    # -- parameters -----------------------------------------------------------
    @property
    def lora(self) -> Optional[dict]:
        """{adapted weight name: {"lora_a", "lora_b"}}, the parameters of
        model.lora; None without a LoRA or once it is merged."""
        module = getattr(self.model, "lora", None)
        return None if module is None else module.entries()

    @lora.setter
    def lora(self, lora: Optional[dict]) -> None:
        """Set the LoRA: copied into model.lora's parameters when it has
        the same entries (the optimizer keeps them); else model.lora is
        replaced (None: removed) and the optimizer rebuilt."""
        current = self.lora
        if lora is not None and current is not None \
                and current.keys() == lora.keys():
            with torch.no_grad():
                for name, entry in lora.items():
                    for key, t in entry.items():
                        current[name][key].copy_(t)
            return
        if current is not None:
            del self.model.lora
        if lora is not None:
            self.model.lora = LoRAParams(
                {name: {k: t.detach().to(self.device)
                        for k, t in entry.items()}
                 for name, entry in lora.items()})
        if self.optimizer is not None:
            self.optimizer = make_optimizer(self.train_cfg, self.model)

    def _gen(self, method: str, *args):
        """generator.<method>(*args), on the LoRA-merged weights while the
        LoRA is not merged in place."""
        lora = self.lora
        if lora is None:
            return getattr(self.model.generator, method)(*args)
        cfg = self.rag_cfg
        params = dict(self.model.generator.named_parameters())
        merged = merge_lora({k: params[k] for k in lora}, lora,
                            alpha=cfg.lora_alpha, rank=cfg.lora_rank)
        return torch.func.functional_call(
            self._call, {f"module.{k}": v for k, v in merged.items()},
            (method,) + args)

    def prepare_for_serving(self) -> None:
        """The deployment form: the LoRA merged into the generator's
        weights once, in place (generate then runs the generator as it is,
        with no per-call merge), and the optimizer dropped."""
        lora = self.lora
        if lora is not None:
            cfg = self.rag_cfg
            params = dict(self.model.generator.named_parameters())
            with torch.no_grad():       # one weight's update alive at a time
                for name, entry in lora.items():
                    params[name].add_(lora_delta(entry, cfg.lora_alpha,
                                                 cfg.lora_rank))
            del self.model.lora
            self._lora_premerged = True
        super().prepare_for_serving()

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

    def _named_params(self) -> dict:
        return dict(self.model.named_parameters())

    def _to_flax(self, values: dict) -> dict:
        """{parameter name: tensor} (retriever.*, generator.*,
        lora.adapters.*; any subset) -> the JAX RagExecutor's tree of
        those leaves: {"retriever", "generator"}, the generator split into
        {"base", "lora"} while the LoRA is not merged."""
        sub = {"retriever": {}, "generator": {}}
        lora: dict = {}
        for key, t in values.items():
            top, _, rest = key.partition(".")
            if top == "lora":
                name, leaf = rest.removeprefix("adapters.").rsplit(".", 1)
                lora.setdefault(name.replace("/", "."), {})[leaf] = t
            else:
                sub[top][rest] = t
        gen = generator_to_flax(self.model.generator, sub["generator"])
        if self.lora is not None:
            gen = {"base": gen, "lora": lora_to_flax(lora)}
        return {"retriever": state_dict_to_flax(
                    sub["retriever"], _num_heads(self.model.retriever)),
                "generator": gen}

    def _from_flax(self, tree: dict) -> dict:
        retriever_sd, generator_sd, lora = rag_params_to_torch(
            {"retriever": tree.get("retriever", {}),
             "generator": tree.get("generator", {})})
        out = {f"retriever.{k}": t for k, t in retriever_sd.items()}
        out.update({f"generator.{k}": t for k, t in generator_sd.items()})
        for name, entry in (lora or {}).items():
            for leaf, t in entry.items():
                out[f"lora.adapters.{name.replace('.', '/')}.{leaf}"] = t
        return out

    def params_tree(self) -> dict:
        """The JAX RagExecutor's params tree of this executor's weights."""
        return self._to_flax(self._named_params())

    # -- retrieval ------------------------------------------------------------
    def encode_query(self, batch) -> torch.Tensor:
        """The batch's FLMR query embeddings (B, Lq, dim) on the device."""
        feats = batch.get("image_features")
        return self.model.retriever.query(
            self._t(batch["query_input_ids"], torch.long),
            self._t(batch["query_attention_mask"]),
            None if feats is None else self._t(feats, torch.float32))

    @torch.no_grad()
    def retrieve(self, batch, training: bool = False) -> dict:
        """rows (B, n) numpy (-1: a dummy passage), the docs' token
        embeddings (B, n, Ld, dim) and masks (B, n, Ld), float32 on the
        index's device (dummy docs all zero), and their contents ("" for a
        dummy). n is n_docs, or n_docs_in_training in training.

        training=True applies the reference's training-only behaviours:
        use_gt_docs_for_training (rag_model_blip.py:559-573: each slot an
        independently drawn positive, when the batch has pos_item_ids) and
        the n_docs_in_training random subset (:552-557)."""
        cfg = self.rag_cfg
        n_docs = cfg.n_docs
        pos_ids = batch.get("pos_item_ids")
        if training and cfg.use_gt_docs_for_training \
                and pos_ids is not None and self._pid2row is not None:
            rows = np.array(
                [[self._pid2row.get(
                    str(pos[self._rng.integers(len(pos))]), -1)
                  for _ in range(n_docs)] if pos else [-1] * n_docs
                 for pos in pos_ids], np.int64)
        elif self.static_retrieval is not None:
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
        if training and cfg.n_docs_in_training \
                and cfg.n_docs_in_training < rows.shape[1]:
            cols = np.stack([self._rng.permutation(rows.shape[1])
                             [:cfg.n_docs_in_training]
                             for _ in range(rows.shape[0])])
            rows = np.take_along_axis(rows, cols, axis=1)
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
        doc_masks = self.index.gather_mask(rows_dev) * keep[..., None]
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

    def _labels(self, texts, maxlen):
        """Label ids (N, maxlen): each text's tokens cut to maxlen - 1, EOS,
        then -100."""
        tk = self.gen_tokenizer
        eos = getattr(tk, "eos_token_id", None) or tk.sep_token_id
        out = np.full((len(texts), maxlen), -100, np.int32)
        for i, t in enumerate(texts):
            row = tk.encode(t, add_special_tokens=False)[:maxlen - 1] + [eos]
            out[i, :len(row)] = row
        return out

    # -- training -------------------------------------------------------------
    def make_train_batch(self, batch) -> dict:
        """A training micro-batch on the device: live retrieval
        (retrieve(training=True)), the retrieval labels, the generator's
        inputs and the labels (force_existence: each doc's selected answer;
        else the gold answer repeated per doc). batch: questions, answers,
        query_input_ids, query_attention_mask, image_features,
        pixel_values (BLIP-2), question_ids (static retrieval),
        pos_item_ids (use_gt_docs_for_training)."""
        cfg = self.rag_cfg
        ret = self.retrieve(batch, training=True)
        answers = batch["answers"]
        retrieval_labels, selected = get_retrieval_labels(answers,
                                                          ret["contents"])
        gi, gm = self._tensorize(
            self.input_builder.build(batch["questions"], ret["contents"]),
            cfg.gen_maxlen)
        if cfg.force_existence:
            label_texts = selected
        else:
            n = ret["rows"].shape[1]
            label_texts = [most_frequent([a for a in ans if a != ""])
                           for ans in answers for _ in range(n)]
        feats = batch.get("image_features")
        out = {"query_input_ids": self._t(batch["query_input_ids"],
                                          torch.long),
               "query_attention_mask": self._t(batch["query_attention_mask"]),
               "image_features": (None if feats is None else
                                  self._t(feats, torch.float32)),
               "doc_tokens": ret["doc_tokens"], "doc_masks": ret["doc_masks"],
               "gen_input_ids": self._t(gi, torch.long),
               "gen_attention_mask": self._t(gm),
               "labels": self._t(self._labels(label_texts, cfg.label_maxlen),
                                 torch.long),
               "retrieval_labels": self._t(retrieval_labels)}
        if cfg.generator_type == "blip2":
            out["pixel_values"] = self._t(batch["pixel_values"],
                                          torch.float32)
        return out

    def loss_fn(self, batch, generator=None):
        """rag_loss_components of a make_train_batch batch: the query
        re-encoded with gradients, the doc scores by paired MaxSim, the
        generator's teacher-forced logits for shift_right(labels) on the
        LoRA-merged weights. Returns (loss, {nll_loss, rag_loss,
        additional_loss})."""
        cfg, gcfg = self.rag_cfg, self._gcfg
        doc_scores = self.doc_scores(batch, batch["doc_tokens"],
                                     batch["doc_masks"])
        args = (batch["gen_input_ids"], batch["gen_attention_mask"],
                shift_right(batch["labels"], gcfg.decoder_start_token_id,
                            gcfg.pad_token_id))
        if cfg.generator_type == "blip2":
            args = (batch["pixel_values"],) + args
        out = rag_loss_components(
            self._gen("forward", *args), doc_scores, batch["labels"],
            retrieval_labels=batch["retrieval_labels"],
            loss_type=cfg.loss_type, rag_loss_weight=cfg.rag_weight,
            additional_loss_weight=cfg.additional_weight,
            nll_loss_weight=cfg.nll_weight, group=self.dp_group)
        return out["loss"], {k: v.detach() for k, v in out.items()
                             if k != "loss"}

    def train_step_rag(self, batch) -> dict:
        """make_train_batch, then one micro-step of the trainer."""
        return self.train_step(self.make_train_batch(batch))

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


def refresh_index(executor: RagExecutor, flmr_executor,
                  doc_batches) -> None:
    """Re-encode the corpus with the executor's current retriever and swap
    its index and searcher in place (live retrieval during joint training
    otherwise searches an index of the retriever as it was).
    flmr_executor: an FLMRExecutor whose model takes the retriever's
    weights; doc_batches: corpus_doc_batches of the corpus in index
    order."""
    flmr_executor.model.load_state_dict(
        executor.model.retriever.state_dict())
    executor._set_index(flmr_executor.build_index(list(doc_batches)))
