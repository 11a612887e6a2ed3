"""M2KR multi-task retrieval: PreFLMR's training recipe and its
evaluation.

Port of ravqa_tpu/executors/m2kr.py. The PreFLMR benchmark (M2KR) scores
one checkpoint across WIT / IGLUE / KVQA / MSMARCO / OVEN / LLaVA / EVQA /
OKVQA / Infoseek, each with its own corpus, instruction prompt and
Recall@K:

- evaluate_m2kr: per task, index its corpus, search its questions and
  score them (FLMRExecutor.evaluate_retrieval: K1 on the card), dropping
  the task's index before the next one's is built;
- the training recipe: each task's query text prefixed by its instruction
  (apply_task_instructions), batches each drawn whole from one task with
  the task picked from size-tempered mixture weights (multitask_loader:
  the task draws from numpy default_rng(seed), task i's batches from
  seed + 31 * i, so both packages see one sequence of (task, batch)), one
  train step each, and evaluate_m2kr every val_every steps (train_m2kr).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..data.datasets import (PassageCorpus, RetrievalDataset,
                             corpus_doc_batches, query_eval_batches)
from .flmr_executor import FLMRExecutor

# the instruction prompts PreFLMR uses per task family
DEFAULT_INSTRUCTIONS = {
    "wit": "Identify the document that is associated with the image.",
    "iglue": "Identify the document that is associated with the image.",
    "kvqa": "Retrieve documents that provide an answer to the question "
            "alongside the image: ",
    "msmarco": "Find the document that answers the question: ",
    "oven": "Retrieve a fact providing answers for the given question "
            "and image: ",
    "llava": "Retrieve the document that is relevant to the question "
             "and image: ",
    "evqa": "Using the provided image, obtain documents that address "
            "the subsequent question: ",
    "okvqa": "Retrieve documents that provide an answer to the question "
             "alongside the image: ",
    "infoseek": "Using the provided image, obtain documents that address "
                "the subsequent question: ",
}


@dataclasses.dataclass
class M2KRTask:
    name: str
    dataset: RetrievalDataset       # eval split
    corpus: PassageCorpus
    ks: Sequence[int] = (1, 5, 10)
    use_answers: bool = True        # also compute pseudo-relevance scores
    train_dataset: Optional[RetrievalDataset] = None  # train split (the
    #   multi-task trainer falls back to `dataset` when absent)


def evaluate_m2kr(executor: FLMRExecutor, tasks: Sequence[M2KRTask],
                  batch_size: int = 64) -> dict:
    """Each task's evaluation: {task: {metric: value}}, plus "_flat" with
    every metric as "<task>/<metric>"."""
    results: dict = {}
    for task in tasks:
        ds = task.dataset
        metrics = executor.evaluate_retrieval(
            query_eval_batches(ds, batch_size=batch_size),
            corpus_doc_batches(task.corpus, ds.dt, batch_size=batch_size),
            passage_ids=task.corpus.ids,
            passage_contents=task.corpus.contents if task.use_answers
            else None,
            answers=[it.get("answers") for it in ds.items]
            if task.use_answers and "answers" in ds.items[0] else None,
            pos_item_ids=[it.get("pos_item_ids", []) for it in ds.items],
            ks=task.ks)
        results[task.name] = {k: v for k, v in metrics.items()
                              if not k.startswith("_")}
        del metrics                 # the task's index, before the next one's
    flat = {}
    for name, m in results.items():
        for k, v in m.items():
            flat[f"{name}/{k}"] = v
    results["_flat"] = flat
    return results


def instruction_input_modules(instruction: str,
                              question_too: bool = True) -> list[dict]:
    """Input modules putting a task's instruction before the query text
    (ModuleParser.InstructionInput): "instruction question"."""
    mod = {"type": "InstructionInput", "option": "default",
           "separation_tokens": {"start": instruction, "end": ""},
           "prompts": [instruction]}
    return [mod] if question_too else [mod,
                                       {"type": "EmptyTextInput",
                                        "option": "default"}]


def apply_task_instructions(tasks: Sequence[M2KRTask]) -> None:
    """Give each task's datasets its instruction (DEFAULT_INSTRUCTIONS by
    task name), unless a dataset's input modules already hold an
    InstructionInput."""
    for t in tasks:
        instr = DEFAULT_INSTRUCTIONS.get(t.name.lower())
        if instr is None:
            continue
        for ds in {id(d): d for d in (t.dataset, t.train_dataset)
                   if d is not None}.values():
            if any(m.get("type") == "InstructionInput"
                   for m in ds.input_modules):
                continue
            ds.input_modules = instruction_input_modules(instr)


def task_mixture_weights(tasks: Sequence[M2KRTask],
                         sampling: str = "temperature",
                         temperature: float = 4.0,
                         ratios: Optional[dict] = None) -> np.ndarray:
    """Sampling probabilities over tasks. "temperature": p_i ~ n_i^(1/T)
    (T = 1 proportional to size, large T uniform); "ratio": `ratios` by
    name (1.0 for a task not listed); "uniform"."""
    if sampling == "ratio":
        w = np.array([float((ratios or {}).get(t.name, 1.0))
                      for t in tasks])
    elif sampling == "uniform":
        w = np.ones(len(tasks))
    elif sampling == "temperature":
        n = np.array([float(len(t.train_dataset or t.dataset))
                      for t in tasks])
        w = n ** (1.0 / max(temperature, 1e-6))
    else:
        raise ValueError(sampling)
    return w / w.sum()


def multitask_loader(tasks: Sequence[M2KRTask], batch_size: int,
                     sampling: str = "temperature",
                     temperature: float = 4.0,
                     ratios: Optional[dict] = None, seed: int = 0):
    """Endless (task name, batch): each batch drawn whole from one task,
    the task drawn from the mixture weights."""
    names = [t.name for t in tasks]
    assert len(set(names)) == len(names), \
        f"duplicate task names: {names} (iterators are keyed by name)"
    probs = task_mixture_weights(tasks, sampling, temperature, ratios)
    rng = np.random.default_rng(seed)
    for t in tasks:
        n = len(t.train_dataset or t.dataset)
        assert n >= batch_size, \
            (f"task '{t.name}' has {n} items < batch_size {batch_size} "
             "(the loader drops incomplete batches, so this task would "
             "never yield)")
    iters = {t.name: iter((t.train_dataset or t.dataset).loader(
        batch_size, shuffle=True, seed=seed + 31 * i))
        for i, t in enumerate(tasks)}
    while True:
        name = names[int(rng.choice(len(names), p=probs))]
        yield name, next(iters[name])


def train_m2kr(executor: FLMRExecutor, tasks: Sequence[M2KRTask],
               steps: int, batch_size: int = 8,
               sampling: str = "temperature", temperature: float = 4.0,
               ratios: Optional[dict] = None, seed: int = 0,
               val_every: Optional[int] = None, eval_batch_size: int = 64,
               log_every: int = 50,
               apply_instructions: bool = True) -> dict:
    """Multi-task training: mixture-sampled batches through the executor's
    train_step, each task's last loss kept on the device and read on the
    host only at a log point (every log_every steps and the last), logged
    under train/<task>/loss and train/<task>/batches; evaluate_m2kr every
    val_every steps, logged under eval/<task>/<metric>.

    Returns {"per_task_loss": {task: last}, "per_task_batches": {task: n},
    "eval_history": [evaluate_m2kr results]}."""
    if apply_instructions:
        apply_task_instructions(tasks)
    loader = multitask_loader(tasks, batch_size, sampling, temperature,
                              ratios, seed)
    task_loss: dict = {}
    task_count: dict = {}
    eval_history: list = []
    for step in range(steps):
        name, batch = next(loader)
        metrics = executor.train_step(batch)
        task_loss[name] = metrics["loss"]
        task_count[name] = task_count.get(name, 0) + 1
        if (step + 1) % log_every == 0 or step == steps - 1:
            task_loss = {n: float(v) for n, v in task_loss.items()}
            rec = {f"{n}/loss": v for n, v in task_loss.items()}
            rec.update({f"{n}/batches": c for n, c in task_count.items()})
            executor.logger.log(rec, executor.step, prefix="train/")
        if val_every and (step + 1) % val_every == 0:
            res = evaluate_m2kr(executor, tasks, batch_size=eval_batch_size)
            executor.logger.log(res["_flat"], executor.step, prefix="eval/")
            eval_history.append(res)
    return {"per_task_loss": {n: float(v) for n, v in task_loss.items()},
            "per_task_batches": task_count,
            "eval_history": eval_history}
