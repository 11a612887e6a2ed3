"""Prediction tables (observability parity with the reference's wandb
tables, FLMR_executor.py:897-973 / :1012-1018).

Schema matches the reference exactly: columns
  question_id, input_image, image_key, question, caption, answers,
  gold_answer, p_0 .. p_{K-1}
where each p_i is "true|<content>" / "false|<content>" depending on whether
any answer appears in the passage (the reference's string-match marking).
Tables write as JSONL (always available); an `image_loader` callable maps
an item to an image artifact reference (the reference's
log_prediction_tables_with_images hook) — text file name by default.

The port's own copy of ravqa_tpu/utils/tables.py (host-only code).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence


def table_columns(max_k: int) -> list[str]:
    return (["question_id", "input_image", "image_key", "question",
             "caption", "answers", "gold_answer"]
            + [f"p_{i}" for i in range(max_k)])


def build_prediction_table(
    items: Sequence[dict],
    retrieved_contents: Sequence[Sequence[str]],
    max_k: int,
    image_loader: Optional[Callable[[dict], object]] = None,
):
    """-> (columns, rows). items need question_id/question/answers (+
    optional img_file_name, image_id, img_caption, gold_answer)."""
    columns = table_columns(max_k)
    rows = []
    for item, contents in zip(items, retrieved_contents):
        caption = item.get("img_caption") or ""
        if isinstance(caption, dict):
            caption = caption.get("caption", "")
        img = item.get("img_file_name") \
            or str(item.get("img_path", "")).split("/")[-1]
        if image_loader is not None:
            img = image_loader(item)
        answers = list(item.get("answers", []))
        row = [item.get("question_id"), img,
               item.get("img_key", item.get("image_id")),
               item.get("question", ""), caption, answers,
               item.get("gold_answer", "")]
        low = [a.lower() for a in answers]
        for i in range(max_k):
            if i < len(contents):
                c = contents[i]
                found = any(a in c.lower() for a in low)
                row.append(f"{'true' if found else 'false'}|{c}")
            else:
                row.append("")
        rows.append(row)
    return columns, rows


def save_prediction_table(path: str, columns: Sequence[str],
                          rows: Sequence[Sequence]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(dict(zip(columns, row)), default=str) + "\n")


def log_prediction_table(logger, name: str, columns, rows) -> None:
    """Send a table to a MetricsLogger's wandb backend when one is active
    (wandb.Table, as the reference does); JSONL is handled by
    save_prediction_table."""
    run = getattr(logger, "_wandb_run", None)
    if run is not None:  # pragma: no cover - wandb not in test env
        import wandb
        run.log({name: wandb.Table(columns=list(columns),
                                   data=[list(r) for r in rows])})
