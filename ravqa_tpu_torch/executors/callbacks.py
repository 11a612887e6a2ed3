"""Checkpoint management + early stopping.

Parity with the reference's Lightning callbacks (SURVEY.md §5:
model_checkpoint_callback_paras monitor/save_top_k/save_last,
early_stopping_callback_paras — configs/okvqa/
FLMR_base_preload_vision_features.jsonnet:206-232): keep the top-k
checkpoints by a monitored validation metric, always keep `last`, and stop
training when the metric stops improving.

The port's own copy of ravqa_tpu/executors/callbacks.py (host-only code).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional


@dataclasses.dataclass
class CheckpointManager:
    dirpath: str
    monitor: str = "loss"
    mode: str = "max"                   # "max" (recall) | "min" (loss)
    save_top_k: int = 1
    save_last: bool = True

    def __post_init__(self):
        os.makedirs(self.dirpath, exist_ok=True)
        self._kept: list[tuple[float, str]] = []

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.mode == "max" else a < b

    def on_validation(self, executor, metrics: dict, step: int) -> bool:
        """Save checkpoints per policy. Returns True if this step produced
        a new best."""
        value = metrics.get(self.monitor)
        is_best = False
        if value is not None:
            value = float(value)
            worst_kept = self._kept[-1][0] if len(self._kept) >= \
                self.save_top_k else None
            if worst_kept is None or self._better(value, worst_kept):
                path = os.path.join(self.dirpath, f"step_{step}")
                executor.save_checkpoint(path)
                with open(os.path.join(path, "monitor.json"), "w") as f:
                    json.dump({self.monitor: value, "step": step}, f)
                self._kept.append((value, path))
                self._kept.sort(key=lambda t: t[0],
                                reverse=(self.mode == "max"))
                is_best = self._kept[0][1] == path
                while len(self._kept) > self.save_top_k:
                    _, drop = self._kept.pop()
                    shutil.rmtree(drop, ignore_errors=True)
        if self.save_last:
            executor.save_checkpoint(os.path.join(self.dirpath, "last"))
        return is_best

    @property
    def best_path(self) -> Optional[str]:
        return self._kept[0][1] if self._kept else None

    @property
    def best_value(self) -> Optional[float]:
        return self._kept[0][0] if self._kept else None


@dataclasses.dataclass
class EarlyStopping:
    monitor: str = "loss"
    mode: str = "max"
    patience: int = 3
    min_delta: float = 0.0

    def __post_init__(self):
        self._best: Optional[float] = None
        self._bad = 0

    def update(self, metrics: dict) -> bool:
        """Returns True when training should stop."""
        value = metrics.get(self.monitor)
        if value is None:
            return False
        value = float(value)
        improved = (self._best is None
                    or (value > self._best + self.min_delta
                        if self.mode == "max"
                        else value < self._best - self.min_delta))
        if improved:
            self._best = value
            self._bad = 0
        else:
            self._bad += 1
        return self._bad > self.patience
