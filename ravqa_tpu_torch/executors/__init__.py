from .base import (BaseExecutor, MetricsLogger, Optimizer, TrainConfig,
                   make_optimizer, make_schedule)
from .callbacks import CheckpointManager, EarlyStopping
from .flmr_executor import FLMRExecutor

__all__ = ["BaseExecutor", "MetricsLogger", "Optimizer", "TrainConfig",
           "make_optimizer", "make_schedule", "CheckpointManager",
           "EarlyStopping", "FLMRExecutor"]
