from .base import (BaseExecutor, MetricsLogger, Optimizer, TrainConfig,
                   make_optimizer, make_schedule)
from .callbacks import CheckpointManager, EarlyStopping
from .dpr_executor import DPRExecutor
from .flmr_executor import FLMRExecutor
from .pretraining_executor import FLMRVisionPretrainingExecutor
from .rag_executor import (RagConfig, RagExecutor,
                           load_static_retrieval_from_predictions,
                           refresh_index)

__all__ = ["BaseExecutor", "MetricsLogger", "Optimizer", "TrainConfig",
           "make_optimizer", "make_schedule", "CheckpointManager",
           "EarlyStopping", "DPRExecutor", "FLMRExecutor",
           "FLMRVisionPretrainingExecutor", "RagConfig", "RagExecutor",
           "load_static_retrieval_from_predictions", "refresh_index"]
