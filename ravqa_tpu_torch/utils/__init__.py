from .profiling import (StepTimer, annotate, device_memory_stats, enabled,
                        recording, span, take_spans, trace)
from .tables import (build_prediction_table, log_prediction_table,
                     save_prediction_table, table_columns)


def set_seed(seed: int):
    """Seed numpy, python's random and torch."""
    import random

    import numpy as np
    import torch
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


__all__ = ["StepTimer", "annotate", "build_prediction_table",
           "device_memory_stats", "enabled", "log_prediction_table",
           "recording", "save_prediction_table", "set_seed", "span",
           "table_columns", "take_spans", "trace"]
