from .flmr_executor import FLMRExecutor

__all__ = ["FLMRExecutor"]
