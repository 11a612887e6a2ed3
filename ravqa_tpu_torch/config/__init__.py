from .config import Config, apply_overrides, load_config, merge_patch

__all__ = ["Config", "apply_overrides", "load_config", "merge_patch"]
