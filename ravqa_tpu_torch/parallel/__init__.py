from .partition import FREEZE_FLAG_PREFIXES, trainable_mask

__all__ = ["FREEZE_FLAG_PREFIXES", "trainable_mask"]
