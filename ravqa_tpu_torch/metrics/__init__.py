from .retrieval_metrics import (exact_match, positive_id_scores,
                                pseudo_relevance_scores)
from .vqa import TextCleaner, normalize_answer, vqa_accuracy

__all__ = ["TextCleaner", "exact_match", "normalize_answer",
           "positive_id_scores", "pseudo_relevance_scores", "vqa_accuracy"]
