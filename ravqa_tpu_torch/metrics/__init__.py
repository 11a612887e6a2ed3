from .bem import evqa_accuracy, initialize_bem_scoring_function
from .retrieval_metrics import (bleu_score, exact_match,
                                exact_match_with_numeric_ranges, mrr_at_k,
                                positive_id_scores, pseudo_relevance_scores,
                                save_ranking_tsv, success_at_k)
from .vqa import (TextCleaner, normalize_answer, vqa_accuracy,
                  vqa_accuracy_single)

__all__ = ["TextCleaner", "bleu_score", "evqa_accuracy", "exact_match",
           "exact_match_with_numeric_ranges",
           "initialize_bem_scoring_function", "mrr_at_k", "normalize_answer",
           "positive_id_scores", "pseudo_relevance_scores",
           "save_ranking_tsv", "success_at_k", "vqa_accuracy",
           "vqa_accuracy_single"]
