from .retrieval_metrics import positive_id_scores, pseudo_relevance_scores

__all__ = ["positive_id_scores", "pseudo_relevance_scores"]
