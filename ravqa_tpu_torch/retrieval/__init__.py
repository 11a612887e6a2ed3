from .coarse import (block_summaries, block_summaries_t, cluster_order,
                     coarse_scores, hierarchical_search, summarize_docs,
                     two_stage_search)
from .distill import (Scorer, kd_triples_from_scores,
                      load_distillation_scores)
from .index import (TokenIndex, build_index_from_embeddings, encode_corpus,
                    load_index, pad_to, save_index)
from .search import LateInteractionSearcher, search_single_device

__all__ = ["TokenIndex", "build_index_from_embeddings", "encode_corpus",
           "load_index", "pad_to", "save_index", "LateInteractionSearcher",
           "search_single_device", "block_summaries", "block_summaries_t",
           "cluster_order", "coarse_scores", "hierarchical_search",
           "summarize_docs", "two_stage_search", "Scorer",
           "kd_triples_from_scores", "load_distillation_scores"]
