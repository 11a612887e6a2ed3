from .index import (TokenIndex, build_index_from_embeddings, encode_corpus,
                    pad_to)
from .search import LateInteractionSearcher, search_single_device

__all__ = ["TokenIndex", "build_index_from_embeddings", "encode_corpus",
           "pad_to", "LateInteractionSearcher", "search_single_device"]
