from .wordpiece import (BasicTokenizer, WordPieceTokenizer, load_vocab,
                        make_tiny_vocab)
from .colbert_tokenizers import DocTokenizer, QueryTokenizer

__all__ = ["BasicTokenizer", "WordPieceTokenizer", "load_vocab",
           "make_tiny_vocab", "DocTokenizer", "QueryTokenizer"]
