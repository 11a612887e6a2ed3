from .pipeline import (BaseTransform, DataPipeline, TRANSFORM_REGISTRY,
                       register_transform)
from .datasets import PassageCorpus, corpus_doc_batches
from . import transforms  # noqa: F401  (populates the registry)

__all__ = ["BaseTransform", "DataPipeline", "TRANSFORM_REGISTRY",
           "register_transform", "PassageCorpus", "corpus_doc_batches"]
