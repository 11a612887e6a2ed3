from .pipeline import (BaseTransform, DataPipeline, TRANSFORM_REGISTRY,
                       register_transform)
from .module_parser import ModuleParser
from .datasets import (PassageCorpus, RetrievalDataset, corpus_doc_batches,
                       query_eval_batches)
from .prefetch import prefetch, prefetch_to_device
from . import transforms  # noqa: F401  (populates the registry)
from . import wit_transforms  # noqa: F401  (the WIT pretraining nodes)

__all__ = ["BaseTransform", "DataPipeline", "TRANSFORM_REGISTRY",
           "register_transform", "ModuleParser", "PassageCorpus",
           "RetrievalDataset", "corpus_doc_batches", "query_eval_batches",
           "prefetch", "prefetch_to_device"]
