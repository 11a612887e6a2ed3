from .bert import BertConfig, BertModel
from .convert import (flatten_params, flax_to_state_dict, load_params,
                      load_params_npz, read_flax_msgpack, save_params,
                      state_dict_to_flax, write_flax_msgpack)
from .flmr import (FLMRModelConfig, FLMRRetriever, l2_normalize,
                   punctuation_skiplist_ids, skiplist_mask)
from .mapping import (MappingMLP, TransformerMapping,
                      TransformerMappingLayer, VisionMapping)
from .transformer import (EncoderConfig, EncoderLayer, MlpBlock,
                          MultiHeadAttention, TransformerEncoder,
                          attention_bias_from_mask, gelu, quick_gelu)
from .vit import (CLIPVisionModel, ViTConfig, clip_preprocess,
                  convert_hf_clip_vision_params)

__all__ = ["BertConfig", "BertModel", "flatten_params", "flax_to_state_dict",
           "load_params", "load_params_npz", "read_flax_msgpack",
           "save_params", "state_dict_to_flax", "write_flax_msgpack",
           "FLMRModelConfig", "FLMRRetriever",
           "l2_normalize", "punctuation_skiplist_ids", "skiplist_mask",
           "MappingMLP", "TransformerMapping", "TransformerMappingLayer",
           "VisionMapping", "EncoderConfig", "EncoderLayer",
           "MlpBlock", "MultiHeadAttention", "TransformerEncoder",
           "attention_bias_from_mask", "gelu", "quick_gelu",
           "CLIPVisionModel", "ViTConfig", "clip_preprocess",
           "convert_hf_clip_vision_params"]
