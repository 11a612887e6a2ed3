from .bert import BertConfig, BertModel
from .blip2 import (Blip2Config, Blip2T5, Blip2VisionConfig,
                    Blip2VisionModel, QFormer, QFormerConfig)
from .convert import (captioner_to_state_dict, detector_to_state_dict,
                      flatten_params, flax_to_state_dict,
                      generator_to_flax, generator_to_state_dict,
                      load_params, load_params_npz, lora_to_flax,
                      lora_to_torch, rag_params_to_torch, read_flax_msgpack,
                      read_params_tree, save_params, state_dict_to_flax,
                      write_flax_msgpack)
from .dpr import DPRModelConfig, DPRRetriever
from .flmr import (FLMRModelConfig, FLMRRetriever, l2_normalize,
                   punctuation_skiplist_ids, skiplist_mask)
from .generation import beam_generate, greedy_generate
from .lora import LoRAParams, count_lora_params, init_lora, merge_lora
from .mapping import (MappingMLP, TransformerMapping,
                      TransformerMappingLayer, VisionMapping)
from .rag import (GeneratorInputBuilder, get_retrieval_labels, most_frequent,
                  rag_loss_components, select_answers_by_joint_score)
from .t5 import T5Config, T5Model, shift_right
from .transformer import (EncoderConfig, EncoderLayer, MlpBlock,
                          MultiHeadAttention, TransformerEncoder,
                          attention_bias_from_mask, gelu, quick_gelu)
from .vit import (CLIPVisionModel, ViTConfig, clip_preprocess,
                  convert_hf_clip_vision_params)

__all__ = ["BertConfig", "BertModel", "Blip2Config", "Blip2T5",
           "Blip2VisionConfig", "Blip2VisionModel", "QFormer",
           "QFormerConfig", "captioner_to_state_dict",
           "detector_to_state_dict", "flatten_params", "flax_to_state_dict",
           "generator_to_flax", "generator_to_state_dict",
           "load_params", "load_params_npz", "lora_to_flax",
           "lora_to_torch", "rag_params_to_torch", "read_flax_msgpack",
           "read_params_tree",
           "save_params", "state_dict_to_flax", "write_flax_msgpack",
           "DPRModelConfig", "DPRRetriever",
           "FLMRModelConfig", "FLMRRetriever",
           "l2_normalize", "punctuation_skiplist_ids", "skiplist_mask",
           "beam_generate", "greedy_generate", "count_lora_params",
           "init_lora", "merge_lora", "LoRAParams",
           "MappingMLP", "TransformerMapping", "TransformerMappingLayer",
           "VisionMapping", "GeneratorInputBuilder", "get_retrieval_labels",
           "most_frequent", "rag_loss_components",
           "select_answers_by_joint_score", "T5Config", "T5Model",
           "shift_right", "EncoderConfig", "EncoderLayer",
           "MlpBlock", "MultiHeadAttention", "TransformerEncoder",
           "attention_bias_from_mask", "gelu", "quick_gelu",
           "CLIPVisionModel", "ViTConfig", "clip_preprocess",
           "convert_hf_clip_vision_params"]
