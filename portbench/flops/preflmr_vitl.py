"""PreFLMR ViT-L FLOPs: the question's BERT, CLIP ViT-L/14, the MLP
mapping of the pooled CLS and the transformer mapping of the patches."""

from portbench.flops import (bert, bert_sizes, mapping, search,
                             transformer_mapping, vit)


def request_flops(cfg: dict, work: dict) -> float:
    mc = cfg["model_config"]
    b, v = bert_sizes(mc), mc["vit"]
    t, dim = cfg["query_maxlen"], mc.get("dim", 128)
    patches = (v["image_size"] // v["patch_size"]) ** 2
    tower = (bert(1, t, b) + 2 * t * b["hidden_size"] * dim + vit(1, v)
             + mapping(1, mc["vision_embedding_size"], dim,
                       mc.get("mapping_network_prefix_length", 32))
             + transformer_mapping(
                 1, patches, t, mc.get("vision_patch_dim", v["hidden_size"]),
                 mc.get("transformer_mapping_hidden", 768), dim,
                 mc.get("transformer_mapping_num_layers", 1)))
    return tower + search(cfg, work)
