"""FLMR (BERT-base + the MLP mapping) FLOPs."""

from portbench.flops import bert, bert_sizes, mapping, maxsim, search


def query_tower(cfg: dict, n: int) -> float:
    mc = cfg["model_config"]
    b = bert_sizes(mc)
    t, dim = cfg["query_maxlen"], mc.get("dim", 128)
    return (bert(n, t, b) + 2 * n * t * b["hidden_size"] * dim
            + mapping(n, mc.get("vision_embedding_size", 768), dim,
                      mc.get("mapping_network_prefix_length", 32)))


def request_flops(cfg: dict, work: dict) -> float:
    return query_tower(cfg, 1) + search(cfg, work)


def step_flops(cfg: dict, work: dict) -> float:
    mc, tr = cfg["model_config"], cfg["train"]
    b = bert_sizes(mc)
    bsz, nway = tr["batch_size"], mc["num_negative_samples"] + 1
    ld, dim = cfg["doc_maxlen"], mc.get("dim", 128)
    lq = cfg["query_maxlen"] + mc.get("mapping_network_prefix_length", 32)
    docs = bsz * nway
    fwd = (query_tower(cfg, bsz) + bert(docs, ld, b)
           + 2 * docs * ld * b["hidden_size"] * dim
           + maxsim(1, lq, docs, ld, dim)            # each query's nway
           + maxsim(bsz, lq, docs, ld, dim))         # in-batch negatives
    return 3 * fwd
