"""Model FLOPs from the published shapes (a multiply-add counts 2), for
the mfu readers. Each configuration's file, flops/<config>.py, gives
`request_flops(cfg, work)` (one served request's query tower and search)
and `step_flops(cfg, work)` (one training step: the forward's FLOPs times
3 for forward and backward). Padding to a bucket is not model work; a
gather, a norm or a softmax is left out as small beside the products."""


def encoder_layer(tokens: int, seq: int, hidden: int, inter: int) -> float:
    """One transformer layer over `tokens` rows in sequences of `seq`:
    the q, k, v and out projections, the scores and the weighted sum, the
    MLP."""
    proj = 4 * 2 * tokens * hidden * hidden
    attn = 2 * 2 * tokens * seq * hidden
    mlp = 2 * 2 * tokens * hidden * inter
    return proj + attn + mlp


def bert(n_seq: int, seq: int, b: dict) -> float:
    return b["num_layers"] * encoder_layer(n_seq * seq, seq,
                                           b["hidden_size"],
                                           b["intermediate_size"])


def vit(n_img: int, v: dict) -> float:
    p = v["patch_size"]
    n_patch = (v["image_size"] // p) ** 2
    seq = n_patch + 1
    embed = 2 * n_img * n_patch * p * p * 3 * v["hidden_size"]
    return embed + v["num_layers"] * encoder_layer(
        n_img * seq, seq, v["hidden_size"], v["intermediate_size"])


def mapping(n: int, vision_dim: int, dim: int, prefix: int) -> float:
    out = dim * prefix
    return 2 * n * (vision_dim * out // 2 + out // 2 * out)


def transformer_mapping(n: int, patches: int, text: int, patch_dim: int,
                        h: int, dim: int, layers: int) -> float:
    rows = n * patches
    cross = (2 * 2 * rows * h * h + 2 * 2 * n * text * h * h
             + 2 * 2 * rows * text * h)
    layer = (encoder_layer(rows, patches, h, 4 * h) + cross)
    return 2 * rows * patch_dim * h + layers * layer + 2 * rows * h * dim


def maxsim(n_q: int, lq: int, n_docs: int, ld: int, dim: int) -> float:
    return 2.0 * n_q * lq * n_docs * ld * dim


def bert_sizes(mc: dict) -> dict:
    base = dict(num_layers=12, hidden_size=768, intermediate_size=3072)
    base.update(mc.get("bert", {}))
    return base


def query_tokens(cfg: dict) -> int:
    """Query tokens the search sees: text, mapping, and one per patch with
    the transformer mapping."""
    mc = cfg["model_config"]
    n = cfg["query_maxlen"] + mc.get("mapping_network_prefix_length", 32)
    if mc.get("use_transformer_mapping"):
        v = mc["vit"]
        n += (v["image_size"] // v["patch_size"]) ** 2
    return n


def search(cfg: dict, work: dict) -> float:
    """One request's search at the cell's mode and cuts."""
    sv = work["serve"]
    lq, ld = query_tokens(cfg), cfg["doc_maxlen"]
    dim = cfg["model_config"].get("dim", 128)
    n = cfg["index"]["n_docs"]
    if sv["search_mode"] == "exact":
        return maxsim(1, lq, n, ld, dim)
    bs = sv["block_size"]
    stage0 = 2.0 * lq * (n // bs) * sv["n_block_summary"] * dim
    stage1 = 2.0 * lq * sv["n_blocks"] * bs * sv["n_summary"] * dim
    return stage0 + stage1 + maxsim(1, lq, sv["n_candidates"], ld, dim)
