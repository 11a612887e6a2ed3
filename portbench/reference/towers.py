"""Plain float32 FLMR / PreFLMR towers, written from the published
architectures with no code of the program under test.

- BERT-base (Devlin et al. 2019): word + position + token-type
  embeddings, LayerNorm, post-LN encoder layers (erf GELU), attention
  logits masked with -1e9 on padded keys.
- FLMR query (Lin et al., NeurIPS 2023): BERT's token states through a
  bias-free linear to `dim`, padded rows zeroed, then the mapping network
  (vision_dim -> dim * prefix / 2 -> dim * prefix, tanh between) as
  `prefix` more tokens; every token L2-normalised (rows of squared norm
  under 1e-12 stay zero).
- FLMR doc: BERT -> linear -> zero the padded tokens -> L2 norm.
- PreFLMR query (Lin et al., ACL 2024): a second BERT for the question,
  CLIP ViT-L/14 (pre-LN, quick GELU) on the pixels, its pooled CLS through
  the mapping network, and the transformer mapping: the ViT's last-layer
  patch rows through an input linear, one post-LN layer of self-attention,
  cross-attention to the question's BERT states (question pads masked) and
  an MLP, then an output linear: one token per patch.

Parameters are read from a flat dict whose keys are `param_specs`' names;
the harness draws them from the seed. `matmul` routes every product, so
the control can run the same code in TF32 (`precision`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_MODE = {"tf32_emulated": False}


@contextlib.contextmanager
def precision(name: str):
    """"float32" (TF32 off) or "tf32": the control's precision. On the card
    TF32 is the tensor cores' own; on the CPU each product's operands are
    rounded to TF32's 10-bit mantissa, which is what TF32 multiplies."""
    if name not in ("float32", "tf32"):
        raise ValueError(name)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, _MODE["tf32_emulated"])
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _MODE["tf32_emulated"] = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _MODE["tf32_emulated"]) = old


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away);
    the gradient passes straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _MODE["tf32_emulated"] and a.device.type == "cpu":
        return _tf32_round(a) @ _tf32_round(b)
    return a @ b


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _MODE["tf32_emulated"] and a.device.type == "cpu":
        return torch.einsum(eq, _tf32_round(a), _tf32_round(b))
    return torch.einsum(eq, a, b)


def linear(x, w, b=None):
    y = matmul(x, w.T)
    return y if b is None else y + b


# -- parameter layout -------------------------------------------------------

def _bert_specs(p: str, bert: dict) -> list:
    h, inter = bert["hidden_size"], bert["intermediate_size"]
    out = [(p + "word_embeddings.weight", (bert["vocab_size"], h), "normal"),
           (p + "position_embeddings.weight",
            (bert["max_position_embeddings"], h), "normal"),
           (p + "token_type_embeddings.weight",
            (bert["type_vocab_size"], h), "normal")]
    out += _ln(p + "embeddings_ln", h)
    for i in range(bert["num_layers"]):
        out += _layer_specs(f"{p}encoder.layers.{i}.", h, inter, h)
    out += _lin(p + "pooler", h, h)
    return out


def _lin(name, n_in, n_out, bias=True):
    out = [(name + ".weight", (n_out, n_in), "normal")]
    if bias:
        out.append((name + ".bias", (n_out,), "normal"))
    return out


def _ln(name, h):
    return [(name + ".weight", (h,), "scale"),
            (name + ".bias", (h,), "normal")]


def _attn(p, h, kv):
    return (_lin(p + "query", h, h) + _lin(p + "key", kv, h)
            + _lin(p + "value", kv, h) + _lin(p + "out", h, h))


def _layer_specs(p, h, inter, kv):
    return (_attn(p + "attention.", h, kv) + _ln(p + "ln1", h)
            + _lin(p + "mlp.fc1", h, inter) + _lin(p + "mlp.fc2", inter, h)
            + _ln(p + "ln2", h))


def _mapping_specs(p, vision_dim, dim, prefix):
    out_dim = dim * prefix
    return (_lin(p + "mlp.dense.0", vision_dim, out_dim // 2)
            + _lin(p + "mlp.dense.1", out_dim // 2, out_dim))


def param_specs(mc: dict) -> list:
    """[(name, shape, init)] of a model_config (the configuration file's
    block), init "normal" (N(0, 0.02)) or "scale" (1 + N(0, 0.02), a
    LayerNorm's weight); in the program's state-dict order and names, so
    one draw serves both."""
    bert = bert_sizes(mc)
    dim = mc.get("dim", 128)
    specs = _bert_specs("doc_encoder.", bert)
    if "separate_question_encoder" in mc.get("modules", []):
        specs += _bert_specs("query_encoder.", bert)
    specs += _lin("linear", bert["hidden_size"], dim, bias=False)
    specs += _mapping_specs("vision_projection.",
                            mc.get("vision_embedding_size", 768), dim,
                            mc.get("mapping_network_prefix_length", 32))
    if mc.get("use_transformer_mapping"):
        h = mc.get("transformer_mapping_hidden", 768)
        specs += _lin("transformer_mapping.input_linear",
                      mc.get("vision_patch_dim")
                      or mc.get("vision_embedding_size"), h)
        for i in range(mc.get("transformer_mapping_num_layers", 1)):
            p = f"transformer_mapping.layers.{i}."
            specs += (_attn(p + "attention.", h, h) + _ln(p + "ln_self", h)
                      + _attn(p + "cross_attention.", h,
                              bert["hidden_size"])
                      + _ln(p + "ln_cross", h)
                      + _lin(p + "mlp.fc1", h, 4 * h)
                      + _lin(p + "mlp.fc2", 4 * h, h) + _ln(p + "ln_out", h))
        specs += _lin("transformer_mapping.output_linear", h, dim)
    vit = mc.get("vit")
    if vit:
        h, p = vit["hidden_size"], vit["patch_size"]
        n_pos = (vit["image_size"] // p) ** 2 + 1
        specs += [("vision_model.patch_embedding.weight", (h, p * p * 3),
                   "normal"),
                  ("vision_model.class_embedding", (h,), "normal"),
                  ("vision_model.position_embedding", (n_pos, h), "normal")]
        specs += _ln("vision_model.pre_layernorm", h)
        for i in range(vit["num_layers"]):
            specs += _layer_specs(f"vision_model.encoder.layers.{i}.", h,
                                  vit["intermediate_size"], h)
        specs += _ln("vision_model.post_layernorm", h)
    return specs


def bert_sizes(mc: dict) -> dict:
    """BERT-base's published sizes, with the config's overrides."""
    base = dict(vocab_size=30522, hidden_size=768, num_layers=12,
                num_heads=12, intermediate_size=3072,
                max_position_embeddings=512, type_vocab_size=2,
                layer_norm_eps=1e-12)
    base.update(mc.get("bert", {}))
    return base


# -- forward ----------------------------------------------------------------

def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def attention(w, p, x, heads, bias=None, kv=None):
    b, t, h = x.shape
    hd = h // heads
    src = x if kv is None else kv
    q = linear(x, w[p + "query.weight"], w[p + "query.bias"])
    k = linear(src, w[p + "key.weight"], w[p + "key.bias"])
    v = linear(src, w[p + "value.weight"], w[p + "value.bias"])
    q = q.view(b, t, heads, hd).transpose(1, 2) * hd ** -0.5
    k = k.view(b, src.shape[1], heads, hd).transpose(1, 2)
    v = v.view(b, src.shape[1], heads, hd).transpose(1, 2)
    logits = matmul(q, k.transpose(-1, -2))
    if bias is not None:
        logits = logits + bias
    ctx = matmul(torch.softmax(logits, dim=-1), v)
    ctx = ctx.transpose(1, 2).reshape(b, t, h)
    return linear(ctx, w[p + "out.weight"], w[p + "out.bias"])


def mlp(w, p, x, act):
    return linear(act(linear(x, w[p + "fc1.weight"], w[p + "fc1.bias"])),
                  w[p + "fc2.weight"], w[p + "fc2.bias"])


def gelu(x):
    return F.gelu(x, approximate="none")


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def mask_bias(mask):
    """(B, T) 1/0 -> (B, 1, 1, T) additive bias, -1e9 on pads."""
    return ((1.0 - mask.float()) * -1e9)[:, None, None, :]


def bert(w, p, bert_cfg, ids, mask):
    """(B, T) ids and attention mask -> (B, T, H) last hidden states."""
    t = ids.shape[1]
    x = (w[p + "word_embeddings.weight"][ids]
         + w[p + "position_embeddings.weight"][:t][None]
         + w[p + "token_type_embeddings.weight"][0])
    eps = bert_cfg["layer_norm_eps"]
    x = layer_norm(x, w[p + "embeddings_ln.weight"],
                   w[p + "embeddings_ln.bias"], eps)
    bias = mask_bias(mask)
    for i in range(bert_cfg["num_layers"]):
        lp = f"{p}encoder.layers.{i}."
        x = layer_norm(x + attention(w, lp + "attention.", x,
                                     bert_cfg["num_heads"], bias),
                       w[lp + "ln1.weight"], w[lp + "ln1.bias"], eps)
        x = layer_norm(x + mlp(w, lp + "mlp.", x, gelu),
                       w[lp + "ln2.weight"], w[lp + "ln2.bias"], eps)
    return x


def vit(w, vit_cfg, pixels):
    """(B, S, S, 3) -> (last hidden (B, 1 + P, h), pooled (B, h)). Patches
    flatten in (row, col, channel) order within a patch, patches in
    row-major order."""
    b = pixels.shape[0]
    s, p = vit_cfg["image_size"], vit_cfg["patch_size"]
    n = s // p
    x = pixels.reshape(b, n, p, n, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = linear(x.reshape(b, n * n, p * p * 3),
               w["vision_model.patch_embedding.weight"])
    cls = w["vision_model.class_embedding"].expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + w["vision_model.position_embedding"]
    eps = vit_cfg.get("layer_norm_eps", 1e-5)
    x = layer_norm(x, w["vision_model.pre_layernorm.weight"],
                   w["vision_model.pre_layernorm.bias"], eps)
    act = quick_gelu if vit_cfg.get("activation", "quick_gelu") \
        == "quick_gelu" else gelu
    for i in range(vit_cfg["num_layers"]):
        lp = f"vision_model.encoder.layers.{i}."
        h = layer_norm(x, w[lp + "ln1.weight"], w[lp + "ln1.bias"], eps)
        x = x + attention(w, lp + "attention.", h, vit_cfg["num_heads"])
        h = layer_norm(x, w[lp + "ln2.weight"], w[lp + "ln2.bias"], eps)
        x = x + mlp(w, lp + "mlp.", h, act)
    pooled = layer_norm(x[:, 0], w["vision_model.post_layernorm.weight"],
                        w["vision_model.post_layernorm.bias"], eps)
    return x, pooled


def l2_normalize(x, eps=1e-12):
    sq = (x * x).sum(-1, keepdim=True)
    zero = sq < eps
    out = x * torch.rsqrt(torch.where(zero, torch.ones_like(sq), sq))
    return torch.where(zero, torch.zeros_like(out), out)


def mapping(w, mc, feats):
    """(B, vision_dim) -> (B, prefix, dim)."""
    h = torch.tanh(linear(feats, w["vision_projection.mlp.dense.0.weight"],
                          w["vision_projection.mlp.dense.0.bias"]))
    h = linear(h, w["vision_projection.mlp.dense.1.weight"],
               w["vision_projection.mlp.dense.1.bias"])
    return h.reshape(h.shape[0], mc.get("mapping_network_prefix_length", 32),
                     mc.get("dim", 128))


def transformer_mapping(w, mc, patches, text_hidden, text_mask):
    p = "transformer_mapping."
    x = linear(patches, w[p + "input_linear.weight"],
               w[p + "input_linear.bias"])
    bias = mask_bias(text_mask)
    heads = mc.get("transformer_mapping_num_heads", 12)
    eps = 1e-12
    for i in range(mc.get("transformer_mapping_num_layers", 1)):
        lp = f"{p}layers.{i}."
        x = layer_norm(x + attention(w, lp + "attention.", x, heads),
                       w[lp + "ln_self.weight"], w[lp + "ln_self.bias"], eps)
        x = layer_norm(x + attention(w, lp + "cross_attention.", x, heads,
                                     bias, kv=text_hidden),
                       w[lp + "ln_cross.weight"], w[lp + "ln_cross.bias"],
                       eps)
        x = layer_norm(x + mlp(w, lp + "mlp.", x, gelu),
                       w[lp + "ln_out.weight"], w[lp + "ln_out.bias"], eps)
    return linear(x, w[p + "output_linear.weight"],
                  w[p + "output_linear.bias"])


def query(w, mc, ids, mask, image_features=None, pixels=None):
    """The late-interaction query (B, Lq_total, dim): text | mapping |
    transformer-mapping tokens, L2-normalised. `ids` rows equal to the pad
    id (0) are zeroed; [MASK] augmentation rows are kept."""
    bcfg = bert_sizes(mc)
    enc = "query_encoder." if "separate_question_encoder" in \
        mc.get("modules", []) else "doc_encoder."
    hidden = bert(w, enc, bcfg, ids, mask)
    text = linear(hidden, w["linear.weight"])
    text = text * (ids != 0).float()[..., None]
    parts = [text]
    patches = None
    if image_features is None:
        last, image_features = vit(w, mc["vit"], pixels)
        patches = last[:, 1:]
    parts.append(mapping(w, mc, image_features))
    if mc.get("use_transformer_mapping"):
        parts.append(transformer_mapping(w, mc, patches, hidden, mask))
    return l2_normalize(torch.cat(parts, dim=1))


def doc(w, mc, ids, mask):
    """(B, Ld) -> (D (B, Ld, dim) L2-normalised, token mask (B, Ld)): pads
    (id 0) zeroed and masked."""
    hidden = bert(w, "doc_encoder.", bert_sizes(mc), ids, mask)
    d = linear(hidden, w["linear.weight"])
    keep = (ids != 0).float()
    return l2_normalize(d * keep[..., None]), keep
