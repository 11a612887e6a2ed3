"""Autoregressive decoding (greedy and beam) for the T5 / BLIP-2 generators.

Port of ravqa_tpu/models/generation.py. Python loops of max_len steps take
the place of lax.scan; every sequence runs all max_len steps, as there.
The tie rules are JAX's: greedy takes the first maximal token
(jnp.argmax); beam search ranks candidates with a stable sort, so on
equal log-probs the lower flat index (beam, then token) wins, as
jax.lax.top_k orders them, and the final beams are ordered with a stable
argsort as jnp.argsort. Beam search returns per-sequence log-probs so the
RAG answer selection can add log g(z|x) to log p(y|x,z).
"""

from __future__ import annotations

from typing import Callable

import torch

NEG = -1e9


def greedy_generate(decode_step: Callable, init_cache, batch: int,
                    max_len: int, start_id: int, eos_id: int,
                    pad_id: int = 0):
    """decode_step(tokens (B, 1), cache) -> (logits (B, 1, V), cache).

    Returns (tokens (B, max_len), seq_logprob (B,)). Sequences stop at EOS
    (pad after); the log-prob sums the tokens up to and including EOS."""
    cache = init_cache
    device = _device(cache)
    tok = torch.full((batch, 1), start_id, dtype=torch.long, device=device)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    lp = torch.zeros(batch, dtype=torch.float32, device=device)
    out = []
    for _ in range(max_len):
        logits, cache = decode_step(tok, cache)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        nxt = logp.argmax(-1)
        step_lp = logp.gather(1, nxt[:, None])[:, 0]
        nxt = torch.where(done, pad_id, nxt)
        lp = lp + torch.where(done, 0.0, step_lp)
        done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt[:, None]
    return torch.stack(out, dim=1), lp


def _device(cache) -> torch.device:
    """The device of the first tensor in a cache (a list of dicts)."""
    return next(v for c in cache for v in c.values()
                if isinstance(v, torch.Tensor)).device


def _reorder(cache: list, flat_src: torch.Tensor) -> list:
    """Gather every cache tensor's batch rows by flat_src (B * beam,)."""
    return [{k: (v.index_select(0, flat_src) if isinstance(v, torch.Tensor)
                 else v) for k, v in c.items()} for c in cache]


def beam_generate(decode_step: Callable, init_cache_fn, batch: int,
                  n_beams: int, max_len: int, start_id: int, eos_id: int,
                  pad_id: int = 0, length_penalty: float = 0.0):
    """Beam search.

    decode_step(tokens (B * beam, 1), cache) -> (logits, cache); the cache
    comes from init_cache_fn(batch * n_beams), the beams of a sequence
    adjacent (beam-major within it).

    Returns (tokens (B, n_beams, max_len), scores (B, n_beams)) best
    first; scores are total log-probs (optionally length-normalized)."""
    cache = init_cache_fn(batch * n_beams)
    device = _device(cache)
    tok = torch.full((batch * n_beams, 1), start_id, dtype=torch.long,
                     device=device)
    # first step: only beam 0 is live (the others start at NEG)
    beam_lp = torch.full((batch, n_beams), NEG, device=device)
    beam_lp[:, 0] = 0.0
    done = torch.zeros(batch, n_beams, dtype=torch.bool, device=device)
    lengths = torch.zeros(batch, n_beams, dtype=torch.long, device=device)
    base = (torch.arange(batch, device=device) * n_beams)[:, None]
    toks, srcs = [], []
    pad_only = None
    for _ in range(max_len):
        logits, cache = decode_step(tok, cache)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        vocab = logp.shape[-1]
        logp = logp.reshape(batch, n_beams, vocab)
        if pad_only is None:
            # a finished beam may only emit pad, with log-prob 0
            pad_only = torch.full((vocab,), NEG, device=device)
            pad_only[pad_id] = 0.0
        logp = torch.where(done[:, :, None], pad_only, logp)
        cand = beam_lp[:, :, None] + logp
        flat = cand.reshape(batch, n_beams * vocab)
        # stable: equal candidates keep the lower flat index first, as
        # jax.lax.top_k does (torch.topk makes no such promise)
        top_lp, top_idx = torch.sort(flat, dim=1, descending=True,
                                     stable=True)
        top_lp, top_idx = top_lp[:, :n_beams], top_idx[:, :n_beams]
        src_beam = top_idx // vocab
        nxt_tok = top_idx % vocab
        cache = _reorder(cache, (base + src_beam).reshape(-1))
        done = done.gather(1, src_beam)
        lengths = lengths.gather(1, src_beam) + (~done).long()
        done = done | (nxt_tok == eos_id)
        beam_lp = top_lp
        toks.append(nxt_tok)
        srcs.append(src_beam)
        tok = nxt_tok.reshape(batch * n_beams, 1)
    # backtrack from each final beam through its source beams
    ptr = torch.arange(n_beams, device=device).expand(batch, n_beams)
    rev = []
    for tok_t, src_t in zip(reversed(toks), reversed(srcs)):
        rev.append(tok_t.gather(1, ptr))
        ptr = src_t.gather(1, ptr)
    seqs = torch.stack(rev[::-1], dim=2)                 # (B, beam, T)
    scores = beam_lp
    if length_penalty > 0:
        scores = scores / lengths.float() ** length_penalty
    order = torch.argsort(-scores, dim=1, stable=True)
    seqs = seqs.gather(1, order[:, :, None].expand_as(seqs))
    return seqs, scores.gather(1, order)
