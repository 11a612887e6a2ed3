"""k1_roofline: K1 (csrc/maxsim_mma.cu, the exact MaxSim sweep) against
its roofline, in %: the sum over the traced window's K1 launches of the
least time the card could take, over the sum of their device times.

A launch scores B queries of Lq tokens against the N rows of the index (Ld
tokens of `dim`): 2 B Lq N Ld dim operations, counted once at the dense
bf16 peak whatever the kernel multiplies, and each input byte read once
and each output byte written once at the widths the cell states (a
float32 index 4 bytes an element, the int8 mask, the float32 query and
(B, N) float32 scores) at the HBM bandwidth. B is the padded batch of the
search range that launched it; padding is K1's work here (batch_fill and
mfu show it)."""

from portbench.flops import query_tokens

KERNEL = "maxsim_mma_kernel"


def launch_bound_s(b, lq, n, ld, dim, index_bytes, peak_flops, peak_bytes):
    ops = 2.0 * b * lq * n * ld * dim
    moved = (n * ld * dim * index_bytes + n * ld + b * lq * dim * 4
             + b * n * 4)
    return max(ops / peak_flops, moved / peak_bytes)


def read(ctx):
    if ctx.trace is None:
        return None
    cfg = ctx.cell.cfg
    ix = cfg["index"]
    n = -(-ix["n_docs"] // ix["pad_multiple"]) * ix["pad_multiple"]
    index_bytes = {"float32": 4, "bfloat16": 2}[ix["dtype"]]
    bound = spent = 0.0
    for e in ctx.trace.kernels(KERNEL):
        rng = e["_range"]
        if not rng.startswith("pb.search.b"):
            continue
        b = int(rng.rsplit(".b", 1)[1])
        bound += launch_bound_s(b, query_tokens(cfg), n, cfg["doc_maxlen"],
                                cfg["model_config"].get("dim", 128),
                                index_bytes, ctx.peak_flops, ctx.peak_bytes)
        spent += e["dur"] / 1e6
    return 100.0 * bound / spent if spent > 0 else None
