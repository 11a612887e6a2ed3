"""Device-resident late-interaction token index.

Port of ravqa_tpu/retrieval/index.py for one device:

    tokens:          (N_pad, Ld, dim)     float32, bfloat16 or int8; None
                                          on a residual index
    mask:            (N_pad, Ld)          int8 (0 on padded tokens and docs)
    pids:            (N_pad,)             int64 numpy, -1 on padded docs
    scales:          (N_pad, Ld)          float32 dequantization scales of
                                          an int8 index (0 on masked tokens)
    summaries:       (N_pad, S, dim)      two-stage / hierarchical search
    block_summaries: (N_pad/bs, Sb, dim)  hierarchical search
    records:         (N_pad, Ld*(4+P))    uint8 residual records
                                          (ops.residual.pack_records), with
                                          the codec's tables beside them

Save format (save_index / load_index): the JAX package's index.npz plus
metadata.json, so an index saved by either package loads in the other.
The functions keep the JAX package's argument positions, `mesh` and
`axis` included; sharding (a given mesh raises NotImplementedError) is not
ported (ROADMAP.md, Queue A: A4).
A float32 index searched exactly on the card also keeps its bf16 planes
(token_planes), made on first use and never saved.
"""

from __future__ import annotations

import dataclasses
import json
import os
import weakref
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

_NO_SHARDING = ("is not ported yet: ravqa_tpu_torch keeps an index on one "
                "device (see ROADMAP.md, Queue A: A4)")


def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(f"sharded {what} {_NO_SHARDING}")


@dataclasses.dataclass
class TokenIndex:
    """A late-interaction token index on one device."""
    tokens: Optional[torch.Tensor]  # (N_pad, Ld, dim); None when residual
    mask: torch.Tensor         # (N_pad, Ld) int8
    pids: np.ndarray           # (N_pad,) int64 passage ids; -1 = pad
    num_docs: int              # real (unpadded) doc count
    meta: dict = dataclasses.field(default_factory=dict)
    summaries: Optional[torch.Tensor] = None        # (N_pad, S, dim)
    block_summaries: Optional[torch.Tensor] = None  # (N_pad / bs, Sb, dim)
    block_size: int = 64
    scales: Optional[torch.Tensor] = None   # (N_pad, Ld): float32 dequant
    #   scales (int8 index) or bf16 reconstruction-norm scales (a legacy
    #   residual save before repacking)
    # residual codec (ops.residual): one packed record row per doc, the
    # flat centroid table, the bucket weights and, for a factored codec,
    # its additive factors
    records: Optional[torch.Tensor] = None          # (N_pad, RB) uint8
    codec_centroids: Optional[torch.Tensor] = None  # (K, dim) float32
    codec_weights: Optional[torch.Tensor] = None    # (2^nbits,) float32
    codec_coarse: Optional[torch.Tensor] = None     # (k_coarse, dim)
    codec_fine: Optional[torch.Tensor] = None       # (k_fine, dim)
    nbits: int = 0

    def build_summaries(self, n_summary: int = 8,
                        iters: int = 4) -> "TokenIndex":
        """Attach per-doc summary vectors (coarse.summarize_docs) for
        two-stage and hierarchical search, in the tokens' dtype; bfloat16
        for an int8 index, whose k-means runs on the raw codes (as the JAX
        package's). A residual index has no tokens: build summaries before
        quantize_residual()."""
        from .coarse import summarize_docs
        if self.tokens is None:
            raise ValueError("a residual index has no tokens to summarize: "
                             "build_summaries() before quantize_residual()")
        dtype = torch.bfloat16 if self.tokens.dtype == torch.int8 \
            else self.tokens.dtype
        self.summaries = summarize_docs(self.tokens, self.mask,
                                        n_summary=n_summary,
                                        iters=iters).to(dtype)
        return self

    def build_block_summaries(self, block_size: int = 64,
                              n_block_summary: int = 4,
                              iters: int = 4) -> "TokenIndex":
        """Second summary level for hierarchical search, over blocks of
        `block_size` consecutive docs. For best recall, build the index
        with cluster-ordered docs (coarse.cluster_order)."""
        from .coarse import block_summaries
        if self.summaries is None:
            raise ValueError("build_summaries() first")
        if self.n_pad % block_size:
            raise ValueError(f"block_size {block_size} must divide the "
                             f"padded doc count {self.n_pad}")
        self.block_summaries = block_summaries(
            self.summaries, block_size=block_size,
            n_block_summary=n_block_summary,
            iters=iters).to(self.summaries.dtype)
        self.block_size = block_size
        return self

    def quantize_int8(self) -> "TokenIndex":
        """Symmetric per-token int8 quantization of the token store
        (ops.quant.quantize_index_int8, in doc chunks): half the bytes of
        bf16. Every search mode keeps working: the scales ride along."""
        from ..ops.quant import quantize_index_int8
        if self.tokens is None:
            raise ValueError("a residual index cannot be re-quantized")
        if self.tokens.dtype == torch.int8:
            raise ValueError("the index is already int8")
        self.tokens, self.scales = quantize_index_int8(self.tokens,
                                                       self.mask)
        self._planes = None
        return self

    def quantize_residual(self, n_centroids=256, nbits: int = 2,
                          mesh=None, axis: str = "index",
                          seed: int = 0, sample: int = 2 ** 16,
                          heldout: int = 2 ** 14,
                          codec=None) -> "TokenIndex":
        """Compress the token store with the residual codec
        (ops.residual): about 7x smaller than bf16 at nbits 2, 3.8x at
        nbits 4. `tokens` is dropped; only the pruned modes (two_stage,
        hierarchical) remain. Build summaries first.

        n_centroids: an int trains the flat codec, a (k_coarse, k_fine)
        tuple the factored one (train_codec_factored). codec: a trained
        ops.residual.ResidualCodec to compress with instead (then
        n_centroids, nbits, seed, sample and heldout are ignored).
        Training and compression run on the index's device, in doc
        blocks written straight into the record rows."""
        from ..ops.residual import (compress_blocks, pack_records,
                                    record_bytes, train_codec,
                                    train_codec_factored)
        _no_mesh(mesh, "residual compression")
        if self.tokens is None:
            raise ValueError("the index is already residual-compressed")
        if self.summaries is None:
            raise ValueError("build_summaries() before quantize_residual()")
        dev = self.device
        if codec is None and isinstance(n_centroids, (tuple, list)):
            k1, k2 = n_centroids
            codec = train_codec_factored(self.tokens, self.mask, k_coarse=k1,
                                         k_fine=k2, nbits=nbits, seed=seed,
                                         sample=sample, heldout=heldout,
                                         device=dev)
        elif codec is None:
            codec = train_codec(self.tokens, self.mask,
                                n_centroids=n_centroids, nbits=nbits,
                                seed=seed, sample=sample, heldout=heldout,
                                device=dev)
        if codec.centroids.shape[0] > 65536:
            raise ValueError("records store uint16 centroid codes (at most "
                             "65536 centroids)")
        codec = dataclasses.replace(codec, **{
            f.name: getattr(codec, f.name).to(dev)
            for f in dataclasses.fields(codec)
            if isinstance(getattr(codec, f.name), torch.Tensor)})
        n, ld, dim = self.tokens.shape
        records = torch.empty((n, record_bytes(ld, dim, codec.nbits)),
                              dtype=torch.uint8, device=dev)
        for s, codes, packed, scales in compress_blocks(self.tokens,
                                                        self.mask, codec):
            records[s:s + codes.shape[0]] = pack_records(codes, scales,
                                                         packed)
        self.records = records
        self.scales = None
        self.codec_centroids = codec.centroids
        self.codec_weights = codec.bucket_weights
        self.codec_coarse, self.codec_fine = codec.coarse, codec.fine
        self.nbits = codec.nbits
        self.meta["dim"] = int(dim)
        self.tokens = None
        self._planes = None
        return self

    def token_planes(self) -> torch.Tensor:
        """The float32 tokens as K1's split route reads them
        (ops.maxsim.split_index_bf16: (N_pad, Ld, 2 * dp) bf16, the same
        bytes as the tokens), made on first use and kept until `tokens`
        changes. Not saved: save_index writes the tokens."""
        from ..ops.maxsim import split_index_bf16
        cached = getattr(self, "_planes", None)
        if cached is None or cached[0]() is not self.tokens:
            self._planes = (weakref.ref(self.tokens),
                            split_index_bf16(self.tokens))
        return self._planes[1]

    def gather_tokens(self, rows: torch.Tensor) -> torch.Tensor:
        """Token embeddings of the given padded-index rows, (..., Ld, dim)
        float32: the stored values (an int8 index's raw codes, as the JAX
        package returns them), or a residual index's reconstruction times
        its normalizing scale."""
        if self.tokens is not None:
            return self.tokens[rows].float()
        from ..ops.residual import decompress, split_records
        cod, scl, pck = split_records(self.records[rows], self.doc_maxlen)
        rec = decompress(cod, pck, self.codec_centroids, self.codec_weights,
                         self.nbits)
        return rec * scl[..., None]

    def unpack_residual(self):
        """Split the records into full-index (codes int32, scales float32,
        residual bytes) arrays (copies: for saving and tests, not search)."""
        from ..ops.residual import split_records
        return split_records(self.records, self.doc_maxlen)

    @property
    def device(self) -> torch.device:
        return self.mask.device

    @property
    def n_pad(self) -> int:
        return (self.tokens if self.tokens is not None
                else self.records).shape[0]

    @property
    def doc_maxlen(self) -> int:
        return self.mask.shape[1]

    @property
    def dim(self) -> int:
        if self.tokens is not None:
            return self.tokens.shape[2]
        return self.codec_centroids.shape[1]


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def build_index_from_embeddings(
    embs,
    masks,
    pids: Optional[Sequence[int]] = None,
    pad_multiple: int = 128,
    dtype: torch.dtype = torch.bfloat16,
    mesh=None,
    axis: str = "index",
    *,
    device=None,
) -> TokenIndex:
    """Assemble an index from per-doc token embeddings.

    embs: (N, Ld, dim) array or tensor, or a list of (Ld_i, dim) arrays
    (padded to the longest); embeddings must already be L2-normalized.
    masks: the matching validity masks. N is padded to a multiple of
    `pad_multiple` with masked docs whose pid is -1. device: where the index
    lives (None: where `embs` is, the CPU for numpy input)."""
    _no_mesh(mesh, "index")
    if isinstance(embs, (list, tuple)):
        n = len(embs)
        ld = max(e.shape[0] for e in embs)
        dim = embs[0].shape[1]
        tok = torch.zeros((n, ld, dim), dtype=torch.float32)
        msk = torch.zeros((n, ld), dtype=torch.int8)
        for i, (e, m) in enumerate(zip(embs, masks)):
            tok[i, :e.shape[0]] = torch.as_tensor(np.asarray(e, np.float32))
            msk[i, :m.shape[0]] = torch.as_tensor(np.asarray(m)).to(
                torch.int8)
    else:
        tok = torch.as_tensor(embs)
        msk = torch.as_tensor(masks)
        n, ld, dim = tok.shape
    if device is None:
        device = tok.device
    tok = tok.to(device=device, dtype=dtype)
    msk = msk.to(device=device).to(torch.int8)
    pids = (np.arange(n, dtype=np.int64) if pids is None
            else np.asarray(pids, np.int64))

    n_pad = pad_to(max(n, 1), pad_multiple)
    if n_pad != n:
        tok = torch.cat([tok, tok.new_zeros((n_pad - n, ld, dim))])
        msk = torch.cat([msk, msk.new_zeros((n_pad - n, ld))])
        pids = np.concatenate([pids, np.full((n_pad - n,), -1, np.int64)])
    return TokenIndex(tokens=tok.contiguous(), mask=msk.contiguous(),
                      pids=pids, num_docs=n,
                      meta={"doc_maxlen": ld, "dim": dim})


def encode_corpus(
    doc_encode_fn: Callable,
    batches: Iterable[dict],
    pad_multiple: int = 128,
    dtype: torch.dtype = torch.bfloat16,
    pids: Optional[Sequence[int]] = None,
    device=None,
    resume_dir: Optional[str] = None,
) -> TokenIndex:
    """Encode a corpus into a TokenIndex.

    doc_encode_fn(batch) -> (D (B, Ld, dim), mask (B, Ld)) tensors. Each
    batch's embeddings are cast to `dtype` as they arrive and stay on their
    device, so the index never makes a round trip through the host (casting
    per batch gives the same values as casting the whole f32 stack).

    resume_dir: each batch's float32 embeddings and int8 mask persist there
    as chunk_{i}.npz (the JAX package's files, so either package resumes
    the other's), and a restarted build skips the chunks already on disk
    (the reference's indexing `resume` mode). A chunk is written to a
    temporary name and renamed, so a crash never leaves a truncated one."""
    embs, msks = [], []
    if resume_dir:
        os.makedirs(resume_dir, exist_ok=True)
    for i, batch in enumerate(batches):
        chunk = (os.path.join(resume_dir, f"chunk_{i}.npz")
                 if resume_dir else None)
        if chunk and os.path.exists(chunk):
            with np.load(chunk) as z:
                d, m = torch.from_numpy(z["d"]), torch.from_numpy(z["m"])
            if device is not None:
                d, m = d.to(device), m.to(device)
        else:
            d, m = doc_encode_fn(batch)
            if chunk:
                tmp = chunk + ".tmp.npz"
                np.savez(tmp, d=_np(d, torch.float32), m=_np(m, torch.int8))
                os.replace(tmp, chunk)
        embs.append(d.to(dtype))
        msks.append(m.to(torch.int8))
    tok = torch.cat(embs)
    del embs
    return build_index_from_embeddings(tok, torch.cat(msks), pids=pids,
                                       pad_multiple=pad_multiple, dtype=dtype,
                                       device=device)


# ---------------------------------------------------------------------------
# Persistence: index.npz + metadata.json, the JAX package's format
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor, dtype) -> np.ndarray:
    return t.detach().cpu().to(dtype).numpy()


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    """bf16 tensor -> its uint16 bit patterns (npz has no bf16 dtype)."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.uint16)


def _from_bf16_bits(raw: np.ndarray) -> torch.Tensor:
    """uint16 bit patterns -> bf16 tensor (no ml_dtypes needed)."""
    wide = (raw.astype(np.uint32) << 16).view(np.float32)
    return torch.from_numpy(np.ascontiguousarray(wide)).to(torch.bfloat16)


def save_index(index: TokenIndex, path: str) -> None:
    """Write index.npz and metadata.json under `path`, in the JAX package's
    format: float tokens as float32, int8 tokens as int8, float32 or
    bf16 (as uint16 bits) scales; a residual index stores its records,
    codec tables and summaries."""
    os.makedirs(path, exist_ok=True)
    if index.scales is None:
        scales_np, scales_dtype = np.zeros((0,)), "float32"
    elif index.scales.dtype == torch.bfloat16:
        scales_np, scales_dtype = _bf16_bits(index.scales), "bfloat16"
    else:
        scales_np, scales_dtype = _np(index.scales, torch.float32), "float32"
    arrays = dict(mask=_np(index.mask, torch.int8), pids=index.pids,
                  scales=scales_np)
    if index.tokens is not None:
        arrays["tokens"] = _np(index.tokens, torch.int8
                               if index.tokens.dtype == torch.int8
                               else torch.float32)
    else:
        arrays["records"] = _np(index.records, torch.uint8)
        arrays["codec_centroids"] = _np(index.codec_centroids, torch.float32)
        arrays["codec_weights"] = _np(index.codec_weights, torch.float32)
        arrays["summaries"] = _np(index.summaries, torch.float32)
        if index.codec_coarse is not None:
            arrays["codec_coarse"] = _np(index.codec_coarse, torch.float32)
            arrays["codec_fine"] = _np(index.codec_fine, torch.float32)
    np.savez(os.path.join(path, "index.npz"), **arrays)
    # "planar": the residual bit-pack layout (ops/residual.py); older
    # interleaved saves decode scrambled and are refused on load
    extra = {"residual_layout": "planar"} if index.tokens is None else {}
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump({"num_docs": index.num_docs,
                   "quantized": index.scales is not None
                   or index.records is not None,
                   "scales_dtype": scales_dtype, "nbits": index.nbits,
                   **extra, **index.meta}, f)


def load_index(path: str, dtype: torch.dtype = torch.bfloat16, mesh=None,
               axis: str = "index", *, device=None) -> TokenIndex:
    """Load an index saved by save_index here or in the JAX package, onto
    `device` (default CPU). Float tokens and a residual index's summaries
    come back in `dtype`. A residual save with the legacy separate
    codes / residuals / scales arrays is repacked into record rows; one
    with a bit-pack layout other than planar is refused."""
    from ..ops.residual import pack_records
    _no_mesh(mesh, "index")
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    z = np.load(os.path.join(path, "index.npz"))
    quantized = meta.pop("quantized", False)
    nbits = meta.pop("nbits", 0)
    scales_dtype = meta.pop("scales_dtype", "float32")
    mask = torch.from_numpy(z["mask"]).to(torch.int8)
    if not quantized:
        scales = None
    elif scales_dtype == "bfloat16":
        raw = z["scales"]
        if raw.dtype != np.uint16:        # npz may keep a void view
            raw = raw.view(np.uint16)
        scales = _from_bf16_bits(raw)
    else:
        scales = torch.from_numpy(z["scales"]).float()

    def dev(t):
        return None if t is None else t.to(device)

    def opt(name):
        return (torch.from_numpy(z[name]).float().to(device)
                if name in z.files else None)

    if "records" in z.files or "codes" in z.files:      # residual index
        layout = meta.pop("residual_layout", "interleaved")
        if layout != "planar":
            raise ValueError(
                f"residual index at {path} uses the '{layout}' bit-pack "
                "layout; only 'planar' decodes (residual bytes would unpack "
                "onto the wrong dims). Re-build the index with "
                "quantize_residual().")
        if "records" in z.files:
            records = torch.from_numpy(z["records"])
        else:
            codes = z["codes"]
            if codes.size and int(codes.max()) >= 65536:
                raise ValueError(
                    f"legacy residual index at {path} uses "
                    f"{int(codes.max()) + 1}+ centroids; record rows store "
                    "uint16 codes (at most 65536): re-build the index")
            if scales is None:
                scales = torch.ones(codes.shape, dtype=torch.bfloat16)
            records = pack_records(torch.from_numpy(codes.astype(np.int32)),
                                   scales, torch.from_numpy(z["residuals"]))
        return TokenIndex(
            tokens=None, mask=dev(mask), pids=z["pids"],
            num_docs=meta.pop("num_docs"), meta=meta,
            summaries=torch.from_numpy(z["summaries"]).to(device=device,
                                                          dtype=dtype),
            records=dev(records), codec_centroids=opt("codec_centroids"),
            codec_weights=opt("codec_weights"),
            codec_coarse=opt("codec_coarse"), codec_fine=opt("codec_fine"),
            nbits=nbits)
    tokens = torch.from_numpy(z["tokens"]).to(
        torch.int8 if quantized else dtype)
    return TokenIndex(tokens=dev(tokens), mask=dev(mask), pids=z["pids"],
                      num_docs=meta.pop("num_docs"), meta=meta,
                      scales=dev(scales))
