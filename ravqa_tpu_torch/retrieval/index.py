"""Device-resident late-interaction token index, on one device or sharded
over a mesh axis.

Port of ravqa_tpu/retrieval/index.py:

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
`axis` included. A float32 index searched exactly on the card also keeps
its bf16 planes (token_planes), made on first use and never saved.

Sharding (a `mesh`, parallel.make_mesh, and its `axis`): the JAX index's
arrays are sharded over dim 0 (P(axis)); here each rank's TokenIndex
holds its own rows, [r * n_local, (r + 1) * n_local) of the padded index
at its position r on the axis, while `pids` stays the global table and
`n_pad` the global padded count. The padded count is a multiple of
pad_multiple * nshards (JAX's rule), the per-doc and per-block arrays
(summaries, block summaries, int8 scales, residual records) are built
from the local rows, block_size must divide n_local, and the residual
codec is trained on the JAX package's global token sample (rank 0 trains,
every rank gets the same tables). load_index reads only the rank's rows,
encode_corpus encodes only the rank's slice of the corpus, and save_index
gathers the shards and writes from rank 0.
"""

from __future__ import annotations

import dataclasses
import json
import os
import weakref
import zipfile
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import (all_gather, all_reduce, axis_group, axis_rank,
                             broadcast_object, mesh_axis_size, rank_zero)


@dataclasses.dataclass
class TokenIndex:
    """A late-interaction token index: on one device, or this rank's
    shard of an index sharded over `axis` of `mesh`."""
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
    mesh: Any = None           # the DeviceMesh the index is sharded over
    axis: Any = "index"        # its mesh axis (or a tuple of axes)

    def build_summaries(self, n_summary: int = 8, iters: int = 4,
                        mesh=None, axis: str = "index") -> "TokenIndex":
        """Attach per-doc summary vectors (coarse.summarize_docs) for
        two-stage and hierarchical search, in the tokens' dtype; bfloat16
        for an int8 index, whose k-means runs on the raw codes (as the JAX
        package's). A residual index has no tokens: build summaries before
        quantize_residual(). A sharded index summarizes its own rows
        (`mesh` and `axis`, the JAX signature's, must be its own)."""
        from .coarse import summarize_docs
        self._check_mesh(mesh, axis)
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
                              iters: int = 4, mesh=None,
                              axis: str = "index") -> "TokenIndex":
        """Second summary level for hierarchical search, over blocks of
        `block_size` consecutive docs. For best recall, build the index
        with cluster-ordered docs (coarse.cluster_order). A sharded index
        summarizes its own blocks: block_size must divide n_local, so no
        block spans two shards."""
        from .coarse import block_summaries
        self._check_mesh(mesh, axis)
        if self.summaries is None:
            raise ValueError("build_summaries() first")
        if self.n_pad % block_size:
            raise ValueError(f"block_size {block_size} must divide the "
                             f"padded doc count {self.n_pad}")
        if self.n_local % block_size:
            raise ValueError(f"block_size {block_size} must divide the "
                             f"per-shard doc count {self.n_local}")
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
        blocks written straight into the record rows. A sharded index
        trains on the global sample the JAX package draws from the whole
        token array (rank 0 trains on it and broadcasts the tables) and
        compresses its own rows."""
        from ..ops.residual import (_sample_split, compress_blocks,
                                    pack_records, record_bytes, train_codec,
                                    train_codec_factored)
        self._check_mesh(mesh, axis)
        if self.tokens is None:
            raise ValueError("the index is already residual-compressed")
        if self.summaries is None:
            raise ValueError("build_summaries() before quantize_residual()")
        dev = self.device
        tokens, mask, gather = self.tokens, self.mask, None
        trains = True
        if self.mesh is not None and codec is None:
            mask = self._gathered(self.mask)
            gather = self._sample_rows
            trains = self.shard_rank == 0
            if not trains:
                # take part in assembling the sample; rank 0 trains on it
                _sample_split(tokens, mask, sample, heldout, seed, dev,
                              gather)
        if trains and codec is None and isinstance(n_centroids,
                                                   (tuple, list)):
            k1, k2 = n_centroids
            codec = train_codec_factored(tokens, mask, k_coarse=k1,
                                         k_fine=k2, nbits=nbits, seed=seed,
                                         sample=sample, heldout=heldout,
                                         device=dev, gather=gather)
        elif trains and codec is None:
            codec = train_codec(tokens, mask,
                                n_centroids=n_centroids, nbits=nbits,
                                seed=seed, sample=sample, heldout=heldout,
                                device=dev, gather=gather)
        if self.mesh is not None:
            # rank 0's tables on every rank, whether trained or given
            group = axis_group(self.mesh, self.axis)
            codec = broadcast_object(
                _to_cpu(codec) if self.shard_rank == 0 else None,
                torch.distributed.get_global_rank(group, 0), group)
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
        its normalizing scale. On a sharded index the rows are global and
        every rank of the axis gets them all (each fills its own rows; a
        sum over the axis assembles them)."""
        if self.mesh is not None:
            return self._gather_global(rows, self._gather_tokens_local)
        return self._gather_tokens_local(rows)

    def gather_mask(self, rows: torch.Tensor) -> torch.Tensor:
        """The token masks of the given (global) padded-index rows, float32,
        (..., Ld)."""
        if self.mesh is not None:
            return self._gather_global(rows, lambda r: self.mask[r].float())
        return self.mask[rows].float()

    def _gather_global(self, rows: torch.Tensor, take) -> torch.Tensor:
        lo = self.shard_rank * self.n_local
        own = (rows >= lo) & (rows < lo + self.n_local)
        out = take(torch.where(own, rows - lo, 0))
        out = out * own.reshape(own.shape + (1,) * (out.dim() - own.dim()))
        return all_reduce(out.contiguous(),
                          group=axis_group(self.mesh, self.axis))

    def _gather_tokens_local(self, rows: torch.Tensor) -> torch.Tensor:
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

    # -- sharding ----------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return 1 if self.mesh is None else mesh_axis_size(self.mesh,
                                                          self.axis)

    @property
    def shard_rank(self) -> int:
        return 0 if self.mesh is None else axis_rank(self.mesh, self.axis)

    @property
    def n_local(self) -> int:
        """The rows this index (shard) holds."""
        return self.mask.shape[0]

    def _check_mesh(self, mesh, axis) -> None:
        if mesh is not None and (mesh is not self.mesh or axis != self.axis):
            raise ValueError("a sharded index is built with its mesh "
                             "(build_index_from_embeddings, encode_corpus "
                             "or load_index with `mesh`); its later steps "
                             "take that mesh and axis or none")

    def _gathered(self, t: torch.Tensor) -> torch.Tensor:
        """The global array of a per-doc shard, on every rank."""
        g = all_gather(t, axis_group(self.mesh, self.axis))
        return g.reshape(-1, *t.shape[1:])

    def _sample_rows(self, rows: np.ndarray) -> torch.Tensor:
        """Flat (N_pad * Ld) token rows of the global index -> their
        float32 tokens on every rank: each rank fills the rows it holds and
        a sum over the axis assembles them (rows are unique)."""
        ld, dim = self.tokens.shape[1], self.tokens.shape[2]
        lo = self.shard_rank * self.n_local * ld
        mine = (rows >= lo) & (rows < lo + self.n_local * ld)
        out = torch.zeros((len(rows), dim), dtype=torch.float32,
                          device=self.device)
        sel = torch.from_numpy(np.flatnonzero(mine)).to(self.device)
        loc = torch.from_numpy(rows[mine] - lo).to(self.device)
        out[sel] = self.tokens.reshape(-1, dim)[loc].float()
        return all_reduce(out, group=axis_group(self.mesh, self.axis))

    @property
    def device(self) -> torch.device:
        return self.mask.device

    @property
    def n_pad(self) -> int:
        """The padded doc count of the whole index (every shard's rows)."""
        return self.n_local * self.n_shards

    @property
    def doc_maxlen(self) -> int:
        return self.mask.shape[1]

    @property
    def dim(self) -> int:
        if self.tokens is not None:
            return self.tokens.shape[2]
        return self.codec_centroids.shape[1]


def _to_cpu(codec):
    return dataclasses.replace(codec, **{
        f.name: getattr(codec, f.name).cpu()
        for f in dataclasses.fields(codec)
        if isinstance(getattr(codec, f.name), torch.Tensor)})


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
    lives (None: where `embs` is, the CPU for numpy input). mesh: every
    rank passes the whole corpus and keeps its shard of the rows over
    `axis`; the padded count is then a multiple of pad_multiple * nshards,
    as the JAX package pads it."""
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
    pids = (np.arange(n, dtype=np.int64) if pids is None
            else np.asarray(pids, np.int64))
    n_pad = padded_count(n, pad_multiple, mesh, axis)
    lo, hi = 0, n_pad
    if mesh is not None:
        n_local = n_pad // mesh_axis_size(mesh, axis)
        lo = axis_rank(mesh, axis) * n_local
        hi = lo + n_local
    tok = tok[lo:min(hi, n)].to(device=device, dtype=dtype)
    msk = msk[lo:min(hi, n)].to(device=device).to(torch.int8)
    return _padded_index(tok, msk, pids, n, n_pad, hi - lo, ld, dim,
                         mesh, axis)


def padded_count(n: int, pad_multiple: int, mesh=None,
                 axis="index") -> int:
    """The padded doc count: a multiple of pad_multiple, and of
    pad_multiple * nshards on a mesh (the JAX package's rule)."""
    n_pad = pad_to(max(n, 1), pad_multiple)
    if mesh is not None:
        n_pad = pad_to(n_pad, pad_multiple * mesh_axis_size(mesh, axis))
    return n_pad


def _padded_index(tok, msk, pids, n, n_pad, n_rows, ld, dim, mesh,
                  axis) -> TokenIndex:
    """A TokenIndex of `tok`/`msk` (the real docs of these rows) padded
    with masked rows to n_rows, the global pids padded with -1 to n_pad."""
    short = n_rows - tok.shape[0]
    if short:
        tok = torch.cat([tok, tok.new_zeros((short, ld, dim))])
        msk = torch.cat([msk, msk.new_zeros((short, ld))])
    if n_pad != n:
        pids = np.concatenate([pids, np.full((n_pad - n,), -1, np.int64)])
    return TokenIndex(tokens=tok.contiguous(), mask=msk.contiguous(),
                      pids=pids, num_docs=n,
                      meta={"doc_maxlen": ld, "dim": dim}, mesh=mesh,
                      axis=axis)


def encode_corpus(
    doc_encode_fn: Callable,
    batches: Iterable[dict],
    pad_multiple: int = 128,
    dtype: torch.dtype = torch.bfloat16,
    pids: Optional[Sequence[int]] = None,
    device=None,
    resume_dir: Optional[str] = None,
    mesh=None,
    axis: str = "index",
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
    temporary name and renamed, so a crash never leaves a truncated one.

    mesh: each rank encodes only the docs of its own rows over `axis` (the
    batches are read once to count the corpus, and each batch's
    overlap with the rank's rows is encoded); a rank's resume chunks are
    chunk_{i}.shard{r}of{n}.npz."""
    if mesh is not None:
        return _encode_corpus_sharded(doc_encode_fn, list(batches),
                                      pad_multiple, dtype, pids, device,
                                      resume_dir, mesh, axis)
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
            d, m = _encode_chunk(doc_encode_fn, batch, chunk)
        embs.append(d.to(dtype))
        msks.append(m.to(torch.int8))
    tok = torch.cat(embs)
    del embs
    return build_index_from_embeddings(tok, torch.cat(msks), pids=pids,
                                       pad_multiple=pad_multiple, dtype=dtype,
                                       device=device)


def _encode_chunk(doc_encode_fn, batch, chunk: Optional[str]):
    """Encode one batch, writing its resume chunk (temporary name, then
    renamed) when `chunk` names one."""
    d, m = doc_encode_fn(batch)
    if chunk:
        tmp = chunk + ".tmp.npz"
        np.savez(tmp, d=_np(d, torch.float32), m=_np(m, torch.int8))
        os.replace(tmp, chunk)
    return d, m


def _batch_len(batch: dict) -> int:
    return len(next(v for v in batch.values()
                    if isinstance(v, (np.ndarray, torch.Tensor, list))))


def _slice_batch(batch: dict, a: int, b: int) -> dict:
    """Rows [a, b) of every per-row value of a batch."""
    n = _batch_len(batch)
    return {k: v[a:b] if isinstance(v, (np.ndarray, torch.Tensor, list))
            and len(v) == n else v for k, v in batch.items()}


def _encode_corpus_sharded(doc_encode_fn, batches, pad_multiple, dtype, pids,
                           device, resume_dir, mesh, axis) -> TokenIndex:
    sizes = [_batch_len(b) for b in batches]
    n = sum(sizes)
    n_pad = padded_count(n, pad_multiple, mesh, axis)
    ns = mesh_axis_size(mesh, axis)
    r = axis_rank(mesh, axis)
    n_local = n_pad // ns
    lo, hi = r * n_local, (r + 1) * n_local
    if resume_dir:
        os.makedirs(resume_dir, exist_ok=True)
    embs, msks, start = [], [], 0
    for i, (batch, size) in enumerate(zip(batches, sizes)):
        a, b = max(lo - start, 0), min(hi - start, size)
        start += size
        if a >= b:
            continue
        chunk = (os.path.join(resume_dir, f"chunk_{i}.shard{r}of{ns}.npz")
                 if resume_dir else None)
        if chunk and os.path.exists(chunk):
            with np.load(chunk) as z:
                d, m = torch.from_numpy(z["d"]), torch.from_numpy(z["m"])
            if device is not None:
                d, m = d.to(device), m.to(device)
        else:
            d, m = _encode_chunk(doc_encode_fn, _slice_batch(batch, a, b),
                                 chunk)
        embs.append(d.to(dtype))
        msks.append(m.to(torch.int8))
    if not embs:
        # a rank of padding only: one doc's encoding gives the shapes
        d, m = doc_encode_fn(_slice_batch(batches[0], 0, 1))
        embs, msks = [d[:0].to(dtype)], [m[:0].to(torch.int8)]
    tok, msk = torch.cat(embs), torch.cat(msks)
    if device is not None:
        tok, msk = tok.to(device), msk.to(device)
    pids = (np.arange(n, dtype=np.int64) if pids is None
            else np.asarray(pids, np.int64))
    return _padded_index(tok, msk, pids, n, n_pad, n_local, tok.shape[1],
                         tok.shape[2], mesh, axis)


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
    codec tables and summaries. A sharded index is gathered over its axis
    (every rank calls this) and rank 0 writes the whole index."""
    if index.mesh is not None:
        full = dataclasses.replace(index, mesh=None, **{
            f: index._gathered(getattr(index, f))
            for f in ("tokens", "mask", "scales", "records", "summaries")
            if getattr(index, f) is not None})
        if rank_zero():
            save_index(full, path)
        return
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
    with a bit-pack layout other than planar is refused. mesh: each rank
    reads only its rows over `axis` of the per-doc arrays (pids and the
    codec tables whole)."""
    from ..ops.residual import pack_records
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    npz = os.path.join(path, "index.npz")
    z = np.load(npz)
    rows = _shard_reader(npz, z, mesh, axis)
    quantized = meta.pop("quantized", False)
    nbits = meta.pop("nbits", 0)
    scales_dtype = meta.pop("scales_dtype", "float32")
    mask = torch.from_numpy(rows("mask")).to(torch.int8)
    if not quantized:
        scales = None
    elif scales_dtype == "bfloat16":
        raw = rows("scales")
        if raw.dtype != np.uint16:        # npz may keep a void view
            raw = raw.view(np.uint16)
        scales = _from_bf16_bits(raw)
    else:
        scales = torch.from_numpy(rows("scales")).float()

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
            records = torch.from_numpy(rows("records"))
        else:
            codes = rows("codes")
            if codes.size and int(codes.max()) >= 65536:
                raise ValueError(
                    f"legacy residual index at {path} uses "
                    f"{int(codes.max()) + 1}+ centroids; record rows store "
                    "uint16 codes (at most 65536): re-build the index")
            if scales is None:
                scales = torch.ones(codes.shape, dtype=torch.bfloat16)
            records = pack_records(torch.from_numpy(codes.astype(np.int32)),
                                   scales, torch.from_numpy(rows("residuals")))
        return TokenIndex(
            tokens=None, mask=dev(mask), pids=z["pids"],
            num_docs=meta.pop("num_docs"), meta=meta,
            summaries=torch.from_numpy(rows("summaries")).to(device=device,
                                                              dtype=dtype),
            records=dev(records), codec_centroids=opt("codec_centroids"),
            codec_weights=opt("codec_weights"),
            codec_coarse=opt("codec_coarse"), codec_fine=opt("codec_fine"),
            nbits=nbits, mesh=mesh, axis=axis)
    tokens = torch.from_numpy(rows("tokens")).to(
        torch.int8 if quantized else dtype)
    return TokenIndex(tokens=dev(tokens), mask=dev(mask), pids=z["pids"],
                      num_docs=meta.pop("num_docs"), meta=meta,
                      scales=dev(scales), mesh=mesh, axis=axis)


def _shard_reader(npz: str, z, mesh, axis):
    """name -> the array, or on a mesh this rank's rows of it, read from
    the uncompressed .npy member without loading the other rows."""
    if mesh is None:
        return lambda name: z[name]
    n_pad = z["pids"].shape[0]
    ns = mesh_axis_size(mesh, axis)
    if n_pad % ns:
        raise ValueError(f"the saved index's {n_pad} rows do not divide "
                         f"over {ns} shards: build it with the mesh, or "
                         "pad it to a multiple of the shard count")
    n_local = n_pad // ns
    lo = axis_rank(mesh, axis) * n_local

    def rows(name):
        with zipfile.ZipFile(npz) as zf, zf.open(name + ".npy") as f:
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            if fortran or len(shape) == 0 or shape[0] != n_pad:
                return z[name][lo:lo + n_local] if len(shape) else z[name]
            row = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
            f.seek(f.tell() + lo * row)
            buf = f.read(n_local * row)
        return np.frombuffer(buf, dtype).reshape(
            (n_local,) + tuple(shape[1:])).copy()
    return rows
