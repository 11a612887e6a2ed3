// Gathered stage-1 sweep of hierarchical search on Hopper (K4).
//
// Replaces ravqa_tpu/ops/maxsim.py::stage1_sweep_pallas (body
// _stage1_sweep_kernel, with the scalar-prefetch PrefetchScalarGridSpec
// that DMAs each query's selected blocks). Each query b scores the doc
// summaries of its OWN selected blocks blk[b, :], in gathered order:
//
//   out[b, i * bs + j] = dscale(doc) *
//                        sum_c max_s q[b, c] . rows[blk[b, i], s, j]
//
// rows is the stage1_rows layout (NB, S, bs, dim): each block's slot-s
// summaries are one contiguous (bs, dim) tile. dscale, the per-doc scale of
// int8 rows, is applied to the raw sum in the kernel's epilogue (the same
// float32 multiply the TPU path applies afterwards); doc validity stays
// with the caller, as on the TPU path.
//
// What bounds it on this card: at the serve shape (B=32, Lq=64, 32 of 256
// blocks of bs=64, S=8, dim=128) the products are 8.6 GFLOP of bf16, about
// 9 us at the tensor cores' peak, and the selected rows a few MB from L2;
// on the CUDA cores (f32 FMAs) the products alone would take 0.13 ms.
//
// bf16 and int8 rows run on the tensor cores (summary_tile.cuh): a tile is
// 64 consecutive docs of one selected block (a block of bs > 64 docs spans
// ceil(bs / 64) tiles; rows of a tile past the block are dropped), its slot
// slabs arrive by TMA at rows ((blk * S + s) * bs + j0) of the rows as
// (NB * S * bs) x dim, and the query's tokens are the MMA's columns
// (m64nNk16 bf16 -> f32, N the smallest of 16, 32, 64, 128 that covers
// the query, several column passes past 128). The block reads its own
// blk entries (the TPU kernel's scalar prefetch) when it asks for a slab.
// A comes from registers: each thread loads its fragment rows from the
// swizzled slab and, for int8 rows, widens them to bf16 exactly (the TPU
// kernel's cast; wgmma has no int8 x bf16 form). K is summed over, so the
// query's staged columns take the order in which a 32-bit load of four
// int8 values (or a 64-bit load of four bf16 ones) fills the fragment:
// dims 4c .. 4c + 3 of each k-step of 16 land at k positions 2c, 2c + 1,
// 2c + 8, 2c + 9.
//
// float32 rows (never made by the searcher, which keeps bf16 or int8
// rows) keep the CUDA-core body: one block per (query, tile of 128
// gathered docs), rows read with cp.async, one slot at a time and
// double-buffered, 8 x 8 register tiles of f32 FMAs (sweep_tile.cuh), each
// score summed by one thread in a fixed order; dscale is applied by the
// caller.
//
// Every sum runs in a fixed order: results repeat bit for bit. The TPU
// kernel's lane rule (n_blocks a multiple of 128 / gcd(bs, 128)) does not
// apply: any n_blocks and bs work.
//
// Inputs, all contiguous: q (B, Lq, dim) bfloat16 (bf16 or int8 rows) or
// float32 (float32 rows); rows (NB, S, bs, dim); blk (B, n_blocks) int32,
// each in [0, NB) (values outside are clamped); dscale (NB * bs) float or
// null; out (B, n_blocks * bs) float32. dim % 8 == 0 (dim % 16 == 0 for
// int8 rows), dim <= 128, pointers 16-byte aligned (the Python wrapper
// checks).

#include "summary_tile.cuh"
#include "sweep_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32 rows on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kMaxDim = 128;

size_t simt_smem_bytes(int dim) {
  using namespace sweep;
  const size_t qs = sizeof(float) * dim * kQsLd;
  const size_t ds = sizeof(float) * 2 * kRows * row_ld<float>(dim);
  const size_t red = sizeof(float) * kRows * kRedLd;
  return qs + (ds > red ? ds : red) + sizeof(long long) * kRows;
}

__global__ void __launch_bounds__(sweep::kThreads, 1)
stage1_sweep_simt(const float* __restrict__ q,
                  const float* __restrict__ rows,
                  const int* __restrict__ blk, float* __restrict__ out,
                  int Lq, int S, int bs, int nbl, int NB, int dim) {
  using namespace sweep;
  extern __shared__ float4 smem4[];
  const int ds_ld = row_ld<float>(dim);
  float* Qs = reinterpret_cast<float*>(smem4);             // [dim][kQsLd]
  char* region = reinterpret_cast<char*>(Qs + dim * kQsLd);
  float* Ds = reinterpret_cast<float*>(region);            // [2][kRows][ds_ld]
  float* red = reinterpret_cast<float*>(region);           // [kRows][kRedLd]
  const size_t ds_bytes = sizeof(float) * 2 * kRows * ds_ld;
  const size_t red_bytes = sizeof(float) * kRows * kRedLd;
  long long* rowoff = reinterpret_cast<long long*>(
      region + (ds_bytes > red_bytes ? ds_bytes : red_bytes));  // [kRows]

  const int P = nbl * bs;                      // gathered docs per query
  const int tiles = (P + kRows - 1) / kRows;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * kRows;
  const int nr = min(kRows, P - p0);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int chunks_per_row = dim * static_cast<int>(sizeof(float)) / 16;

  // row r of the tile is doc j of selected block t; its slot-0 summary
  // starts at element rowoff[r] * dim of rows
  for (int r = tid; r < nr; r += kThreads) {
    const int t = (p0 + r) / bs, j = (p0 + r) % bs;
    const int blk_id = min(max(blk[static_cast<size_t>(b) * nbl + t], 0),
                           NB - 1);
    rowoff[r] = static_cast<long long>(blk_id) * S * bs + j;
  }
  __syncthreads();

  auto issue = [&](int s) {
    char* dst = reinterpret_cast<char*>(Ds + (s & 1) * kRows * ds_ld);
    for (int i = tid; i < nr * chunks_per_row; i += kThreads) {
      const int r = i / chunks_per_row, c = i % chunks_per_row;
      const float* src =
          rows + (rowoff[r] + static_cast<long long>(s) * bs) * dim;
      cp_async16(dst + (static_cast<size_t>(r) * ds_ld) * sizeof(float) +
                     c * 16,
                 reinterpret_cast<const char*>(src) + c * 16);
    }
    cp_async_commit();
  };

  const float* qb = q + static_cast<size_t>(b) * Lq * dim;
  for (int c0 = 0; c0 < Lq; c0 += kCols) {
    const int nc = min(kCols, Lq - c0);
    __syncthreads();  // the previous chunk's readers of Qs and red are done
    issue(0);
    for (int i = tid; i < kCols * (dim / 4); i += kThreads) {
      const int c = i / (dim / 4), k = (i % (dim / 4)) * 4;
      const float4 v = c < nc
          ? load4(qb + static_cast<size_t>(c0 + c) * dim + k)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      Qs[(k + 0) * kQsLd + c] = v.x;
      Qs[(k + 1) * kQsLd + c] = v.y;
      Qs[(k + 2) * kQsLd + c] = v.z;
      Qs[(k + 3) * kQsLd + c] = v.w;
    }

    float m[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) m[i][j] = __int_as_float(0xff800000);
    for (int s = 0; s < S; ++s) {
      cp_async_wait_all();
      __syncthreads();  // slot s landed; everyone is done with slot s-1
      if (s + 1 < S) issue(s + 1);
      const float* D = Ds + (s & 1) * kRows * ds_ld;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      if (nc > 64)
        tile_product<2>(Qs, D, ds_ld, dim, tx, ty, acc);
      else
        tile_product<1>(Qs, D, ds_ld, dim, tx, ty, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) m[i][j] = fmaxf(m[i][j], acc[i][j]);
    }

    __syncthreads();  // every product is done: red may overwrite Ds
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[(ty + 16 * i) * kRedLd + tile_col(tx, j)] = m[i][j];
    __syncthreads();
    for (int r = tid; r < nr; r += kThreads) {
      float total = 0.f;
      for (int c = 0; c < nc; ++c) total += red[r * kRedLd + c];
      const size_t o = static_cast<size_t>(b) * P + p0 + r;
      out[o] = c0 > 0 ? out[o] + total : total;  // Lq longer than kCols
    }
  }
}

int launch_simt(const void* q, const void* rows, const void* blk, void* out,
                int B, int Lq, int S, int bs, int nbl, int NB, int dim,
                cudaStream_t stream) {
  if (dim > kMaxDim || dim % 8 || S <= 0 || bs <= 0 || NB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = simt_smem_bytes(dim);
  auto kernel = stage1_sweep_simt;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      (static_cast<long long>(nbl) * bs + sweep::kRows - 1) / sweep::kRows;
  const long long blocks = tiles * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), sweep::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(rows),
      static_cast<const int*>(blk), static_cast<float*>(out), Lq, S, bs, nbl,
      NB, dim);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16 and int8 rows on the tensor cores
// ---------------------------------------------------------------------------

using summary_tile::Args;
using summary_tile::kRows;
using summary_tile::Row;

// TR: the rows' type (bf16 or int8); NC: the MMA's N
template <typename TR, int NC>
struct Stage1Op {
  static constexpr int kCols = NC;
  static constexpr int kElemBytes = static_cast<int>(sizeof(TR));
  static constexpr int kSlabPanels = kElemBytes;   // dim <= 128 values
  static constexpr int kQueryPanels = 2;           // bf16 query columns
  static constexpr bool kWeighted = false;
  using Acc = float;
  __device__ static float lowest() { return __int_as_float(0xff800000); }
  // the k-panels that hold data (a bf16 row of dim <= 64 takes one)
  __device__ static int panels(const Args& a) {
    return (a.dim * kElemBytes + 127) / 128;
  }

  __device__ static int chunks(const Args& a) {
    return (a.bs + kRows - 1) / kRows;
  }

  // the selected block of tile t (clamped to [0, NB)) and its first doc
  __device__ static int block_of(const Args& a, int b, int t, int* j0) {
    const int ch = chunks(a), sel = t / ch;
    *j0 = (t - sel * ch) * kRows;
    return min(max(a.blk[static_cast<size_t>(b) * a.nbl + sel], 0),
               a.NB - 1);
  }

  // slot s of docs j0 .. j0 + 63 of the tile's block (rows past the block
  // are the next slot's or block's, or zeros past the last, and are
  // never written)
  __device__ static int slab_row(const Args& a, int b, int t, int s) {
    int j0;
    const int id = block_of(a, b, t, &j0);
    return (id * a.S + s) * a.bs + j0;
  }

  // A fragments of rows r0 = 16 warp + g and r0 + 8 for each k-step of 16
  // values, from the swizzled slab (16-byte chunk k of row r at k ^ (r &
  // 7)): dims 4c .. 4c + 3 of the k-step in (a0, a2) and (a1, a3), zeros
  // past dim; then the 8 wgmmas, waited for
  __device__ static void product(const Args& a, float (&acc)[NC / 2],
                                 const unsigned char* slab,
                                 const unsigned char* qbuf, int warp,
                                 int lane) {
    const int r0 = 16 * warp + (lane >> 2), c = lane & 3;
    uint32_t A[8][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint2 x0 = make_uint2(0, 0), x1 = make_uint2(0, 0);
      if (16 * ks < a.dim) {
        if constexpr (kElemBytes == 1) {
          const unsigned char* p =
              slab + r0 * 128 + (((ks ^ r0) & 7) << 4) + 4 * c;
          x0 = summary_tile::widen_int8(*reinterpret_cast<const uint32_t*>(p));
          x1 = summary_tile::widen_int8(
              *reinterpret_cast<const uint32_t*>(p + 8 * 128));
        } else {
          const unsigned char* p =
              slab + (ks >> 2) * kRows * 128 + r0 * 128 +
              ((((ks & 3) * 2 + (c >> 1)) ^ (r0 & 7)) << 4) + 8 * (c & 1);
          x0 = *reinterpret_cast<const uint2*>(p);
          x1 = *reinterpret_cast<const uint2*>(p + 8 * 128);
        }
      }
      A[ks][0] = x0.x;
      A[ks][1] = x1.x;
      A[ks][2] = x0.y;
      A[ks][3] = x1.y;
    }
    const uint32_t qa = summary_tile::smem_addr(qbuf);
    mma_tile::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      summary_tile::wgmma_rs<NC>(
          acc, A[ks],
          summary_tile::sw128_desc(qa + (ks >> 2) * NC * 128 + (ks & 3) * 32),
          ks > 0);
    mma_tile::wgmma_commit();
    mma_tile::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) summary_tile::fence_operand(acc[i]);
  }

  // column c of pass p: token p * NC + c of query b, each k-step's 16 dims
  // as the words w0..w7 (dims 2i, 2i + 1) in the order w0 w2 w4 w6 | w1 w3
  // w5 w7 (the fragments' k order above), 128-byte rows of two k-panels
  // (chunk k at k ^ (c & 7)); zeros past Lq and past dim
  __device__ static void stage_query(const Args& a, int b, int, int pass,
                                     unsigned char* qbuf, float*, int tid) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    for (int i = tid; i < NC * 8; i += summary_tile::kThreads) {
      const int c = i >> 3, ks = i & 7, tok = pass * NC + c;
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (tok < a.Lq) {
        const __nv_bfloat16* src =
            q + (static_cast<size_t>(b) * a.Lq + tok) * a.dim + 16 * ks;
        if (16 * ks < a.dim) lo = *reinterpret_cast<const uint4*>(src);
        if (16 * ks + 8 < a.dim) hi = *reinterpret_cast<const uint4*>(src + 8);
      }
      unsigned char* row = qbuf + (ks >> 2) * NC * 128 + c * 128;
      const int k0 = (ks & 3) * 2;
      *reinterpret_cast<uint4*>(row + ((k0 ^ (c & 7)) << 4)) =
          make_uint4(lo.x, lo.z, hi.x, hi.z);
      *reinterpret_cast<uint4*>(row + (((k0 + 1) ^ (c & 7)) << 4)) =
          make_uint4(lo.y, lo.w, hi.y, hi.w);
    }
  }

  __device__ static Row row(const Args& a, int b, int t, int r) {
    int j0;
    const int id = block_of(a, b, t, &j0);
    const int j = j0 + r;
    if (j >= a.bs) return Row{-1, 0.f, false};
    const int sel = t / chunks(a);
    return Row{static_cast<long long>(b) * a.nbl * a.bs +
                   static_cast<long long>(sel) * a.bs + j,
               a.dscale != nullptr
                   ? a.dscale[static_cast<size_t>(id) * a.bs + j]
                   : 1.f,
               false};
  }

  __device__ static float term(float m, float, const Row&) { return m; }

  // the raw sum, times the doc's scale once the last pass has added
  __device__ static void emit(const Args& a, int, int, const Row& r, float v,
                              bool first, bool last) {
    float* o = a.out + r.o;
    v = first ? v : *o + v;
    *o = last ? v * r.scale : v;
  }
};

template <typename TR>
int launch_mma(const Args& a, const void* rows, int cols, cudaStream_t s) {
  const long long map_rows = static_cast<long long>(a.NB) * a.S * a.bs;
  switch (cols) {
    case 16:
      return summary_tile::launch<Stage1Op<TR, 16>>(a, rows, map_rows, s);
    case 32:
      return summary_tile::launch<Stage1Op<TR, 32>>(a, rows, map_rows, s);
    case 64:
      return summary_tile::launch<Stage1Op<TR, 64>>(a, rows, map_rows, s);
    case 128:
      return summary_tile::launch<Stage1Op<TR, 128>>(a, rows, map_rows, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface (loaded with ctypes). rows_type: 0 float32 rows with a
// float32 q (the CUDA-core body; dscale must be null), 1 bfloat16 rows, 2
// int8 rows, both with a bfloat16 q (the tensor cores). The plan's ints
// (cols, lqp, G, passes, n_tiles, tiles_per_block) come from
// ops/maxsim.py::summary_plan and are unused by the float32 body. Returns
// the CUDA error code of the launch (0 on success); launches nothing when
// B or n_blocks is 0.
extern "C" int ravqa_stage1_sweep(const void* q, const void* rows,
                                  const void* blk, const void* dscale,
                                  void* out, int B, int Lq, int S, int bs,
                                  int nbl, int NB, int dim, int rows_type,
                                  int cols, int lqp, int G, int passes,
                                  int n_tiles, int tiles_per_block,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || nbl <= 0) return 0;
  if (Lq <= 0 || S <= 0 || bs <= 0 || NB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_type == 0) {
    if (dscale != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_simt(q, rows, blk, out, B, Lq, S, bs, nbl, NB, dim, s);
  }
  if (G != 1 || n_tiles != nbl * ((bs + kRows - 1) / kRows) ||
      dim % (rows_type == 2 ? 16 : 8) ||
      static_cast<long long>(B) * nbl * bs > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.blk = static_cast<const int*>(blk);
  a.dscale = static_cast<const float*>(dscale);
  a.out = static_cast<float*>(out);
  a.B = B, a.Lq = Lq, a.S = S, a.dim = dim;
  a.bs = bs, a.nbl = nbl, a.NB = NB;
  a.lqp = lqp, a.G = G, a.passes = passes, a.n_tiles = n_tiles;
  a.tiles_per_block = tiles_per_block;
  if (rows_type == 1) return launch_mma<__nv_bfloat16>(a, rows, cols, s);
  if (rows_type == 2) return launch_mma<int8_t>(a, rows, cols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
