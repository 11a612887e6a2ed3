// Gathered stage-1 sweep of hierarchical search on Hopper (K4).
//
// Replaces ravqa_tpu/ops/maxsim.py::stage1_sweep_pallas (body
// _stage1_sweep_kernel, with the scalar-prefetch PrefetchScalarGridSpec
// that DMAs each query's selected blocks). Each query b scores the doc
// summaries of its OWN selected blocks blk[b, :], in gathered order:
//
//   out[b, t * bs + j] = sum_c max_s q[b, c] . rows[blk[b, t], s, j]
//
// rows is the stage1_rows layout (NB, S, bs, dim): each block's slot-s
// summaries are one contiguous (bs, dim) tile. The scores are raw: the
// caller applies per-doc scales and doc validity, as the TPU path does.
// int8 rows are upcast to float exactly; products accumulate in float32.
//
// What bounds it on this card: every query reads its own n_blocks * S * bs
// summary rows (at the bench shape, B=32, n_blocks=32, S=8, bs=64, dim=128:
// 67 MB in int8, 134 MB in bf16), each byte feeding Lq * 2 / elem_bytes
// operations (32 in bf16, 64 in int8): close to the balance of the CUDA
// cores' f32 rate and the memory, so both the loads and the FMAs matter.
// The design:
//  - one block per (query, tile of 128 gathered docs); the block reads its
//    own block ids (the TPU kernel's scalar prefetch) and computes each
//    row's source offset once, in shared memory;
//  - only the selected rows are read, straight into shared memory with
//    cp.async, one slot at a time and double-buffered, so no gathered copy
//    and no (B, n_blocks, bs, S, Lq) intermediate is written;
//  - the query's tokens are staged once; each thread owns an 8 x 8 (or,
//    with at most 64 query tokens, 8 x 4) micro-tile and keeps the running
//    max over slots in registers (sweep_tile.cuh);
//  - each score is summed by one thread in a fixed order: results repeat
//    bit for bit.
// The TPU kernel's lane rule (n_blocks a multiple of 128 / gcd(bs, 128))
// does not apply: any n_blocks and bs work. At Lq = 32 half of the 8 x 4
// micro-tile multiplies zero columns; a narrower tile is later work.
//
// Inputs, all contiguous: q (B, Lq, dim) bfloat16 (bf16 or int8 rows) or
// float32 (float32 rows); rows (NB, S, bs, dim); blk (B, n_blocks) int32,
// each in [0, NB) (values outside are clamped); out (B, n_blocks * bs)
// float32. dim % 8 == 0 (dim % 16 == 0 for int8 rows), dim <= 128,
// pointers 16-byte aligned (the Python wrapper checks).

#include "sweep_tile.cuh"

namespace {

using namespace sweep;

constexpr int kMaxDim = 128;

template <typename TD>
size_t smem_bytes(int dim) {
  const size_t qs = sizeof(float) * dim * kQsLd;
  const size_t ds = sizeof(TD) * 2 * kRows * row_ld<TD>(dim);
  const size_t red = sizeof(float) * kRows * kRedLd;
  return qs + (ds > red ? ds : red) + sizeof(long long) * kRows;
}

template <typename TQ, typename TD>
__global__ void __launch_bounds__(kThreads, 1)
stage1_sweep_kernel(const TQ* __restrict__ q, const TD* __restrict__ rows,
                    const int* __restrict__ blk, float* __restrict__ out,
                    int Lq, int S, int bs, int nbl, int NB, int dim) {
  extern __shared__ float4 smem4[];
  const int ds_ld = row_ld<TD>(dim);
  float* Qs = reinterpret_cast<float*>(smem4);             // [dim][kQsLd]
  char* region = reinterpret_cast<char*>(Qs + dim * kQsLd);
  TD* Ds = reinterpret_cast<TD*>(region);                  // [2][kRows][ds_ld]
  float* red = reinterpret_cast<float*>(region);           // [kRows][kRedLd]
  const size_t ds_bytes = sizeof(TD) * 2 * kRows * ds_ld;
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
  const int chunks_per_row = dim * static_cast<int>(sizeof(TD)) / 16;

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
      const TD* src = rows + (rowoff[r] + static_cast<long long>(s) * bs) * dim;
      cp_async16(dst + (static_cast<size_t>(r) * ds_ld) * sizeof(TD) + c * 16,
                 reinterpret_cast<const char*>(src) + c * 16);
    }
    cp_async_commit();
  };

  const TQ* qb = q + static_cast<size_t>(b) * Lq * dim;
  for (int c0 = 0; c0 < Lq; c0 += kCols) {
    const int nc = min(kCols, Lq - c0);
    __syncthreads();  // the previous chunk's readers of Qs and red are done
    issue(0);
    for (int i = tid; i < kCols * (dim / 4); i += kThreads) {
      const int c = i / (dim / 4), k = (i % (dim / 4)) * 4;
      const float4 v = c < nc ? load4(qb + static_cast<size_t>(c0 + c) * dim + k)
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
      const TD* D = Ds + (s & 1) * kRows * ds_ld;
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

template <typename TQ, typename TD>
int launch(const void* q, const void* rows, const void* blk, void* out,
           int B, int Lq, int S, int bs, int nbl, int NB, int dim,
           cudaStream_t stream) {
  if (dim > kMaxDim || dim % (sizeof(TD) == 1 ? 16 : 8) || S <= 0 ||
      bs <= 0 || NB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<TD>(dim);
  auto kernel = stage1_sweep_kernel<TQ, TD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      (static_cast<long long>(nbl) * bs + kRows - 1) / kRows;
  const long long blocks = tiles * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TD*>(rows),
      static_cast<const int*>(blk), static_cast<float*>(out), Lq, S, bs, nbl,
      NB, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). rows_type: 0 float32 rows with a
// float32 q, 1 bfloat16 rows with a bfloat16 q, 2 int8 rows with a
// bfloat16 q. Returns the CUDA error code of the launch (0 on success);
// launches nothing when B or n_blocks is 0.
extern "C" int ravqa_stage1_sweep(const void* q, const void* rows,
                                  const void* blk, void* out, int B, int Lq,
                                  int S, int bs, int nbl, int NB, int dim,
                                  int rows_type, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || nbl <= 0) return 0;
  if (Lq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (rows_type) {
    case 0:
      return launch<float, float>(q, rows, blk, out, B, Lq, S, bs, nbl, NB,
                                  dim, s);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(q, rows, blk, out, B, Lq,
                                                  S, bs, nbl, NB, dim, s);
    case 2:
      return launch<__nv_bfloat16, int8_t>(q, rows, blk, out, B, Lq, S, bs,
                                           nbl, NB, dim, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
