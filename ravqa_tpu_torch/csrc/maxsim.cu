// Exhaustive late-interaction (MaxSim) search over a float32 index on
// Hopper's CUDA cores (K1, float32 route).
//
// Replaces ravqa_tpu/ops/maxsim.py::maxsim_search_pallas (body
// _maxsim_kernel) for a float32 query and index; a bfloat16 index takes the
// tensor-core kernel of maxsim_mma.cu. Computes, directly in (B, N) layout,
//
//   out[b, n] = sum_q max_l s(b, q, n, l)
//   s(b, q, n, l) = q[b, q, :] . tok[n, l, :]   if mask[n, l] != 0
//                 = -9999                         otherwise
//
// so a doc whose tokens are all masked scores -9999 * Lq, exactly as the
// reference fills padded doc tokens before the max. The running max starts
// at -inf (never 0): an all-negative query token keeps its negative maximum.
//
// What bounds it on this card: at the serve shape (B=32, Lq=64, dim=128)
// every index byte feeds B*Lq/2 FLOPs (1k), far above the H100's ridge of
// about 295 FLOP/byte. The kernel is bound by compute, not bytes, and
// computes in f32 on the CUDA cores (the f32 index must keep f32 products:
// TF32 tensor cores would move scores past the 1e-3 serve checks). The
// design keeps the FMA pipes fed:
//  - one block per (group of queries, tile of 8 docs): the group's query
//    tokens, up to 128 columns, are staged once in shared memory
//    (transposed: a thread reads 4 columns as one float4);
//  - doc tokens stream through shared memory 128 rows at a time with
//    cp.async, double-buffered, so the next rows load while these compute
//    (at dim 128 in f32 the block takes 215 KB: one block per SM);
//  - each thread owns an 8 x 8 micro-tile (rows ty+16i, columns tx*4+j and
//    64+tx*4+j): 16 FMAs per 16-byte shared load, conflict-free; with at
//    most 64 query columns a block-uniform branch runs the 8 x 4 half;
//  - the inner loop has no branches: rows past a doc's end are multiplied
//    too, and their products never enter the max;
//  - blocks of one doc tile are numbered next to each other, so the blocks
//    that read the same doc rows run together and share them in L2.
//
// Inputs: q (B, Lq, dim) and tok (N, Ld, dim) f32; mask (N, Ld) int8;
// out (B, N) f32. All contiguous, dim % 8 == 0, dim <= 128,
// q and tok 16-byte aligned (checked by the Python wrapper). Sums are taken
// in f32 in a fixed order, so results repeat bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 8 outputs each
constexpr int kRows = 128;         // doc-token rows per step
constexpr int kCols = 128;         // query-token columns per step
constexpr int kDocsPerBlock = 8;
constexpr int kMaxDim = 128;
constexpr int kQsLd = kCols + 4;   // Qs[k][c] row stride (floats)
constexpr int kDsPad = 4;          // Ds row padding (floats): 16 bytes
constexpr float kNegFill = -9999.0f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

size_t smem_bytes(int dim) {
  const size_t ds_ld = dim + kDsPad;
  return sizeof(float) * (static_cast<size_t>(dim) * kQsLd  // Qs
                          + 16 * kCols                      // red
                          + kCols                           // colmax
                          + kDocsPerBlock * kCols           // acc
                          + 2 * kRows * ds_ld);             // Ds x 2
}

// s[i][4h + j] += sum_k D[ty + 16 i][k] * Qs[k][64 h + 4 tx + j] for h < H.
// All 8 rows, also those past the doc's end (their products are never
// read): the loads stay ahead of the FMAs without branches.
template <int H>
__device__ __forceinline__ void tile_product(const float* Qs, const float* D,
                                             int ds_ld, int dim, int tx,
                                             int ty, float (&s)[8][8]) {
  for (int k = 0; k < dim; k += 4) {
    float4 w[4][H];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < H; ++h)
        w[kk][h] = *reinterpret_cast<const float4*>(
            Qs + (k + kk) * kQsLd + 64 * h + tx * 4);
    float4 a4[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a4[i] = load4(D + (ty + 16 * i) * ds_ld + k);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a[4] = {a4[i].x, a4[i].y, a4[i].z, a4[i].w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          s[i][4 * h + 0] = fmaf(a[kk], w[kk][h].x, s[i][4 * h + 0]);
          s[i][4 * h + 1] = fmaf(a[kk], w[kk][h].y, s[i][4 * h + 1]);
          s[i][4 * h + 2] = fmaf(a[kk], w[kk][h].z, s[i][4 * h + 2]);
          s[i][4 * h + 3] = fmaf(a[kk], w[kk][h].w, s[i][4 * h + 3]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
maxsim_kernel(const float* __restrict__ q, const float* __restrict__ tok,
              const int8_t* __restrict__ mask, float* __restrict__ out,
              int B, int Lq, int N, int Ld, int dim, int G) {
  extern __shared__ float4 smem4[];
  const int ds_ld = dim + kDsPad;
  float* Qs = reinterpret_cast<float*>(smem4);      // [dim][kQsLd]
  float* red = Qs + dim * kQsLd;                    // [16][kCols]
  float* colmax = red + 16 * kCols;                 // [kCols]
  float* acc = colmax + kCols;                      // [kDocsPerBlock][G]
  // [2][kRows][ds_ld]
  float* Ds = acc + kDocsPerBlock * kCols;

  const int n_groups = (B + G - 1) / G;
  const int b0 = (blockIdx.x % n_groups) * G;
  const int g_here = min(G, B - b0);
  const int n0 = (blockIdx.x / n_groups) * kDocsPerBlock;
  const int n_docs = min(kDocsPerBlock, N - n0);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int steps = (Ld + kRows - 1) / kRows;
  const int n_tiles = n_docs * steps;
  const int cols_total = g_here * Lq;      // this block's query columns
  const int chunks_per_row = dim / 4;
  const float neg_inf = __int_as_float(0xff800000);

  for (int i = tid; i < kDocsPerBlock * G; i += kThreads) acc[i] = 0.f;

  // issue the cp.async copies of tile t (doc t / steps, row step t % steps)
  auto issue = [&](int t) {
    const int d = t / steps, r0 = (t % steps) * kRows;
    const int nr = min(kRows, Ld - r0);
    const char* src = reinterpret_cast<const char*>(
        tok + (static_cast<size_t>(n0 + d) * Ld + r0) * dim);
    char* dst = reinterpret_cast<char*>(Ds + (t & 1) * kRows * ds_ld);
    for (int i = tid; i < nr * chunks_per_row; i += kThreads) {
      const int r = i / chunks_per_row, c = i % chunks_per_row;
      cp_async16(dst + (static_cast<size_t>(r) * ds_ld) * sizeof(float) +
                     c * 16,
                 src + (static_cast<size_t>(r) * dim) * sizeof(float) +
                     c * 16);
    }
    cp_async_commit();
  };

  for (int c0 = 0; c0 < cols_total; c0 += kCols) {
    const int nc = min(kCols, cols_total - c0);
    __syncthreads();  // previous chunk's readers of Qs and Ds are done
    issue(0);
    for (int i = tid; i < kCols * (dim / 4); i += kThreads) {
      const int c = i / (dim / 4), k = (i % (dim / 4)) * 4;
      const float4 v = c < nc
          ? load4(q + (static_cast<size_t>(b0) * Lq + c0 + c) * dim + k)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      Qs[(k + 0) * kQsLd + c] = v.x;
      Qs[(k + 1) * kQsLd + c] = v.y;
      Qs[(k + 2) * kQsLd + c] = v.z;
      Qs[(k + 3) * kQsLd + c] = v.w;
    }

    float m[8];
    for (int t = 0; t < n_tiles; ++t) {
      const int d = t / steps, step = t % steps;
      const int r0 = step * kRows;
      const int nr = min(kRows, Ld - r0);
      if (step == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) m[j] = neg_inf;
      }
      cp_async_wait_all();
      __syncthreads();  // tile t landed; everyone is done with tile t-1
      if (t + 1 < n_tiles) issue(t + 1);

      // this thread's rows: ty + 16 i for i < n_i
      const int n_i = (nr - ty + 15) / 16;
      const int8_t* mrow = mask + static_cast<size_t>(n0 + d) * Ld + r0;
      int valid[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        valid[i] = i < n_i ? (mrow[ty + 16 * i] != 0) : 0;

      const float* D = Ds + (t & 1) * kRows * ds_ld;
      float s[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;

      // a block-uniform choice: with at most 64 query columns the second
      // half of every thread's columns would only multiply zeros
      if (nc > 64) {
        tile_product<2>(Qs, D, ds_ld, dim, tx, ty, s);
      } else {
        tile_product<1>(Qs, D, ds_ld, dim, tx, ty, s);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < n_i) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            m[j] = fmaxf(m[j], valid[i] ? s[i][j] : kNegFill);
        }
      }

      if (step == steps - 1) {
        // max over the 16 row groups, then per-query sums of the columns
#pragma unroll
        for (int j = 0; j < 8; ++j)
          red[ty * kCols + (j / 4) * 64 + tx * 4 + (j % 4)] = m[j];
        __syncthreads();
        if (tid < kCols) {
          float v = neg_inf;
#pragma unroll
          for (int r = 0; r < 16; ++r) v = fmaxf(v, red[r * kCols + tid]);
          colmax[tid] = v;
        }
        __syncthreads();
        if (tid < G) {
          const int lo = max(tid * Lq - c0, 0);
          const int hi = min((tid + 1) * Lq - c0, nc);
          float total = 0.f;
          for (int c = lo; c < hi; ++c) total += colmax[c];
          acc[d * G + tid] += total;
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n_docs * g_here; i += kThreads) {
    const int d = i / g_here, g = i % g_here;
    out[static_cast<size_t>(b0 + g) * N + n0 + d] = acc[d * G + g];
  }
}

int launch(const void* q, const void* tok, const void* mask, void* out,
           int B, int Lq, int N, int Ld, int dim, cudaStream_t stream) {
  if (dim % 8 || dim > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(dim);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // queries per block: as many whole queries as fit in kCols columns
  const int G = Lq >= kCols ? 1 : (kCols / Lq < B ? kCols / Lq : B);
  const long long groups = (B + G - 1) / G;
  const long long tiles = (N + kDocsPerBlock - 1) / kDocsPerBlock;
  const long long blocks = tiles * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  maxsim_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(tok),
      static_cast<const int8_t*>(mask), static_cast<float*>(out), B, Lq, N,
      Ld, dim, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes), float32 q and tok. Returns the
// CUDA error code of the launch (0 on success); launches nothing when B or
// N is 0, and writes zeros when Lq is 0.
extern "C" int ravqa_maxsim_search(const void* q, const void* tok,
                                   const void* mask, void* out, int B,
                                   int Lq, int N, int Ld, int dim,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return 0;
  if (Lq <= 0) {
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(B) * N, s));
  }
  if (Ld <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, tok, mask, out, B, Lq, N, Ld, dim, s);
}
