// Exhaustive int8 late-interaction (MaxSim) search on Hopper (K5).
//
// Replaces ravqa_tpu/ops/quant.py::maxsim_search_int8_pallas (body
// _maxsim_int8_kernel). Queries and index are int8 with float32 scales,
// per query token and per doc token. Computes, directly in (B, N) layout,
//
//   out[b, n] = sum_t qscale[b, t] * max_l s(b, t, n, l)
//   s(b, t, n, l) = (q8[b, t] . tok8[n, l]) * dscale[n, l]  if dscale > 0
//                 = -9999                                   otherwise
//
// The dot products are int32 (__dp4a), exact before scaling. A doc-token
// scale of 0 marks an invalid token (quantize_index_int8 zeroes the scales
// of masked tokens), as in the TPU kernel; no mask is read. The running
// max over Ld starts at -inf (never 0), so an all-negative query token
// keeps its negative maximum, and a doc with no valid token scores
// -9999 * sum_t qscale[b, t]. The query-token scale multiplies each
// maximum inside the sum over Lq, where the TPU kernel applies it before
// its selector matmul.
//
// What bounds it on this card: every index byte feeds B*Lq*2 operations
// (2k at B=32, Lq=32), far above the H100's ridge, so the kernel is bound
// by the CUDA cores' __dp4a rate (4 multiply-adds per instruction). The
// design is the MaxSim kernel's (maxsim.cu) with int8 rows:
//  - one block per (group of whole queries, tile of 8 docs): the group's
//    query tokens, up to 128 columns, are staged once in shared memory as
//    4-byte words (transposed: a thread reads 4 columns as one int4);
//  - each doc's tokens stream through shared memory 16 * NI rows at a time
//    with cp.async, double-buffered; NI = 4 (64 rows) when Ld <= 64, so the
//    1M index's 64-token docs waste no rows, else NI = 8 (128 rows);
//  - each thread owns an NI x 8 micro-tile of int32 sums and keeps the
//    running max over the doc's rows in registers; rows past the doc's end
//    are multiplied too and never enter the max;
//  - blocks of one doc tile are numbered next to each other, so the blocks
//    that read the same rows run together and share them in L2;
//  - each (query, doc) sum is taken by one thread in a fixed order:
//    results repeat bit for bit.
// The TPU kernel's rule N % tile_d == 0 does not apply: any N works. An
// int8 tensor-core version (mma.sync s8) is later work.
//
// Inputs, all contiguous: q8 (B, Lq, dim) int8, qscale (B, Lq) float,
// tok8 (N, Ld, dim) int8, dscale (N, Ld) float, out (B, N) float.
// dim % 16 == 0, dim <= 128, pointers 16-byte aligned (the Python wrapper
// checks).

#include "sweep_tile.cuh"

namespace {

using namespace sweep;

constexpr int kDocsPerBlock = 8;
constexpr int kMaxDim = 128;

template <int NI>
size_t smem_bytes(int dim) {
  return sizeof(int) * (dim / 4) * kQsLd                  // Qw
         + sizeof(float) * (16 * kCols                    // red
                            + kCols                       // colmax
                            + kDocsPerBlock * kCols)      // acc
         + 2 * static_cast<size_t>(16 * NI) * row_ld<int8_t>(dim);  // Ds x 2
}

// s[i][4h + j] += sum_k D[ty + 16 i][k] * q[64 h + 4 tx + j][k] for i < NI,
// h < H, exactly in int32. Qw[kw][c] holds word kw (dims 4 kw .. 4 kw + 3)
// of query column c.
template <int NI, int H>
__device__ __forceinline__ void tile_product_i8(const int* Qw,
                                                const int8_t* D, int ds_ld,
                                                int dim, int tx, int ty,
                                                int (&s)[NI][8]) {
  for (int k = 0; k < dim; k += 16) {
    int4 w[4][H];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < H; ++h)
        w[kk][h] = *reinterpret_cast<const int4*>(
            Qw + (k / 4 + kk) * kQsLd + 64 * h + tx * 4);
    int4 a4[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      a4[i] = *reinterpret_cast<const int4*>(D + (ty + 16 * i) * ds_ld + k);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int a[4] = {a4[i].x, a4[i].y, a4[i].z, a4[i].w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          s[i][4 * h + 0] = __dp4a(a[kk], w[kk][h].x, s[i][4 * h + 0]);
          s[i][4 * h + 1] = __dp4a(a[kk], w[kk][h].y, s[i][4 * h + 1]);
          s[i][4 * h + 2] = __dp4a(a[kk], w[kk][h].z, s[i][4 * h + 2]);
          s[i][4 * h + 3] = __dp4a(a[kk], w[kk][h].w, s[i][4 * h + 3]);
        }
      }
    }
  }
}

template <int NI>
__global__ void __launch_bounds__(kThreads, 1)
maxsim_int8_kernel(const int8_t* __restrict__ q8,
                   const float* __restrict__ qscale,
                   const int8_t* __restrict__ tok,
                   const float* __restrict__ dscale,
                   float* __restrict__ out, int B, int Lq, int N, int Ld,
                   int dim, int G) {
  constexpr int kR = 16 * NI;                       // rows per tile
  extern __shared__ float4 smem4[];
  const int ds_ld = row_ld<int8_t>(dim);
  int* Qw = reinterpret_cast<int*>(smem4);          // [dim / 4][kQsLd]
  float* red = reinterpret_cast<float*>(Qw + (dim / 4) * kQsLd);  // [16][kCols]
  float* colmax = red + 16 * kCols;                 // [kCols]
  float* acc = colmax + kCols;                      // [kDocsPerBlock][G]
  int8_t* Ds = reinterpret_cast<int8_t*>(acc + kDocsPerBlock * kCols);  // [2][kR][ds_ld]

  const int n_groups = (B + G - 1) / G;
  const int b0 = (blockIdx.x % n_groups) * G;
  const int g_here = min(G, B - b0);
  const int n0 = (blockIdx.x / n_groups) * kDocsPerBlock;
  const int n_docs = min(kDocsPerBlock, N - n0);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int steps = (Ld + kR - 1) / kR;
  const int n_tiles = n_docs * steps;
  const int cols_total = g_here * Lq;      // this block's query columns
  const int chunks_per_row = dim / 16;
  const float neg_inf = __int_as_float(0xff800000);

  for (int i = tid; i < kDocsPerBlock * G; i += kThreads) acc[i] = 0.f;

  // issue the cp.async copies of tile t (doc t / steps, row step t % steps)
  auto issue = [&](int t) {
    const int d = t / steps, r0 = (t % steps) * kR;
    const int nr = min(kR, Ld - r0);
    const int8_t* src = tok + (static_cast<size_t>(n0 + d) * Ld + r0) * dim;
    int8_t* dst = Ds + (t & 1) * kR * ds_ld;
    for (int i = tid; i < nr * chunks_per_row; i += kThreads) {
      const int r = i / chunks_per_row, c = i % chunks_per_row;
      cp_async16(dst + static_cast<size_t>(r) * ds_ld + c * 16,
                 src + static_cast<size_t>(r) * dim + c * 16);
    }
    cp_async_commit();
  };

  for (int c0 = 0; c0 < cols_total; c0 += kCols) {
    const int nc = min(kCols, cols_total - c0);
    const size_t qrow0 = static_cast<size_t>(b0) * Lq + c0;
    __syncthreads();  // previous chunk's readers of Qw and Ds are done
    issue(0);
    for (int i = tid; i < kCols * (dim / 4); i += kThreads) {
      const int c = i / (dim / 4), kw = i % (dim / 4);
      Qw[kw * kQsLd + c] = c < nc
          ? *reinterpret_cast<const int*>(q8 + (qrow0 + c) * dim + 4 * kw)
          : 0;
    }

    float m[8];
    for (int t = 0; t < n_tiles; ++t) {
      const int d = t / steps, step = t % steps;
      const int r0 = step * kR;
      const int nr = min(kR, Ld - r0);
      if (step == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) m[j] = neg_inf;
      }
      cp_async_wait_all();
      __syncthreads();  // tile t landed; everyone is done with tile t-1
      if (t + 1 < n_tiles) issue(t + 1);

      // this thread's rows: ty + 16 i for i < n_i
      const int n_i = (nr - ty + 15) / 16;
      const float* dsrow = dscale + static_cast<size_t>(n0 + d) * Ld + r0;
      float dsc[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) dsc[i] = i < n_i ? dsrow[ty + 16 * i] : 0.f;

      const int8_t* D = Ds + (t & 1) * kR * ds_ld;
      int s[NI][8];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0;
      // a block-uniform choice: with at most 64 query columns the second
      // half of every thread's columns would only multiply zeros
      if (nc > 64) {
        tile_product_i8<NI, 2>(Qw, D, ds_ld, dim, tx, ty, s);
      } else {
        tile_product_i8<NI, 1>(Qw, D, ds_ld, dim, tx, ty, s);
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        if (i < n_i) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            m[j] = fmaxf(m[j], dsc[i] > 0.f
                                   ? static_cast<float>(s[i][j]) * dsc[i]
                                   : kNegFill);
        }
      }

      if (step == steps - 1) {
        // max over the 16 row groups, then per-query sums of the columns,
        // each maximum times its query token's scale
#pragma unroll
        for (int j = 0; j < 8; ++j) red[ty * kCols + tile_col(tx, j)] = m[j];
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
          for (int c = lo; c < hi; ++c) total += qscale[qrow0 + c] * colmax[c];
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

template <int NI>
int launch(const void* q8, const void* qscale, const void* tok,
           const void* dscale, void* out, int B, int Lq, int N, int Ld,
           int dim, cudaStream_t stream) {
  const size_t smem = smem_bytes<NI>(dim);
  auto kernel = maxsim_int8_kernel<NI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // queries per block: as many whole queries as fit in kCols columns
  const int G = Lq >= kCols ? 1 : (kCols / Lq < B ? kCols / Lq : B);
  const long long groups = (B + G - 1) / G;
  const long long tiles = (N + kDocsPerBlock - 1) / kDocsPerBlock;
  const long long blocks = tiles * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const float*>(qscale),
      static_cast<const int8_t*>(tok), static_cast<const float*>(dscale),
      static_cast<float*>(out), B, Lq, N, Ld, dim, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Returns the CUDA error code of
// the launch (0 on success); launches nothing when B or N is 0.
extern "C" int ravqa_maxsim_search_int8(const void* q8, const void* qscale,
                                        const void* tok8, const void* dscale,
                                        void* out, int B, int Lq, int N,
                                        int Ld, int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return 0;
  if (Lq <= 0 || Ld <= 0 || dim % 16 || dim > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Ld <= 64)
    return launch<4>(q8, qscale, tok8, dscale, out, B, Lq, N, Ld, dim, s);
  return launch<8>(q8, qscale, tok8, dscale, out, B, Lq, N, Ld, dim, s);
}
