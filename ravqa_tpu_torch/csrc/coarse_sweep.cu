// Coarse summary sweep on Hopper: float (K2) and int8 (K3) bodies.
//
// Replaces ravqa_tpu/ops/maxsim.py::coarse_sweep_pallas, bodies
// _coarse_sweep_kernel (float) and _coarse_sweep_int8_kernel (int8).
// Scores every query against every doc's S summary vectors, stored
// slot-major (S, N, dim), directly in (B, N) layout:
//
//   float: out[b, n] = sum_t max_s q[b, t] . summ[s, n]
//   int8:  out[b, n] = sum_t qscale[b, t] * (dscale[n] * max_s m(b, t, s, n))
//          m(b, t, s, n) = q8[b, t] . summ8[s, n]  in int32 (__dp4a)
//   both:  out[b, n] = -9999 exactly where valid[n] == 0
//
// The per-doc scale is applied after the int32 max over slots and the
// per-token query scale inside the sum over query tokens, as the TPU
// kernel applies them (its selector matmul carries the query scales).
// The TPU kernel's 0/1 selector matmul for the sum over Lq was Mosaic
// layout work; here each sum is a plain loop over shared memory.
//
// What bounds it on this card: at the two-stage bench shape (B=32, Lq=32,
// N=112,640, S=8, dim=128) each summary byte feeds B*Lq*2/elem_bytes
// operations (1k in bf16, 2k in int8), far above the H100's ridge, so the
// sweep is bound by arithmetic on the CUDA cores (f32 FMA for K2, __dp4a
// for K3: 4 multiply-adds per instruction, exact). The design keeps those
// pipes fed, as the MaxSim kernel (maxsim.cu) does:
//  - one block per (group of whole queries, tile of 128 docs): the group's
//    query tokens, up to 128 columns, are staged once in shared memory
//    and reused by all S slots of the 128 docs;
//  - the tile's slot-s rows are one contiguous (128, dim) slab of the
//    slot-major layout; slabs stream through shared memory with cp.async,
//    double-buffered, so slot s+1 loads while slot s computes;
//  - each thread owns an 8 x 8 micro-tile (sweep_tile.cuh) and keeps the
//    running max over slots in registers: no (N, S, B, Lq) intermediate
//    ever leaves the chip;
//  - blocks of one doc tile are numbered next to each other, so the blocks
//    that read the same summaries run together and share them in L2;
//  - each (query, doc) sum is taken by one thread in a fixed order: results
//    repeat bit for bit, and the int32 maxima are exact.
// Tensor-core versions (wgmma in bf16, int8 mma) are later work.
//
// Inputs, all contiguous: q (B*Lq, dim) float, bfloat16 (the summaries'
// type) or int8 with qscale (B*Lq,) float; summ (S, N, dim) of the same
// type, with dscale (N,) float for int8; valid (N,) int8 or null (all
// valid); out (B, N) float. dim % 8 == 0 (float, bfloat16) or dim % 16 == 0
// (int8), dim <= 128, pointers 16-byte aligned (the Python wrapper checks).

#include <climits>
#include <type_traits>

#include "sweep_tile.cuh"

namespace {

using namespace sweep;

constexpr int kMaxDim = 128;

template <typename TD, bool kInt8>
size_t smem_bytes(int dim) {
  const size_t qs = kInt8 ? sizeof(int) * (dim / 4) * kQsLd
                          : sizeof(float) * dim * kQsLd;
  const size_t ds = sizeof(TD) * 2 * kRows * row_ld<TD>(dim);
  const size_t red = sizeof(float) * kRows * kRedLd;
  return qs + (ds > red ? ds : red);
}

template <typename TQ, typename TD, bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
coarse_sweep_kernel(const TQ* __restrict__ q,
                    const float* __restrict__ qscale,
                    const TD* __restrict__ summ,
                    const float* __restrict__ dscale,
                    const int8_t* __restrict__ valid,
                    float* __restrict__ out, int B, int Lq, int S, int N,
                    int dim, int G) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ float4 smem4[];
  const int ds_ld = row_ld<TD>(dim);
  const int qs_rows = kInt8 ? dim / 4 : dim;
  float* Qs = reinterpret_cast<float*>(smem4);              // [qs_rows][kQsLd]
  int* Qw = reinterpret_cast<int*>(smem4);                  // int8: words
  char* region = reinterpret_cast<char*>(Qs + qs_rows * kQsLd);
  TD* Ds = reinterpret_cast<TD*>(region);                   // [2][kRows][ds_ld]
  float* red = reinterpret_cast<float*>(region);            // [kRows][kRedLd]

  const int n_groups = (B + G - 1) / G;
  const int b0 = (blockIdx.x % n_groups) * G;
  const int g_here = min(G, B - b0);
  const int n0 = (blockIdx.x / n_groups) * kRows;
  const int nr = min(kRows, N - n0);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int cols_total = g_here * Lq;
  const int chunks_per_row = dim * static_cast<int>(sizeof(TD)) / 16;

  // cp.async copies of slot s's rows n0 .. n0 + nr into buffer s & 1
  auto issue = [&](int s) {
    const char* src = reinterpret_cast<const char*>(
        summ + (static_cast<size_t>(s) * N + n0) * dim);
    char* dst = reinterpret_cast<char*>(Ds + (s & 1) * kRows * ds_ld);
    for (int i = tid; i < nr * chunks_per_row; i += kThreads) {
      const int r = i / chunks_per_row, c = i % chunks_per_row;
      cp_async16(dst + (static_cast<size_t>(r) * ds_ld) * sizeof(TD) + c * 16,
                 src + (static_cast<size_t>(r) * dim) * sizeof(TD) + c * 16);
    }
    cp_async_commit();
  };

  for (int c0 = 0; c0 < cols_total; c0 += kCols) {
    const int nc = min(kCols, cols_total - c0);
    const bool last = c0 + kCols >= cols_total;
    __syncthreads();  // the previous chunk's readers of Qs and red are done
    issue(0);
    const size_t qrow0 = static_cast<size_t>(b0) * Lq + c0;
    for (int i = tid; i < kCols * (dim / 4); i += kThreads) {
      const int c = i / (dim / 4), kw = i % (dim / 4);
      if constexpr (kInt8) {
        Qw[kw * kQsLd + c] = c < nc
            ? *reinterpret_cast<const int*>(
                  reinterpret_cast<const int8_t*>(q) + (qrow0 + c) * dim +
                  4 * kw)
            : 0;
      } else {
        const float4 v = c < nc
            ? load4(q + (qrow0 + c) * dim + 4 * kw)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        Qs[(4 * kw + 0) * kQsLd + c] = v.x;
        Qs[(4 * kw + 1) * kQsLd + c] = v.y;
        Qs[(4 * kw + 2) * kQsLd + c] = v.z;
        Qs[(4 * kw + 3) * kQsLd + c] = v.w;
      }
    }

    Acc init;
    if constexpr (kInt8) init = INT_MIN;
    else init = __int_as_float(0xff800000);   // -inf
    Acc m[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) m[i][j] = init;
    for (int s = 0; s < S; ++s) {
      cp_async_wait_all();
      __syncthreads();  // slot s landed; everyone is done with slot s-1
      if (s + 1 < S) issue(s + 1);
      const TD* D = Ds + (s & 1) * kRows * ds_ld;
      Acc acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0;
      // block-uniform: with at most 64 query columns the second half of
      // every thread's columns would only multiply zeros
      if constexpr (kInt8) {
        if (nc > 64)
          tile_product_i8<2>(Qw, reinterpret_cast<const int8_t*>(D), ds_ld,
                             dim, tx, ty, acc);
        else
          tile_product_i8<1>(Qw, reinterpret_cast<const int8_t*>(D), ds_ld,
                             dim, tx, ty, acc);
      } else {
        if (nc > 64)
          tile_product<2>(Qs, D, ds_ld, dim, tx, ty, acc);
        else
          tile_product<1>(Qs, D, ds_ld, dim, tx, ty, acc);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) m[i][j] = max(m[i][j], acc[i][j]);
    }

    __syncthreads();  // every product is done: red may overwrite Ds
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      const float dsc = kInt8 ? (r < nr ? dscale[n0 + r] : 0.f) : 1.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = kInt8 ? static_cast<float>(m[i][j]) * dsc
                              : static_cast<float>(m[i][j]);
        red[r * kRedLd + tile_col(tx, j)] = v;
      }
    }
    __syncthreads();
    // per (doc, query) sums over this chunk's columns; consecutive threads
    // take consecutive docs, so the writes of out coalesce
    for (int p = tid; p < kRows * g_here; p += kThreads) {
      const int r = p % kRows, g = p / kRows;
      if (r >= nr) continue;
      const int lo = max(g * Lq - c0, 0);
      const int hi = min((g + 1) * Lq - c0, nc);
      float total = 0.f;
      for (int c = lo; c < hi; ++c) {
        const float v = red[r * kRedLd + c];
        total += kInt8 ? qscale[qrow0 + c] * v : v;
      }
      const size_t o = static_cast<size_t>(b0 + g) * N + n0 + r;
      if (c0 > 0) total += out[o];   // a query longer than kCols columns
      if (last && valid != nullptr && valid[n0 + r] == 0) total = kNegFill;
      out[o] = total;
    }
  }
}

template <typename TQ, typename TD, bool kInt8>
int launch(const void* q, const void* qscale, const void* summ,
           const void* dscale, const void* valid, void* out, int B, int Lq,
           int S, int N, int dim, cudaStream_t stream) {
  if (dim > kMaxDim || dim % (kInt8 ? 16 : 8) || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<TD, kInt8>(dim);
  auto kernel = coarse_sweep_kernel<TQ, TD, kInt8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // queries per block: as many whole queries as fit in kCols columns
  const int G = Lq >= kCols ? 1 : (kCols / Lq < B ? kCols / Lq : B);
  const long long groups = (B + G - 1) / G;
  const long long tiles = (N + kRows - 1) / kRows;
  const long long blocks = tiles * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const float*>(qscale),
      static_cast<const TD*>(summ), static_cast<const float*>(dscale),
      static_cast<const int8_t*>(valid), static_cast<float*>(out), B, Lq, S,
      N, dim, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the CUDA error code
// of the launch (0 on success) and launches nothing when B or N is 0.
// Float body (K2): q and summ both float32 (bf16 == 0) or both bfloat16.
extern "C" int ravqa_coarse_sweep(const void* q, const void* summ,
                                  const void* valid, void* out, int B,
                                  int Lq, int S, int N, int dim, int bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return 0;
  if (Lq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, nullptr, summ, nullptr, valid, out, B, Lq, S, N, dim, s);
  return launch<float, float, false>(q, nullptr, summ, nullptr, valid, out,
                                     B, Lq, S, N, dim, s);
}

// int8 body (K3): q8 (B*Lq, dim) int8 with qscale (B*Lq,) float, summ8
// (S, N, dim) int8 with dscale (N,) float.
extern "C" int ravqa_coarse_sweep_int8(const void* q8, const void* qscale,
                                       const void* summ8, const void* dscale,
                                       const void* valid, void* out, int B,
                                       int Lq, int S, int N, int dim,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return 0;
  if (Lq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<int8_t, int8_t, true>(q8, qscale, summ8, dscale, valid, out,
                                      B, Lq, S, N, dim, s);
}
