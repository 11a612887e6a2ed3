// Register-tiled building blocks of the CUDA-core summary sweeps on Hopper:
// K2's float body (coarse_sweep.cu) and K4's float32 rows
// (stage1_sweep.cu). K3 and K4's bf16 and int8 rows run on the tensor
// cores (summary_tile.cuh).
//
// A block of 256 threads (16 x 16) computes a 128-row x 128-column tile of
// dot products: rows are summary vectors staged in shared memory (one row
// per doc and slot), columns are query tokens staged transposed in shared
// memory. Each thread owns an 8 x 8 micro-tile: rows ty + 16 i, columns
// 4 tx + j and 64 + 4 tx + j (H = 2), or only the first four columns when a
// tile has at most 64 query columns (H = 1). The stage-2 candidate sweep
// (candidate_tile.cuh) streams doc tokens through the same scheme.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sweep {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kRows = 128;         // summary rows per tile
constexpr int kCols = 128;         // query-token columns per tile
constexpr int kQsLd = kCols + 4;   // Qs[k][c] row stride (elements)
constexpr int kRedLd = kCols + 1;  // red[r][c] row stride (floats)
constexpr float kNegFill = -9999.0f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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

// shared-memory row stride of staged summary rows, in elements: 16 bytes
// of padding keeps rows 16-byte aligned and spreads them over the banks
template <typename TD>
__host__ __device__ constexpr int row_ld(int dim) {
  return dim + 16 / static_cast<int>(sizeof(TD));
}

// s[i][4h + j] += sum_k D[ty + 16 i][k] * Qs[k][64 h + 4 tx + j], h < H,
// float products (float or bfloat16 rows). All 8 rows, also those past the
// data's end: their products are computed and never read, so the loads run
// ahead of the FMAs without branches.
template <int H, typename TD>
__device__ __forceinline__ void tile_product(const float* Qs, const TD* D,
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

// the thread's column j of its micro-tile
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j / 4) * 64 + tx * 4 + (j % 4);
}

}  // namespace sweep
