// Building blocks of the CUDA-core candidate-MaxSim kernel on Hopper,
// residual_lut_maxsim.cu (X1). X2/X3 (candidate_maxsim.cu) run on the
// tensor cores instead.
//
// Each query b has C candidates of Ld token rows, laid out one after
// another, (B, C, Ld, ...). A block of 256 threads scores kCands of one
// query's candidates: their C_block x Ld rows go kRows at a time through
// shared memory, and each thread computes an 8 x 4 register tile of
// row x query-token dot products in float32, rows ty + TY i (i < 8) and
// columns 4 tx + j (j < 4). TX threads span the columns and TY = 256 / TX
// the rows; the launch picks TX from Lq, 8 (Lq <= 32: tiles of 256 rows x
// 32 columns), 16 (Lq <= 64: 128 x 64) or 32 (Lq <= 128: 64 x 128), so at
// Lq = 32 no thread multiplies a column past Lq (the sweep kernels' fixed
// 64-column tile wastes half of its products there). Every row's scores
// go to a shared buffer and fold into a running (candidate, query token)
// maximum in shared memory that starts at -inf, so a candidate may span
// tiles (Ld = 220) and a tile may hold several candidates (Ld = 64); each
// candidate's sum over Lq is one thread's loop in a fixed order, so the
// results repeat bit for bit.

#pragma once

#include "sweep_tile.cuh"

namespace cand {

using sweep::kNegFill;
using sweep::kThreads;
using sweep::load4;

constexpr int kCands = 16;        // candidates per block
constexpr int kMaxDim = 128;
constexpr int kMaxLq = 128;
constexpr size_t kMaxSmem = 232448;

template <int TX>
struct Tile {
  static constexpr int TY = kThreads / TX;
  static constexpr int kRows = 8 * TY;       // token rows per tile
  static constexpr int kCols = 4 * TX;       // query-token columns
  static constexpr int kQsLd = kCols + 4;    // Qs[k][c] row stride (floats)
  static constexpr int kRedLd = kCols + 1;   // red[r][c] row stride (floats)
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared memory of one block: the query, transposed, [dim][kQsLd] float;
// the row tile [kRows][ds_ld] (ds_bytes a row), which the scores
// [kRows][kRedLd] float overwrite once the products are done; n_meta
// 4-byte values per row; the running maxima [kCands][Lq] float.
struct Layout {
  size_t qs, region, meta, colmax, total;
};

template <int TX>
__host__ __device__ inline Layout layout(int dim, int Lq, size_t ds_bytes,
                                         int n_meta) {
  using T = Tile<TX>;
  Layout L;
  L.qs = align16(sizeof(float) * dim * T::kQsLd);
  const size_t ds = ds_bytes * T::kRows;
  const size_t red = sizeof(float) * T::kRows * T::kRedLd;
  L.region = align16(ds > red ? ds : red);
  L.meta = align16(sizeof(int) * T::kRows * n_meta);
  L.colmax = align16(sizeof(float) * kCands * Lq);
  L.total = L.qs + L.region + L.meta + L.colmax;
  return L;
}

// Qs[d][c] = q[c][d] for c < Lq, 0 up to kCols; colmax = -inf
template <int TX>
__device__ __forceinline__ void stage_query(float* Qs, float* colmax,
                                            const float* qb, int Lq, int dim,
                                            int tid) {
  using T = Tile<TX>;
  for (int i = tid; i < T::kCols * dim; i += kThreads) {
    const int c = i / dim, d = i % dim;
    Qs[d * T::kQsLd + c] = c < Lq ? qb[c * dim + d] : 0.f;
  }
  const float neg_inf = __int_as_float(0xff800000);
  for (int i = tid; i < kCands * Lq; i += kThreads) colmax[i] = neg_inf;
}

// s[i][j] += sum_k D[ty + TY i][k] * Qs[k][4 tx + j]. All 8 rows, also
// those past the tile's data: their products are computed and never read.
template <int TX>
__device__ __forceinline__ void tile_product(const float* Qs, const float* D,
                                             int ds_ld, int dim, int tx,
                                             int ty, float (&s)[8][4]) {
  using T = Tile<TX>;
  for (int k = 0; k < dim; k += 4) {
    float4 w[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      w[kk] = *reinterpret_cast<const float4*>(Qs + (k + kk) * T::kQsLd +
                                               4 * tx);
    float4 a4[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a4[i] = load4(D + (ty + T::TY * i) * ds_ld + k);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a[4] = {a4[i].x, a4[i].y, a4[i].z, a4[i].w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        s[i][0] = fmaf(a[kk], w[kk].x, s[i][0]);
        s[i][1] = fmaf(a[kk], w[kk].y, s[i][1]);
        s[i][2] = fmaf(a[kk], w[kk].z, s[i][2]);
        s[i][3] = fmaf(a[kk], w[kk].w, s[i][3]);
      }
    }
  }
}

// fold rows [r0, r0 + nr) of the block's rows, scores in red, into the
// running maxima of the candidates they belong to
template <int TX>
__device__ __forceinline__ void fold_max(const float* red, float* colmax,
                                         int r0, int nr, int Ld, int Lq,
                                         int tid) {
  using T = Tile<TX>;
  const int cf = r0 / Ld;
  const int n_cand = (r0 + nr - 1) / Ld - cf + 1;
  for (int p = tid; p < n_cand * Lq; p += kThreads) {
    const int cl = cf + p / Lq, c = p % Lq;
    const int lo = max(cl * Ld, r0) - r0;
    const int hi = min((cl + 1) * Ld, r0 + nr) - r0;
    float m = colmax[cl * Lq + c];
    for (int r = lo; r < hi; ++r) m = fmaxf(m, red[r * T::kRedLd + c]);
    colmax[cl * Lq + c] = m;
  }
}

// out[cl] = sum over query tokens of candidate cl's maxima, in order
__device__ __forceinline__ void write_sums(const float* colmax, float* out,
                                           int ct, int Lq, int tid) {
  for (int cl = tid; cl < ct; cl += kThreads) {
    float total = 0.f;
    for (int c = 0; c < Lq; ++c) total += colmax[cl * Lq + c];
    out[cl] = total;
  }
}

}  // namespace cand
