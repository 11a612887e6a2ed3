// Coarse summary sweep on Hopper: float32 and bf16 (K2) and int8 (K3)
// bodies.
//
// Replaces ravqa_tpu/ops/maxsim.py::coarse_sweep_pallas, bodies
// _coarse_sweep_kernel (float) and _coarse_sweep_int8_kernel (int8).
// Scores every query against every doc's S summary vectors, stored
// slot-major (S, N, dim), directly in (B, N) layout:
//
//   float: out[b, n] = sum_t max_s q[b, t] . summ[s, n]
//   int8:  out[b, n] = sum_t qscale[b, t] * (dscale[n] * max_s m(b, t, s, n))
//          m(b, t, s, n) = q8[b, t] . summ8[s, n]  in int32
//   both:  out[b, n] = -9999 exactly where valid[n] == 0
//
// The per-doc scale is applied after the int32 max over slots and the
// per-token query scale inside the sum over query tokens, as the TPU
// kernel applies them (its selector matmul carries the query scales).
// The TPU kernel's 0/1 selector matmul for the sum over Lq was Mosaic
// layout work; here each sum runs over registers and two shuffles.
//
// What bounds it on this card: at the two-stage bench shape (B=32, Lq=32,
// N=112,640, S=8, dim=128) each summary byte feeds B*Lq*2/elem_bytes
// operations (1k in bf16, 2k in int8), far above the H100's ridge, so the
// sweep is bound by arithmetic.
//
// K2 on bf16 summaries (the only kind the searcher makes) and K3 run on
// the tensor cores (summary_tile.cuh): a tile's 64 docs of slot s are the
// MMA's rows (one TMA box of the slot-major layout) and a group of whole
// queries' tokens, 128 columns, its columns, both read from shared memory.
// K2 multiplies bf16 x bf16 -> f32 (wgmma m64n128k16, 8 k-steps at dim
// 128), exact products summed in float32, and keeps the float max over
// slots in the accumulators; its epilogue has no scales. K3 multiplies
// s8 x s8 -> s32 (m64n128k32), exact; the int32 max over slots is an
// elementwise max of the accumulators, the doc scale multiplies each
// row's maximum as a float, the query scale each column, inside the sum
// over the query's columns.
//
// K2's float32 body stays on the CUDA cores (sweep_tile.cuh): f32 FMAs on
// 8 x 8 register tiles, one block per (group of whole queries, up to 128
// columns; tile of 128 docs), slot slabs double-buffered with cp.async,
// the running max over slots in registers; each (query, doc) sum by one
// thread in a fixed order.
//
// Inputs, all contiguous: q (B*Lq, dim) float32 or bfloat16 (the
// summaries' type), or int8 with qscale (B*Lq,) float; summ (S, N, dim) of
// the same type, with dscale (N,) float for int8; valid (N,) int8 or null
// (all valid); out (B, N) float. dim % 8 == 0 (float32, bfloat16) or
// dim % 16 == 0 (int8), dim <= 128, pointers 16-byte aligned (the Python
// wrapper checks).

#include "summary_tile.cuh"
#include "sweep_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// K2: the float32 body on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kMaxDim = 128;

size_t smem_bytes(int dim) {
  const size_t qs = sizeof(float) * dim * sweep::kQsLd;
  const size_t ds = sizeof(float) * 2 * sweep::kRows * sweep::row_ld(dim);
  const size_t red = sizeof(float) * sweep::kRows * sweep::kRedLd;
  return qs + (ds > red ? ds : red);
}

__global__ void __launch_bounds__(sweep::kThreads, 1)
coarse_sweep_kernel(const float* __restrict__ q,
                    const float* __restrict__ summ,
                    const int8_t* __restrict__ valid,
                    float* __restrict__ out, int B, int Lq, int S, int N,
                    int dim, int G) {
  using namespace sweep;
  extern __shared__ float4 smem4[];
  const int ds_ld = row_ld(dim);
  float* Qs = reinterpret_cast<float*>(smem4);              // [dim][kQsLd]
  char* region = reinterpret_cast<char*>(Qs + dim * kQsLd);
  float* Ds = reinterpret_cast<float*>(region);         // [2][kRows][ds_ld]
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
  const int chunks_per_row = dim * static_cast<int>(sizeof(float)) / 16;

  // cp.async copies of slot s's rows n0 .. n0 + nr into buffer s & 1
  auto issue = [&](int s) {
    const char* src = reinterpret_cast<const char*>(
        summ + (static_cast<size_t>(s) * N + n0) * dim);
    char* dst = reinterpret_cast<char*>(Ds + (s & 1) * kRows * ds_ld);
    for (int i = tid; i < nr * chunks_per_row; i += kThreads) {
      const int r = i / chunks_per_row, c = i % chunks_per_row;
      cp_async16(dst + (static_cast<size_t>(r) * ds_ld + 4 * c) * 4,
                 src + (static_cast<size_t>(r) * dim + 4 * c) * 4);
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
      const float4 v = c < nc
          ? load4(q + (qrow0 + c) * dim + 4 * kw)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      Qs[(4 * kw + 0) * kQsLd + c] = v.x;
      Qs[(4 * kw + 1) * kQsLd + c] = v.y;
      Qs[(4 * kw + 2) * kQsLd + c] = v.z;
      Qs[(4 * kw + 3) * kQsLd + c] = v.w;
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
      // block-uniform: with at most 64 query columns the second half of
      // every thread's columns would only multiply zeros
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
    // per (doc, query) sums over this chunk's columns; consecutive threads
    // take consecutive docs, so the writes of out coalesce
    for (int p = tid; p < kRows * g_here; p += kThreads) {
      const int r = p % kRows, g = p / kRows;
      if (r >= nr) continue;
      const int lo = max(g * Lq - c0, 0);
      const int hi = min((g + 1) * Lq - c0, nc);
      float total = 0.f;
      for (int c = lo; c < hi; ++c) total += red[r * kRedLd + c];
      const size_t o = static_cast<size_t>(b0 + g) * N + n0 + r;
      if (c0 > 0) total += out[o];   // a query longer than kCols columns
      if (last && valid != nullptr && valid[n0 + r] == 0) total = kNegFill;
      out[o] = total;
    }
  }
}

int launch_float(const void* q, const void* summ, const void* valid,
                 void* out, int B, int Lq, int S, int N, int dim,
                 cudaStream_t stream) {
  if (dim > kMaxDim || dim % 8 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(dim);
  auto kernel = coarse_sweep_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // queries per block: as many whole queries as fit in kCols columns
  const int kc = sweep::kCols;
  const int G = Lq >= kc ? 1 : (kc / Lq < B ? kc / Lq : B);
  const long long groups = (B + G - 1) / G;
  const long long tiles = (N + sweep::kRows - 1) / sweep::kRows;
  const long long blocks = tiles * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), sweep::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(summ),
      static_cast<const int8_t*>(valid), static_cast<float*>(out), B, Lq, S,
      N, dim, G);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2 (bf16) and K3 (int8) on the tensor cores
// ---------------------------------------------------------------------------

using summary_tile::Args;
using summary_tile::kRows;
using summary_tile::Row;

// what both bodies share: where a slab lies, and how a query's sum is
// written
struct CoarseSlabs {
  static constexpr int kCols = 128;      // a group of whole queries

  // slot s of docs 64 t .. 64 t + 63 (rows past N are the next slot's, or
  // zeros past the last, and are never written)
  __device__ static int slab_row(const Args& a, int, int t, int s) {
    return s * a.N + t * kRows;
  }

  __device__ static void emit(const Args& a, int gi, int qi, const Row& r,
                              float v, bool first, bool last) {
    float* o = a.out + static_cast<size_t>(gi * a.G + qi) * a.N + r.o;
    v = first ? v : *o + v;
    *o = last && r.invalid ? summary_tile::kNegFill : v;
  }
};

// K2: bf16 x bf16 -> f32 (wgmma m64n128k16), the float max over slots
struct CoarseBf16Op : CoarseSlabs {
  static constexpr int kSlabPanels = 2;    // a bf16 row: dim <= 128 values
  static constexpr int kQueryPanels = 2;
  static constexpr int kElemBytes = 2;
  static constexpr bool kWeighted = false;
  using Acc = float;
  __device__ static float lowest() { return __int_as_float(0xff800000); }
  // the k-panels that hold data (a row of dim <= 64 takes one; the sweep
  // keeps the other zero)
  __device__ static int panels(const Args& a) {
    return (a.dim * kElemBytes + 127) / 128;
  }

  // the slab's 8 k-steps of 16 values, both operands K-major in shared
  // memory (zeros past dim on both sides)
  __device__ static void product(const Args&, float (&acc)[64],
                                 const unsigned char* slab,
                                 const unsigned char* qbuf, int, int) {
    summary_tile::product_bf16_ss<kCols>(acc, slab, qbuf);
  }

  // column c of pass p: token tok of query qi of group gi (lqp columns a
  // query); zeros past the group's queries, Lq and dim
  __device__ static void stage_query(const Args& a, int gi, int g_here,
                                     int pass, unsigned char* qbuf, float*,
                                     int tid) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    for (int i = tid; i < kCols * 16; i += summary_tile::kThreads) {
      const int c = i >> 4, k = i & 15;
      const int gcol = pass * kCols + c, qi = gcol / a.lqp;
      const int tok = gcol - qi * a.lqp;
      const bool in = qi < g_here && tok < a.Lq;
      summary_tile::stage_bf16<kCols>(
          qbuf, c, k,
          in ? q + (static_cast<size_t>(gi * a.G + qi) * a.Lq + tok) * a.dim
             : nullptr,
          a.dim);
    }
  }

  __device__ static Row row(const Args& a, int, int t, int r) {
    const int n = t * kRows + r;
    if (n >= a.N) return Row{-1, 1.f, false};
    return Row{n, 1.f, a.valid != nullptr && a.valid[n] == 0};
  }

  __device__ static float term(float m, float, const Row&) { return m; }
};

// K3: s8 x s8 -> s32 (wgmma m64n128k32), the int32 max over slots
struct CoarseInt8Op : CoarseSlabs {
  static constexpr int kSlabPanels = 1;    // a summary row: dim <= 128 bytes
  static constexpr int kQueryPanels = 1;
  static constexpr int kElemBytes = 1;
  static constexpr bool kWeighted = true;
  using Acc = int;
  __device__ static int lowest() { return INT_MIN; }
  __device__ static int panels(const Args&) { return 1; }

  // the slab's 4 k-steps of 32 values: wgmma s8 x s8 -> s32, both operands
  // K-major in shared memory (zeros past dim on both sides)
  __device__ static void product(const Args&, int (&acc)[64],
                                 const unsigned char* slab,
                                 const unsigned char* qbuf, int, int) {
    const uint32_t sa = summary_tile::smem_addr(slab);
    const uint32_t qa = summary_tile::smem_addr(qbuf);
    mma_tile::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      summary_tile::wgmma_s8_n128(acc, summary_tile::sw128_desc(sa + 32 * ks),
                                  summary_tile::sw128_desc(qa + 32 * ks),
                                  ks > 0);
    mma_tile::wgmma_commit();
    mma_tile::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) summary_tile::fence_operand(acc[i]);
  }

  // column c of pass p: token tok of query qi of group gi (lqp columns a
  // query), its int8 row as 128 K-major bytes (chunk k at k ^ (c & 7)) and
  // its scale in qs[c]; zeros past the group's queries, Lq and dim
  __device__ static void stage_query(const Args& a, int gi, int g_here,
                                     int pass, unsigned char* qbuf,
                                     float* qs, int tid) {
    const int8_t* q8 = static_cast<const int8_t*>(a.q);
    for (int i = tid; i < kCols * 8; i += summary_tile::kThreads) {
      const int c = i >> 3, k = i & 7;
      const int gcol = pass * kCols + c, qi = gcol / a.lqp;
      const int tok = gcol - qi * a.lqp;
      const bool in = qi < g_here && tok < a.Lq;
      const size_t row = static_cast<size_t>(gi * a.G + qi) * a.Lq + tok;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (in && 16 * k < a.dim)
        v = *reinterpret_cast<const uint4*>(q8 + row * a.dim + 16 * k);
      *reinterpret_cast<uint4*>(qbuf + c * 128 + ((k ^ (c & 7)) << 4)) = v;
      if (k == 0) qs[c] = in ? a.qscale[row] : 0.f;
    }
  }

  __device__ static Row row(const Args& a, int, int t, int r) {
    const int n = t * kRows + r;
    if (n >= a.N) return Row{-1, 0.f, false};
    return Row{n, a.dscale[n], a.valid != nullptr && a.valid[n] == 0};
  }

  // qscale * (dscale * max), the plain version's products
  __device__ static float term(int m, float w, const Row& r) {
    return w * (summary_tile::exact_float(m) * r.scale);
  }
};

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the CUDA error code
// of the launch (0 on success) and launches nothing when B or N is 0.
// float32 body (K2 on the CUDA cores): q and summ float32.
extern "C" int ravqa_coarse_sweep(const void* q, const void* summ,
                                  const void* valid, void* out, int B,
                                  int Lq, int S, int N, int dim,
                                  void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (Lq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_float(q, summ, valid, out, B, Lq, S, N, dim,
                      static_cast<cudaStream_t>(stream));
}

namespace {

// the tensor-core bodies' arguments: the plan's ints (cols, lqp, G,
// passes, n_tiles, tiles_per_block) from ops/maxsim.py::summary_plan
int launch_coarse_mma(bool int8, const void* q, const void* qscale,
                      const void* summ, const void* dscale,
                      const void* valid, void* out, int B, int Lq, int S,
                      int N, int dim, int cols, int lqp, int G, int passes,
                      int n_tiles, int tiles_per_block, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (Lq <= 0 || dim % (int8 ? 16 : 8) || cols != CoarseSlabs::kCols ||
      n_tiles != (N + kRows - 1) / kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.qscale = static_cast<const float*>(qscale);
  a.dscale = static_cast<const float*>(dscale);
  a.valid = static_cast<const int8_t*>(valid);
  a.out = static_cast<float*>(out);
  a.B = B, a.Lq = Lq, a.S = S, a.dim = dim, a.N = N;
  a.lqp = lqp, a.G = G, a.passes = passes, a.n_tiles = n_tiles;
  a.tiles_per_block = tiles_per_block;
  const long long rows = static_cast<long long>(S) * N;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8 ? summary_tile::launch<CoarseInt8Op>(a, summ, rows, s)
              : summary_tile::launch<CoarseBf16Op>(a, summ, rows, s);
}

}  // namespace

// bf16 body (K2 on the tensor cores): q (B*Lq, dim) and summ (S, N, dim)
// bfloat16, the plan's ints as for the int8 body.
extern "C" int ravqa_coarse_sweep_bf16(const void* q, const void* summ,
                                       const void* valid, void* out, int B,
                                       int Lq, int S, int N, int dim,
                                       int cols, int lqp, int G, int passes,
                                       int n_tiles, int tiles_per_block,
                                       void* stream) {
  return launch_coarse_mma(false, q, nullptr, summ, nullptr, valid, out, B,
                           Lq, S, N, dim, cols, lqp, G, passes, n_tiles,
                           tiles_per_block, stream);
}

// int8 body (K3): q8 (B*Lq, dim) int8 with qscale (B*Lq,) float, summ8
// (S, N, dim) int8 with dscale (N,) float. The plan's ints (cols, lqp, G,
// passes, n_tiles, tiles_per_block) come from
// ops/maxsim.py::summary_plan; cols must be 128.
extern "C" int ravqa_coarse_sweep_int8(const void* q8, const void* qscale,
                                       const void* summ8, const void* dscale,
                                       const void* valid, void* out, int B,
                                       int Lq, int S, int N, int dim,
                                       int cols, int lqp, int G, int passes,
                                       int n_tiles, int tiles_per_block,
                                       void* stream) {
  return launch_coarse_mma(true, q8, qscale, summ8, dscale, valid, out, B,
                           Lq, S, N, dim, cols, lqp, G, passes, n_tiles,
                           tiles_per_block, stream);
}
