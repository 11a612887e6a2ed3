// Exhaustive late-interaction (MaxSim) search on Hopper's tensor cores (K1).
//
// Replaces ravqa_tpu/ops/maxsim.py::maxsim_search_pallas (body
// _maxsim_kernel), for a bfloat16 and a float32 index. Computes, directly
// in (B, N) layout,
//
//   out[b, n] = sum_q max_l s(b, q, n, l)
//   s(b, q, n, l) = q[b, q, :] . tok[n, l, :]   if mask[n, l] != 0
//                 = -9999                         otherwise
//
// with the running max from -inf, so a doc whose tokens are all masked
// scores exactly -9999 * Lq and an all-negative query token keeps its
// negative maximum.
//
// What bounds it on this card: every index byte feeds B * Lq operations
// (1k at B=32, Lq=32; 4k at the float32 serve's B=32, Lq=64), far above
// the H100's ridge of ~295 FLOP/byte, so the bound is the tensor cores'
// bf16 rate, times the bf16 products a split takes. The design
// (mma_tile.cuh): wgmma m64nWk16 bf16 x bf16 -> f32, the only instruction
// that reaches Hopper's full tensor rate (mma.sync tops out well below
// it), with query tokens as the MMA's rows held in registers and doc
// tokens as its columns read from shared memory, W fitted to Ld (112 at
// Ld 220 on a float32 index: no MMA column without a token of the padded
// doc); a producer warp streams the tiles through a 3-stage TMA ring and
// writes each column's mask facts, two consumer warpgroups multiply in
// turns so that one's masked max runs under the other's wgmmas, the
// producer's other warps sum over Lq; one persistent block an SM walks
// (query group, doc range) units.
//
// A float32 query is split by the caller into bf16 parts (ops/maxsim.py::
// split_query_bf16: hi = bf16(q), lo = bf16(q - hi)); each part's product
// with the same doc fragment goes into the same f32 accumulator. A bf16
// doc value times a bf16 part is exact in f32, so the query keeps ~16 of
// its 24 bits instead of 8. A bf16 query is one part.
//
// A float32 index is read the same way, as two bf16 planes of each token
// row ([hi | lo], ops/maxsim.py::split_index_bf16, made once per index and
// kept beside it: the float32 index's bytes at dim 128). The CUDA cores'
// float32 rate is 67 TFLOP/s; the tensor cores take the three products
// hi.hi + lo.hi + hi.lo at 989 TFLOP/s of bf16, which bounds the float32
// serve at 3 x 1.89 TFLOP in 5.7 ms where the CUDA cores' bound was 28 ms.
// The dropped lo.lo term is below 2^-16 of each product: the CPU test
// (tests/test_torch_maxsim.py) holds two parts per side within 1e-4 of the
// float32 MaxSim at the serve geometry, three would add three products
// for nothing the 1e-3 check can see. Two planes double a ring stage's
// bytes, so this route's ring stages hold 128 rows (3 stages of 64 KB).
//
// Inputs, all contiguous: q (parts, B, Lq, dim) bf16, tok (N, Ld, dim)
// bf16 or (N, Ld, 2 * dp) bf16 planes (dp = dim rounded up to the k-steps
// of 16 values), mask (N, Ld) int8, out (B, N) float. dim % 8 == 0,
// dim <= 128, q and tok 16-byte aligned (the Python wrapper checks). Sums
// are taken in a fixed order, so results repeat bit for bit.

#include "mma_tile.cuh"

namespace {

struct Bf16Op {
  using Acc = float;
  static constexpr int kElemBytes = 2;

  // d (64 x 2R f32) += a (64 x 16 bf16, registers) x the bf16 tile at
  // desc
  template <int R>
  __device__ __forceinline__ static void wgmma(float (&d)[R],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
    mma_tile::wgmma_bf16(d, a, desc, scale_d);
  }
  // a column: valid, or the value it scores instead (-9999 for a masked
  // token, -inf off the tile)
  struct Col {
    bool valid;
    float fill;
  };
  __device__ __forceinline__ static Col column(const void* fill, size_t i,
                                               bool in_tile) {
    if (!in_tile) return {false, __int_as_float(0xff800000)};
    return {static_cast<const int8_t*>(fill)[i] != 0, mma_tile::kNegFill};
  }
  __device__ __forceinline__ static float score(float s, Col col) {
    return col.valid ? s : col.fill;
  }
  __device__ __forceinline__ static float term(const float*, size_t,
                                               float m) {
    return m;
  }
};

// MT 64-row m-tiles per consumer warpgroup, P query parts, X index planes:
// (2, 1, 1) for a bf16 query on a bf16 index (256 query rows per unit row
// chunk), (1, 2, 1) for a split float32 query (128 rows), (1, 2, 2) for a
// float32 query on a float32 index read as two planes; KS k-steps of 16
// values per plane; ring stages of 256 rows, or 128 for two planes; MMA
// chunks of W columns
template <int MT, int P, int X, int KS, int W>
__global__ void __launch_bounds__(mma_tile::kThreads, 1)
maxsim_mma_kernel(const mma_tile::Args a,
                  const __grid_constant__ CUtensorMap map) {
  mma_tile::sweep<Bf16Op, MT, P, KS, X, (X > 1 ? 128 : 256), W>(a, map);
}

template <int MT, int P, int X, int KS, int W>
int launch_w(mma_tile::Args a, int blocks, cudaStream_t s) {
  constexpr int tr = X > 1 ? 128 : 256;
  a.tok_dim = X > 1 ? X * 16 * KS : a.dim;
  return mma_tile::launch(maxsim_mma_kernel<MT, P, X, KS, W>, a,
                          mma_tile::block_rows<MT>(), tr, W, X * KS, 2,
                          blocks, s);
}

// the widths a kernel is built for (ops/maxsim.py::mma_widths): 64 for
// rows of 64 values or fewer; else 64, 112 and 128, and 96 where a
// warpgroup holds one m-tile
template <int MT, int P, int X, int KS>
int launch_ks(const mma_tile::Args& a, int width, int blocks,
              cudaStream_t s) {
  if constexpr (KS < 8) {
    if (width == 64) return launch_w<MT, P, X, KS, 64>(a, blocks, s);
  } else {
    switch (width) {
      case 64: return launch_w<MT, P, X, KS, 64>(a, blocks, s);
      case 112: return launch_w<MT, P, X, KS, 112>(a, blocks, s);
      case 128: return launch_w<MT, P, X, KS, 128>(a, blocks, s);
      case 96:
        if constexpr (MT == 1) return launch_w<MT, P, X, KS, 96>(a, blocks, s);
        break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int MT, int P, int X>
int launch(const mma_tile::Args& a, int width, int blocks, cudaStream_t s) {
  switch (mma_tile::k_steps(a.dim * 2)) {
    case 1: return launch_ks<MT, P, X, 1>(a, width, blocks, s);
    case 2: return launch_ks<MT, P, X, 2>(a, width, blocks, s);
    case 4: return launch_ks<MT, P, X, 4>(a, width, blocks, s);
    case 8: return launch_ks<MT, P, X, 8>(a, width, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface (loaded with ctypes). parts is 1 (bf16 query) or 2
// (float32 query split in two); planes 1 (bf16 index) or 2 (float32 index
// as two bf16 planes, with parts 2); the plan's ints come from
// ops/maxsim.py::mma_tile_plan for TILE_ROWS[planes] and the widths the
// route is built for. Returns the CUDA error code of the launch (0 on
// success); launches nothing when B or N is 0, and writes zeros when Lq is
// 0.
extern "C" int ravqa_maxsim_mma(const void* q, const void* tok,
                                const void* mask, void* out, int B, int Lq,
                                int N, int Ld, int dim, int parts,
                                int planes, int docs_per_tile, int doc_cols,
                                int tiles_per_doc, int tiles_per_unit,
                                int G, int width, int chunks, int blocks,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return 0;
  if (Lq <= 0) {
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(B) * N, s));
  }
  if (Ld <= 0 || dim % 8 || dim > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const mma_tile::Args a{q, nullptr, tok, mask, static_cast<float*>(out),
                         B, Lq, N, Ld, dim, dim, G, docs_per_tile, doc_cols,
                         tiles_per_doc, tiles_per_unit, chunks};
  if (parts == 1 && planes == 1) return launch<2, 1, 1>(a, width, blocks, s);
  if (parts == 2 && planes == 1) return launch<1, 2, 1>(a, width, blocks, s);
  if (parts == 2 && planes == 2) return launch<1, 2, 2>(a, width, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
