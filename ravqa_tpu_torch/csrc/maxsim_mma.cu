// Exhaustive late-interaction (MaxSim) search over a bf16 index on Hopper's
// tensor cores (K1, bf16-index route).
//
// Replaces ravqa_tpu/ops/maxsim.py::maxsim_search_pallas (body
// _maxsim_kernel) for a bfloat16 index; a float32 index stays on the SIMT
// kernel of maxsim.cu. Computes, directly in (B, N) layout,
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
// (1k at B=32, Lq=32), far above the H100's ridge of ~295 FLOP/byte, so
// the bound is the tensor cores' bf16 rate. The design (mma_tile.cuh):
// wgmma.m64n64k16 bf16 x bf16 -> f32, the only instruction that reaches
// Hopper's full tensor rate (mma.sync tops out well below it), with query
// tokens as the MMA's rows held in registers and doc tokens as its columns
// read from shared memory, streamed by the TMA through a 3-stage ring of
// tiles that follow Ld; the max over a doc's tokens in registers plus two
// shuffles; the sum over Lq once per (query, doc).
//
// A float32 query is split by the caller into bf16 parts (ops/maxsim.py::
// split_query_bf16: hi = bf16(q), lo = bf16(q - hi)); each part's product
// with the same doc fragment goes into the same f32 accumulator. A bf16
// doc value times a bf16 part is exact in f32, so the query keeps ~16 of
// its 24 bits instead of 8. A bf16 query is one part.
//
// Inputs, all contiguous: q (parts, B, Lq, dim) bf16, tok (N, Ld, dim)
// bf16, mask (N, Ld) int8, out (B, N) float. dim % 8 == 0, dim <= 128,
// q and tok 16-byte aligned (the Python wrapper checks). Sums are taken in
// a fixed order, so results repeat bit for bit.

#include "mma_tile.cuh"

namespace {

struct Bf16Op {
  using Acc = float;
  static constexpr int kElemBytes = 2;

  // d (64 x 64 f32, this thread's 32) += a (64 x 16 bf16, registers) x the
  // 16 x 64 bf16 tile at desc; scale_d 0 overwrites d
  __device__ __forceinline__ static void wgmma(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d)
        : "memory");
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

// MT 64-row m-tiles per warpgroup, P query parts: (2, 1) for a bf16 query
// (256 query rows per block), (1, 2) for a split float32 query (128 rows);
// KS k-steps of 16 values
template <int MT, int P, int KS>
__global__ void __launch_bounds__(mma_tile::kThreads, 1)
maxsim_mma_kernel(const mma_tile::Args a,
                  const __grid_constant__ CUtensorMap map) {
  mma_tile::sweep<Bf16Op, MT, P, KS>(a, map);
}

template <int MT, int P>
int launch(const mma_tile::Args& a, cudaStream_t s) {
  constexpr int rows = mma_tile::block_rows<MT>();
  switch (mma_tile::k_steps(a.dim * 2)) {
    case 1:
      return mma_tile::launch(maxsim_mma_kernel<MT, P, 1>, a, rows, 1, 2, s);
    case 2:
      return mma_tile::launch(maxsim_mma_kernel<MT, P, 2>, a, rows, 2, 2, s);
    case 4:
      return mma_tile::launch(maxsim_mma_kernel<MT, P, 4>, a, rows, 4, 2, s);
    case 8:
      return mma_tile::launch(maxsim_mma_kernel<MT, P, 8>, a, rows, 8, 2, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface (loaded with ctypes). parts is 1 (bf16 query) or 2
// (float32 query split in two); the plan's ints come from
// ops/maxsim.py::mma_tile_plan. Returns the CUDA error code of the launch
// (0 on success); launches nothing when B or N is 0, and writes zeros when
// Lq is 0.
extern "C" int ravqa_maxsim_mma(const void* q, const void* tok,
                                const void* mask, void* out, int B, int Lq,
                                int N, int Ld, int dim, int parts,
                                int docs_per_tile, int doc_cols,
                                int tiles_per_doc, int tiles_per_block,
                                int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return 0;
  if (Lq <= 0) {
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(B) * N, s));
  }
  if (Ld <= 0 || dim % 8 || dim > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const mma_tile::Args a{q, nullptr, tok, mask, static_cast<float*>(out),
                         B, Lq, N, Ld, dim, G, docs_per_tile, doc_cols,
                         tiles_per_doc, tiles_per_block};
  if (parts == 1) return launch<2, 1>(a, s);
  if (parts == 2) return launch<1, 2>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
