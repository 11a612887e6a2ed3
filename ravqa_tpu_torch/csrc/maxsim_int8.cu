// Exhaustive int8 late-interaction (MaxSim) search on Hopper's tensor cores
// (K5).
//
// Replaces ravqa_tpu/ops/quant.py::maxsim_search_int8_pallas (body
// _maxsim_int8_kernel). Queries and index are int8 with float32 scales,
// per query token and per doc token. Computes, directly in (B, N) layout,
//
//   out[b, n] = sum_t qscale[b, t] * max_l s(b, t, n, l)
//   s(b, t, n, l) = (q8[b, t] . tok8[n, l]) * dscale[n, l]  if dscale > 0
//                 = -9999                                   otherwise
//
// The dot products are int32 (wgmma.m64n64k32 s8 x s8 -> s32), exact. A
// doc-token scale of 0 marks an invalid token (quantize_index_int8 zeroes
// the scales of masked tokens), as in the TPU kernel; no mask is read. The
// running max over Ld starts at -inf, so an all-negative query token keeps
// its negative maximum and a doc with no valid token scores
// -9999 * sum_t qscale[b, t]. Each maximum is multiplied by its query
// token's scale inside the sum over Lq, as in the plain version (the TPU
// kernel applies the scale before its selector matmul); the sum runs in a
// fixed order, so results repeat bit for bit.
//
// What bounds it on this card: every index byte feeds 2 * B * Lq integer
// operations (2k at B=32, Lq=32), far above the ridge, so the bound is the
// tensor cores' int8 rate. The design is K1's (mma_tile.cuh: query tokens
// as the MMA's rows in registers, doc tiles and MMA widths that follow Ld
// through a 3-stage TMA ring fed by a producer warp, two consumer
// warpgroups multiplying in turns, maxima in registers, persistent
// blocks). At int8 rates the epilogue
// (int32 -> float, times the doc-token scale, select -9999, max) can set
// the pace, and int-to-float conversion runs at a fraction of the FMA
// rate; since |s| <= dim * 128^2 < 2^22, the conversion here is exact with
// two full-rate adds: float bits (s + 0x4B400000) are 1.5 * 2^23 + s. The
// doc-token scale and the -9999 / -inf fills then take one fma per product
// (Int8Op::Col), worked out once per tile column.
//
// Inputs, all contiguous: q8 (B, Lq, dim) int8, qscale (B, Lq) float,
// tok8 (N, Ld, dim) int8, dscale (N, Ld) float, out (B, N) float.
// dim % 16 == 0, dim <= 128, pointers 16-byte aligned (the Python wrapper
// checks). The TPU kernel's rule N % tile_d == 0 does not apply.

#include "mma_tile.cuh"

namespace {

// s exactly as a float, for |s| < 2^22, with integer and float adds
__device__ __forceinline__ float exact_float(int s) {
  return __int_as_float(s + 0x4B400000) - 12582912.0f;
}

// d (64 x 2R s32) += a (64 x 32 s8) x the s8 tile at desc: m64nWk32 for
// W = 2R = 64, 112 or 128
template <int R>
__device__ __forceinline__ void wgmma_s8(int (&d)[R], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[32],
    const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<56>(int (&d)[56],
    const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55"
      "}, "
      "{%56, %57, %58, %59}, %60, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[64],
    const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

struct Int8Op {
  using Acc = int;
  static constexpr int kElemBytes = 1;

  // d (64 x 2R s32, this thread's R) += a (64 x 32 s8, registers) x the
  // 32 x 2R s8 tile at desc; scale_d 0 overwrites d
  template <int R>
  __device__ __forceinline__ static void wgmma(int (&d)[R],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
    wgmma_s8(d, a, desc, scale_d);
  }
  // a column: score = s * w + add, with (w, add) = (dscale, 0) for a valid
  // token, (0, -9999) for an invalid one (dscale 0), (0, -inf) off the
  // tile. s * dscale + 0 rounds once, as the plain version's product.
  struct Col {
    float w, add;
  };
  __device__ __forceinline__ static Col column(const void* fill, size_t i,
                                               bool in_tile) {
    if (!in_tile) return {0.f, __int_as_float(0xff800000)};
    const float ds = static_cast<const float*>(fill)[i];
    return ds > 0.f ? Col{ds, 0.f} : Col{0.f, mma_tile::kNegFill};
  }
  __device__ __forceinline__ static float score(int s, Col col) {
    return fmaf(exact_float(s), col.w, col.add);
  }
  __device__ __forceinline__ static float term(const float* qscale,
                                               size_t row, float m) {
    return qscale[row] * m;
  }
};

// KS k-steps of 32 values, MMA chunks of W columns
template <int KS, int W>
__global__ void __launch_bounds__(mma_tile::kThreads, 1)
maxsim_int8_mma_kernel(const mma_tile::Args a,
                       const __grid_constant__ CUtensorMap map) {
  mma_tile::sweep<Int8Op, 2, 1, KS, 1, 256, W>(a, map);
}

template <int KS, int W>
int launch_w(const mma_tile::Args& a, int blocks, cudaStream_t s) {
  return mma_tile::launch(maxsim_int8_mma_kernel<KS, W>, a,
                          mma_tile::block_rows<2>(), 256, W, KS, 1, blocks,
                          s);
}

// the widths built (ops/maxsim.py::mma_widths): 64, 112 and 128 for rows
// of more than 64 values, else 64
template <int KS>
int launch_ks(const mma_tile::Args& a, int width, int blocks,
              cudaStream_t s) {
  if constexpr (KS < 4) {
    if (width == 64) return launch_w<KS, 64>(a, blocks, s);
  } else {
    switch (width) {
      case 64: return launch_w<KS, 64>(a, blocks, s);
      case 112: return launch_w<KS, 112>(a, blocks, s);
      case 128: return launch_w<KS, 128>(a, blocks, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface (loaded with ctypes); the plan's ints come from
// ops/maxsim.py::mma_tile_plan. Returns the CUDA error code of the launch
// (0 on success); launches nothing when B or N is 0.
extern "C" int ravqa_maxsim_search_int8(const void* q8, const void* qscale,
                                        const void* tok8, const void* dscale,
                                        void* out, int B, int Lq, int N,
                                        int Ld, int dim, int docs_per_tile,
                                        int doc_cols, int tiles_per_doc,
                                        int tiles_per_unit, int G,
                                        int width, int chunks, int blocks,
                                        void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (Lq <= 0 || Ld <= 0 || dim % 16 || dim > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const mma_tile::Args a{q8, static_cast<const float*>(qscale), tok8, dscale,
                         static_cast<float*>(out), B, Lq, N, Ld, dim, dim, G,
                         docs_per_tile, doc_cols, tiles_per_doc,
                         tiles_per_unit, chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mma_tile::k_steps(dim)) {
    case 1: return launch_ks<1>(a, width, blocks, s);
    case 2: return launch_ks<2>(a, width, blocks, s);
    case 4: return launch_ks<4>(a, width, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
