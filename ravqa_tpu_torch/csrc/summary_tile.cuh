// The tensor-core sweep of slot-major summaries on Hopper: K3
// (coarse_sweep.cu, int8) and K4 (stage1_sweep.cu, bf16 and int8 rows).
// Both compute
//
//   out[b, doc] = sum_t w_t * max_s q[b, t] . row_s(doc)
//
// over tiles of 64 summary rows that are one contiguous slab per slot: K3's
// slab s of summaries_t (S, N, dim) at docs n0 .. n0 + 63, K4's rows j0 ..
// j0 + 63 of block blk[b, i] at slot s in summ_rows (NB, S, bs, dim). Each
// kernel's Op says where a slab lies, how it is multiplied and how a
// query's sum is weighed, scaled and written.
//
// Orientation: summary rows are the MMA's rows (M = 64, one warpgroup) and
// query tokens its columns (N = Op::kCols, whole queries padded to lqp =
// Lq rounded up to 8 columns, so an 8-column slab of the accumulator never
// holds two queries). Then:
//  - the max over slots is an elementwise max of accumulator fragments:
//    the same (row, column) sits at the same register in every slot's
//    product, so the running max needs no shuffle and no shared memory;
//  - the per-row (per-doc) scale is one scalar per accumulator row;
//  - a query's sum over its columns is in-thread adds over the columns the
//    thread owns (weighed by the column's scale, K3) and two shuffles
//    (lanes ^1, ^2), in a fixed order: results repeat bit for bit.
// A query longer than kCols columns takes several column passes; the same
// thread adds each pass's sum to the one it wrote.
//
// Copies: one thread asks the TMA for each slot's slab (a box of 64 rows x
// one 128-byte k-panel, from a tensor map of the summaries as rows x dim
// that the host encodes per call) into a 4-stage ring with an mbarrier per
// stage, so three slabs load while one multiplies. The TMA writes wgmma's
// K-major 128-byte-swizzle layout; values past dim, and rows past the
// tensor, arrive as zeros, and rows past a tile's docs are never written
// out. The query's columns are staged once per pass by the threads, in
// the same layout, with zeros past Lq and past dim.
//
// Every wgmma of a slab runs in straight code (ptxas serializes a wgmma in
// a branch or in flight across a loop's back edge); the slab's product is
// waited for before its max, and the other blocks on the SM (two to four,
// by shared memory) fill the tensor cores meanwhile.
//
// Grid (ops/maxsim.py::summary_plan): groups of G whole queries (G = 1 for
// K4, whose queries each read their own blocks) x ranges of
// tiles_per_block consecutive tiles; block x takes group x % n_groups and
// tile range x / n_groups, so the groups that read the same tiles run
// together and share them in L2.

#pragma once

#include "mma_tile.cuh"

namespace summary_tile {

using mma_tile::fence_operand;
using mma_tile::sw128_desc;

constexpr int kThreads = 128;    // one warpgroup
constexpr int kRows = 64;        // summary rows (the MMA's M) per tile
constexpr int kStages = 4;
constexpr int kMaxDim = 128;
constexpr float kNegFill = -9999.0f;

struct Args {
  const void* q;          // the queries, as each Op reads them
  const float* qscale;    // (B * Lq) query-token scales (K3), or null
  const int* blk;         // (B, nbl) selected blocks (K4), or null
  const float* dscale;    // per-doc scales, or null
  const int8_t* valid;    // (N) doc validity (K3), or null
  float* out;
  int B, Lq, S, dim;
  int N;                  // K3: docs per slot
  int bs, nbl, NB;        // K4: block size, blocks per query, blocks
  int lqp;                // columns per query: Lq rounded up to 8
  int G;                  // queries per group
  int passes;             // column passes per group
  int n_tiles;            // 64-row tiles per group
  int tiles_per_block;
};

// what a tile row needs to be written: out offset o (K3: the doc, K4: the
// gathered position; < 0 off the tile), its scale, and whether it is an
// invalid doc (K3: scores -9999)
struct Row {
  long long o;
  float scale;
  bool invalid;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the threads' shared-memory writes, before the wgmmas (the async proxy)
// read them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// int32 s exactly as a float, for |s| < 2^22, with an integer and a float
// add
__device__ __forceinline__ float exact_float(int s) {
  return __int_as_float(s + 0x4B400000) - 12582912.0f;
}

// int8 values v0..v3 of a word, exactly, as the bf16 pairs (v0, v1) and
// (v2, v3): byte i biased to u = v + 128 becomes the float bits of 2^23 +
// u, minus 2^23 + 128, then two to a register
__device__ __forceinline__ uint2 widen_int8(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | i)) -
           8388736.0f;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

// d (64 x N f32, this thread's N / 2) += a (64 x 16 bf16, registers) x the
// 16 x N bf16 tile at b (K-major, 128-byte swizzle); scale_d 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

// d (64 x 128 s32, this thread's 64) += the 64 x 32 s8 tile at a x the
// 32 x 128 s8 tile at b (both K-major, 128-byte swizzle); scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}


// The sweep of one block. Op provides: kCols (the MMA's N), kSlabPanels and
// kQueryPanels (128-byte k-panels of a slab row and of a staged query
// column), kElemBytes (of a summary value), kWeighted (columns weighed by
// qs), Acc, lowest(); slab_row(a, gi, t, s): the TMA row of tile t's slot
// s; panels(a): the k-panels a slab loads; product(a, acc, slab, qbuf):
// the slab's wgmmas, waited for; stage_query(a, gi, g_here, pass, qbuf,
// qs, tid); row(a, gi, t, r) -> Row; term(m, w, row) -> the column's
// float; emit(a, gi, qi, row, v, first, last): query qi's sum v of this
// pass, the first and/or last of its passes.
template <class Op>
__device__ __forceinline__ void sweep(const Args& a, const CUtensorMap& map) {
  constexpr int NC = Op::kCols;
  constexpr int NA = NC / 2;                        // accumulators a thread
  constexpr int kSlab = Op::kSlabPanels * kRows * 128;
  constexpr int kQuery = Op::kQueryPanels * NC * 128;
  using Acc = typename Op::Acc;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle's 8-row atoms must start at 1024-byte boundaries
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qbuf = base + kStages * kSlab;     // the pass's columns
  float* qs = reinterpret_cast<float*>(qbuf + kQuery);   // [NC] weights
  const uint32_t bars = smem_addr(qs + NC);         // [kStages]
  const uint32_t ring = smem_addr(base);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int n_groups = (a.B + a.G - 1) / a.G;
  const int gi = blockIdx.x % n_groups;
  const int g_here = min(a.G, a.B - gi * a.G);
  const int t0 = static_cast<int>(blockIdx.x / n_groups) * a.tiles_per_block;
  const int T = min(a.tiles_per_block, a.n_tiles - t0);
  const int per_pass = T * a.S;                     // slabs a pass
  const int panels = Op::panels(a);

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mma_tile::mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // slab k of a pass (tile k / S, slot k % S), the q-th this block loads,
  // into stage q % kStages
  auto load = [&](int q, int k) {
    if (tid != 0 || k >= per_pass) return;
    const int t = k / a.S, s = k - t * a.S;
    const uint32_t bar = bars + 8 * (q % kStages);
    const uint32_t st = ring + (q % kStages) * kSlab;
    const int row = Op::slab_row(a, gi, t0 + t, s);
    mma_tile::mbar_expect_tx(bar, panels * kRows * 128);
    for (int pn = 0; pn < panels; ++pn)
      mma_tile::tma_load_2d(st + pn * kRows * 128, &map,
                            pn * (128 / Op::kElemBytes), row, bar);
  };

  Acc acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = Acc(0);
  int q0 = 0;                       // slabs this block has loaded before
  for (int pass = 0; pass < a.passes; ++pass) {
    for (int k = 0; k < kStages; ++k) load(q0 + k, k);
    Op::stage_query(a, gi, g_here, pass, qbuf, qs, tid);
    fence_async_smem();
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      Acc m[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) m[i] = Op::lowest();
      for (int s = 0; s < a.S; ++s) {
        const int k = t * a.S + s, q = q0 + k;
        mma_tile::mbar_wait(bars + 8 * (q % kStages), (q / kStages) & 1);
        Op::product(a, acc, base + (q % kStages) * kSlab, qbuf, warp, lane);
        __syncthreads();            // every thread is done with the stage
        load(q + kStages, k + kStages);
#pragma unroll
        for (int i = 0; i < NA; ++i) m[i] = max(m[i], acc[i]);
      }

      // each query's sum over its columns. Accumulator of slab j (columns
      // 8j .. 8j + 7): [4j], [4j + 1] row g, columns 8j + 2c, 8j + 2c + 1;
      // [4j + 2], [4j + 3] row g + 8
      Row rw[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rw[h] = Op::row(a, gi, t0 + t, 16 * warp + g + 8 * h);
      float run[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = 8 * j + 2 * c;
        const float w0 = Op::kWeighted ? qs[col] : 1.f;
        const float w1 = Op::kWeighted ? qs[col + 1] : 1.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          run[h] += Op::term(m[4 * j + 2 * h], w0, rw[h]);
          run[h] += Op::term(m[4 * j + 2 * h + 1], w1, rw[h]);
        }
        const int done = pass * NC + 8 * j + 8;     // the group's columns
        if (done % a.lqp == 0 || j == NC / 8 - 1) {
          // a query ends here, or this pass does (warp-uniform)
          const int qi = (done - 1) / a.lqp;
          const bool first = qi * a.lqp >= pass * NC;
          const bool last = (qi + 1) * a.lqp <= (pass + 1) * NC;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = run[h];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            run[h] = 0.f;
            if (c == 0 && qi < g_here && rw[h].o >= 0)
              Op::emit(a, gi, qi, rw[h], v, first, last);
          }
        }
      }
    }
    q0 += per_pass;
    __syncthreads();                // the pass's columns are read
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
summary_kernel(const Args a, const __grid_constant__ CUtensorMap map) {
  sweep<Op>(a, map);
}

// Checks a launch's plan against the kernel, encodes the summaries' tensor
// map (map_rows x dim values of elem_bytes at rows, boxes of 64 rows),
// sizes the shared memory and launches on `stream`. Returns the CUDA error
// code (0 on success).
template <class Op>
int launch(const Args& a, const void* rows, long long map_rows,
           cudaStream_t stream) {
  constexpr int NC = Op::kCols;
  const bool fits = a.G > 1 ? a.G * a.lqp <= NC && a.passes == 1
                            : a.G == 1 &&
                                  static_cast<long long>(a.passes) * NC >=
                                      a.lqp &&
                                  (a.passes - 1) * NC < a.lqp;
  if (!fits || a.lqp < a.Lq || a.lqp % 8 || a.n_tiles < 1 ||
      a.tiles_per_block < 1 || a.dim > kMaxDim || a.dim <= 0 || a.S < 1 ||
      map_rows + kRows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>((a.B + a.G - 1) / a.G) *
      ((a.n_tiles + a.tiles_per_block - 1) / a.tiles_per_block);
  if (blocks > INT_MAX ||
      static_cast<long long>(a.n_tiles) * a.S + kStages > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  int err = mma_tile::encode_map_2d(&map, rows, Op::kElemBytes, a.dim,
                                    map_rows, kRows);
  if (err) return err;
  const size_t smem = 1024 +
                      static_cast<size_t>(kStages) * Op::kSlabPanels * kRows *
                          128 +
                      static_cast<size_t>(Op::kQueryPanels) * NC * 128 +
                      sizeof(float) * NC + 8 * kStages;
  auto kernel = summary_kernel<Op>;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a, map);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace summary_tile
