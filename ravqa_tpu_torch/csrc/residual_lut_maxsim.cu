// Fused 2-bit LUT + MaxSim over pre-gathered residual candidates on
// Hopper's tensor cores (X1).
//
// Replaces scripts/exp_residual_stage2.py::v_pallas (pallas_call :189, body
// _fused_kernel): each query b scores its C candidates from their
// pre-gathered centroid scores and bucket ids,
//
//   out[b, c] = sum_t max_l s(b, c, l, t)
//   s(b, c, l, t) = (sum_d w[min(id[b, c, l, d], 3)] q[b, t, d]
//                    + cqg[b, c, l, t]) * sg[b, c, l]   if mg[b, c, l] != 0
//                 = -9999                              otherwise
//
// in float32: w is the 2-bit codec's 4 bucket weights, and an id past 3
// takes w[3], as the TPU body's select chain does. The running maximum
// over Ld starts at -inf, so a candidate with no valid token scores exactly
// -9999 * Lq.
//
// What bounds it on this card: the function needs the mask and, of each
// scored row (mg != 0) only, its ids, centroid scores and scale. At the
// experiment's shape (B=32, C=1024, Ld=64, Lq=32, dim=128) that is 547 MB
// with every row scored (cqg 268, ids 268, sg 8.4, mg 2.1), 0.163 ms at
// 3.35 TB/s, and 384 MB (0.115 ms) with 30 % of the rows masked, as
// chip_smoke.py's are. The residual term is 1.7e10
// multiply-adds; float32 has no tensor-core rate, and on the CUDA cores
// (67 TFLOP/s) they would take 0.256 ms, above the bytes. So the product
// runs on the tensor cores in bf16, as three products with K = dim:
// w_hi q_hi + w_lo q_hi + w_hi q_lo, where w_hi = bf16(w), w_lo = bf16(w -
// w_hi) (two 4-entry tables) and the query splits the same way. One bf16
// part a side keeps 8 bits of each value and misses the 1e-4 float32
// tolerance; the dropped w_lo q_lo and the rounding of the lo parts are
// about 2^-17 of the product. The three products are 5.15e10 bf16
// operations, 0.052 ms at 989 TFLOP/s: bytes bound the function.
//
// What the design does about the bytes: every byte the function needs is
// read once, straight into registers, and nothing goes through shared
// memory but the query; of a masked row only its mask is read.
//  - Grid (ops/stage2.py::candidate_plan, as X2): one block (one
//    warpgroup) per (query, range of cands_per_block candidates); a tile
//    is 64 token rows of one candidate, the MMA's rows (a candidate past 64
//    tokens spans several tiles; rows past it are dropped, none at Ld = 64).
//  - A, the weights, from registers: each thread loads its two rows' ids 8
//    bytes at a time in the order the A fragment takes them (lane c of a
//    quad takes bytes 8 (4 i + c) .. + 7 of a row, so a quad's load is one
//    32-byte sector), and decodes 4 ids with one clamp and two byte
//    permutes a table (__byte_perm picks 2 bf16 of the 8-byte table per
//    word). No TMA: a tensor map needs rows of a multiple of 16 bytes,
//    and X1 takes dim % 8 == 0; and no shared-memory round trip, so no
//    stale k-panel either: ids past dim are never loaded (they decode to
//    w[0]) and meet zeros in the query.
//  - B, the query's tokens as the MMA's columns (N = 16, 32, 64 or 128,
//    the least that covers Lq): q_hi and q_lo staged once per block in
//    shared memory (128-byte swizzle, two k-panels each), in the fragments'
//    k order, zeros past Lq and past dim.
//  - The accumulator starts at the centroid scores, read in its layout
//    (4 lanes read a row's 8 consecutive values, a 32-byte sector), so cqg
//    is read once and needs no add.
//  - The next tile's masks and its scored rows' ids, scales and (at
//    N <= 32, where the registers allow) centroid scores load while this
//    one multiplies; the first tile's while the query is staged.
//  - The 3 x 8 wgmmas m64nNk16 (lo parts first), in straight code, waited
//    for before the epilogue (ptxas serializes a wgmma in a branch or in
//    flight across a loop's back edge).
//  - Epilogue as X2 (candidate_maxsim.cu): x sg, -9999 where masked (-inf
//    past the candidate), each thread's max over its two rows of every
//    tile of the candidate, then lanes ^4, ^8, ^16 and the 4 warps, and
//    warp 0 sums the Lq columns in a fixed order: no atomics, results
//    repeat bit for bit.
// There is no tile rule on C (the TPU kernel needed C % 32 == 0).
//
// Inputs, all contiguous: q (B, Lq, dim) float; cqg (B, C, Ld, Lq) float;
// bits (B, C, Ld, dim) uint8, 16-byte aligned; sg (B, C, Ld) float; mg
// (B, C, Ld) int8; w (4,) float; out (B, C) float. 0 < Lq <= 128, Ld > 0,
// dim % 8 == 0, dim <= 128. The Python wrapper checks.

#include "summary_tile.cuh"

namespace {

using summary_tile::kRows;       // token rows a tile (the MMA's M)
using summary_tile::kThreads;    // one warpgroup
using summary_tile::smem_addr;

constexpr int kMaxDim = 128;
constexpr int kMaxLq = 128;
constexpr int kUnits = 4;        // 8-byte units of ids a thread loads a row
constexpr float kNegFill = -9999.0f;

struct Args {
  const float* q;             // (B, Lq, dim)
  const float* cqg;           // (B * C * Ld, Lq)
  const uint8_t* bits;        // (B * C * Ld, dim)
  const float* sg;            // (B * C * Ld)
  const int8_t* mg;           // (B * C * Ld)
  const float* w;             // (4)
  float* out;                 // (B, C)
  int B, Lq, C, Ld, dim;
  int tiles_per_cand;         // ceil(Ld / 64)
  int cands_per_block;
};

// The k order: value j (< 4) of lane c's slots in k-step ks (A fragment k
// positions 2c, 2c + 1, 2c + 8, 2c + 9) is this dim of the row. Lane c's
// unit i of a row (bytes 8 (4 i + c) ..) holds k-steps 2 i and 2 i + 1.
__device__ __forceinline__ int dim_of(int ks, int c, int j) {
  return 32 * (ks >> 1) + 8 * c + 4 * (ks & 1) + j;
}

// bf16(a) in the low half, bf16(b) in the high half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x as hi = bf16(x) and lo = x - hi, both as floats: pack_bf16 rounds lo
// to bf16 (hi is one already)
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = x - hi;
}

// the 4 ids (bytes) of a word, each clamped to 3, looked up in the 4-entry
// bf16 table t (entry k at bytes 2k, 2k + 1 of t.x | t.y): ids 0 and 1 in
// .x, 2 and 3 in .y, the lower id in the low half
__device__ __forceinline__ uint2 lookup(uint32_t ids, uint2 t) {
  const uint32_t d = __vminu4(ids, 0x03030303u) << 1;   // bytes 2 id
  const uint32_t s = d | ((d + 0x01010101u) << 4);       // nibbles 2 id, +1
  return make_uint2(__byte_perm(t.x, t.y, s),
                    __byte_perm(t.x, t.y, s >> 16));
}

// The query's bf16 parts as the MMA's NC columns: column n, 16-byte chunk k
// (k positions 8 (k & 1) .. + 7 of k-step k >> 1) of part buffers hi and lo,
// each two 128-byte k-panels of NC rows (chunk k & 7 of panel k >> 3 at
// (k ^ n) & 7, the 128-byte swizzle); zeros past Lq and past dim
template <int NC>
__device__ __forceinline__ void stage_query(unsigned char* hi,
                                            unsigned char* lo,
                                            const float* q, int Lq, int dim,
                                            int tid) {
  for (int i = tid; i < NC * 16; i += kThreads) {
    const int n = i >> 4, k = i & 15, ks = k >> 1, half = k & 1;
    uint32_t h[4], l[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float vh[2], vl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = dim_of(ks, c, 2 * half + e);
        split(n < Lq && d < dim ? q[n * dim + d] : 0.f, vh[e], vl[e]);
      }
      h[c] = pack_bf16(vh[0], vh[1]);
      l[c] = pack_bf16(vl[0], vl[1]);
    }
    const int off = (k >> 3) * NC * 128 + n * 128 + (((k ^ n) & 7) << 4);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// 0: a scored row, 1: a masked one (-9999), 2: past the candidate (-inf)
__device__ __forceinline__ float fill(float v, int kind) {
  return kind == 0 ? v : kind == 1 ? kNegFill : __int_as_float(0xff800000);
}

template <int NC>
__global__ void __launch_bounds__(kThreads) lut_maxsim_kernel(const Args a) {
  constexpr int NA = NC / 2;        // accumulators a thread
  constexpr int NM = NC / 4;        // columns a thread keeps the max of
  constexpr int kPart = 2 * NC * 128;                   // a staged part
  extern __shared__ unsigned char smem_raw[];
  // the swizzle's 8-row atoms must start at 1024-byte boundaries
  unsigned char* qhi =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qlo = qhi + kPart;
  // [2][4][NC]: each warp's column maxima of a candidate, by its parity
  float* red = reinterpret_cast<float*>(qlo + kPart);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int ranges = (a.C + a.cands_per_block - 1) / a.cands_per_block;
  const int b = blockIdx.x / ranges;
  const int c0 = (blockIdx.x - b * ranges) * a.cands_per_block;
  const int tpc = a.tiles_per_cand;
  const int T = min(a.cands_per_block, a.C - c0) * tpc;    // tiles
  // the block's first token row (below 2^31: the host checks)
  const int row0 = (b * a.C + c0) * a.Ld;
  const int r0 = 16 * warp + g;     // this thread's rows r0, r0 + 8

  // the weights' two bf16 tables
  uint2 thi, tlo;
  {
    float h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a.w[i], h[i], l[i]);
    thi = make_uint2(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
    tlo = make_uint2(pack_bf16(l[0], l[1]), pack_bf16(l[2], l[3]));
  }

  // What this thread reads of tile k (its rows r0 and r0 + 8), loaded a
  // tile ahead: each row's kind (fill's) and, of a scored row only, its
  // ids (zeros past dim), its scale and, where the registers allow it
  // (N <= 32), the centroid scores that start the accumulator; at N > 32
  // those load at the tile's start. Measured on the H100 against a copy
  // that preloads them at every N: at N = 64 that takes 197 registers (2
  // blocks an SM instead of 3) and is 19-31 % slower, at N = 128 it spills
  // and is 18-24 % slower. A masked row scores -9999 whatever its ids,
  // scores and scale hold, so they are not read: against loading them, 4 %
  // faster at C = 1,024 and 9 % at C = 200 (B=32, Lq=32, Ld=64, 30 % of
  // the rows masked), though the ids wait on the mask's load; loading the
  // masks a further tile ahead to spare that wait measured 8 % slower.
  constexpr bool kAhead = NC <= 32;
  uint2 raw[2][kUnits];
  int kind[2];
  float sc[2], cq[NA];
  // tile k's centroid scores: [4s + 2h + e] is row r0 + 8h, column
  // 8s + 2c + e, the accumulator's layout; zeros past Lq and in rows not
  // scored
  auto load_scores = [&](int k, float (&dst)[NA]) {
    const int ci = k / tpc, l0 = (k - ci * tpc) * kRows + r0;
    const float* cs = a.cqg + static_cast<size_t>(row0 + ci * a.Ld) * a.Lq;
#pragma unroll
    for (int s = 0; s < NC / 8; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * s + 2 * c + e, l = l0 + 8 * h;
          dst[4 * s + 2 * h + e] =
              kind[h] == 0 && col < a.Lq
                  ? __ldg(cs + static_cast<size_t>(l) * a.Lq + col)
                  : 0.f;
        }
  };
  auto load_tile = [&](int k) {
    const int ci = k / tpc, l0 = (k - ci * tpc) * kRows + r0;
    const int rc = row0 + ci * a.Ld;          // the candidate's first row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = l0 + 8 * h;
      const bool live = k < T && l < a.Ld;
      kind[h] = live ? (a.mg[rc + l] != 0 ? 0 : 1) : 2;
      sc[h] = kind[h] == 0 ? __ldg(a.sg + rc + l) : 0.f;
      const uint8_t* row = a.bits + static_cast<size_t>(rc + l) * a.dim;
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        const int byte = 8 * (4 * i + c);
        raw[h][i] = kind[h] == 0 && byte < a.dim
                        ? __ldg(reinterpret_cast<const uint2*>(row + byte))
                        : make_uint2(0, 0);
      }
    }
    if constexpr (kAhead) load_scores(k, cq);
  };

  const float neg_inf = __int_as_float(0xff800000);
  const uint32_t shi = smem_addr(qhi), slo = smem_addr(qlo);
  float acc[NA];
  float m[NM];
#pragma unroll
  for (int i = 0; i < NM; ++i) m[i] = neg_inf;
  load_tile(0);                     // in flight while the query is staged
  stage_query<NC>(qhi, qlo, a.q + static_cast<size_t>(b) * a.Lq * a.dim,
                  a.Lq, a.dim, tid);
  summary_tile::fence_async_smem();
  __syncthreads();
  int ci = 0, j = 0;                // the tile's candidate and its part
  for (int k = 0; k < T; ++k) {
    const int kd[2] = {kind[0], kind[1]};
    const float sk[2] = {sc[0], sc[1]};
    // the accumulator starts at the centroid scores
    if constexpr (kAhead) {
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = cq[i];
    } else {
      load_scores(k, acc);
    }
    // the weights of this tile's ids, both tables: A fragments of rows r0
    // (a0, a2) and r0 + 8 (a1, a3), values 0, 1 (a0, a1) and 2, 3 (a2, a3)
    // of the k-step's word
    uint32_t Ahi[8][4], Alo[8][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint2 vh[2], vl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t word = ks & 1 ? raw[h][ks >> 1].y : raw[h][ks >> 1].x;
        vh[h] = lookup(word, thi);
        vl[h] = lookup(word, tlo);
      }
      Ahi[ks][0] = vh[0].x, Ahi[ks][1] = vh[1].x;
      Ahi[ks][2] = vh[0].y, Ahi[ks][3] = vh[1].y;
      Alo[ks][0] = vl[0].x, Alo[ks][1] = vl[1].x;
      Alo[ks][2] = vl[0].y, Alo[ks][3] = vl[1].y;
    }
    load_tile(k + 1);               // in flight while this tile multiplies

    // + w_lo q_hi + w_hi q_lo + w_hi q_hi, 8 k-steps each
    mma_tile::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      summary_tile::wgmma_rs<NC>(
          acc, Alo[ks],
          summary_tile::sw128_desc(shi + (ks >> 2) * NC * 128 + (ks & 3) * 32),
          1);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      summary_tile::wgmma_rs<NC>(
          acc, Ahi[ks],
          summary_tile::sw128_desc(slo + (ks >> 2) * NC * 128 + (ks & 3) * 32),
          1);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      summary_tile::wgmma_rs<NC>(
          acc, Ahi[ks],
          summary_tile::sw128_desc(shi + (ks >> 2) * NC * 128 + (ks & 3) * 32),
          1);
    mma_tile::wgmma_commit();
    mma_tile::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NA; ++i) summary_tile::fence_operand(acc[i]);

#pragma unroll
    for (int s = 0; s < NC / 8; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        m[2 * s + e] =
            fmaxf(m[2 * s + e],
                  fmaxf(fill(acc[4 * s + e] * sk[0], kd[0]),
                        fill(acc[4 * s + 2 + e] * sk[1], kd[1])));
    if (++j < tpc) continue;

    // candidate c0 + ci ends: the max over its rows, then the sum over Lq
    float* rd = red + (ci & 1) * 4 * NC;
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      float v = m[i];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
      m[i] = neg_inf;
      if (g == 0) rd[warp * NC + 8 * (i >> 1) + 2 * c + (i & 1)] = v;
    }
    // red's other half was last read before every warp reached this
    // barrier one candidate ago
    __syncthreads();
    if (warp == 0) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < (NC + 31) / 32; ++i) {
        const int col = 32 * i + lane;
        if (col < NC && col < a.Lq)
          sum += fmaxf(fmaxf(rd[col], rd[NC + col]),
                       fmaxf(rd[2 * NC + col], rd[3 * NC + col]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) a.out[static_cast<size_t>(b) * a.C + c0 + ci] = sum;
    }
    ++ci;
    j = 0;
  }
}

template <int NC>
int launch(const Args& a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.B) * a.C * a.Ld;
  const long long blocks =
      static_cast<long long>(a.B) *
      ((a.C + a.cands_per_block - 1) / a.cands_per_block);
  if (a.Lq > NC || a.tiles_per_cand != (a.Ld + kRows - 1) / kRows ||
      a.cands_per_block < 1 || rows + kRows > INT_MAX || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 1024 + static_cast<size_t>(2) * 2 * NC * 128 +
                      sizeof(float) * 2 * 4 * NC;
  auto kernel = lut_maxsim_kernel<NC>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). The plan's ints (cols,
// tiles_per_cand, cands_per_block) come from ops/stage2.py::candidate_plan.
// Returns the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue when the shapes or the plan are refused); launches
// nothing when B or C is 0.
extern "C" int ravqa_residual_lut_maxsim(const void* q, const void* cqg,
                                         const void* bits, const void* sg,
                                         const void* mg, const void* w,
                                         void* out, int B, int Lq, int C,
                                         int Ld, int dim, int cols,
                                         int tiles_per_cand,
                                         int cands_per_block, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (Lq <= 0 || Lq > kMaxLq || Ld <= 0 || dim <= 0 || dim % 8 ||
      dim > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = static_cast<const float*>(q);
  a.cqg = static_cast<const float*>(cqg);
  a.bits = static_cast<const uint8_t*>(bits);
  a.sg = static_cast<const float*>(sg);
  a.mg = static_cast<const int8_t*>(mg);
  a.w = static_cast<const float*>(w);
  a.out = static_cast<float*>(out);
  a.B = B, a.Lq = Lq, a.C = C, a.Ld = Ld, a.dim = dim;
  a.tiles_per_cand = tiles_per_cand;
  a.cands_per_block = cands_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 128: return launch<128>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
