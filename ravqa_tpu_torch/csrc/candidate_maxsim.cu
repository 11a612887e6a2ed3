// MaxSim over pre-gathered candidate tokens on Hopper's tensor cores (X2,
// and X3 by one launch per query).
//
// Replaces scripts/exp_residual_stage2.py::maxsim_candidates_pallas (body
// _cand_kernel) and, launched once per query with B = 1,
// v_record_perq_pallas (body _perq_kernel, the same function):
//
//   out[b, c] = sum_t max_l s(b, c, l, t)
//   s(b, c, l, t) = sum_d tok[b, c, l, d] q[b, t, d]   if mask[b, c, l] != 0
//                 = -9999                             otherwise
//
// bf16 tokens and queries, float32 products (exact) and sums; the running
// maximum over Ld starts at -inf, so a candidate with no valid token
// scores exactly -9999 * Lq.
//
// What bounds it on this card: the tokens are read once. At the
// experiment's shape (B=32, C=1024, Ld=64, Lq=32, dim=128) that is 537 MB
// against 1.7e10 FLOP, 32 operations per byte, under the 295 at which bf16
// tensor cores would be the limit: bytes bound the function (0.16 ms at
// 3.35 TB/s). So the design streams the tokens at the memory's rate and
// fills the card at B = 32 and at B = 1 alike; idle MMA columns cost
// nothing that matters, an idle SM would.
//
// Design (X1, residual_lut_maxsim.cu, takes the same grid and epilogue):
//  - a tile is 64 token rows of one candidate, one TMA box (per 128-byte
//    k-panel) of the contiguous (B * C * Ld, dim) tokens, into a 4-stage
//    mbarrier ring; a candidate longer than 64 tokens spans several tiles,
//    and rows of a tile past its candidate are dropped (none at Ld = 64);
//  - the tiles are the MMA's rows and the query's tokens its columns (N =
//    16, 32, 64 or 128, the least that covers Lq), staged once per block
//    (summary_tile.cuh's stage_bf16); bf16 wgmma m64nNk16 with both
//    operands in shared memory, 8 k-steps at dim 128;
//  - epilogue: the mask selects -9999 per row (-inf for a dropped row);
//    each thread keeps, per column it owns, the max over its two rows of
//    every tile of the candidate; at the candidate's end shuffles over
//    lanes ^4, ^8, ^16 take the max over the warp's 16 rows, shared memory
//    over the 4 warps, and warp 0 sums the Lq columns in a fixed order
//    (lane l's columns l, l + 32, .. in turn, then a shuffle tree): repeats
//    are bit for bit;
//  - grid (ops/stage2.py::candidate_plan): one block per (query, range of
//    cands_per_block candidates), so a B = 1 launch at C = 256 still has
//    256 blocks for 132 SMs. The other orientation (query tokens as rows,
//    mma_tile.cuh) would leave 75 % of the MMA's 64 rows idle at Lq = 32.
//
// Every tile's wgmmas run in straight code and are waited for before the
// epilogue (ptxas serializes a wgmma in a branch or in flight across a
// loop's back edge); two or three blocks an SM, by shared memory, overlap
// one block's epilogue with another's products and copies.
//
// Inputs, all contiguous: q (B, Lq, dim) bf16; tok (B, C, Ld, dim) bf16,
// 16-byte aligned; mask (B, C, Ld) int8; out (B, C) float. 0 < Lq <= 128,
// Ld > 0, dim % 8 == 0, dim <= 128. The Python wrapper checks.

#include "summary_tile.cuh"

namespace {

using summary_tile::kRows;       // token rows a tile (the MMA's M)
using summary_tile::kStages;
using summary_tile::kThreads;    // one warpgroup
using summary_tile::smem_addr;

constexpr int kPanels = 2;       // 128-byte k-panels of a row: dim <= 128
constexpr int kTile = kPanels * kRows * 128;
constexpr int kMaxDim = 128;
constexpr float kNegFill = -9999.0f;

struct Args {
  const __nv_bfloat16* q;     // (B, Lq, dim)
  const int8_t* mask;         // (B * C * Ld)
  float* out;                 // (B, C)
  int B, Lq, C, Ld, dim;
  int tiles_per_cand;         // ceil(Ld / 64)
  int cands_per_block;
};

// 0: a scored row, 1: a masked one (-9999), 2: past the candidate (-inf)
__device__ __forceinline__ float fill(float v, int kind) {
  return kind == 0 ? v : kind == 1 ? kNegFill : __int_as_float(0xff800000);
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
candidate_kernel(const Args a, const __grid_constant__ CUtensorMap map) {
  constexpr int NA = NC / 2;        // accumulators a thread
  constexpr int NM = NC / 4;        // columns a thread keeps the max of
  extern __shared__ unsigned char smem_raw[];
  // the swizzle's 8-row atoms must start at 1024-byte boundaries
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qbuf = base + kStages * kTile;
  // [4][NC]: each warp's column maxima of a candidate
  float* red = reinterpret_cast<float*>(qbuf + kPanels * NC * 128);
  const uint32_t bars = smem_addr(red + 4 * NC);          // [kStages]
  const uint32_t ring = smem_addr(base);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int ranges = (a.C + a.cands_per_block - 1) / a.cands_per_block;
  const int b = blockIdx.x / ranges;
  const int c0 = (blockIdx.x - b * ranges) * a.cands_per_block;
  const int tpc = a.tiles_per_cand;
  const int T = min(a.cands_per_block, a.C - c0) * tpc;    // tiles
  const int panels = (a.dim * 2 + 127) / 128;
  // the block's first token row (below 2^31: the host checks)
  const int row0 = (b * a.C + c0) * a.Ld;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mma_tile::mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  summary_tile::zero_unloaded_panels<kPanels>(base, panels, tid);
  // the query's tokens as the MMA's columns, zeros past Lq and dim
  const __nv_bfloat16* qb = a.q + static_cast<size_t>(b) * a.Lq * a.dim;
  for (int i = tid; i < NC * 16; i += kThreads) {
    const int col = i >> 4;
    summary_tile::stage_bf16<NC>(
        qbuf, col, i & 15, col < a.Lq ? qb + col * a.dim : nullptr, a.dim);
  }
  summary_tile::fence_async_smem();
  __syncthreads();

  // tile k of the block (candidate k / tpc, rows 64 (k % tpc) ..) into
  // stage k % kStages
  auto load = [&](int k) {
    if (tid != 0 || k >= T) return;
    const int ci = k / tpc;
    const uint32_t bar = bars + 8 * (k % kStages);
    const uint32_t st = ring + (k % kStages) * kTile;
    const int row = row0 + ci * a.Ld + (k - ci * tpc) * kRows;
    mma_tile::mbar_expect_tx(bar, panels * kRows * 128);
    for (int pn = 0; pn < panels; ++pn)
      mma_tile::tma_load_2d(st + pn * kRows * 128, &map, pn * 64, row, bar);
  };
  for (int k = 0; k < kStages; ++k) load(k);

  const float neg_inf = __int_as_float(0xff800000);
  const int r0 = 16 * warp + g;     // this thread's rows r0, r0 + 8
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  float m[NM];
#pragma unroll
  for (int i = 0; i < NM; ++i) m[i] = neg_inf;
  int ci = 0, j = 0;                // the tile's candidate and its part
  for (int k = 0; k < T; ++k) {
    // the two rows' kinds, read while the tile lands
    const int8_t* mk = a.mask + row0 + ci * a.Ld;
    int kind[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = j * kRows + r0 + 8 * h;
      kind[h] = l >= a.Ld ? 2 : mk[l] != 0 ? 0 : 1;
    }
    mma_tile::mbar_wait(bars + 8 * (k % kStages), (k / kStages) & 1);
    summary_tile::product_bf16_ss<NC>(acc, base + (k % kStages) * kTile,
                                      qbuf);
    __syncthreads();                // every thread is done with the stage
    load(k + kStages);
    // accumulator of slab s (columns 8s .. 8s + 7): [4s], [4s + 1] row r0,
    // columns 8s + 2c, 8s + 2c + 1; [4s + 2], [4s + 3] row r0 + 8
#pragma unroll
    for (int s = 0; s < NC / 8; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        m[2 * s + e] = fmaxf(m[2 * s + e],
                             fmaxf(fill(acc[4 * s + e], kind[0]),
                                   fill(acc[4 * s + 2 + e], kind[1])));
    if (++j < tpc) continue;

    // candidate c0 + ci ends: the max over its rows, then the sum over Lq
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      float v = m[i];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
      m[i] = neg_inf;
      if (g == 0) red[warp * NC + 8 * (i >> 1) + 2 * c + (i & 1)] = v;
    }
    __syncthreads();
    if (warp == 0) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < (NC + 31) / 32; ++i) {
        const int col = 32 * i + lane;
        if (col < NC && col < a.Lq)
          sum += fmaxf(fmaxf(red[col], red[NC + col]),
                       fmaxf(red[2 * NC + col], red[3 * NC + col]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) a.out[static_cast<size_t>(b) * a.C + c0 + ci] = sum;
    }
    // red is written again only after the next tile's __syncthreads
    ++ci;
    j = 0;
  }
}

template <int NC>
int launch(const Args& a, const void* tok, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.B) * a.C * a.Ld;
  const long long blocks =
      static_cast<long long>(a.B) *
      ((a.C + a.cands_per_block - 1) / a.cands_per_block);
  if (a.Lq > NC || a.tiles_per_cand != (a.Ld + kRows - 1) / kRows ||
      a.cands_per_block < 1 || rows + kRows > INT_MAX || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  int err = mma_tile::encode_map_2d(&map, tok, 2, a.dim, rows, kRows);
  if (err) return err;
  const size_t smem = 1024 + static_cast<size_t>(kStages) * kTile +
                      static_cast<size_t>(kPanels) * NC * 128 +
                      sizeof(float) * 4 * NC + 8 * kStages;
  auto kernel = candidate_kernel<NC>;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a, map);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). The plan's ints (cols,
// tiles_per_cand, cands_per_block) come from ops/stage2.py::candidate_plan.
// Returns the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue when the shapes or the plan are refused); launches
// nothing when B or C is 0.
extern "C" int ravqa_candidate_maxsim(const void* q, const void* tok,
                                      const void* mask, void* out, int B,
                                      int Lq, int C, int Ld, int dim,
                                      int cols, int tiles_per_cand,
                                      int cands_per_block, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (Lq <= 0 || Ld <= 0 || dim <= 0 || dim % 8 || dim > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.mask = static_cast<const int8_t*>(mask);
  a.out = static_cast<float*>(out);
  a.B = B, a.Lq = Lq, a.C = C, a.Ld = Ld, a.dim = dim;
  a.tiles_per_cand = tiles_per_cand;
  a.cands_per_block = cands_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 16: return launch<16>(a, tok, s);
    case 32: return launch<32>(a, tok, s);
    case 64: return launch<64>(a, tok, s);
    case 128: return launch<128>(a, tok, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
