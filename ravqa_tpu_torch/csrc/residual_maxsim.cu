// Fused residual decompress + MaxSim over per-query candidates on Hopper's
// tensor cores (K6).
//
// Replaces ravqa_tpu/ops/residual.py::maxsim_residual_pallas (body
// _residual_maxsim_kernel). Each query b scores its own candidate docs
// cand[b, :] straight from their packed residual records,
//
//   out[b, c] = sum_t max_l s(b, t, l)              (doc n = cand[b, c])
//   s(b, t, l) = (cs[b, code, t] + sum_d w[bucket(n, l, d)] q[b, t, d])
//                * scale(n, l)                      if scale(n, l) > 0
//              = -9999                              otherwise
//
// at the TPU kernel's precision: q and the bucket weights in bf16, every
// sum in float32; cs is the per-query centroid-score table in bf16 (the
// flat codec's centroids . q, or the factored codec's coarse rows then fine
// rows, whose terms cs[hi] + cs[k1 + lo] are summed in float32); scale is
// the record's bf16 reconstruction-norm scale times the doc's mask. The
// running max over Ld starts at -inf.
//
// Record row n (pack_records): Ld uint16 codes, Ld bf16 scales, then Ld x P
// residual bytes, P = dim * nbits / 8, planar: plane p of byte j is dim
// p * P + j, bits p * nbits .. p * nbits + nbits - 1.
//
// What bounds it on this card: the records. At the 1M fine-stage shape
// (B=32, C=256, Ld=64, Lq=32, dim=128, nbits 2) the residual products are
// 2.1e9 multiply-adds over 19 MB of records: 5.6 us of bytes against 4 us
// of bf16 tensor-core work. The CUDA-core kernel this replaces ran one
// block per (query, 16 candidates) and staged the query and the whole
// centroid-score table in every block, 16 times per query at C = 256, with
// two-byte loads; its products ran at a tenth of the float32 rate.
//
// The design:
//  - the residual term on wgmma (m64n64k16 bf16 -> f32): the decoded
//    bucket weights are exact in bf16 and the TPU kernel multiplies them
//    with the bf16 query too, so only the order of the f32 sum changes.
//    Query tokens are the MMA's rows, held in registers as A for the
//    block's whole sweep (one m64 tile for Lq <= 64, two for Lq <= 128; at
//    Lq = 32 half a tile idles, and its epilogue is skipped); candidate
//    tokens are the columns, 64 a chunk;
//  - a warpgroup scores one query's run of cands candidates
//    (ops/residual.py::residual_plan: about four runs per SM over the
//    batch), a block two runs of the same query, so the query's fragments
//    and the candidate ids are staged once per run, the centroid-score
//    table once per block with 16-byte loads, not once per 16 candidates;
//    each warpgroup steps through its chunks on its own barrier;
//  - the threads decode each chunk's 64 token rows from the records (read
//    by candidate id, no gathered copy, 8 bytes a load) into wgmma's
//    K-major 128-byte swizzle layout, two bucket weights per lookup, while
//    the tensor cores multiply the previous chunk (two buffers); the raw
//    bytes of the chunk after are loaded into registers one chunk ahead,
//    so their latency hides behind an epilogue. (The threads' latency, not
//    bytes or products, held back the first version of this design, which
//    loaded and decoded each chunk in one step. What holds this one back
//    is still the threads' work per chunk: the decode and the epilogue
//    are some 700 instructions a thread against 8 wgmmas, at ~190
//    registers a thread, one block of two warpgroups an SM; capping the
//    registers for two blocks measured slower.)
//  - the epilogue adds the centroid term by lookup and applies the scale,
//    per column: each column's table offsets and (scale, fill) are worked
//    out once at decode, the table holds bf16 pairs of rows t and t + 8 so
//    one 32-bit load serves both of a thread's rows, and a score is
//    fma(cterm + dot, w, add): (scale, 0) for a valid token, (0, -9999) for
//    a masked one, (0, -inf) off the candidate;
//  - candidates are padded to doc_cols = Ld rounded up to 8 columns, so an
//    8-column slab never straddles two candidates: the max over a
//    candidate's tokens is a running max in registers plus two shuffles,
//    carried across chunks (Ld = 220 spans four), and the sum over Lq runs
//    once per candidate, one warp per candidate, in a fixed order, so
//    results repeat bit for bit.
// Any C works. The table (rows x Lq bf16) must fit shared memory beside the
// buffers: a flat codec of 1,024 centroids fits at Lq <= 64.
//
// Inputs, all contiguous: q (B, Lq, dim) bf16; cs (B, rows, Lq) bf16;
// records (N, Ld * (4 + P)) uint8; cand (B, C) int32 (clamped to [0, N));
// mask (N, Ld) int8; w (2^nbits,) float (bf16 values); out (B, C) float.
// 0 < Lq <= 128, dim % 8 == 0, dim <= 128, nbits 2, 4 or 8; k2 a power of
// two when k1 > 0. The Python wrapper checks.

#include "mma_tile.cuh"

namespace {

using mma_tile::kNegFill;

constexpr int kWg = 128;            // threads of a warpgroup
constexpr int kCols = 64;           // candidate tokens (MMA columns) a chunk
constexpr int kKSteps = 8;          // k-steps of 16 values: dim <= 128
constexpr int kPanel = kCols * 128;  // one 128-byte k-panel of a chunk
constexpr int kChunkBytes = 2 * kPanel;
constexpr int kMaxCands = 64;       // candidates per warpgroup, most
constexpr size_t kMaxSmem = 232448;

// what a column needs to score: the centroid-score table's word offsets of
// its code's rows (coarse, fine; fine unused for a flat codec) and the
// score's fma factors
struct Col {
  int off1, off2;
  float w, add;
};

// 32-bit words per code in the centroid-score table: bf16 pairs of rows
// (t, t + 8) for t < Lq rounded up to 16, padded off multiples of 32 words
// so the four codes a warp looks up at once spread over the banks
__host__ __device__ inline int table_words(int Lq) {
  const int w = (Lq + 15) / 16 * 8;
  return w % 32 ? w : w + 8;
}

struct Layout {
  size_t cols, ends, cand, rowmax, region, w16, wpair, cs, total;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// shared memory of a block of wgs warpgroups: each warpgroup's region (its
// two 1024-byte aligned chunk buffers, then the offsets below inside the
// region), then the block's tables
__host__ __device__ inline Layout layout(int wgs, int Lq, int rows,
                                         int cands) {
  Layout L;
  L.cols = 2 * kChunkBytes;
  L.ends = L.cols + align16(sizeof(Col) * 2 * kCols);
  L.cand = L.ends + align16(sizeof(int) * 2 * 8);
  L.rowmax = L.cand + align16(sizeof(int) * kMaxCands);
  L.region = (L.rowmax + sizeof(float) * cands * Lq + 1023) & ~size_t(1023);
  L.w16 = wgs * L.region;
  L.wpair = L.w16 + align16(sizeof(uint16_t) * 256);
  L.cs = L.wpair + align16(sizeof(uint32_t) * 256);
  L.total = 1024 + L.cs + sizeof(uint32_t) * rows * table_words(Lq);
  return L;
}

// the warpgroup's own barrier (named barrier 1 + wg of 128 threads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(kWg) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// MT m-tiles of query rows (Lq <= 64 MT), NB bits per residual value, WG
// warpgroups a block
template <int MT, int NB, int WG>
__global__ void __launch_bounds__(WG * kWg)
residual_maxsim_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ cs,
                       const uint8_t* __restrict__ records,
                       const int* __restrict__ cand,
                       const int8_t* __restrict__ mask,
                       const float* __restrict__ wts,
                       float* __restrict__ out, int Lq, int C, int N, int Ld,
                       int dim, int rows, int k1, int k2, int cands) {
  constexpr int kPerByte = 8 / NB;
  constexpr int kMask = (1 << NB) - 1;
  constexpr int kThreads = WG * kWg;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle's 8-row atoms must start at 1024-byte boundaries
  unsigned char* base = smem_raw +
      ((1024 - (static_cast<unsigned>(__cvta_generic_to_shared(smem_raw)) &
                1023)) & 1023);
  const Layout L = layout(WG, Lq, rows, cands);
  const int wg = threadIdx.x / kWg;
  unsigned char* own = base + wg * L.region;                    // this wg's
  Col* colbuf = reinterpret_cast<Col*>(own + L.cols);           // [2][64]
  int* endbuf = reinterpret_cast<int*>(own + L.ends);           // [2][8]
  int* candS = reinterpret_cast<int*>(own + L.cand);            // [cands]
  float* rowmax = reinterpret_cast<float*>(own + L.rowmax);     // [cands][Lq]
  uint16_t* w16 = reinterpret_cast<uint16_t*>(base + L.w16);    // [256]
  uint32_t* wpair = reinterpret_cast<uint32_t*>(base + L.wpair);  // [256]
  uint32_t* csS = reinterpret_cast<uint32_t*>(base + L.cs);  // [rows][SW]
  const uint32_t buf_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(own));

  // tid: the thread in its warpgroup; warp: the warp in its warpgroup
  const int tid = threadIdx.x % kWg, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  // block x holds query x / per_query's runs WG (x % per_query) .. + WG
  // - 1, a run of cands candidates a warpgroup
  const int splits = (C + cands - 1) / cands;
  const int per_query = (splits + WG - 1) / WG;
  const int b = blockIdx.x / per_query;
  const int c0 = ((blockIdx.x % per_query) * WG + wg) * cands;
  const int ct = min(cands, C - c0);       // <= 0: an idle warpgroup
  const int P = dim * NB / 8;              // residual bytes per token
  const size_t RB = static_cast<size_t>(Ld) * (4 + P);
  const int dc = (Ld + 7) / 8 * 8;         // columns per candidate
  const int n_chunks = (ct * dc + kCols - 1) / kCols;
  const int SW = table_words(Lq);
  const float neg_inf = __int_as_float(0xff800000);
  // 8-byte residual loads: every token's bytes start 8-byte aligned
  const bool fast = dim == 128 && P % 8 == 0 && Ld % 2 == 0 &&
                    (reinterpret_cast<uintptr_t>(records) & 7) == 0;

  // the warpgroup's candidate ids, clamped to [0, N)
  const int* cb = cand + static_cast<size_t>(b) * C + c0;
  for (int i = tid; i < ct; i += kWg) candS[i] = min(max(cb[i], 0), N - 1);

  // the bucket weights as bf16 bits, singly and in pairs (low half the
  // first), and the centroid-score table as bf16 pairs of rows (t, t + 8)
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    w16[i] = __bfloat16_as_ushort(__float2bfloat16(wts[i & kMask]));
    if (NB < 8) {
      const int lo = i & kMask, hi = (i >> NB) & kMask;
      wpair[i] = __bfloat16_as_ushort(__float2bfloat16(wts[lo])) |
                 static_cast<uint32_t>(__bfloat16_as_ushort(
                     __float2bfloat16(wts[hi]))) << 16;
    }
  }
  const __nv_bfloat16* csb = cs + static_cast<size_t>(b) * rows * Lq;
  const int nblk = (Lq + 15) / 16;
  if (Lq % 8 == 0 && (reinterpret_cast<uintptr_t>(csb) & 15) == 0) {
    for (int i = threadIdx.x; i < rows * nblk; i += kThreads) {
      const int k = i / nblk, t0 = (i - k * nblk) * 16;
      const uint4* src = reinterpret_cast<const uint4*>(
          csb + static_cast<size_t>(k) * Lq + t0);
      const uint4 z = make_uint4(0, 0, 0, 0);
      const uint4 lo = src[0], hi = t0 + 8 < Lq ? src[1] : z;
      uint4* dst = reinterpret_cast<uint4*>(csS + k * SW + t0 / 2);
      dst[0] = make_uint4(__byte_perm(lo.x, hi.x, 0x5410),
                          __byte_perm(lo.x, hi.x, 0x7632),
                          __byte_perm(lo.y, hi.y, 0x5410),
                          __byte_perm(lo.y, hi.y, 0x7632));
      dst[1] = make_uint4(__byte_perm(lo.z, hi.z, 0x5410),
                          __byte_perm(lo.z, hi.z, 0x7632),
                          __byte_perm(lo.w, hi.w, 0x5410),
                          __byte_perm(lo.w, hi.w, 0x7632));
    }
  } else {
    const uint16_t* cs16 = reinterpret_cast<const uint16_t*>(csb);
    for (int i = threadIdx.x; i < rows * nblk * 8; i += kThreads) {
      const int k = i / (nblk * 8), p = i - k * nblk * 8;
      const int t = p / 8 * 16 + p % 8;
      const uint32_t lo = t < Lq ? cs16[static_cast<size_t>(k) * Lq + t] : 0;
      const uint32_t hi =
          t + 8 < Lq ? cs16[static_cast<size_t>(k) * Lq + t + 8] : 0;
      csS[k * SW + p] = lo | hi << 16;
    }
  }

  // A fragments of the query (each warp holds 16 rows of an m64 tile):
  // a0 row g, a1 row g + 8, bytes 4c..4c+3 of the k-step's first half
  // (a0, a1) and second half (a2, a3); zero past Lq and past dim
  uint32_t A[MT][kKSteps][4];
  const unsigned char* qb = reinterpret_cast<const unsigned char*>(
      q + static_cast<size_t>(b) * Lq * dim);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = mt * 64 + warp * 16 + g + (i & 1) * 8;
        const int byte = ks * 32 + (i >> 1) * 16 + 4 * c;
        A[mt][ks][i] = row < Lq && byte < 2 * dim
                           ? *reinterpret_cast<const uint32_t*>(
                                 qb + static_cast<size_t>(row) * 2 * dim +
                                 byte)
                           : 0u;
      }

  // A chunk in two steps, so that its loads are in flight while the
  // previous chunk's epilogue runs. load: the raw bytes of chunk ch's 64
  // columns into registers (the facts of column tid for the first two
  // warps; on the fast path the residual bytes of this thread's items, 8
  // bytes of one token each). decode: from those registers, the columns'
  // facts into colbuf[ch & 1], the candidates ending at each 8-column slab
  // into endbuf[ch & 1], and the residual rows as bf16 bucket weights into
  // buffer ch & 1 (chunk k of row r of a 128-byte k-panel at chunk
  // (k ^ r) & 7).
  constexpr int kGroups = 128 * NB / 64;       // 8-byte groups a token
  constexpr int kItems = kCols * kGroups / kWg;
  struct Raw {
    uint2 res[kItems];
    uint32_t valid;                            // a bit per item
    int code, sbits, mval;                     // mval < 0: off the chunk
  };
  auto load = [&](int ch, Raw& x) {
    const int col0 = ch * kCols;
    if (tid < kCols) {
      const int col = col0 + tid, cl = col / dc, l = col - cl * dc;
      x.mval = -1;
      if (cl < ct && l < Ld) {
        const int id = candS[cl];
        const uint8_t* rec = records + static_cast<size_t>(id) * RB;
        x.code = rec[2 * l] | (rec[2 * l + 1] << 8);
        x.sbits = rec[2 * Ld + 2 * l] | (rec[2 * Ld + 2 * l + 1] << 8);
        x.mval = mask[static_cast<size_t>(id) * Ld + l] != 0;
      }
    }
    if (!fast) return;
    x.valid = 0;
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      const int i = tid + s * kWg, r = i / kGroups, m = i % kGroups;
      const int col = col0 + r, cl = col / dc, l = col - cl * dc;
      x.res[s] = make_uint2(0, 0);
      if (cl < ct && l < Ld) {
        x.res[s] = __ldg(reinterpret_cast<const uint2*>(
            records + static_cast<size_t>(candS[cl]) * RB + 4 * Ld +
            static_cast<size_t>(l) * P + 8 * m));
        x.valid |= 1u << s;
      }
    }
  };
  auto decode = [&](int ch, const Raw& x) {
    unsigned char* buf = own + (ch & 1) * kChunkBytes;
    const int col0 = ch * kCols;
    if (tid < kCols) {
      Col k{0, 0, 0.f, neg_inf};
      if (x.mval >= 0) {
        const float sc = __uint_as_float(static_cast<uint32_t>(x.sbits)
                                         << 16) * static_cast<float>(x.mval);
        // table rows of the code's centroid term; compress never writes a
        // code past the table, and the clamp keeps a corrupt one in bounds
        k.off1 = (k1 ? min(x.code / k2, k1 - 1) : min(x.code, rows - 1)) *
                 SW;
        k.off2 = k1 ? (k1 + x.code % k2) * SW : 0;
        k.w = sc > 0.f ? sc : 0.f;
        k.add = sc > 0.f ? 0.f : kNegFill;
      }
      colbuf[(ch & 1) * kCols + tid] = k;
    } else if (tid < kCols + 8) {
      // slab j ends candidate end / dc - 1 when end, its last column + 1,
      // is a multiple of doc_cols
      const int end = (ch * 8 + tid - kCols + 1) * 8;
      endbuf[(ch & 1) * 8 + tid - kCols] =
          end % dc == 0 && end / dc <= ct ? end / dc - 1 : -1;
    }
    if (fast) {
      // item (row r, byte group m): 8 residual bytes of one token give a
      // 16-byte chunk of every plane p: dims p * P + 8m .. + 7
#pragma unroll
      for (int s = 0; s < kItems; ++s) {
        const int i = tid + s * kWg, r = i / kGroups, m = i % kGroups;
#pragma unroll
        for (int p = 0; p < kPerByte; ++p) {
          const uint32_t lo = x.res[s].x >> (p * NB),
                         hi = x.res[s].y >> (p * NB);
          uint32_t v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t src = e < 2 ? lo : hi;
            const int sh = 16 * (e & 1);
            const uint32_t b0 = (src >> sh) & kMask,
                           b1 = (src >> (sh + 8)) & kMask;
            v[e] = NB < 8 ? wpair[b0 | b1 << NB]
                          : w16[b0] | static_cast<uint32_t>(w16[b1]) << 16;
          }
          if (!(x.valid >> s & 1)) v[0] = v[1] = v[2] = v[3] = 0;
          const int k = p * kGroups + m;        // 16-byte chunk of the row
          *reinterpret_cast<uint4*>(buf + (k >> 3) * kPanel + r * 128 +
                                    (((k & 7) ^ (r & 7)) << 4)) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    } else {
      // any dim, Ld and alignment: one 16-byte chunk (8 dims) an item,
      // each dim's bucket read on its own; zeros past dim
      for (int i = tid; i < kCols * 16; i += kWg) {
        const int r = i >> 4, k = i & 15;
        const int col = col0 + r, cl = col / dc, l = col - cl * dc;
        uint32_t v[4] = {0, 0, 0, 0};
        if (cl < ct && l < Ld) {
          const uint8_t* res = records +
                               static_cast<size_t>(candS[cl]) * RB + 4 * Ld +
                               static_cast<size_t>(l) * P;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int d = 8 * k + e;
            if (d < dim) {
              const int p = d / P, j = d - p * P;
              v[e >> 1] |= static_cast<uint32_t>(
                                w16[(res[j] >> (p * NB)) & kMask])
                           << (16 * (e & 1));
            }
          }
        }
        *reinterpret_cast<uint4*>(buf + (k >> 3) * kPanel + r * 128 +
                                  (((k & 7) ^ (r & 7)) << 4)) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    // the wgmmas read the buffer through the async proxy
    fence_async_smem();
  };

  float acc[MT][32];
  float m[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) m[mt][0] = m[mt][1] = neg_inf;
  // the pair word of this thread's rows (g, g + 8) in an m-tile's table
  const int pw = warp * 8 + g;

  __syncthreads();     // the tables and the candidate ids are staged
  if (ct <= 0) return;  // no more block-wide barriers below
  Raw x = {};
  load(0, x);
  decode(0, x);
  if (n_chunks > 1) load(1, x);
  wg_sync(wg);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const uint32_t st = buf_addr + (ch & 1) * kChunkBytes;
    // the chunk's products: every k-step into one accumulator per m-tile
    mma_tile::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const uint64_t desc = mma_tile::sw128_desc(st + (ks >> 2) * kPanel +
                                                 (ks & 3) * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_tile::wgmma_bf16(acc[mt], A[mt][ks], desc, ks > 0);
    }
    mma_tile::wgmma_commit();
    // the next chunk decodes while the tensor cores multiply this one, and
    // the one after it loads while this one's epilogue runs
    if (ch + 1 < n_chunks) decode(ch + 1, x);
    if (ch + 2 < n_chunks) load(ch + 2, x);
    mma_tile::wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) mma_tile::fence_operand(acc[mt][i]);

    // the epilogue: accumulator of slab j: [4j], [4j + 1] row g, columns
    // 2c, 2c + 1; [4j + 2], [4j + 3] row g + 8
    const Col* cbuf = colbuf + (ch & 1) * kCols;
    const int* ends = endbuf + (ch & 1) * 8;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt * 64 + warp * 16 >= Lq) continue;  // rows past Lq, warp-wide
      const uint32_t* tab = csS + mt * 32 + pw;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const Col k = cbuf[8 * j + 2 * c + e];
          uint32_t v = tab[k.off1];
          float t0 = __uint_as_float(v << 16), t1 = __uint_as_float(
                                                  v & 0xffff0000u);
          if (k2 > 0) {
            v = tab[k.off2];
            t0 += __uint_as_float(v << 16);
            t1 += __uint_as_float(v & 0xffff0000u);
          }
          m[mt][0] = fmaxf(m[mt][0],
                           fmaf(t0 + acc[mt][4 * j + e], k.w, k.add));
          m[mt][1] = fmaxf(m[mt][1],
                           fmaf(t1 + acc[mt][4 * j + 2 + e], k.w, k.add));
        }
        const int cl = ends[j];
        if (cl >= 0) {
          // the candidate ends here: max over the quad's columns
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = m[mt][h];
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
            const int t = mt * 64 + warp * 16 + g + 8 * h;
            if (c == 0 && t < Lq) rowmax[cl * Lq + t] = v;
            m[mt][h] = neg_inf;
          }
        }
      }
    }
    wg_sync(wg);   // the next buffer is in; this one's readers are done
  }

  // each candidate's sum over Lq: one warp a candidate, lane l adding rows
  // l, l + 32, ..., then a shuffle tree, a fixed order
  for (int cl = warp; cl < ct; cl += kWg / 32) {
    float total = 0.f;
    for (int t = lane; t < Lq; t += 32) total += rowmax[cl * Lq + t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, o);
    if (lane == 0) out[static_cast<size_t>(b) * C + c0 + cl] = total;
  }
}

template <int MT, int NB, int WG>
int launch_wg(const void* q, const void* cs, const void* records,
              const void* cand, const void* mask, const void* w, void* out,
              int B, int Lq, int C, int N, int Ld, int dim, int rows, int k1,
              int k2, int cands, cudaStream_t stream) {
  const size_t smem = layout(WG, Lq, rows, cands).total;
  auto kernel = residual_maxsim_kernel<MT, NB, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = (C + cands - 1) / cands;
  const long long blocks =
      static_cast<long long>(B) * ((splits + WG - 1) / WG);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), WG * kWg, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(cs),
      static_cast<const uint8_t*>(records), static_cast<const int*>(cand),
      static_cast<const int8_t*>(mask), static_cast<const float*>(w),
      static_cast<float*>(out), Lq, C, N, Ld, dim, rows, k1, k2, cands);
  return static_cast<int>(cudaGetLastError());
}

// two warpgroups a block where their buffers and the table fit shared
// memory (they share the table), else one
template <int MT, int NB>
int launch(const void* q, const void* cs, const void* records,
           const void* cand, const void* mask, const void* w, void* out,
           int B, int Lq, int C, int N, int Ld, int dim, int rows, int k1,
           int k2, int cands, cudaStream_t stream) {
  if (layout(2, Lq, rows, cands).total <= kMaxSmem)
    return launch_wg<MT, NB, 2>(q, cs, records, cand, mask, w, out, B, Lq,
                                C, N, Ld, dim, rows, k1, k2, cands, stream);
  if (layout(1, Lq, rows, cands).total <= kMaxSmem)
    return launch_wg<MT, NB, 1>(q, cs, records, cand, mask, w, out, B, Lq,
                                C, N, Ld, dim, rows, k1, k2, cands, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int MT>
int launch_nbits(int nbits, const void* q, const void* cs,
                 const void* records, const void* cand, const void* mask,
                 const void* w, void* out, int B, int Lq, int C, int N,
                 int Ld, int dim, int rows, int k1, int k2, int cands,
                 cudaStream_t s) {
  switch (nbits) {
    case 2:
      return launch<MT, 2>(q, cs, records, cand, mask, w, out, B, Lq, C, N,
                           Ld, dim, rows, k1, k2, cands, s);
    case 4:
      return launch<MT, 4>(q, cs, records, cand, mask, w, out, B, Lq, C, N,
                           Ld, dim, rows, k1, k2, cands, s);
    case 8:
      return launch<MT, 8>(q, cs, records, cand, mask, w, out, B, Lq, C, N,
                           Ld, dim, rows, k1, k2, cands, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface (loaded with ctypes). k1 = k2 = 0 for a flat codec
// (rows = K); k1 = k_coarse, k2 = k_fine (rows = k1 + k2) for a factored
// one; cands candidates per block (ops/residual.py::residual_plan, at most
// 64). Returns the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue when the shapes are refused or the cs table does
// not fit shared memory); launches nothing when B or C is 0.
extern "C" int ravqa_residual_maxsim(const void* q, const void* cs,
                                     const void* records, const void* cand,
                                     const void* mask, const void* w,
                                     void* out, int B, int Lq, int C, int N,
                                     int Ld, int dim, int nbits, int rows,
                                     int k1, int k2, int cands,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || C <= 0) return 0;
  if (Lq <= 0 || Lq > 128 || Ld <= 0 || N <= 0 || dim % 8 || dim <= 0 ||
      dim > 128 || rows <= 0 || cands < 1 || cands > kMaxCands ||
      (k1 > 0 && (k2 <= 0 || (k2 & (k2 - 1)))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Lq > 64)
    return launch_nbits<2>(nbits, q, cs, records, cand, mask, w, out, B, Lq,
                           C, N, Ld, dim, rows, k1, k2, cands, s);
  return launch_nbits<1>(nbits, q, cs, records, cand, mask, w, out, B, Lq, C,
                         N, Ld, dim, rows, k1, k2, cands, s);
}
