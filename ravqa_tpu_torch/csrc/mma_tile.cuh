// Exhaustive MaxSim on Hopper's tensor cores: the sweep shared by K1
// (maxsim_mma.cu: a bf16 index, or a float32 one read as two bf16 planes)
// and K5 (maxsim_int8.cu).
//
//   out[b, n] = sum_t w[b, t] * max_l s(b, t, n, l)
//
// where s is a query token's dot product with a doc token, or -9999 for an
// invalid doc token, and w is 1 (K1) or the query token's scale (K5). Each
// kernel's Op says how a dot product is multiplied (wgmma), how a column is
// marked invalid, and what weighs a query token.
//
// Orientation: query tokens are the MMA's rows (M) and doc tokens its
// columns (N), the reverse of the TPU kernel's. Then:
//  - the max over a doc's tokens is a max along N: each thread folds its two
//    columns of every 8-column slab into a running max in registers, and two
//    shuffles (lanes ^1, ^2) finish it when the doc ends;
//  - what a column needs to score (valid, masked or off the tile; K5's
//    doc-token scale) is worked out once per tile column by one thread,
//    into shared memory, while the previous tile multiplies: the epilogue
//    reads it there, not from device memory, and spends one select (K1) or
//    one fma (K5) per product on it;
//  - the sum over a query's tokens runs once per (query, doc), over
//    per-row maxima staged in shared memory, one warp per sum in a fixed
//    order (each lane's rows in turn, then a shuffle tree).
//
// A block is two warpgroups. Each owns MT 64-row m-tiles of query rows and
// keeps their A fragments, every k-step and every query part, in registers
// for the block's whole sweep (wgmma's A from registers), so the stationary
// operand costs no shared-memory traffic; B, the doc tokens, is read by the
// tensor cores from shared memory through wgmma descriptors, 64 columns per
// instruction (m64n64k16 bf16, m64n64k32 s8).
//
// Split operands: the query may come as P parts and the index as X planes
// of one token row ([plane 0 | plane 1], each plane KS k-steps wide), whose
// sums approximate float32 values. Part p times plane x goes into the same
// accumulator when p + x < max(P, X): hi.hi, lo.hi and hi.lo for two of
// each; the dropped lo.lo is below float32's rounding of the sum. The
// A fragments of each part serve every plane, so a split index costs no
// registers, only the planes' k-steps in the ring. Each warpgroup keeps two
// 64-column chunks in flight: the next chunk's wgmmas run while this one's
// maxima are taken, and the other warpgroup fills the gaps: at these
// shapes the epilogue, not the MMA, is the larger part of the work. A
// block holds whole queries (G of them, or one query over several row
// chunks when Lq exceeds the block's rows) and sweeps `tiles_per_block`
// consecutive doc tiles; blocks of one tile range are numbered next to each
// other, so the query groups that read the same doc rows run together and
// the index is read from HBM about once.
//
// Doc tiles follow Ld (ops/maxsim.py::mma_tile_plan): a tile of TR columns
// (256, or 128 for a split index, whose planes double a stage's bytes)
// holds docs_per_tile whole docs, each padded to doc_cols = Ld rounded up
// to 8 columns, so an 8-column slab never straddles two docs; a doc longer
// than TR tokens spans tiles_per_doc tiles and its running max carries
// across them. Columns past a doc's tokens or past the last doc are never
// maxed. Every tile runs all its TR / 64 chunks of 64 columns; those past
// its last slab multiply stale rows whose products are dropped, so no
// wgmma sits in a branch (the compiler would serialize them).
//
// Copies: one thread asks the TMA for each doc's rows of a tile (a box of
// doc_cols rows x 128 bytes per k-panel, from a tensor map of the index as
// (N * Ld) x tok_dim that the host encodes per call) into a 3-stage ring
// with an mbarrier per stage, so tile t + 2 loads while tile t multiplies
// and no other thread spends an instruction on copies. The TMA writes
// wgmma's K-major 128-byte-swizzle layout: 128-byte k-panels of TR rows,
// 16-byte chunk c of row r at chunk (c ^ r) & 7 of its row. Columns past
// the row (dim < 64 bf16 or 128 int8) are out of the map's bounds and
// arrive as zeros; rows past a doc's end are the next doc's, or zeros past
// the index, and are never maxed. The index is never copied or padded.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace mma_tile {

constexpr int kWarps = 8;        // two warpgroups
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;
constexpr int kMaxTileRows = 256;  // doc tokens (MMA columns) per tile, most
constexpr int kMaxDocs = 8;      // docs per tile (per-row maxima staged)
constexpr float kNegFill = -9999.0f;

struct Args {
  const void* q;          // (P, B * Lq, dim) query parts / (B * Lq, dim)
  const float* qscale;    // (B * Lq) query-token scales, or null
  const void* tok;        // (N * Ld, tok_dim) doc tokens (all planes)
  const void* fill;       // (N * Ld) int8 mask or float doc-token scales
  float* out;             // (B, N)
  int B, Lq, N, Ld, dim;
  int tok_dim;            // values per index row: dim, or X planes' width
  int G;                  // queries per block
  int docs_per_tile, doc_cols, tiles_per_doc, tiles_per_block;
};

// one 128-byte k-panel of a tile of tr rows
__host__ __device__ constexpr int panel_bytes(int tr) { return tr * 128; }

// bytes of one ring stage of tr-row tiles whose MMAs read ks k-steps of 32
// bytes (every plane's)
__host__ __device__ constexpr int stage_bytes(int ks, int tr) {
  return (2 * ks + 7) / 8 * panel_bytes(tr);
}

// the k-steps a kernel is built for: the fewest of 1, 2, 4, 8 that cover a
// token row of row_bytes
inline int k_steps(int row_bytes) {
  int ks = 1;
  while (32 * ks < row_bytes) ks *= 2;
  return ks;
}

template <int MT>
__host__ __device__ constexpr int block_rows() { return 2 * 64 * MT; }

// wgmma descriptor of a K-major, 128-byte-swizzled operand at smem address
// addr (inside a 1024-byte-aligned atom of 8 rows x 128 bytes): leading
// byte offset 16 (unused), stride 1024 bytes between 8-row groups
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// arrive on the barrier and expect `bytes` more from the TMA
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// the TMA copies the box at (column c0, row c1) of `map` to shared memory
// at dst and reports its bytes to the barrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of wgmmas are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 x 64 f32, this thread's 32) += a (64 x 16 bf16, registers) x the
// 16 x 64 bf16 tile at desc (K-major, 128-byte swizzle); scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
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

// pin an accumulator register at this point of the program: the compiler
// does not know that wgmma writes its registers late, so every read of an
// accumulator must follow a fence placed after the wait
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// The sweep, its MMAs over KS k-steps of 32 bytes per query part and index
// plane (a plane's row, zero past dim), P query parts, X index planes,
// tiles of TR columns. Op provides: Acc (accumulator type), kElemBytes,
// wgmma(acc, a, desc, scale_d) for an m64 x n64 x 32-byte product, Col (8
// bytes: what a column needs to score), column(fill, i, in_tile) -> Col,
// score(acc, col) -> the product's value, -9999 for an invalid token, -inf
// off the tile; term(qscale, row, max).
template <class Op, int MT, int P, int KS, int X, int TR>
__device__ __forceinline__ void sweep(const Args& a, const CUtensorMap& map) {
  constexpr int MB = block_rows<MT>();  // query rows per block
  constexpr int SB = stage_bytes(X * KS, TR);
  constexpr int kPanelBytes = panel_bytes(TR);
  constexpr int NC = TR / 64;           // 64-column chunks per tile
  static_assert(NC == 2 || NC == 4, "tiles of 128 or 256 columns");
  using Acc = typename Op::Acc;
  using Col = typename Op::Col;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle's 8-row atoms must start at 1024-byte boundaries
  unsigned char* ring = smem_raw +
      ((1024 - (static_cast<unsigned>(__cvta_generic_to_shared(smem_raw)) &
                1023)) & 1023);
  float* rowmax = reinterpret_cast<float*>(ring + kStages * SB);
  // [2][TR]: the columns of tiles t and t + 1
  Col* colbuf = reinterpret_cast<Col*>(rowmax + 2 * kMaxDocs * MB);
  static_assert(sizeof(Col) == 8, "a column's facts take 8 bytes");
  // [kStages]: the TMA's barrier of each ring stage
  const uint32_t bars = static_cast<uint32_t>(
      __cvta_generic_to_shared(colbuf + 2 * TR));
  const uint32_t ring_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  const int rb = a.dim * Op::kElemBytes;     // bytes per token row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  // this thread's first query row in a row chunk: warpgroup, warp in it
  const int row_w = (warp >> 2) * 64 * MT + (warp & 3) * 16 + g;
  const int n_groups = (a.B + a.G - 1) / a.G;
  const int b0 = (blockIdx.x % n_groups) * a.G;
  const int rows_g = min(a.G, a.B - b0) * a.Lq;
  const size_t qrow0 = static_cast<size_t>(b0) * a.Lq;
  const int dpt = a.docs_per_tile, dc = a.doc_cols, tpd = a.tiles_per_doc;
  // fewer than 2^31 tiles (the host checks)
  const int n_tiles = (a.N + dpt - 1) / dpt * tpd;
  const int t_first = static_cast<int>(blockIdx.x / n_groups) *
                      a.tiles_per_block;
  const int T = min(a.tiles_per_block, n_tiles - t_first);
  const float neg_inf = __int_as_float(0xff800000);

  // tile t of this block: its first doc, how many docs, which part of them
  struct Tile { int doc0, docs, part; };
  auto tile_at = [&](int t) {
    const int tg = t_first + t, dg = tg / tpd;
    Tile x;
    x.part = tg - dg * tpd;
    x.doc0 = dg * dpt;
    x.docs = min(dpt, a.N - x.doc0);
    return x;
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the TMA copies of tile t, the q-th tile this block loads, into stage
  // q % kStages: one box of doc_cols rows per doc and k-panel
  constexpr int kPanels = SB / kPanelBytes;
  auto load_tile = [&](int q, int t) {
    if (tid != 0 || t >= T) return;
    const Tile x = tile_at(t);
    const uint32_t bar = bars + 8 * (q % kStages);
    const uint32_t st = ring_addr + (q % kStages) * SB;
    mbar_expect_tx(bar, x.docs * kPanels * dc * 128);
    for (int d = 0; d < x.docs; ++d)
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn)
        tma_load_2d(st + pn * kPanelBytes + d * dc * 128, &map,
                    pn * (128 / Op::kElemBytes),
                    (x.doc0 + d) * a.Ld + x.part * dc, bar);
  };

  // what each of tile t's columns needs to score, into colbuf[t & 1]: one
  // column per thread
  auto columns = [&](int t) {
    if (t >= T || tid >= TR) return;
    const Tile x = tile_at(t);
    const int d = tid / dc, row = x.part * dc + tid - d * dc;
    colbuf[(t & 1) * TR + tid] = Op::column(
        a.fill, static_cast<size_t>(x.doc0 + d) * a.Ld + row,
        d < x.docs && row < a.Ld);
  };

  // sums over each query's rows of tile t's per-row maxima: one warp per
  // (query, doc), lane l adding rows l, l + 32, ..., then a shuffle tree,
  // a fixed order; the chunk that holds a query's first row writes, later
  // chunks add
  auto sum_rows = [&](int t, int c0) {
    const Tile x = tile_at(t);
    if (x.part != tpd - 1) return;          // its docs go on in tile t + 1
    const float* rm = rowmax + (t & 1) * kMaxDocs * MB;
    const int hi_row = min(c0 + MB, rows_g);
    const int qa = c0 / a.Lq, nq = (hi_row - 1) / a.Lq - qa + 1;
    for (int i = warp; i < nq * x.docs; i += kWarps) {
      const int qi = qa + i / x.docs, d = i % x.docs;
      const int lo = max(qi * a.Lq, c0), hi = min((qi + 1) * a.Lq, hi_row);
      float total = 0.f;
      for (int r = lo + lane; r < hi; r += 32)
        total += Op::term(a.qscale, qrow0 + r, rm[d * MB + r - c0]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        total += __shfl_xor_sync(0xffffffffu, total, o);
      if (lane == 0) {
        float* o = a.out + static_cast<size_t>(b0 + qi) * a.N + x.doc0 + d;
        *o = lo == qi * a.Lq ? total : *o + total;
      }
    }
  };

  const unsigned char* qb = static_cast<const unsigned char*>(a.q);
  const size_t part_bytes = static_cast<size_t>(a.B) * a.Lq * rb;
  // two chunks' accumulators, 64 x 64 per m-tile
  Acc acc[2][MT][32];
#pragma unroll
  for (int bb = 0; bb < 2; ++bb)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[bb][mt][i] = Acc(0);

  int q0 = 0;                   // tiles this block has loaded before
  for (int c0 = 0; c0 < rows_g; c0 += MB) {
    // A fragments of this thread's rows (each warp holds 16 rows of an m64
    // tile, as an m16 x k32-byte mma fragment): a0 row g, a1 row g + 8,
    // bytes 4c..4c+3 of the k-step's first half (a0, a1) and second half
    // (a2, a3)
    uint32_t A[P][MT][KS][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = c0 + row_w + mt * 64 + (i & 1) * 8;
            const int byte = ks * 32 + (i >> 1) * 16 + 4 * c;
            A[p][mt][ks][i] =
                row < rows_g && byte < rb
                    ? *reinterpret_cast<const uint32_t*>(
                          qb + p * part_bytes + (qrow0 + row) * rb + byte)
                    : 0u;
          }

    float m[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) m[mt][0] = m[mt][1] = neg_inf;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) load_tile(q0 + s, s);
    columns(0);

    for (int t = 0; t < T; ++t) {
      const int q = q0 + t;
      mbar_wait(bars + 8 * (q % kStages), (q / kStages) & 1);  // tile t is in
      __syncthreads();          // every warp is done with tile t - 1
      if (t > 0) sum_rows(t - 1, c0);
      load_tile(q + kStages - 1, t + kStages - 1);
      columns(t + 1);           // its buffer was last read by tile t - 1

      const Tile x = tile_at(t);
      const uint32_t st = ring_addr + (q % kStages) * SB;
      float* rm = rowmax + (t & 1) * kMaxDocs * MB;
      const int n_slabs = x.docs * dc / 8;   // <= TR / 8
      const Col* cb = colbuf + (t & 1) * TR;

      // chunk ci (columns 64 ci .. 64 ci + 63) into accumulator buffer B:
      // the wgmmas of every k-step, index plane and query part, part p of
      // plane x where p + x < max(P, X) (all compile-time: straight code)
      auto start = [&](int ci, auto buf) {
        constexpr int B = decltype(buf)::value;
        constexpr int PX = P > X ? P : X;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int xp = 0; xp < X; ++xp) {
            const int kk = xp * KS + ks;      // k-step in the token row
            const uint64_t desc = sw128_desc(st + (kk >> 2) * kPanelBytes +
                                             ci * 64 * 128 + (kk & 3) * 32);
#pragma unroll
            for (int p = 0; p < P; ++p)
              if (p + xp < PX)
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                  Op::wgmma(acc[B][mt], A[p][mt][ks], desc,
                            ks + xp + p > 0);
          }
        wgmma_commit();
      };

      // chunk ci's maxima, once its wgmmas are waited for. Accumulator of
      // slab j: [4j], [4j + 1] row g, columns 2c, 2c + 1; [4j + 2],
      // [4j + 3] row g + 8 (a slab never straddles two docs: doc_cols is a
      // multiple of 8)
      auto finish = [&](int ci, auto buf) {
        constexpr int B = decltype(buf)::value;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 32; ++i) fence_operand(acc[B][mt][i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int slab = 8 * ci + j;
          const Col k0 = cb[slab * 8 + 2 * c], k1 = cb[slab * 8 + 2 * c + 1];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              m[mt][h] = fmaxf(m[mt][h],
                               Op::score(acc[B][mt][4 * j + 2 * h], k0));
              m[mt][h] = fmaxf(m[mt][h],
                               Op::score(acc[B][mt][4 * j + 2 * h + 1], k1));
            }
          const int d = slab * 8 / dc;
          if (slab < n_slabs && (slab + 1) * 8 == (d + 1) * dc &&
              x.part == tpd - 1) {
            // the doc ends here: max over the quad's columns, keep the row
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float v = m[mt][h];
                v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
                v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
                if (c == 0) rm[d * MB + row_w + mt * 64 + 8 * h] = v;
                m[mt][h] = neg_inf;
              }
          }
        }
      };

      // two chunks in flight: chunk ci + 1's wgmmas run while chunk ci's
      // maxima are taken. Every tile runs all NC chunks of its TR rows
      // (those past the last slab multiply stale rows, dropped) in straight
      // code: a wgmma in a branch, or in flight across a loop's back edge,
      // makes the compiler serialize them
      using Buf0 = std::integral_constant<int, 0>;
      using Buf1 = std::integral_constant<int, 1>;
      start(0, Buf0());
      start(1, Buf1());
      wgmma_wait<1>();
      finish(0, Buf0());
      if constexpr (NC == 4) {
        start(2, Buf0());
        wgmma_wait<1>();
        finish(1, Buf1());
        start(3, Buf1());
        wgmma_wait<1>();
        finish(2, Buf0());
        wgmma_wait<0>();
        finish(3, Buf1());
      } else {
        wgmma_wait<0>();
        finish(1, Buf1());
      }
    }
    __syncthreads();
    sum_rows(T - 1, c0);
    q0 += T;
  }
}

// The tensor map of a row-major rows x cols matrix at ptr of elem_bytes
// values (2: bf16, 1: int8), in boxes of one 128-byte k-panel x box_rows
// rows, 128-byte swizzle, zeros out of bounds. cuTensorMapEncodeTiled
// lives in libcuda: it is reached through the runtime's entry-point query,
// so the library links against the runtime only.
inline int encode_map_2d(CUtensorMap* map, const void* ptr, int elem_bytes,
                         unsigned long long cols, unsigned long long rows,
                         int box_rows) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(
      map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the tensor map of the index tok as (N * Ld) x tok_dim values, in boxes
// of one 128-byte k-panel x doc_cols rows
inline int encode_tok_map(CUtensorMap* map, const Args& a, int elem_bytes) {
  return encode_map_2d(map, a.tok, elem_bytes, a.tok_dim,
                       static_cast<unsigned long long>(a.N) * a.Ld,
                       a.doc_cols);
}

// Checks a launch's plan against the kernel (block_rows query rows per
// block, tiles of tile_rows columns, ks k-steps of every plane, elem_bytes
// per index value), encodes the index's tensor map, sizes the shared
// memory and launches the kernel on `stream`. Returns the CUDA error code
// (0 on success).
inline int launch(void (*kernel)(Args, CUtensorMap), const Args& a,
                  int block_rows, int tile_rows, int ks, int elem_bytes,
                  cudaStream_t stream) {
  const int dpt = a.docs_per_tile, dc = a.doc_cols, tpd = a.tiles_per_doc,
            tpb = a.tiles_per_block;
  if (a.G < 1 || (a.G > 1 && a.G * a.Lq > block_rows) || dpt < 1 ||
      dpt > kMaxDocs || dc < 8 || dc % 8 || dpt * dc > tile_rows ||
      tpd < 1 || static_cast<long long>(dc) * tpd < a.Ld ||
      (tpd > 1 && dpt != 1) || tpb < 1 || tpb % tpd)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles =
      static_cast<long long>((a.N + dpt - 1) / dpt) * tpd;
  const long long blocks =
      static_cast<long long>((a.B + a.G - 1) / a.G) *
      ((n_tiles + tpb - 1) / tpb);
  // tile, TMA row and tile-sequence numbers stay below 2^31
  if (n_tiles + tpb > INT_MAX || blocks > INT_MAX ||
      static_cast<long long>(a.N) * a.Ld + kMaxTileRows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  int err = encode_tok_map(&map, a, elem_bytes);
  if (err) return err;
  const size_t smem =
      1024 + static_cast<size_t>(kStages) * stage_bytes(ks, tile_rows) +
      sizeof(float) * 2 * kMaxDocs * block_rows + 2 * 8 * tile_rows +
      8 * kStages;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a, map);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma_tile
