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
// columns (N), the reverse of the TPU kernel's. Then the max over a doc's
// tokens is a max along N: each thread folds its two columns of every
// 8-column slab into a running max in registers, and two shuffles (lanes
// ^1, ^2) finish it when the doc ends; the sum over a query's tokens runs
// once per (query, doc), over per-row maxima staged in shared memory.
//
// Roles. A block is three warpgroups, one block an SM:
//  - the producer warpgroup gives up registers (setmaxnreg.dec to 56).
//    Its warp 0 is the loader: for each tile it waits for the tile's ring
//    stage to be empty, asks the TMA for the tile's doc rows, writes what
//    each of the tile's columns needs to score (valid, masked or off the
//    tile; K5's doc-token scale) into the stage's column buffer, and
//    arrives on the stage's full barrier. Warps 1-3 are the summers: when a
//    tile's docs end they take the per-row maxima from a rowmax slot, sum
//    each (query, doc) in a fixed order (one warp a pair: each lane's rows
//    in turn, then a shuffle tree) and write out[b, n];
//  - two consumer warpgroups (setmaxnreg.inc to 224) each own MT 64-row
//    m-tiles of the block's query rows and keep their A fragments, every
//    k-step and query part, in registers for a whole unit of work (wgmma's
//    A from registers); B, the doc tokens, is read by the tensor cores from
//    the ring through wgmma descriptors.
// No block-wide barrier runs after set-up. The ring has a full and an
// empty mbarrier a stage (the loader's 32 lanes and its byte count; the
// consumers' 8 warps), the rowmax slots a full and an empty one (the 8
// consumer warps; the 3 summers).
//
// Ping-pong. The consumer warpgroups multiply in turns, one chunk of W
// columns each, ordered by two named barriers: warpgroup w waits for its
// turn, issues the chunk's wgmmas, hands the turn to the other and only
// then waits for its own products and takes their masked maxima. So one
// warpgroup's epilogue (the maxima, the rowmax stores, its waits) runs
// while the other's wgmmas keep the tensor cores busy, and a chunk's
// wgmmas are waited for within the chunk: none is in flight across a
// loop's back edge or sits in a branch, which would make ptxas serialize
// them.
//
// Split operands: the query may come as P parts and the index as X planes
// of one token row ([plane 0 | plane 1], each plane KS k-steps wide), whose
// sums approximate float32 values. Part p times plane x goes into the same
// accumulator when p + x < max(P, X): hi.hi, lo.hi and hi.lo for two of
// each; the dropped lo.lo is below float32's rounding of the sum. The A
// fragments of each part serve every plane, so a split index costs no
// registers, only the planes' k-steps in the ring.
//
// Doc tiles and MMA widths follow the input's shape (ops/maxsim.py::
// mma_tile_plan): a tile holds docs_per_tile whole docs, each padded to
// doc_cols = Ld rounded up to 8 columns (an 8-column slab never straddles
// two docs), or one part of a doc longer than the stage's TR rows, which
// spans tiles_per_doc tiles and whose running max carries across them. The
// tile's columns go to the MMA in `chunks` chunks of W columns (m64nWk16
// bf16, m64nWk32 s8), W the kernel's, chosen by the plan from those it is
// built for so that the chunks cover the tile's doc columns with the least
// surplus: at Ld 220 on a float32 index, two tiles of 112 columns and
// W = 112, every MMA column a token of the padded doc. Columns past a doc's
// tokens, past the last doc or past the tile are never maxed.
//
// Persistent blocks. The grid is one block an SM (at most the units); a
// unit is a group of G whole queries (or one query over several row chunks
// when Lq exceeds the block's rows) x a range of tiles_per_unit tiles, and
// unit u is query group u % n_groups over tile range u / n_groups. Block x
// walks units x, x + grid, ...: at any time the blocks hold consecutive
// units, so the groups that read the same doc tiles run together and the
// index is read from HBM about once. The loader runs through the same walk
// and keeps the ring full across unit boundaries; the consumers reload
// their A fragments at a unit's start while the other warpgroup multiplies.
//
// Copies: the TMA writes each doc's rows of a tile (a box of doc_cols rows
// x 128 bytes per k-panel, from a tensor map of the index as (N * Ld) x
// tok_dim that the host encodes per call) into a 3-stage ring in wgmma's
// K-major 128-byte-swizzle layout: 128-byte k-panels of TR rows, 16-byte
// chunk c of row r at chunk (c ^ r) & 7 of its row. Columns past the row
// (dim < 64 bf16 or 128 int8) are out of the map's bounds and arrive as
// zeros; rows past a doc's end are the next doc's, or zeros past the
// index, and are never maxed. The index is never copied or padded.
//
// What bounds it: the tensor cores. Every index byte feeds B * Lq products
// (thousands of operations a byte at the serve shapes, above the card's
// ridge of ~295); the epilogue is a select (K1) or an fma (K5) and a max a
// product. On an H100 at the float32 serve shape (B 32, Lq 64, Ld 220,
// three products) the wgmmas alone, with no copies and one max a chunk,
// run at about 78 % of the bf16 peak; the masked maxima add about 13 % to
// that (ping-pong hides most, not all, of them) and the copies about 4 %
// (16 query groups read each tile from L2, near 7.7 TB/s when nothing
// else runs). At a bucket of 2 (one query group) HBM feeds the 3-stage
// ring, and the copies bound it (PERF.md section 6).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace mma_tile {

constexpr int kThreads = 3 * 128;  // a producer and two consumer warpgroups
constexpr int kStages = 3;
constexpr int kSlots = 2;          // rowmax slots of tiles whose docs end
constexpr int kSummers = 3;        // producer warps 1-3
constexpr int kProducerRegs = 56;  // setmaxnreg: 128 x 56 + 256 x 224
constexpr int kConsumerRegs = 224; //   <= 65,536 registers of the SM
constexpr int kTurnBar = 1;        // named barriers 1, 2: the consumers' turns
constexpr int kMaxTileRows = 256;  // doc tokens (MMA columns) per tile, most
constexpr int kMaxDocs = 8;        // docs per tile (per-row maxima staged)
constexpr float kNegFill = -9999.0f;

struct Args {
  const void* q;          // (P, B * Lq, dim) query parts / (B * Lq, dim)
  const float* qscale;    // (B * Lq) query-token scales, or null
  const void* tok;        // (N * Ld, tok_dim) doc tokens (all planes)
  const void* fill;       // (N * Ld) int8 mask or float doc-token scales
  float* out;             // (B, N)
  int B, Lq, N, Ld, dim;
  int tok_dim;            // values per index row: dim, or X planes' width
  int G;                  // queries per unit
  int docs_per_tile, doc_cols, tiles_per_doc, tiles_per_unit;
  int chunks;             // MMA chunks of the kernel's width W per tile
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// named barrier `id` of `n` threads: wait for it, or arrive without waiting
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// a warpgroup's registers per thread, down to or up to N (all its warps)
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
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

// d (64 x 2R f32, this thread's R) += a (64 x 16 bf16, registers) x the
// 16 x 2R bf16 tile at desc (K-major, 128-byte swizzle); scale_d 0
// overwrites d. One instruction a width: N = 64, 96, 112 or 128
template <int R>
__device__ __forceinline__ void wgmma_bf16(float (&d)[R],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[32],
    const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, "
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

template <>
__device__ __forceinline__ void wgmma_bf16<48>(float (&d)[48],
    const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<56>(float (&d)[56],
    const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55"
      "}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[64],
    const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
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
// plane (a plane's row, zero past dim), P query parts, X index planes, ring
// stages of TR rows, chunks of W columns. Op provides: Acc (accumulator
// type), kElemBytes, wgmma(acc, a, desc, scale_d) for an m64 x nW x
// 32-byte product (acc of W / 2), Col (8 bytes: what a column needs to
// score), column(fill, i, in_tile) -> Col, score(acc, col) -> the product's
// value, -9999 for an invalid token, -inf off the tile; term(qscale, row,
// max).
template <class Op, int MT, int P, int KS, int X, int TR, int W>
__device__ __forceinline__ void sweep(const Args& a, const CUtensorMap& map) {
  constexpr int MB = block_rows<MT>();  // query rows per unit row chunk
  constexpr int SB = stage_bytes(X * KS, TR);
  constexpr int kPanelBytes = panel_bytes(TR);
  constexpr int kPanels = SB / kPanelBytes;
  constexpr int R = W / 2;              // accumulators a thread, per m-tile
  static_assert(W % 8 == 0 && W >= 64 && W <= TR && TR % 64 == 0,
                "chunks of 64 to TR columns, whole slabs");
  using Acc = typename Op::Acc;
  using Col = typename Op::Col;
  static_assert(sizeof(Col) == 8, "a column's facts take 8 bytes");
  extern __shared__ unsigned char smem_raw[];
  // the swizzle's 8-row atoms must start at 1024-byte boundaries
  unsigned char* ring = smem_raw +
      ((1024 - (static_cast<unsigned>(__cvta_generic_to_shared(smem_raw)) &
                1023)) & 1023);
  // [kSlots][kMaxDocs][MB]: per-row maxima of tiles whose docs end
  float* rowmax = reinterpret_cast<float*>(ring + kStages * SB);
  // [kStages][TR]: the columns of the tile in each ring stage
  Col* colbuf = reinterpret_cast<Col*>(rowmax + kSlots * kMaxDocs * MB);
  // full[kStages], empty[kStages], maxfull[kSlots], maxempty[kSlots]
  const uint32_t bars = static_cast<uint32_t>(
      __cvta_generic_to_shared(colbuf + kStages * TR));
  const uint32_t ring_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto maxfull = [&](int e) { return bars + 8 * (2 * kStages + e); };
  auto maxempty = [&](int e) {
    return bars + 8 * (2 * kStages + kSlots + e);
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dpt = a.docs_per_tile, dc = a.doc_cols, tpd = a.tiles_per_doc;
  const int n_groups = (a.B + a.G - 1) / a.G;
  // fewer than 2^31 tiles and units (the host checks)
  const int n_tiles = (a.N + dpt - 1) / dpt * tpd;
  const int units =
      n_groups * ((n_tiles + a.tiles_per_unit - 1) / a.tiles_per_unit);

  // unit u: its query group's first query and rows, its tile range
  struct Unit { int b0, rows_g, t_first, T; };
  auto unit_at = [&](int u) {
    Unit x;
    x.b0 = (u % n_groups) * a.G;
    x.rows_g = min(a.G, a.B - x.b0) * a.Lq;
    x.t_first = (u / n_groups) * a.tiles_per_unit;
    x.T = min(a.tiles_per_unit, n_tiles - x.t_first);
    return x;
  };
  // tile tg: its first doc, how many docs, which part of them
  struct Tile { int doc0, docs, part; };
  auto tile_at = [&](int tg) {
    const int dg = tg / tpd;
    Tile x;
    x.part = tg - dg * tpd;
    x.doc0 = dg * dpt;
    x.docs = min(dpt, a.N - x.doc0);
    return x;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 33);     // the loader's expect_tx and its 32 lanes
      mbar_init(empty(s), 8);     // each consumer warp
    }
    for (int e = 0; e < kSlots; ++e) {
      mbar_init(maxfull(e), 8);
      mbar_init(maxempty(e), kSummers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    regs_dealloc<kProducerRegs>();
    if (warp == 0) {
      // the loader: tile q of the walk into stage q % kStages, k-th use of
      // the stage k = q / kStages (its empty barrier's phase k - 1 done)
      constexpr int kColsPerLane = TR / 32;
      const int n_cols = a.chunks * W;
      int q = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit un = unit_at(u);
        for (int c0 = 0; c0 < un.rows_g; c0 += MB)
          for (int t = 0; t < un.T; ++t, ++q) {
            const int s = q % kStages;
            const Tile x = tile_at(un.t_first + t);
            mbar_wait(empty(s), ((q / kStages) & 1) ^ 1);
            if (lane == 0) {
              // one box of doc_cols rows per doc and k-panel
              const uint32_t st = ring_addr + s * SB;
              mbar_expect_tx(full(s), x.docs * kPanels * dc * 128);
              for (int d = 0; d < x.docs; ++d)
#pragma unroll
                for (int pn = 0; pn < kPanels; ++pn)
                  tma_load_2d(st + pn * kPanelBytes + d * dc * 128, &map,
                              pn * (128 / Op::kElemBytes),
                              (x.doc0 + d) * a.Ld + x.part * dc, full(s));
            }
            // the columns' facts, every load in flight before the stores
            Col v[kColsPerLane];
#pragma unroll
            for (int j = 0; j < kColsPerLane; ++j) {
              const int i = lane + 32 * j;
              const int d = i / dc, row = x.part * dc + i - d * dc;
              v[j] = Op::column(a.fill,
                                static_cast<size_t>(x.doc0 + d) * a.Ld + row,
                                d < x.docs && row < a.Ld);
            }
            Col* cb = colbuf + s * TR;
#pragma unroll
            for (int j = 0; j < kColsPerLane; ++j)
              if (lane + 32 * j < n_cols) cb[lane + 32 * j] = v[j];
            mbar_arrive(full(s));
          }
      }
    } else {
      // the summers: sums over each query's rows of a tile's per-row
      // maxima, one warp per (query, doc), lane l adding rows l, l + 32,
      // ..., then a shuffle tree, a fixed order; the row chunk that holds
      // a query's first row writes, later chunks add (the same warp: G is
      // 1 when a query spans chunks)
      const int sw = warp - 1;
      int e = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit un = unit_at(u);
        for (int c0 = 0; c0 < un.rows_g; c0 += MB) {
          const int hi_row = min(c0 + MB, un.rows_g);
          const int qa = c0 / a.Lq, nq = (hi_row - 1) / a.Lq - qa + 1;
          for (int t = 0; t < un.T; ++t) {
            const Tile x = tile_at(un.t_first + t);
            if (x.part != tpd - 1) continue;      // its docs go on
            const int slot = e % kSlots;
            mbar_wait(maxfull(slot), (e / kSlots) & 1);
            const float* rm = rowmax + slot * kMaxDocs * MB;
            for (int i = sw; i < nq * x.docs; i += kSummers) {
              const int qi = qa + i / x.docs, d = i % x.docs;
              const int lo = max(qi * a.Lq, c0),
                        hi = min((qi + 1) * a.Lq, hi_row);
              const size_t qrow0 = static_cast<size_t>(un.b0) * a.Lq;
              float total = 0.f;
              for (int r = lo + lane; r < hi; r += 32)
                total += Op::term(a.qscale, qrow0 + r, rm[d * MB + r - c0]);
#pragma unroll
              for (int o = 16; o > 0; o >>= 1)
                total += __shfl_xor_sync(0xffffffffu, total, o);
              if (lane == 0) {
                float* o = a.out + static_cast<size_t>(un.b0 + qi) * a.N +
                           x.doc0 + d;
                *o = lo == qi * a.Lq ? total : *o + total;
              }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(maxempty(slot));
            ++e;
          }
        }
      }
    }
  } else {
    regs_alloc<kConsumerRegs>();
    const int cw = warp - 4, wg = cw >> 2;  // consumer warp, warpgroup
    const int g = lane >> 2, c = lane & 3;
    // this thread's first query row in a row chunk: warpgroup, warp in it
    const int row_w = wg * 64 * MT + (cw & 3) * 16 + g;
    const int rb = a.dim * Op::kElemBytes;     // bytes per token row
    const unsigned char* qb = static_cast<const unsigned char*>(a.q);
    const size_t part_bytes = static_cast<size_t>(a.B) * a.Lq * rb;
    const float neg_inf = __int_as_float(0xff800000);
    const int dslabs = dc / 8;                 // slabs per doc in a tile
    Acc acc[MT][R];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < R; ++i) acc[mt][i] = Acc(0);

    if (wg == 1) bar_arrive(kTurnBar, 256);    // warpgroup 0 goes first
    int q = 0, e = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit un = unit_at(u);
      const size_t qrow0 = static_cast<size_t>(un.b0) * a.Lq;
      for (int c0 = 0; c0 < un.rows_g; c0 += MB) {
        // A fragments of this thread's rows (each warp holds 16 rows of an
        // m64 tile, as an m16 x k32-byte mma fragment): a0 row g, a1 row
        // g + 8, bytes 4c..4c+3 of the k-step's first half (a0, a1) and
        // second half (a2, a3)
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
                    row < un.rows_g && byte < rb
                        ? *reinterpret_cast<const uint32_t*>(
                              qb + p * part_bytes + (qrow0 + row) * rb + byte)
                        : 0u;
              }

        float m[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) m[mt][0] = m[mt][1] = neg_inf;

        for (int t = 0; t < un.T; ++t, ++q) {
          const int s = q % kStages;
          const Tile x = tile_at(un.t_first + t);
          const bool ends = x.part == tpd - 1;  // its docs end in this tile
          const int slot = e % kSlots;
          float* rm = rowmax + slot * kMaxDocs * MB;
          if (ends) mbar_wait(maxempty(slot), ((e / kSlots) & 1) ^ 1);
          mbar_wait(full(s), (q / kStages) & 1);
          const uint32_t st = ring_addr + s * SB;
          const Col* cb = colbuf + s * TR;
          const int n_slabs = x.docs * dslabs;
          int d = 0, doc_end = dslabs - 1;     // doc d ends at slab doc_end

          for (int ci = 0; ci < a.chunks; ++ci) {
            // chunk ci (columns W ci .. W ci + W - 1): the wgmmas of every
            // k-step, index plane and query part, part p of plane x where
            // p + x < max(P, X) (all compile-time: straight code), issued
            // in this warpgroup's turn
            bar_sync(kTurnBar + wg, 256);
            constexpr int PX = P > X ? P : X;
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
#pragma unroll
              for (int xp = 0; xp < X; ++xp) {
                const int kk = xp * KS + ks;    // k-step in the token row
                const uint64_t desc = sw128_desc(
                    st + (kk >> 2) * kPanelBytes + ci * W * 128 +
                    (kk & 3) * 32);
#pragma unroll
                for (int p = 0; p < P; ++p)
                  if (p + xp < PX)
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
                      Op::wgmma(acc[mt], A[p][mt][ks], desc,
                                ks + xp + p > 0);
              }
            wgmma_commit();
            bar_arrive(kTurnBar + (wg ^ 1), 256);
            wgmma_wait<0>();
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int i = 0; i < R; ++i) fence_operand(acc[mt][i]);

            // the chunk's maxima. Accumulator of slab j: [4j], [4j + 1]
            // row g, columns 2c, 2c + 1; [4j + 2], [4j + 3] row g + 8
#pragma unroll
            for (int j = 0; j < W / 8; ++j) {
              const int slab = ci * (W / 8) + j;
              const Col k0 = cb[slab * 8 + 2 * c],
                        k1 = cb[slab * 8 + 2 * c + 1];
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  m[mt][h] = fmaxf(m[mt][h],
                                   Op::score(acc[mt][4 * j + 2 * h], k0));
                  m[mt][h] = fmaxf(m[mt][h],
                                   Op::score(acc[mt][4 * j + 2 * h + 1], k1));
                }
              if (ends && slab == doc_end && slab < n_slabs) {
                // doc d ends here: max over the quad's columns, keep the
                // row in the slot
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
                ++d;
                doc_end += dslabs;
              }
            }
          }
          // the stage (its rows and columns) and the slot are done with
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(empty(s));
            if (ends) mbar_arrive(maxfull(slot));
          }
          if (ends) ++e;
        }
      }
    }
    if (wg == 0) bar_sync(kTurnBar, 256);      // warpgroup 1's last hand-over
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
// unit row chunk, ring stages of tile_rows rows, chunks of width columns,
// ks k-steps of every plane, elem_bytes per index value), encodes the
// index's tensor map, sizes the shared memory and launches `blocks`
// persistent blocks of the kernel on `stream`. Returns the CUDA error code
// (0 on success).
inline int launch(void (*kernel)(Args, CUtensorMap), const Args& a,
                  int block_rows, int tile_rows, int width, int ks,
                  int elem_bytes, int blocks, cudaStream_t stream) {
  const int dpt = a.docs_per_tile, dc = a.doc_cols, tpd = a.tiles_per_doc,
            tpu = a.tiles_per_unit;
  if (a.G < 1 || (a.G > 1 && a.G * a.Lq > block_rows) || dpt < 1 ||
      dpt > kMaxDocs || dc < 8 || dc % 8 || dpt * dc > tile_rows ||
      tpd < 1 || static_cast<long long>(dc) * tpd < a.Ld ||
      (tpd > 1 && dpt != 1) || tpu < 1 || tpu % tpd || a.chunks < 1 ||
      dpt * dc > a.chunks * width || a.chunks * width > tile_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles =
      static_cast<long long>((a.N + dpt - 1) / dpt) * tpd;
  const long long groups = (a.B + a.G - 1) / a.G;
  const long long units = groups * ((n_tiles + tpu - 1) / tpu);
  const long long row_chunks =
      (static_cast<long long>(a.G) * a.Lq + block_rows - 1) / block_rows;
  // tile, unit, TMA row and a block's tile-sequence numbers stay below 2^31
  if (n_tiles + tpu > INT_MAX || units > INT_MAX ||
      n_tiles * groups * row_chunks > INT_MAX ||
      static_cast<long long>(a.N) * a.Ld + kMaxTileRows > INT_MAX ||
      blocks < 1 || blocks > units)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  int err = encode_tok_map(&map, a, elem_bytes);
  if (err) return err;
  const size_t smem =
      1024 + static_cast<size_t>(kStages) * stage_bytes(ks, tile_rows) +
      sizeof(float) * kSlots * kMaxDocs * block_rows +
      8 * kStages * tile_rows + 8 * (2 * kStages + 2 * kSlots);
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a, map);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma_tile
