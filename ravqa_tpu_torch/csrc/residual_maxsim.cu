// Fused residual decompress + MaxSim over per-query candidates on Hopper
// (K6).
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
// What it does instead of the TPU kernel's devices: the TPU multiplies a
// one-hot (flat) or two-hot (factored) selector by the cs table on its
// matrix unit, which gates flat codebooks to 1,024 centroids. Here the
// table sits in shared memory and each token's centroid term is a lookup
// by code (a flat table of 1,024 x 32 bf16 is 64 KB, a factored one of
// (64 + 128) x 32 is 12 KB). The TPU reads a gathered (B, C, ...) copy of
// the candidates; here each block reads its candidates' record and mask
// rows by id, as the stage-1 kernel reads its selected blocks, so no
// gathered copy is written.
//
// What bounds it on this card: the residual term is a dim-long dot per
// (token, query token): at the 1M fine-stage shape (B=32, C=256, Ld=64,
// Lq=32, dim=128) 2.1e9 multiply-adds over 19 MB of records, about 220
// operations per byte, so the CUDA cores' f32 FMA rate bounds it. The
// design:
//  - one block per (query, 16 candidates); the query's tokens (bf16 ->
//    f32, transposed), the cs table and the bucket weights are staged once;
//  - the candidates' tokens are flattened into rows and go 128 rows at a
//    time: the block decodes each row's residual bytes into bf16 weights
//    in shared memory (exact: the weights are bf16), then each thread
//    computes an 8 x 8 (Lq > 64) or 8 x 4 register tile of dot products
//    (the sweep kernels' scheme), adds the centroid term by lookup and
//    applies the scale;
//  - the max over each candidate's rows is folded into a running (16, Lq)
//    maximum in shared memory, so a doc may span tiles (Ld = 220) and a
//    tile may hold several docs (Ld = 64); each candidate's sum over Lq is
//    one thread's loop in a fixed order, so results repeat bit for bit.
// There is no tile rule on C. Tensor-core products are later work.
//
// Inputs, all contiguous: q (B, Lq, dim) bf16; cs (B, rows, Lq) bf16;
// records (N, Ld * (4 + P)) uint8; cand (B, C) int32 (clamped to [0, N));
// mask (N, Ld) int8; w (2^nbits,) float (bf16 values); out (B, C) float.
// 0 < Lq <= 128, dim % 8 == 0, dim <= 128, nbits 2, 4 or 8; k2 a power of
// two when k1 > 0. The Python wrapper checks.

#include "sweep_tile.cuh"

namespace {

using namespace sweep;

constexpr int kCands = 16;          // candidates per block
constexpr int kTileRows = 128;      // token rows per tile (16 x 8)
constexpr int kMaxDim = 128;
constexpr int kMaxLq = 128;
constexpr size_t kMaxSmem = 232448;

struct Layout {
  int qs_ld, ds_ld, red_ld;
  size_t qs, region, meta, colmax, w, cs, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline Layout layout(int H, int Lq, int dim, int rows) {
  Layout L;
  L.qs_ld = 64 * H + 4;
  L.ds_ld = dim + 8;
  L.red_ld = 64 * H + 1;
  L.qs = align16(sizeof(float) * dim * L.qs_ld);
  const size_t ds = sizeof(__nv_bfloat16) * kTileRows * L.ds_ld;
  const size_t red = sizeof(float) * kTileRows * L.red_ld;
  L.region = align16(ds > red ? ds : red);
  L.meta = align16(4 * sizeof(int) * kTileRows);   // id, c1, c2, scale
  L.colmax = align16(sizeof(float) * kCands * Lq);
  L.w = align16(sizeof(float) * 256);
  L.cs = align16(sizeof(__nv_bfloat16) * static_cast<size_t>(rows) * Lq);
  L.total = L.qs + L.region + L.meta + L.colmax + L.w + L.cs;
  return L;
}

// s[i][4h + j] += sum_k D[ty + 16 i][k] * Qs[k][64 h + 4 tx + j], h < H,
// with Qs rows qs_ld apart (sweep_tile.cuh's tile_product, whose stride is
// fixed at kQsLd; here the 64-column tile takes half of that).
template <int H>
__device__ __forceinline__ void tile_product_bf16(const float* Qs, int qs_ld,
                                                  const __nv_bfloat16* D,
                                                  int ds_ld, int dim, int tx,
                                                  int ty, float (&s)[8][8]) {
  for (int k = 0; k < dim; k += 4) {
    float4 w[4][H];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < H; ++h)
        w[kk][h] = *reinterpret_cast<const float4*>(
            Qs + (k + kk) * qs_ld + 64 * h + tx * 4);
    float4 a4[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a4[i] = load4(D + (ty + 16 * i) * ds_ld + k);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a[4] = {a4[i].x, a4[i].y, a4[i].z, a4[i].w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          s[i][4 * h + 0] = fmaf(a[kk], w[kk][h].x, s[i][4 * h + 0]);
          s[i][4 * h + 1] = fmaf(a[kk], w[kk][h].y, s[i][4 * h + 1]);
          s[i][4 * h + 2] = fmaf(a[kk], w[kk][h].z, s[i][4 * h + 2]);
          s[i][4 * h + 3] = fmaf(a[kk], w[kk][h].w, s[i][4 * h + 3]);
        }
      }
    }
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
residual_maxsim_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ cs,
                       const uint8_t* __restrict__ records,
                       const int* __restrict__ cand,
                       const int8_t* __restrict__ mask,
                       const float* __restrict__ wts,
                       float* __restrict__ out, int Lq, int C, int N, int Ld,
                       int dim, int nbits, int rows, int k1, int k2) {
  extern __shared__ float4 smem4[];
  const Layout L = layout(H, Lq, dim, rows);
  char* base = reinterpret_cast<char*>(smem4);
  float* Qs = reinterpret_cast<float*>(base);                  // [dim][qs_ld]
  char* region = base + L.qs;
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(region);  // [128][ds_ld]
  float* red = reinterpret_cast<float*>(region);                 // [128][red_ld]
  int* rid = reinterpret_cast<int*>(region + L.region);          // [128]
  int* rc1 = rid + kTileRows;                                    // [128]
  int* rc2 = rc1 + kTileRows;                                    // [128]
  float* rscale = reinterpret_cast<float*>(rc2 + kTileRows);     // [128]
  float* colmax = reinterpret_cast<float*>(region + L.region + L.meta);
  float* wS = reinterpret_cast<float*>(
      region + L.region + L.meta + L.colmax);                    // [256]
  __nv_bfloat16* csS = reinterpret_cast<__nv_bfloat16*>(
      region + L.region + L.meta + L.colmax + L.w);              // [rows][Lq]

  const int cblocks = (C + kCands - 1) / kCands;
  const int b = blockIdx.x / cblocks;
  const int c0 = (blockIdx.x % cblocks) * kCands;
  const int ct = min(kCands, C - c0);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int P = dim * nbits / 8;           // residual bytes per token
  const int per_byte = 8 / nbits;
  const int bmask = (1 << nbits) - 1;
  const size_t RB = static_cast<size_t>(Ld) * (4 + P);
  const float neg_inf = __int_as_float(0xff800000);
  const int ncols = 64 * H;

  // stage the query (transposed, zero past Lq), the cs table, the weights
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * Lq * dim;
  for (int i = tid; i < ncols * dim; i += kThreads) {
    const int c = i / dim, d = i % dim;
    Qs[d * L.qs_ld + c] = c < Lq ? __bfloat162float(qb[c * dim + d]) : 0.f;
  }
  const __nv_bfloat16* csb = cs + static_cast<size_t>(b) * rows * Lq;
  for (int i = tid; i < rows * Lq; i += kThreads) csS[i] = csb[i];
  for (int i = tid; i <= bmask; i += kThreads) wS[i] = wts[i];
  for (int i = tid; i < kCands * Lq; i += kThreads) colmax[i] = neg_inf;
  const int* cb = cand + static_cast<size_t>(b) * C + c0;

  const int R = ct * Ld;                   // the block's token rows
  for (int r0 = 0; r0 < R; r0 += kTileRows) {
    const int nr = min(kTileRows, R - r0);
    __syncthreads();  // staging done; the previous tile's readers are done
    // per row: its doc, centroid rows and effective scale
    for (int r = tid; r < nr; r += kThreads) {
      const int cl = (r0 + r) / Ld, l = (r0 + r) % Ld;
      const int id = min(max(cb[cl], 0), N - 1);
      const uint8_t* rec = records + static_cast<size_t>(id) * RB;
      const int code = rec[2 * l] | (rec[2 * l + 1] << 8);
      const unsigned sbits = rec[2 * Ld + 2 * l] | (rec[2 * Ld + 2 * l + 1] << 8);
      rid[r] = id;
      // table rows of the code's centroid term; compress never writes a
      // code past the table, and the clamp keeps a corrupt one in bounds
      rc1[r] = k1 ? min(code / k2, k1 - 1) : min(code, rows - 1);
      rc2[r] = k1 ? k1 + code % k2 : -1;
      rscale[r] = __uint_as_float(sbits << 16) *
                  static_cast<float>(mask[static_cast<size_t>(id) * Ld + l]);
    }
    __syncthreads();
    // decode each row's residual bytes into bf16 bucket weights
    for (int i = tid; i < nr * P; i += kThreads) {
      const int r = i / P, j = i % P;
      const int l = (r0 + r) % Ld;
      const int byte = records[static_cast<size_t>(rid[r]) * RB + 4 * Ld +
                               static_cast<size_t>(l) * P + j];
      for (int p = 0; p < per_byte; ++p)
        Ds[r * L.ds_ld + p * P + j] =
            __float2bfloat16(wS[(byte >> (p * nbits)) & bmask]);
    }
    __syncthreads();

    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    tile_product_bf16<H>(Qs, L.qs_ld, Ds, L.ds_ld, dim, tx, ty, s);
    __syncthreads();  // every product is done: red may overwrite Ds

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      if (r < nr) {
        const int c1 = rc1[r], c2 = rc2[r];
        const float sc = rscale[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tile_col(tx, j);
          if (c < Lq) {
            float cterm = __bfloat162float(csS[c1 * Lq + c]);
            if (c2 >= 0) cterm += __bfloat162float(csS[c2 * Lq + c]);
            red[r * L.red_ld + c] =
                sc > 0.f ? (cterm + s[i][j]) * sc : kNegFill;
          }
        }
      }
    }
    __syncthreads();
    // fold each candidate's rows of this tile into its running maxima
    const int cf = r0 / Ld;
    const int n_cand = (r0 + nr - 1) / Ld - cf + 1;
    for (int p = tid; p < n_cand * Lq; p += kThreads) {
      const int cl = cf + p / Lq, c = p % Lq;
      const int lo = max(cl * Ld, r0) - r0;
      const int hi = min((cl + 1) * Ld, r0 + nr) - r0;
      float m = colmax[cl * Lq + c];
      for (int r = lo; r < hi; ++r) m = fmaxf(m, red[r * L.red_ld + c]);
      colmax[cl * Lq + c] = m;
    }
  }
  __syncthreads();
  for (int cl = tid; cl < ct; cl += kThreads) {
    float total = 0.f;
    for (int c = 0; c < Lq; ++c) total += colmax[cl * Lq + c];
    out[static_cast<size_t>(b) * C + c0 + cl] = total;
  }
}

template <int H>
int launch(const void* q, const void* cs, const void* records,
           const void* cand, const void* mask, const void* w, void* out,
           int B, int Lq, int C, int N, int Ld, int dim, int nbits, int rows,
           int k1, int k2, cudaStream_t stream) {
  const size_t smem = layout(H, Lq, dim, rows).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = residual_maxsim_kernel<H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(B) * ((C + kCands - 1) / kCands);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(cs),
      static_cast<const uint8_t*>(records), static_cast<const int*>(cand),
      static_cast<const int8_t*>(mask), static_cast<const float*>(w),
      static_cast<float*>(out), Lq, C, N, Ld, dim, nbits, rows, k1, k2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). k1 = k2 = 0 for a flat codec
// (rows = K); k1 = k_coarse, k2 = k_fine (rows = k1 + k2) for a factored
// one. Returns the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue when the shapes are refused or the cs table does
// not fit shared memory); launches nothing when B or C is 0.
extern "C" int ravqa_residual_maxsim(const void* q, const void* cs,
                                     const void* records, const void* cand,
                                     const void* mask, const void* w,
                                     void* out, int B, int Lq, int C, int N,
                                     int Ld, int dim, int nbits, int rows,
                                     int k1, int k2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || C <= 0) return 0;
  if (Lq <= 0 || Lq > kMaxLq || Ld <= 0 || N <= 0 || dim % 8 ||
      dim > kMaxDim || (nbits != 2 && nbits != 4 && nbits != 8) ||
      rows <= 0 || (k1 > 0 && (k2 <= 0 || (k2 & (k2 - 1)))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Lq > 64)
    return launch<2>(q, cs, records, cand, mask, w, out, B, Lq, C, N, Ld,
                     dim, nbits, rows, k1, k2, s);
  return launch<1>(q, cs, records, cand, mask, w, out, B, Lq, C, N, Ld, dim,
                   nbits, rows, k1, k2, s);
}
