// Fused 2-bit LUT + MaxSim over pre-gathered residual candidates on Hopper
// (X1).
//
// Replaces scripts/exp_residual_stage2.py::v_pallas (body _fused_kernel):
// each query b scores its C candidates from their pre-gathered centroid
// scores and bucket ids,
//
//   out[b, c] = sum_t max_l s(b, c, l, t)
//   s(b, c, l, t) = (sum_d w[bits[b, c, l, d]] q[b, t, d] + cqg[b, c, l, t])
//                   * sg[b, c, l]                  if mg[b, c, l] != 0
//                 = -9999                          otherwise
//
// all in float32: w is the 2-bit codec's 4 bucket weights, and an id past 3
// takes w[3], as the TPU body's select chain does. The running maximum
// over Ld starts at -inf.
//
// What it takes instead of the TPU kernel's layout: the TPU read int32 ids
// and mask and a weight row padded to 128 lanes; here the ids are the
// uint8 of ops.residual.unpack_bits and the mask int8, the same function
// in 0.55 GB of input instead of 1.34 GB at C = 1,024.
//
// What bounds it on this card: 1.7e10 float32 multiply-adds at the
// experiment's shape (B=32, C=1024, Ld=64, Lq=32, dim=128) over 0.55 GB of
// input, 31 operations per byte; float32 has no tensor-core rate, so the
// CUDA cores' 67 TFLOP/s bound it (0.26 ms), above the 0.16 ms the bytes
// take. The design (candidate_tile.cuh): one block per (query, 16
// candidates); the query is staged once, transposed, in float32; each
// tile of token rows is decoded from 8 id bytes at a time into float32
// weights in shared memory; the register tile's width follows Lq (no idle
// columns at Lq = 32); the epilogue adds the centroid score read straight
// from cqg, scales and masks; a running (16, Lq) maximum in shared memory
// lets a candidate span tiles. There is no tile rule on C (the TPU kernel
// needed C % 32 == 0).
//
// Inputs, all contiguous: q (B, Lq, dim) float; cqg (B, C, Ld, Lq) float;
// bits (B, C, Ld, dim) uint8, 16-byte aligned; sg (B, C, Ld) float; mg
// (B, C, Ld) int8; w (4,) float; out (B, C) float. 0 < Lq <= 128, Ld > 0,
// dim % 8 == 0, dim <= 128. The Python wrapper checks.

#include "candidate_tile.cuh"

namespace {

using namespace cand;

template <int TX>
__global__ void __launch_bounds__(kThreads, 1)
residual_lut_maxsim_kernel(const float* __restrict__ q,
                           const float* __restrict__ cqg,
                           const uint8_t* __restrict__ bits,
                           const float* __restrict__ sg,
                           const int8_t* __restrict__ mg,
                           const float* __restrict__ wts,
                           float* __restrict__ out, int Lq, int C, int Ld,
                           int dim) {
  using T = Tile<TX>;
  extern __shared__ float4 smem4[];
  const int ds_ld = dim + 4;                 // floats, 16-byte rows
  const Layout L = layout<TX>(dim, Lq, sizeof(float) * ds_ld, 2);
  char* base = reinterpret_cast<char*>(smem4);
  float* Qs = reinterpret_cast<float*>(base);
  char* region = base + L.qs;
  float* Ds = reinterpret_cast<float*>(region);
  float* red = reinterpret_cast<float*>(region);
  float* rscale = reinterpret_cast<float*>(region + L.region);
  int* rvalid = reinterpret_cast<int*>(rscale + T::kRows);
  float* colmax = reinterpret_cast<float*>(region + L.region + L.meta);

  const int cblocks = (C + kCands - 1) / kCands;
  const int b = blockIdx.x / cblocks;
  const int c0 = (blockIdx.x % cblocks) * kCands;
  const int ct = min(kCands, C - c0);
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const float w0 = wts[0], w1 = wts[1], w2 = wts[2], w3 = wts[3];

  stage_query<TX>(Qs, colmax, q + static_cast<size_t>(b) * Lq * dim, Lq,
                  dim, tid);
  const size_t row0 = (static_cast<size_t>(b) * C + c0) * Ld;
  const int R = ct * Ld;
  const int chunks = dim / 8;                // 8 ids a load
  for (int r0 = 0; r0 < R; r0 += T::kRows) {
    const int nr = min(T::kRows, R - r0);
    __syncthreads();  // staging done; the previous tile's readers are done
    for (int i = tid; i < nr * chunks; i += kThreads) {
      const int r = i / chunks, j = i % chunks;
      const uint2 raw = *reinterpret_cast<const uint2*>(
          bits + (row0 + r0 + r) * dim + 8 * j);
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const unsigned id = ((k < 4 ? raw.x : raw.y) >> (8 * (k % 4))) & 0xff;
        v[k] = id == 0 ? w0 : id == 1 ? w1 : id == 2 ? w2 : w3;
      }
      float4* dst = reinterpret_cast<float4*>(Ds + r * ds_ld + 8 * j);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    for (int r = tid; r < nr; r += kThreads) {
      rscale[r] = sg[row0 + r0 + r];
      rvalid[r] = mg[row0 + r0 + r] != 0;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_product<TX>(Qs, Ds, ds_ld, dim, tx, ty, s);
    __syncthreads();  // every product is done: red may overwrite Ds

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + T::TY * i;
      if (r < nr) {
        const bool valid = rvalid[r];
        const float sc = rscale[r];
        const float* cq = cqg + (row0 + r0 + r) * Lq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * tx + j;
          if (c < Lq)
            red[r * T::kRedLd + c] = valid ? (s[i][j] + cq[c]) * sc : kNegFill;
        }
      }
    }
    __syncthreads();
    fold_max<TX>(red, colmax, r0, nr, Ld, Lq, tid);
  }
  __syncthreads();
  write_sums(colmax, out + static_cast<size_t>(b) * C + c0, ct, Lq, tid);
}

template <int TX>
int launch(const void* q, const void* cqg, const void* bits, const void* sg,
           const void* mg, const void* w, void* out, int B, int Lq, int C,
           int Ld, int dim, cudaStream_t stream) {
  const size_t smem = layout<TX>(dim, Lq, sizeof(float) * (dim + 4), 2).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = residual_lut_maxsim_kernel<TX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(B) * ((C + kCands - 1) / kCands);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(cqg),
      static_cast<const uint8_t*>(bits), static_cast<const float*>(sg),
      static_cast<const int8_t*>(mg), static_cast<const float*>(w),
      static_cast<float*>(out), Lq, C, Ld, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Returns the CUDA error code of
// the launch (0 on success; cudaErrorInvalidValue when the shapes are
// refused); launches nothing when B or C is 0.
extern "C" int ravqa_residual_lut_maxsim(const void* q, const void* cqg,
                                         const void* bits, const void* sg,
                                         const void* mg, const void* w,
                                         void* out, int B, int Lq, int C,
                                         int Ld, int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || C <= 0) return 0;
  if (Lq <= 0 || Lq > kMaxLq || Ld <= 0 || dim <= 0 || dim % 8 ||
      dim > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Lq <= 32)
    return launch<8>(q, cqg, bits, sg, mg, w, out, B, Lq, C, Ld, dim, s);
  if (Lq <= 64)
    return launch<16>(q, cqg, bits, sg, mg, w, out, B, Lq, C, Ld, dim, s);
  return launch<32>(q, cqg, bits, sg, mg, w, out, B, Lq, C, Ld, dim, s);
}
