// MaxSim over pre-gathered candidate tokens on Hopper (X2, and X3 by one
// launch per query).
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
// maximum over Ld starts at -inf.
//
// What bounds it on this card: the tokens are read once. At the
// experiment's shape (B=32, C=1024, Ld=64, Lq=32, dim=128) that is 537 MB
// against 1.7e10 FLOP, 32 operations per byte, under the 295 at which bf16
// tensor cores would be the limit: bytes bound the function (0.16 ms at
// 3.35 TB/s). This first version multiplies on the CUDA cores in float32
// (the sweep kernels' scheme), so their 67 TFLOP/s rate bounds it instead,
// about 0.26 ms; tensor-core products are later work. The design
// (candidate_tile.cuh): one block per (query, 16 candidates); the query
// (bf16 -> float, transposed) is staged once; the candidates' rows are
// contiguous in memory and go 16 bytes a thread into a shared tile; the
// register tile's width follows Lq, so at Lq = 32 no column idles; a
// running (16, Lq) maximum in shared memory lets a candidate span tiles.
// There is no tile rule on C (the TPU kernel needed C % 128 == 0).
//
// Inputs, all contiguous: q (B, Lq, dim) bf16; tok (B, C, Ld, dim) bf16,
// 16-byte aligned; mask (B, C, Ld) int8; out (B, C) float. 0 < Lq <= 128,
// Ld > 0, dim % 8 == 0, dim <= 128. The Python wrapper checks.

#include "candidate_tile.cuh"

namespace {

using namespace cand;

template <int TX>
__global__ void __launch_bounds__(kThreads, 1)
candidate_maxsim_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ tok,
                        const int8_t* __restrict__ mask,
                        float* __restrict__ out, int Lq, int C, int Ld,
                        int dim) {
  using T = Tile<TX>;
  extern __shared__ float4 smem4[];
  const int ds_ld = dim + 8;                 // bf16 elements, 16-byte rows
  const Layout L = layout<TX>(dim, Lq, sizeof(__nv_bfloat16) * ds_ld, 1);
  char* base = reinterpret_cast<char*>(smem4);
  float* Qs = reinterpret_cast<float*>(base);
  char* region = base + L.qs;
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(region);
  float* red = reinterpret_cast<float*>(region);
  int* rvalid = reinterpret_cast<int*>(region + L.region);
  float* colmax = reinterpret_cast<float*>(region + L.region + L.meta);

  const int cblocks = (C + kCands - 1) / kCands;
  const int b = blockIdx.x / cblocks;
  const int c0 = (blockIdx.x % cblocks) * kCands;
  const int ct = min(kCands, C - c0);
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  stage_query<TX>(Qs, colmax, q + static_cast<size_t>(b) * Lq * dim, Lq,
                  dim, tid);
  // the block's rows: candidates c0 .. c0 + ct - 1 of query b
  const size_t row0 = (static_cast<size_t>(b) * C + c0) * Ld;
  const int R = ct * Ld;
  const int chunks = dim / 8;                // 16-byte chunks a row
  for (int r0 = 0; r0 < R; r0 += T::kRows) {
    const int nr = min(T::kRows, R - r0);
    __syncthreads();  // staging done; the previous tile's readers are done
    for (int i = tid; i < nr * chunks; i += kThreads) {
      const int r = i / chunks, j = i % chunks;
      *reinterpret_cast<uint4*>(Ds + r * ds_ld + 8 * j) =
          *reinterpret_cast<const uint4*>(tok + (row0 + r0 + r) * dim + 8 * j);
    }
    for (int r = tid; r < nr; r += kThreads)
      rvalid[r] = mask[row0 + r0 + r] != 0;
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
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * tx + j;
          if (c < Lq) red[r * T::kRedLd + c] = valid ? s[i][j] : kNegFill;
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
int launch(const void* q, const void* tok, const void* mask, void* out,
           int B, int Lq, int C, int Ld, int dim, cudaStream_t stream) {
  const size_t smem =
      layout<TX>(dim, Lq, sizeof(__nv_bfloat16) * (dim + 8), 1).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = candidate_maxsim_kernel<TX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(B) * ((C + kCands - 1) / kCands);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(tok),
      static_cast<const int8_t*>(mask), static_cast<float*>(out), Lq, C, Ld,
      dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Returns the CUDA error code of
// the launch (0 on success; cudaErrorInvalidValue when the shapes are
// refused); launches nothing when B or C is 0.
extern "C" int ravqa_candidate_maxsim(const void* q, const void* tok,
                                      const void* mask, void* out, int B,
                                      int Lq, int C, int Ld, int dim,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || C <= 0) return 0;
  if (Lq <= 0 || Lq > kMaxLq || Ld <= 0 || dim <= 0 || dim % 8 ||
      dim > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Lq <= 32) return launch<8>(q, tok, mask, out, B, Lq, C, Ld, dim, s);
  if (Lq <= 64) return launch<16>(q, tok, mask, out, B, Lq, C, Ld, dim, s);
  return launch<32>(q, tok, mask, out, B, Lq, C, Ld, dim, s);
}
