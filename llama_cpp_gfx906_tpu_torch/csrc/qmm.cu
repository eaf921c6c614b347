// K5 qmm_int8: the prefill-shape dequant matmul on int8 weights with plain
// scales, y (Mp, Np) = x (M, K) · W (K, Np) for M > 8 rows of x.
//
// Replaces: llama_cpp_gfx906_tpu/ops/quant_matmul.py  _qmm_int8_kernel (K5,
// launched by _quant_matmul_pallas) for the int8 format.  It reads the JAX
// package's device planes:
//   q   int8 (K, Np)
//   s   f32 (K/g, Np) plain scales
// and computes w[k, n] = q[k, n] * s[k/g, n].  As in the JAX kernel, affine
// mins are not taken here: the wrapper subtracts (group sums of x) · m.
//
// Numerics as the JAX kernel: x in bf16, each weight the f32 product rounded
// to bf16, products summed in f32 (bf16 tensor-core MMA, f32 accumulators).
//
// Bound on the card: at the prefill shapes it serves (a few hundred rows of
// x against weights of K, N ~ 10^3) the work is a few GFLOP over a few MB of
// weights, so the bf16 tensor-core rate bounds it.  A simple design first:
//   - a block computes a 64 x 128 output tile with 8 warps, each a 32 x 32
//     sub-tile of 2 x 2 WMMA 16x16x16 bf16 fragments accumulating in f32;
//   - per 32-row step of K the block stages the x tile (64 x 32 bf16; rows
//     past M are zero) and the dequantized weight tile (32 x 128: one
//     16-byte int8 load and 16 scales per thread, rounded to bf16) in shared
//     memory, rows padded by 16 bytes against bank conflicts;
//   - no software pipelining yet: a step's loads and MMAs do not overlap.
// The output carries Mp = M rounded up to 64 rows (the tail rows are the
// products of the zero rows); the wrapper drops them.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 128, BK = 32;
constexpr int NT = 256;        // 8 warps: 2 (rows) x 4 (columns) of 32 x 32
constexpr int LDA = BK + 8;    // bf16 elements per staged x row
constexpr int LDB = BN + 8;    // bf16 elements per staged weight row

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(NT)
qmm_int8_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ q, const float* __restrict__ s,
                float* __restrict__ out, int M, int K, int Np, int group) {
  __shared__ __align__(32) __nv_bfloat16 xs[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 ws[BK * LDB];
  lcg::count_launch(0);
  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp / 4, wn = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // staging roles: x as 64 rows x 4 runs of 8, weights as 32 rows x 8 runs
  // of 16 columns
  const int xr = tid / 4, xc = (tid % 4) * 8;
  const int wr = tid / 8, wc = (tid % 8) * 16;
  const bool xlive = m0 + xr < M;

  for (int k0 = 0; k0 < K; k0 += BK) {
    uint4 xv = make_uint4(0u, 0u, 0u, 0u);
    if (xlive)
      xv = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + xr) * K + k0 + xc);
    *reinterpret_cast<uint4*>(xs + xr * LDA + xc) = xv;

    const int k = k0 + wr;
    const uint4 qv =
        *reinterpret_cast<const uint4*>(q + (size_t)k * Np + n0 + wc);
    const float* sp = s + (size_t)(k / group) * Np + n0 + wc;
    const uint32_t words[4] = {qv.x, qv.y, qv.z, qv.w};
    uint32_t packed[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 d = *reinterpret_cast<const float4*>(sp + 4 * i);
      const float w0 = (float)(int8_t)(words[i] & 0xFF) * d.x;
      const float w1 = (float)(int8_t)((words[i] >> 8) & 0xFF) * d.y;
      const float w2 = (float)(int8_t)((words[i] >> 16) & 0xFF) * d.z;
      const float w3 = (float)(int8_t)(words[i] >> 24) * d.w;
      packed[2 * i] = pack_bf16x2(w0, w1);
      packed[2 * i + 1] = pack_bf16x2(w2, w3);
    }
    uint4* wdst = reinterpret_cast<uint4*>(ws + wr * LDB + wc);
    wdst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    wdst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], ws + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are restaged by the next step
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          out + (size_t)(m0 + wm * 32 + i * 16) * Np + n0 + wn * 32 + j * 16,
          acc[i][j], Np, wmma::mem_row_major);
}

}  // namespace

// x: bf16 (M, K), 16-byte aligned rows; out: f32 (Mp, Np) with Mp = M
// rounded up to 64, every element written.  K must be a multiple of 32 and
// Np of 128.
LCG_EXPORT int lcg_qmm_int8(const void* x, const int8_t* q, const float* s,
                            float* out, int M, int K, int Np, int group,
                            void* stream) {
  if (M <= 0 || K % BK || Np % BN || group <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(Np / BN, (M + BM - 1) / BM);
  qmm_int8_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), q, s, out, M, K, Np, group);
  return static_cast<int>(cudaGetLastError());
}
