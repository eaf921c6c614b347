// K5 qmm: the prefill-shape dequant matmul, y (Mp, Np) = x (M, K) · W (K, Np)
// for M > 8 rows of x, in two modes:
//   int8  q int8 (K, Np), w[k, n] = q[k, n] * s[k/g, n]
//   nib4  q int8 (K/2, Np), split-K 4-bit (stacked experts whose K has no
//         nib4c chunk): byte row r holds logical row r in its low nibble
//         and row K/2 + r in its high nibble, w = nibble * s[row/g, n]
// with s f32 (K/g, Np) plain scales.
//
// Replaces: llama_cpp_gfx906_tpu/ops/quant_matmul.py  _qmm_int8_kernel and
// _qmm_nib4_kernel (K5, launched by _quant_matmul_pallas).  As in the JAX
// kernels, affine mins are not taken here: the wrapper subtracts (group
// sums of x) · m.
//
// Numerics as the JAX kernels: x in bf16, each weight the f32 product rounded
// to bf16, products summed in f32 (bf16 tensor-core MMA, f32 accumulators).
// The nib4 mode runs two products per step, one per K half, into the same
// accumulators (the JAX body's two dots into one f32 scratch).  A block owns
// its output tile and walks K in one fixed order: two launches give the
// same bits.
//
// Bound on the card: at the prefill shapes it serves (a few hundred rows of
// x against weights of K, N ~ 10^3) the work is a few GFLOP over a few MB of
// weights, so the bf16 tensor-core rate bounds it.  A simple design first:
//   - a block computes a 64 x 128 output tile with 8 warps, each a 32 x 32
//     sub-tile of 2 x 2 WMMA 16x16x16 bf16 fragments accumulating in f32;
//   - per 32-row step of packed K the block stages the x tile (64 x 32 bf16;
//     rows past M are zero) and the dequantized weight tile (32 x 128: one
//     16-byte load and 16 scales per thread, rounded to bf16) in shared
//     memory, rows padded by 16 bytes against bank conflicts; the nib4 mode
//     stages both halves' tiles from the same bytes (lo with the first
//     half's x columns and scale rows, hi with the second's), so a K of
//     2 * 32 n takes any n (gpt-oss's 2880: 45 steps);
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

// NIB: the split-K nib4 mode (two K halves per packed row), else int8.
template <bool NIB>
__global__ void __launch_bounds__(NT)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ s, float* __restrict__ out, int M, int K,
           int Np, int group) {
  constexpr int H = NIB ? 2 : 1;  // K halves staged per step
  __shared__ __align__(32) __nv_bfloat16 xs[H][BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 ws[H][BK * LDB];
  lcg::count_launch(NIB ? 1 : 0);  // slot 0: int8, 1: nib4
  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp / 4, wn = warp % 4;
  const int kq = NIB ? K / 2 : K;  // packed rows; half h's x columns at h * kq

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

  for (int k0 = 0; k0 < kq; k0 += BK) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      uint4 xv = make_uint4(0u, 0u, 0u, 0u);
      if (xlive)
        xv = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + xr) * K + h * kq + k0 + xc);
      *reinterpret_cast<uint4*>(xs[h] + xr * LDA + xc) = xv;
    }

    const int k = k0 + wr;  // this thread's packed row
    const uint4 qv =
        *reinterpret_cast<const uint4*>(q + (size_t)k * Np + n0 + wc);
    const uint32_t words[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
    for (int h = 0; h < H; ++h) {
      // half h's logical row and its scale row
      const float* sp = s + (size_t)((h * kq + k) / group) * Np + n0 + wc;
      uint32_t packed[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 d = *reinterpret_cast<const float4*>(sp + 4 * i);
        float v[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t byte = (words[i] >> (8 * b)) & 0xFFu;
          v[b] = NIB ? static_cast<float>(h ? byte >> 4 : byte & 0x0Fu)
                     : static_cast<float>(static_cast<int8_t>(byte));
        }
        packed[2 * i] = pack_bf16x2(v[0] * d.x, v[1] * d.y);
        packed[2 * i + 1] = pack_bf16x2(v[2] * d.z, v[3] * d.w);
      }
      uint4* wdst = reinterpret_cast<uint4*>(ws[h] + wr * LDB + wc);
      wdst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      wdst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], xs[h] + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], ws[h] + kk * LDB + wn * 32 + j * 16, LDB);
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

template <bool NIB>
int launch(const void* x, const int8_t* q, const float* s, float* out, int M,
           int K, int Np, int group, void* stream) {
  if (M <= 0 || K % ((NIB ? 2 : 1) * BK) || Np % BN || group <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(Np / BN, (M + BM - 1) / BM);
  qmm_kernel<NIB><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), q, s, out, M, K, Np, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: bf16 (M, K), 16-byte aligned rows; out: f32 (Mp, Np) with Mp = M
// rounded up to 64, every element written.  K must be a multiple of 32 and
// Np of 128.
LCG_EXPORT int lcg_qmm_int8(const void* x, const int8_t* q, const float* s,
                            float* out, int M, int K, int Np, int group,
                            void* stream) {
  return launch<false>(x, q, s, out, M, K, Np, group, stream);
}

// The nib4 mode: q (K/2, Np) split-K nibbles, s (K/group, Np) over the
// logical rows; K must be a multiple of 64 and Np of 128.
LCG_EXPORT int lcg_qmm_nib4(const void* x, const int8_t* q, const float* s,
                            float* out, int M, int K, int Np, int group,
                            void* stream) {
  return launch<true>(x, q, s, out, M, K, Np, group, stream);
}
