// K1 gemv_int8 and K2 gemv_nib4c: the decode-shape quantized GEMV
// y (M, Np) = x (M, K) · W (K, Np) for M <= 8 rows of x.
//
// Replaces: llama_cpp_gfx906_tpu/ops/quant_matmul.py  _qmm_int8_gemv_kernel
// (K1) and _qmm_nib4c_gemv_kernel (K2), launched by _quant_gemv_pallas.  It
// reads the same device planes as the JAX package:
//   q   int8 (K, Np)             int8 format, w = q
//       int8 (K/2, Np)           nib4c: within each CK-row chunk the byte
//                                b = (lo | hi<<4) ^ 0x80 holds logical rows
//                                c*CK + r (lo) and c*CK + CK/2 + r (hi)
//   s   f32 (K/g, Np) plain scales, or int8 sub-scales when folded
//   sd  f32 (K/128, Np) folded super-scales (per-256 d repeated twice)
//   m   optional mins, f32 or int8 (folded, times md f32 (K/128, Np))
// and computes w[k, n] = q[k, n] * scale(k/g, n) - min(k/g, n) with
// scale = s (plain) or s * sd[k/128] (folded).  The mins are taken inside
// the kernel: each thread subtracts (its partial sum of x over the rows it
// owns) * min, so no second pass over the m plane is needed.
//
// Bound on the card: the weight bytes.  At M = 1 every weight byte is used
// once for a few flops, far below the H100's ~295 flop/byte ridge, so the
// kernel is a stream of q (1 byte/weight int8, 0.5 nib4c) plus the scale
// planes at ~3.35 TB/s.  Design for that:
//   - each thread issues 16-byte loads of 16 adjacent columns of one row,
//     8 threads cover a 128-column tile (whole 32-byte sectors), and a
//     thread keeps the next 4 rows' loads in flight while it computes; its
//     first rows and scales are requested before it waits for the x slice;
//   - the grid splits K into segments as well as N into tiles, so even the
//     4096x1024 projection launches enough blocks to fill 132 SMs; segment
//     partial sums meet in the f32 output through atomicAdd (after a
//     shuffle + shared-memory reduction inside the block);
//   - nibbles and bytes become floats by a byte permute into the mantissa of
//     2^23 and one subtraction (exact), not by the slower int->float convert;
//   - a thread's rows lie inside one quant group, so it loads that group's
//     16 scales (and mins) once.  The TPU kernel's MXU "groupdot-diff"
//     schedule is not carried over: there is no matrix unit to feed here.
// Numerics: exact f32 products q*scale, f32 accumulation (the plain PyTorch
// version dequantizes to f32 and multiplies in f32).

#include "gemv_tile.cuh"

namespace {

using lcg::GT_NT;
using lcg::GT_SMEM_FLOATS;
using lcg::GT_TN;

// One block: a TN-column tile x a segment of `seg` packed rows.
template <int M, bool NIB, bool FOLDED>
__global__ void __launch_bounds__(GT_NT, M <= 2 ? 2 : 1)  // M <= 2: 2 blocks/SM
gemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
            const void* __restrict__ s, const void* __restrict__ mn,
            const float* __restrict__ sd, const float* __restrict__ md,
            float* __restrict__ out, int K, int Np, int group, int sgroup,
            int ck, int seg) {
  __shared__ __align__(16) float smem[GT_SMEM_FLOATS];
  lcg::gemv_tile<M, NIB, FOLDED, false>(
      [&](int m, int k) { return x[(size_t)m * K + k]; }, q, s, mn, sd, md,
      out, Np, K, Np, group, sgroup, ck, seg, blockIdx.x, blockIdx.y, smem);
}

template <int M, bool NIB, bool FOLDED>
cudaError_t launch(const float* x, const int8_t* q, const void* s,
                   const void* mn, const float* sd, const float* md,
                   float* out, int K, int Np, int group, int sgroup, int ck,
                   int seg, cudaStream_t st) {
  const int rows = NIB ? K / 2 : K;
  dim3 grid((Np + GT_TN - 1) / GT_TN, rows / seg);
  gemv_kernel<M, NIB, FOLDED><<<grid, GT_NT, 0, st>>>(
      x, q, s, mn, sd, md, out, K, Np, group, sgroup, ck, seg);
  return cudaGetLastError();
}

template <bool NIB, bool FOLDED>
cudaError_t dispatch_m(int M, const float* x, const int8_t* q, const void* s,
                       const void* mn, const float* sd, const float* md,
                       float* out, int K, int Np, int group, int sgroup,
                       int ck, int seg, cudaStream_t st) {
  switch (M) {
    case 1: return launch<1, NIB, FOLDED>(x, q, s, mn, sd, md, out, K, Np, group, sgroup, ck, seg, st);
    case 2: return launch<2, NIB, FOLDED>(x, q, s, mn, sd, md, out, K, Np, group, sgroup, ck, seg, st);
    case 4: return launch<4, NIB, FOLDED>(x, q, s, mn, sd, md, out, K, Np, group, sgroup, ck, seg, st);
    case 8: return launch<8, NIB, FOLDED>(x, q, s, mn, sd, md, out, K, Np, group, sgroup, ck, seg, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: f32 (M, K) with M in {1, 2, 4, 8} (the wrapper pads); out: f32 (M, Np),
// zeroed by the caller.  folded != 0 selects int8 sub-scale planes with f32
// super planes; mn may be null.  nib != 0 selects the nib4c byte layout
// (chunk ck); seg is the packed-row segment per block.
LCG_EXPORT int lcg_gemv(int nib, int folded, int M, const float* x,
                        const int8_t* q, const void* s, const void* mn,
                        const float* sd, const float* md, float* out, int K,
                        int Np, int group, int sgroup, int ck, int seg,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nib) {
    return folded ? dispatch_m<true, true>(M, x, q, s, mn, sd, md, out, K, Np, group, sgroup, ck, seg, st)
                  : dispatch_m<true, false>(M, x, q, s, mn, sd, md, out, K, Np, group, 1, ck, seg, st);
  }
  return folded ? dispatch_m<false, true>(M, x, q, s, mn, sd, md, out, K, Np, group, sgroup, ck, seg, st)
                : dispatch_m<false, false>(M, x, q, s, mn, sd, md, out, K, Np, group, 1, ck, seg, st);
}
