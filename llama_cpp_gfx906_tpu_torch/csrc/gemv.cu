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

#include "common.cuh"

namespace {

constexpr int TX = 8;            // threads across columns
constexpr int TY = 32;           // threads across K
constexpr int COLS = 16;         // columns per thread: one 16-byte load
constexpr int TN = TX * COLS;    // columns per block tile
constexpr int NT = TX * TY;      // threads per block
constexpr int UNROLL = 4;        // rows per batch; the next batch is in flight
// x slice (M x 512 rows at most) or the cross-warp reduction (8 warps x M x TN)
constexpr int SMEM_FLOATS = (NT / 32) * 8 * TN;

// float(byte i of word) for a byte holding 0..255, exactly
__device__ __forceinline__ float ubyte_f(uint32_t word, int i) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540 + i)) -
         8388608.0f;
}

template <bool FOLDED>
__device__ __forceinline__ void load_planes(const void* plane, const float* sup,
                                            int row, int sup_row, int Np,
                                            int col0, float* out) {
  if (FOLDED) {
    const uint4 w =
        *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(plane) +
                                        (size_t)row * Np + col0);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    const float* sp = sup + (size_t)sup_row * Np + col0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 d = *reinterpret_cast<const float4*>(sp + 4 * i);
      const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[4 * i + b] =
            (float)(int8_t)((words[i] >> (8 * b)) & 0xFF) * dv[b];
    }
  } else {
    const float* sp =
        static_cast<const float*>(plane) + (size_t)row * Np + col0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 d = *reinterpret_cast<const float4*>(sp + 4 * i);
      out[4 * i] = d.x; out[4 * i + 1] = d.y;
      out[4 * i + 2] = d.z; out[4 * i + 3] = d.w;
    }
  }
}

// One block: a TN-column tile x a segment of `seg` packed rows.  NIB selects
// nib4c (two logical rows per byte) over int8 (one).  R = seg / TY rows per
// thread, a multiple of UNROLL that divides the quant group.
template <int M, bool NIB, bool FOLDED>
__global__ void __launch_bounds__(NT, M <= 2 ? 2 : 1)  // M <= 2: 2 blocks/SM
gemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
            const void* __restrict__ s, const void* __restrict__ mn,
            const float* __restrict__ sd, const float* __restrict__ md,
            float* __restrict__ out, int K, int Np, int group, int sgroup,
            int ck, int seg) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int col0 = blockIdx.x * TN + tx * COLS;
  const int R = seg / TY;
  const int p0 = blockIdx.y * seg;  // first packed row of the segment
  // logical row of packed row p (lo nibble / int8) and its hi partner
  const int half = NIB ? ck / 2 : 0;
  const int seg_lo = NIB ? (p0 / half) * ck + p0 % half : p0;
  const int nx = NIB ? 2 * seg : seg;  // x entries of the segment per row

  const bool live = col0 < Np;
  const int r0 = ty * R;                 // first row within the segment
  const int klo = seg_lo + r0;           // its logical row
  const int8_t* qrow = q + (size_t)(p0 + r0) * Np + col0;

  // issue the first rows and the scale planes before waiting on the x
  // slice, so the latencies overlap
  uint4 w[UNROLL];
  float sc_lo[COLS], sc_hi[COLS];
  if (live) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (u < R) w[u] = *reinterpret_cast<const uint4*>(qrow + (size_t)u * Np);
    load_planes<FOLDED>(s, sd, klo / group, klo / sgroup, Np, col0, sc_lo);
    if (NIB)
      load_planes<FOLDED>(s, sd, (klo + half) / group,
                          (klo + half) / sgroup, Np, col0, sc_hi);
  }

  // x slice of this segment: [lo rows..., hi rows...] for each of M rows
  for (int i = tid; i < M * nx; i += NT) {
    const int m = i / nx, j = i % nx;
    const int k = (NIB && j >= seg) ? seg_lo + half + (j - seg) : seg_lo + j;
    smem[i] = x[(size_t)m * K + k];
  }
  __syncthreads();

  float acc[M][COLS];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.f;

  if (live) {
    float xs_lo[M], xs_hi[M];
#pragma unroll
    for (int m = 0; m < M; ++m) xs_lo[m] = xs_hi[m] = 0.f;

    for (int r = 0; r < R; r += UNROLL) {
      uint4 cur[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) cur[u] = w[u];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)  // prefetch the next rows
        if (r + UNROLL + u < R)
          w[u] = *reinterpret_cast<const uint4*>(
              qrow + (size_t)(r + UNROLL + u) * Np);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u >= R) break;
        const int j = r0 + r + u;
        float xl[M], xh[M];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          xl[m] = smem[m * nx + j];
          xs_lo[m] += xl[m];
          if (NIB) {
            xh[m] = smem[m * nx + seg + j];
            xs_hi[m] += xh[m];
          }
        }
        const uint32_t words[4] = {cur[u].x, cur[u].y, cur[u].z, cur[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (NIB) {
            const uint32_t lo = words[i] & 0x0F0F0F0Fu;
            const uint32_t hi = ((words[i] ^ 0x80808080u) >> 4) & 0x0F0F0F0Fu;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int c = 4 * i + b;
              const float wl = ubyte_f(lo, b) * sc_lo[c];
              const float wh = ubyte_f(hi, b) * sc_hi[c];
#pragma unroll
              for (int m = 0; m < M; ++m)
                acc[m][c] = fmaf(xh[m], wh, fmaf(xl[m], wl, acc[m][c]));
            }
          } else {
            const uint32_t u8 = words[i] ^ 0x80808080u;  // int8 + 128
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int c = 4 * i + b;
              const float wv = (ubyte_f(u8, b) - 128.f) * sc_lo[c];
#pragma unroll
              for (int m = 0; m < M; ++m)
                acc[m][c] = fmaf(xl[m], wv, acc[m][c]);
            }
          }
        }
      }
    }
    if (mn != nullptr) {  // affine mins: w -= min, so y -= (sum x) * min
      float mv[COLS];
      load_planes<FOLDED>(mn, md, klo / group, klo / sgroup, Np, col0, mv);
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[m][c] -= xs_lo[m] * mv[c];
      if (NIB) {
        load_planes<FOLDED>(mn, md, (klo + half) / group,
                            (klo + half) / sgroup, Np, col0, mv);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int c = 0; c < COLS; ++c) acc[m][c] -= xs_hi[m] * mv[c];
      }
    }
  }

  // reduce over ty: lanes 8 and 16 apart share tx inside a warp, then the
  // 8 warps meet in shared memory; one atomicAdd per output per block
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  __syncthreads();  // the x slice is dead; reuse smem
  const int warp = tid / 32, lane = tid % 32;
  if (lane < TX) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        smem[(warp * M + m) * TN + lane * COLS + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = tid; i < M * TN; i += NT) {
    const int m = i / TN, c = i % TN;
    const int col = blockIdx.x * TN + c;
    if (col >= Np) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) v += smem[(w * M + m) * TN + c];
    atomicAdd(out + (size_t)m * Np + col, v);
  }
}

template <int M, bool NIB, bool FOLDED>
cudaError_t launch(const float* x, const int8_t* q, const void* s,
                   const void* mn, const float* sd, const float* md,
                   float* out, int K, int Np, int group, int sgroup, int ck,
                   int seg, cudaStream_t st) {
  const int rows = NIB ? K / 2 : K;
  dim3 grid((Np + TN - 1) / TN, rows / seg);
  gemv_kernel<M, NIB, FOLDED><<<grid, NT, 0, st>>>(
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
