// The quantized GEMV tile shared by K1/K2 (gemv.cu) and the decode
// megakernel (decode_stream.cu): one block of NT threads computes a
// TN-column tile x one segment of `seg` packed rows of
//   y (M, Np) += x (M, K) · W (K, Np)
// and adds its partial sums into `out` with atomicAdd.
//
// Device planes (the JAX package's layouts, see gemv.cu):
//   q   int8 (K, Np), or nib4c (K/2, Np): within each CK-row chunk the byte
//       b = (lo | hi<<4) ^ 0x80 holds logical rows c*CK + r (lo) and
//       c*CK + CK/2 + r (hi)
//   s   f32 (K/g, Np) plain scales, or int8 sub-scales when FOLDED
//   sd  f32 (K/sgroup, Np) folded super-scales
//   m   optional mins, f32 or int8 (folded, times md)
// w[k, n] = q[k, n] * scale(k/g, n) - min(k/g, n).  The mins are taken from
// the thread's own sum of x over the rows it owns.
//
// Design (bound: the weight bytes): 16-byte loads of 16 adjacent columns of
// one row, 8 threads across a 128-column tile; each thread owns R = seg/32
// rows inside one quant group and keeps the next UNROLL rows in flight;
// nibbles and bytes become floats by a byte permute into the mantissa of
// 2^23 (exact); partial sums meet by shuffles, shared memory and one
// atomicAdd per output per block.
#pragma once

#include "common.cuh"

namespace lcg {

constexpr int GT_TX = 8;                 // threads across columns
constexpr int GT_TY = 32;                // threads across K
constexpr int GT_COLS = 16;              // columns per thread: one 16-byte load
constexpr int GT_TN = GT_TX * GT_COLS;   // columns per tile
constexpr int GT_NT = GT_TX * GT_TY;     // threads per block
constexpr int GT_UNROLL = 4;             // rows per batch; the next is in flight
// x slice (M x 1024 entries at most) or the cross-warp reduction
// (8 warps x M x TN), for M <= 8
constexpr int GT_SMEM_FLOATS = (GT_NT / 32) * 8 * GT_TN;

// float(byte i of word) for a byte holding 0..255, exactly
__device__ __forceinline__ float ubyte_f(uint32_t word, int i) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540 + i)) -
         8388608.0f;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// One (tile_n, tile_k) tile.  NIB selects nib4c over int8; ROUNDW rounds
// each dequantized int8 weight to bf16 before the product (the JAX decode
// megakernel's rounding point; the nib4c path there is exact in f32).
// xf(m, k) yields x; `smem` holds GT_SMEM_FLOATS floats and is free on
// entry (the caller synchronises before reusing it).  sgroup is 1 unless
// FOLDED.
template <int M, bool NIB, bool FOLDED, bool ROUNDW, class XF>
__device__ __forceinline__ void gemv_tile(
    XF xf, const int8_t* __restrict__ q, const void* __restrict__ s,
    const void* __restrict__ mn, const float* __restrict__ sd,
    const float* __restrict__ md, float* __restrict__ out, int out_ld, int K,
    int Np, int group, int sgroup, int ck, int seg, int tile_n, int tile_k,
    float* smem) {
  const int tid = threadIdx.x;
  const int tx = tid % GT_TX, ty = tid / GT_TX;
  const int col0 = tile_n * GT_TN + tx * GT_COLS;
  const int R = seg / GT_TY;
  const int p0 = tile_k * seg;  // first packed row of the segment
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
  uint4 w[GT_UNROLL];
  float sc_lo[GT_COLS], sc_hi[GT_COLS];
  if (live) {
#pragma unroll
    for (int u = 0; u < GT_UNROLL; ++u)
      if (u < R) w[u] = *reinterpret_cast<const uint4*>(qrow + (size_t)u * Np);
    load_planes<FOLDED>(s, sd, klo / group, klo / sgroup, Np, col0, sc_lo);
    if (NIB)
      load_planes<FOLDED>(s, sd, (klo + half) / group,
                          (klo + half) / sgroup, Np, col0, sc_hi);
  }

  // x slice of this segment: [lo rows..., hi rows...] for each of M rows
  for (int i = tid; i < M * nx; i += GT_NT) {
    const int m = i / nx, j = i % nx;
    const int k = (NIB && j >= seg) ? seg_lo + half + (j - seg) : seg_lo + j;
    smem[i] = xf(m, k);
  }
  __syncthreads();

  float acc[M][GT_COLS];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < GT_COLS; ++c) acc[m][c] = 0.f;

  if (live) {
    float xs_lo[M], xs_hi[M];
#pragma unroll
    for (int m = 0; m < M; ++m) xs_lo[m] = xs_hi[m] = 0.f;

    for (int r = 0; r < R; r += GT_UNROLL) {
      uint4 cur[GT_UNROLL];
#pragma unroll
      for (int u = 0; u < GT_UNROLL; ++u) cur[u] = w[u];
#pragma unroll
      for (int u = 0; u < GT_UNROLL; ++u)  // prefetch the next rows
        if (r + GT_UNROLL + u < R)
          w[u] = *reinterpret_cast<const uint4*>(
              qrow + (size_t)(r + GT_UNROLL + u) * Np);
#pragma unroll
      for (int u = 0; u < GT_UNROLL; ++u) {
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
              float wv = (ubyte_f(u8, b) - 128.f) * sc_lo[c];
              if (ROUNDW) wv = bf16r(wv);
#pragma unroll
              for (int m = 0; m < M; ++m)
                acc[m][c] = fmaf(xl[m], wv, acc[m][c]);
            }
          }
        }
      }
    }
    if (mn != nullptr) {  // affine mins: w -= min, so y -= (sum x) * min
      float mv[GT_COLS];
      load_planes<FOLDED>(mn, md, klo / group, klo / sgroup, Np, col0, mv);
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int c = 0; c < GT_COLS; ++c) acc[m][c] -= xs_lo[m] * mv[c];
      if (NIB) {
        load_planes<FOLDED>(mn, md, (klo + half) / group,
                            (klo + half) / sgroup, Np, col0, mv);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int c = 0; c < GT_COLS; ++c) acc[m][c] -= xs_hi[m] * mv[c];
      }
    }
  }

  // reduce over ty: lanes 8 and 16 apart share tx inside a warp, then the
  // 8 warps meet in shared memory; one atomicAdd per output per block
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < GT_COLS; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  __syncthreads();  // the x slice is dead; reuse smem
  const int warp = tid / 32, lane = tid % 32;
  if (lane < GT_TX) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int c = 0; c < GT_COLS; ++c)
        smem[(warp * M + m) * GT_TN + lane * GT_COLS + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = tid; i < M * GT_TN; i += GT_NT) {
    const int m = i / GT_TN, c = i % GT_TN;
    const int col = tile_n * GT_TN + c;
    if (col >= Np) continue;
    float v = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < GT_NT / 32; ++w8) v += smem[(w8 * M + m) * GT_TN + c];
    atomicAdd(out + (size_t)m * out_ld + col, v);
  }
}

}  // namespace lcg
