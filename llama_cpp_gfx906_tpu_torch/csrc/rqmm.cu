// K8 rqmm: the routed (expert-indexed) quantized matmul, the
// ggml_mul_mat_id analog of the MoE FFN, in two modes.
//
// Replaces: llama_cpp_gfx906_tpu/ops/quant_matmul.py  _rqmm_int8_kernel and
// _rqmm_nib4_kernel (launched by _routed_qmm_pallas) for experts with plain
// scales:
//   out[p, n] = sum_k bf16(x[p, k]) * bf16(v[e, k, n] * s[e, k/g, n]
//                                         - m[e, k/g, n]),   e = idx[p]
// in f32, for P (token, expert) pairs, where v is
//   int8  q[e, k, n] of q int8 (E, K, Np)
//   nib4  a nibble of q int8 (E, K/2, Np), split-K: byte row r holds
//         logical row r in its low nibble and K/2 + r in its high one
//         (stacked experts whose K has no nib4c chunk: gpt-oss's gate and
//         up at K 2880); each half reads its own scale and min rows.
// The mins fold into each weight before its bf16 rounding (K1 takes them
// outside, as (sum x) * m: the rounding differs, so K1's tile is not
// reused).  The expert ids are read on the device, as the JAX kernel's
// scalar prefetch reads them, so a captured graph replays with new ids and
// no host sync.
//
// Planes: q as above, s and m f32 (E, K/g, Np), g 16 or 32.
//
// Bound on the card: the bytes of the chosen experts' slices (each pair
// streams its expert's packed rows and K/g x Np scale and min rows); the
// flops are P * 2 * K * Np, far below the byte time.  Design:
//   - one block per (pair, 128-column tile, K split); the split is chosen
//     so that the grid holds about two blocks per SM (the down projection
//     has few column tiles); each block stores its split's partial sums to
//     scratch and the last block of a (pair, tile) to arrive adds them in
//     split order (gemv_tile.cuh tile_store), so the result is the same
//     from launch to launch;
//   - a block walks its packed rows in 256-row chunks: each thread issues
//     its 8 rows' 16-byte loads of 16 adjacent columns first, then the
//     block stages the chunk's x slice and scale/min rows (nib4: of both
//     halves) in shared memory, so the weight loads are in flight while the
//     staging runs;
//   - a thread's 8 rows lie inside one quant group (in each half): one
//     scale and min vector per chunk and half; bytes and nibbles become
//     floats by a byte permute (exact); w = v * s - m is rounded without
//     contraction, then to bf16; a nib4 byte feeds two products, the lo
//     one with the first half's x and the hi one with the second's;
//   - partial sums meet by shuffles and shared memory, then tile_store.
// Pairs that share an expert stream its slice once each (grouping them is
// later work).

#include "gemv_tile.cuh"

namespace {

constexpr int NT = 256;
constexpr int TX = 8;            // threads across columns
constexpr int TY = NT / TX;      // threads across K
constexpr int COLS = 16;         // columns per thread: one 16-byte load
constexpr int TN = TX * COLS;    // columns per tile
constexpr int KC = 256;          // rows per chunk
constexpr int RPT = KC / TY;     // rows per thread per chunk
constexpr int MAX_GROWS = KC / 16;  // scale rows per chunk (g >= 16)

// NIB: the split-K nib4 mode (two K halves per packed row), else int8.
template <bool NIB>
__global__ void __launch_bounds__(NT) rqmm_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ s, const float* __restrict__ m,
    const int* __restrict__ idx, float* __restrict__ out,
    float* __restrict__ part, unsigned* __restrict__ cnt, int K, int Np,
    int group, int E, int chunks_per_split) {
  constexpr int H = NIB ? 2 : 1;  // K halves per packed row
  lcg::count_launch(NIB ? 1 : 0);  // slot 0: int8, 1: nib4
  __shared__ __align__(16) float xs[H * KC];
  __shared__ __align__(16) float ss[H * MAX_GROWS * TN];
  __shared__ __align__(16) float ms[H * MAX_GROWS * TN];
  const int tile = blockIdx.x, p = blockIdx.y, split = blockIdx.z;
  const int e = idx[p];
  const bool valid = e >= 0 && e < E;  // else the pair's output is 0
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int col0 = tile * TN + tx * COLS;
  const int kq = NIB ? K / 2 : K;  // packed rows; half h's rows at h * kq
  const int nchunks = (kq + KC - 1) / KC;
  const int c0 = split * chunks_per_split;
  const int c1 = valid ? min(nchunks, c0 + chunks_per_split) : c0;
  const int ngroups = K / group;
  const int ev = valid ? e : 0;
  const int8_t* qe = q + (size_t)ev * kq * Np;
  const float* se = s + (size_t)ev * ngroups * Np;
  const float* me = m != nullptr ? m + (size_t)ev * ngroups * Np : nullptr;
  const __nv_bfloat16* xp = x + (size_t)p * K;
  const int r0 = ty * RPT;  // this thread's first row in a chunk

  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  for (int ch = c0; ch < c1; ++ch) {
    const int k0 = ch * KC;
    const int kc = min(KC, kq - k0);  // a multiple of the group
    const bool live = r0 < kc;
    uint4 w[RPT];
    if (live) {
#pragma unroll
      for (int u = 0; u < RPT; ++u)
        w[u] = *reinterpret_cast<const uint4*>(qe + (size_t)(k0 + r0 + u) * Np +
                                               col0);
    }
    const int gr = kc / group;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      for (int i = tid; i < kc; i += NT)
        xs[h * KC + i] = __bfloat162float(xp[h * kq + k0 + i]);
      const int g0 = (h * kq + k0) / group;
      for (int i = tid; i < gr * (TN / 4); i += NT) {
        const int r = i / (TN / 4), c4 = (i % (TN / 4)) * 4;
        const size_t off = (size_t)(g0 + r) * Np + tile * TN + c4;
        const int dst = (h * MAX_GROWS + r) * TN + c4;
        *reinterpret_cast<float4*>(ss + dst) = *reinterpret_cast<const float4*>(se + off);
        if (me != nullptr)
          *reinterpret_cast<float4*>(ms + dst) = *reinterpret_cast<const float4*>(me + off);
      }
    }
    __syncthreads();
    if (live) {
      const int gi = r0 / group;  // RPT divides the group: one group a half
      float sc[H][COLS], mn[H][COLS];
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const int at = (h * MAX_GROWS + gi) * TN + tx * COLS + c;
          sc[h][c] = ss[at];
          mn[h][c] = me != nullptr ? ms[at] : 0.f;
        }
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        float xv[H];
#pragma unroll
        for (int h = 0; h < H; ++h) xv[h] = xs[h * KC + r0 + u];
        const uint32_t words[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // int8: the bytes + 128 (unsigned); nib4: the lo and hi nibbles
          uint32_t v8[H];
          if constexpr (NIB) {
            v8[0] = words[i] & 0x0F0F0F0Fu;
            v8[H - 1] = (words[i] >> 4) & 0x0F0F0F0Fu;
          } else {
            v8[0] = words[i] ^ 0x80808080u;
          }
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int c = 4 * i + b;
#pragma unroll
            for (int h = 0; h < H; ++h) {
              const float qv = lcg::ubyte_f(v8[h], b) - (NIB ? 0.f : 128.f);
              const float wv = lcg::bf16r(__fsub_rn(__fmul_rn(qv, sc[h][c]), mn[h][c]));
              acc[c] = fmaf(xv[h], wv, acc[c]);
            }
          }
        }
      }
    }
    __syncthreads();  // xs, ss and ms are restaged by the next chunk
  }

  // reduce over ty: lanes 8 and 16 apart share tx inside a warp, then the
  // 8 warps meet in shared memory (ss is free), in a fixed order
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    float v = acc[c];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    acc[c] = v;
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane < TX) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) ss[warp * TN + lane * COLS + c] = acc[c];
  }
  __syncthreads();
  const size_t row = (size_t)p * Np;
  const lcg::TileOut o{out + row, Np, part + row, (size_t)gridDim.y * Np,
                       cnt + (size_t)p * gridDim.x + tile, split, (int)gridDim.z, 1.f};
  lcg::tile_store<1>(o, Np, tile * TN, TN, [&](int, int c) {
    float v = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < NT / 32; ++w8) v += ss[w8 * TN + c];
    return v;
  });
}

static_assert((NT / 32) * TN <= MAX_GROWS * TN, "reduction fits in ss");

template <bool NIB>
int launch(const void* x, const void* q, const void* s, const void* m,
           const void* idx, void* out, void* part, void* cnt, int P, int K,
           int Np, int group, int E, int splits, void* stream) {
  const int kq = NIB ? K / 2 : K;
  if (Np % TN || K % (NIB ? 64 : 16) || (group != 16 && group != 32) || P < 1 ||
      splits < 1 || (NIB && kq % group))
    return cudaErrorInvalidValue;
  const int tiles = Np / TN, nchunks = (kq + KC - 1) / KC;
  const int per = (nchunks + splits - 1) / splits;
  if ((nchunks + per - 1) / per != splits) return cudaErrorInvalidValue;
  rqmm_kernel<NIB><<<dim3(tiles, P, splits), NT, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<const float*>(m),
      static_cast<const int*>(idx), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<unsigned*>(cnt), K, Np, group, E,
      per);
  return cudaGetLastError();
}

}  // namespace

// The K split of one launch: about two blocks per SM over the pairs' tiles
// (sms: the card's multiprocessor count), whole 256-row chunks of the K
// packed rows per split (nib4: K/2).
LCG_EXPORT int lcg_rqmm_splits(int P, int K, int Np, int sms) {
  const int tiles = Np / TN, nchunks = (K + KC - 1) / KC;
  const int want = (2 * sms + tiles * P - 1) / (tiles * P);
  int splits = want < nchunks ? want : nchunks;
  if (splits < 1) splits = 1;
  const int per = (nchunks + splits - 1) / splits;
  return (nchunks + per - 1) / per;
}

// K8.  x bf16 (P, K); q int8 (E, K, Np); s, m f32 (E, K/group, Np), m may
// be null; idx int32 (P,) on the device; out f32 (P, Np); part f32 scratch
// (splits, P, Np), splits from lcg_rqmm_splits; cnt one uint32 per (pair,
// 128-column tile), zero (the kernel leaves it zero).  Np % 128 == 0,
// K % 16 == 0, group 16 or 32.
LCG_EXPORT int lcg_rqmm_int8(const void* x, const void* q, const void* s,
                             const void* m, const void* idx, void* out,
                             void* part, void* cnt, int P, int K, int Np,
                             int group, int E, int splits, void* stream) {
  return launch<false>(x, q, s, m, idx, out, part, cnt, P, K, Np, group, E, splits,
                       stream);
}

// K8's nib4 mode: as lcg_rqmm_int8 with q int8 (E, K/2, Np) split-K
// nibbles and splits from lcg_rqmm_splits(P, K/2, ...); K % 64 == 0 and the
// group divides K/2.
LCG_EXPORT int lcg_rqmm_nib4(const void* x, const void* q, const void* s,
                             const void* m, const void* idx, void* out,
                             void* part, void* cnt, int P, int K, int Np,
                             int group, int E, int splits, void* stream) {
  return launch<true>(x, q, s, m, idx, out, part, cnt, P, K, Np, group, E, splits,
                      stream);
}
