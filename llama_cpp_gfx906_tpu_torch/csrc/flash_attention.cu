// K4 flash_attention: causal GQA prefill attention over an already-updated
// KV cache, never materialising the (T, S) score matrix.
//
// Replaces: llama_cpp_gfx906_tpu/ops/flash_attention.py  _flash_kernel
// (wrapper flash_attention), for bf16, f32 or int8 KV with GQA, a
// per-sequence offset n_past, sliding window, logit softcap and attention
// sinks.
//
// Contract: q (B, T, Hq, D) in the element type E (bf16 or f32); the cache
// (B, S, Hkv, D) in E, or int8 with one f32 scale per (row, KV head),
// kscale / vscale (B, S, Hkv); query t of head hq sits at position
// n_past + t and attends KV head hq / (Hq / Hkv), keys k <= n_past + t and,
// with a window W > 0, k > n_past + t - W.  A per-head sink logit joins the
// softmax denominator only.  Output (B, T, Hq, D) in E.
//
// int8 mode: each K and V element is dequantized (int8 value x its row's
// scale, in f32) as the tile is staged into shared memory, so both products
// run on the same f32 tiles as the other modes; the only rounding to E is
// the output's.  (The JAX kernel applies the scales to the scores and to p,
// and returns bf16.)
//
// Bound on the card: the flops, 4 * T * S_live * D per head (QK^T and PV),
// against 989 TFLOP/s of bf16 tensor cores; the bytes (Q, K, V once, O once,
// and in the int8 mode 1 byte per element plus 4 bytes of scale per row and
// KV head) are far smaller.  This first version runs the two products as f32 FMA
// tile loops from shared memory (no mma / wgmma yet), so it is bound by the
// 67 TFLOP/s of f32 FMA at best.  Design:
//   - grid (q tile of 64, query head, batch); K and V are read strided from
//     the stored (B, S, Hkv, D) layout, with no (B, H, S, D) transpose copy;
//   - key tiles of 64 wholly above the causal diagonal or wholly outside the
//     window are skipped (the block computes its live key-tile range);
//   - online softmax in f32 per query row, 8 threads per row group.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BKT = 64;  // keys per tile
constexpr int NT = 128;  // threads: 16 row groups (4 rows) x 8 column groups
constexpr int PAD = 4;   // row padding of the transposed tiles (floats)

template <int D>
struct Smem {
  static constexpr int QS = D * (BQ + PAD);   // Qs[d][r]
  static constexpr int KS = D * (BKT + PAD);  // Ks[d][c]
  static constexpr int VS = BKT * D;          // Vs[c][d]
  static constexpr int PS = BQ * (BKT + PAD); // Ps[r][c]
  static constexpr size_t bytes = sizeof(float) * (QS + KS + VS + PS);
};

// element i of a K or V plane as f32; int8 rows take their scale
template <typename KV>
__device__ __forceinline__ float kv_at(const KV* p, size_t i,
                                       const float* sc, size_t si) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    return static_cast<float>(p[i]) * sc[si];
  } else {
    return lcg::to_float(p[i]);
  }
}

template <typename E, typename KV, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const E* __restrict__ q, const KV* __restrict__ k,
                       const KV* __restrict__ v,
                       const float* __restrict__ kscale,  // (B, S, Hkv) or null
                       const float* __restrict__ vscale,
                       const int* __restrict__ n_past_arr,
                       const float* __restrict__ sinks,  // (Hq,) or null
                       E* __restrict__ out, int T, int S, int Hq, int Hkv,
                       float scale, int window, float softcap) {
  extern __shared__ __align__(16) float sm[];
  lcg::count_launch(std::is_same<KV, int8_t>::value ? 1 : 0);  // slot 1: int8
  float* Qs = sm;
  float* Ks = Qs + Smem<D>::QS;
  float* Vs = Ks + Smem<D>::KS;
  float* Ps = Vs + Smem<D>::VS;
  constexpr int QLD = BQ + PAD, KLD = BKT + PAD, PLD = BKT + PAD;
  constexpr int DC = D / 8;  // output columns per thread

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;  // 8 lanes share a row group
  const int qt = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int n_past = n_past_arr[b];
  const int q0 = qt * BQ;

  // Q tile, transposed: Qs[d][r]
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    Qs[d * QLD + r] =
        t < T ? lcg::to_float(q[(((size_t)b * T + t) * Hq + hq) * D + d]) : 0.f;
  }

  float m_r[4], l_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = lcg::kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // live key range of this query tile
  const int q_last = min(q0 + BQ, T) - 1;
  const int k_end = min(S, n_past + q_last + 1);  // exclusive
  const int k_beg = window > 0 ? max(0, n_past + q0 - window + 1) : 0;
  const size_t row_stride = (size_t)Hkv * D;
  const KV* kb = k + (size_t)b * S * row_stride + (size_t)hk * D;
  const KV* vb = v + (size_t)b * S * row_stride + (size_t)hk * D;
  const size_t sbase = (size_t)b * S * Hkv + hk;  // scale of row kp: + kp * Hkv

  for (int kt = k_beg / BKT; kt * BKT < k_end; ++kt) {
    const int c0 = kt * BKT;
    __syncthreads();  // previous tile's Ks/Vs/Ps are consumed
    for (int i = tid; i < BKT * D; i += NT) {
      const int c = i / D, d = i % D;
      const int kp = c0 + c;
      float kv = 0.f, vv = 0.f;
      if (kp < k_end) {
        const size_t si = sbase + (size_t)kp * Hkv;
        kv = kv_at(kb, (size_t)kp * row_stride + d, kscale, si);
        vv = kv_at(vb, (size_t)kp * row_stride + d, vscale, si);
      }
      Ks[d * KLD + c] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    // S = Q K^T for rows ty*4..+4, key columns tx*8..+8
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * QLD + ty * 4]);
      const float4 k0 = *reinterpret_cast<const float4*>(&Ks[d * KLD + tx * 8]);
      const float4 k1 =
          *reinterpret_cast<const float4*>(&Ks[d * KLD + tx * 8 + 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

    // mask, online softmax (row max / sum over the 8 lanes of a row group)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + ty * 4 + i;
      const int qp = n_past + t;
      float mx = lcg::kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = c0 + tx * 8 + j;
        float sc = s[i][j] * scale;
        if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
        const bool ok = t < T && kp < k_end && kp <= qp &&
                        (window <= 0 || kp > qp - window);
        s[i][j] = ok ? sc : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_r[i] = l_r[i] * alpha + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      float* prow = &Ps[(ty * 4 + i) * PLD + tx * 8];
      *reinterpret_cast<float4*>(prow) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(prow + 4) =
          make_float4(s[i][4], s[i][5], s[i][6], s[i][7]);
    }
    __syncthreads();

    // O += P V for rows ty*4..+4, head dims tx*DC..+DC
    const int nk = min(BKT, k_end - c0);
    for (int j = 0; j < nk; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PLD + j];
#pragma unroll
      for (int c4 = 0; c4 < DC; c4 += 4) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[j * D + tx * DC + c4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c4] = fmaf(pv[i], vv.x, acc[i][c4]);
          acc[i][c4 + 1] = fmaf(pv[i], vv.y, acc[i][c4 + 1]);
          acc[i][c4 + 2] = fmaf(pv[i], vv.z, acc[i][c4 + 2]);
          acc[i][c4 + 3] = fmaf(pv[i], vv.w, acc[i][c4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= T) continue;
    float denom = l_r[i], alpha = 1.f;
    if (sinks != nullptr) {  // the sink joins the running max, then the sum
      const float sk = sinks[hq];
      const float m_new = fmaxf(m_r[i], sk);
      alpha = expf(m_r[i] - m_new);
      denom = denom * alpha + expf(sk - m_new);
    }
    const float inv = alpha / fmaxf(denom, 1e-30f);
    E* orow = out + (((size_t)b * T + t) * Hq + hq) * D + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) lcg::from_float(acc[i][c] * inv, orow + c);
  }
}

template <typename E, typename KV, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const float* kscale, const float* vscale,
                     const int* n_past, const float* sinks, void* out, int B,
                     int T, int S, int Hq, int Hkv, float scale, int window,
                     float softcap, cudaStream_t st) {
  auto kern = flash_attention_kernel<E, KV, D>;
  static bool smem_set = false;  // once, so later launches may be graph-captured
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::bytes);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  dim3 grid((T + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NT, Smem<D>::bytes, st>>>(
      static_cast<const E*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), kscale, vscale, n_past, sinks,
      static_cast<E*>(out), T, S, Hq, Hkv, scale, window, softcap);
  return cudaGetLastError();
}

template <typename E, typename KV>
cudaError_t launch(int D, const void* q, const void* k, const void* v,
                   const float* kscale, const float* vscale,
                   const int* n_past, const float* sinks, void* out, int B,
                   int T, int S, int Hq, int Hkv, float scale, int window,
                   float softcap, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_d<E, KV, 64>(q, k, v, kscale, vscale, n_past, sinks, out,
                                 B, T, S, Hq, Hkv, scale, window, softcap, st);
    case 128:
      return launch_d<E, KV, 128>(q, k, v, kscale, vscale, n_past, sinks, out,
                                  B, T, S, Hq, Hkv, scale, window, softcap, st);
    case 256:  // 222 KB of shared tiles
      return launch_d<E, KV, 256>(q, k, v, kscale, vscale, n_past, sinks, out,
                                  B, T, S, Hq, Hkv, scale, window, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 != 0: q and output are bf16, else f32; kv_int8 != 0: the cache is
// int8 with kscale / vscale (B, S, Hkv) f32, else in q's type.  n_past:
// int32 (B,).
LCG_EXPORT int lcg_flash_attention(int bf16, int kv_int8, int D, const void* q,
                                   const void* k, const void* v,
                                   const float* kscale, const float* vscale,
                                   const int* n_past, const float* sinks,
                                   void* out, int B, int T, int S, int Hq,
                                   int Hkv, float scale, int window,
                                   float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_int8)
    return bf16 ? launch<__nv_bfloat16, int8_t>(D, q, k, v, kscale, vscale,
                                                n_past, sinks, out, B, T, S, Hq,
                                                Hkv, scale, window, softcap, st)
                : launch<float, int8_t>(D, q, k, v, kscale, vscale, n_past,
                                        sinks, out, B, T, S, Hq, Hkv, scale,
                                        window, softcap, st);
  return bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(
                    D, q, k, v, nullptr, nullptr, n_past, sinks, out, B, T, S,
                    Hq, Hkv, scale, window, softcap, st)
              : launch<float, float>(D, q, k, v, nullptr, nullptr, n_past,
                                     sinks, out, B, T, S, Hq, Hkv, scale,
                                     window, softcap, st);
}
