// K3 flash_decode: attention for a few new queries per KV head (G*T <= 128)
// over an already-updated KV cache.
//
// Replaces: llama_cpp_gfx906_tpu/ops/flash_decode.py  _decode_kernel
// (launched by _flash_decode_call, wrapper flash_decode), for bf16 or f32 KV
// with GQA, a per-sequence fill level n_past, sliding window, logit softcap
// and attention sinks.  Its int8-KV, ALiBi, self-extend and shared-prefix
// modes are not ported yet.
//
// Contract: qh (B, Hkv, NQ, D) f32 holds the NQ = G*T queries of each KV
// head, lane u = g*T + t (query head h*G + g, new token t); the cache
// (B, S, Hkv, D) already holds the T new rows at n_past .. n_past+T-1.
// Query t sits at position n_past + t and sees keys k with k <= n_past + t
// and, with a window W > 0, k > n_past + t - W.  A sink logit per lane joins
// the softmax denominator only.  Output (B, Hkv, NQ, D) f32.
//
// Bound on the card: the live KV bytes, 2 * n_live * D * sizeof(KV) per KV
// head, read once; the flops per byte are ~G, far below the ridge.  Design:
//   - one block per (batch, KV head) and tile of 8 queries: K and V are read
//     once for all G*T queries of the head, in the stored (B, S, Hkv, D)
//     layout, with no transpose;
//   - only the live rows [max(0, n_past+1-W), n_past+T) are walked, in tiles
//     of 64 keys, so the traffic follows n_past, not the allocation; the
//     block reads n_past itself, so the host never synchronises;
//   - the K and V rows of a tile stream into shared memory with 16-byte
//     cp.async copies, double-buffered: the next tile is in flight while
//     the current one computes;
//   - scores: 4 threads per key split the head dim and meet by shuffles;
//     online softmax per query in f32 (one warp per query); P.V: the same
//     warp owns its query, each lane D/32 head dims, 4 keys per step.
// At B = 1 the 8 KV heads of a llama-3 8B layer give 8 blocks on 132 SMs:
// the kernel cannot approach the bandwidth bound there.  Splitting the key
// range over more blocks (split-K with a merge) is the next step.

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr int BK = 64;   // keys per tile
constexpr int QT = 8;    // queries per block (one softmax warp each)
constexpr int KSPLIT = NT / BK;  // threads per key in the score phase

template <typename KV, int D>
struct Tile {
  // rows padded by 64 bytes: the 2 keys a quarter-warp reads hit other banks
  static constexpr int LD = D + 64 / sizeof(KV);
  static constexpr int CHUNKS = D * sizeof(KV) / 16;    // 16-byte chunks/row
  static constexpr int STAGE = 2 * BK * LD;             // K and V rows
  static constexpr size_t bytes = sizeof(KV) * 2 * STAGE;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n consecutive elements (n = 2, 4 or 8, 4n-byte aligned) as f32
template <int N>
__device__ __forceinline__ void load_dims(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 8) {
    load_dims<4>(p, out);
    load_dims<4>(p + 4, out + 4);
  } else if constexpr (N == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(w.x << 16); out[1] = __uint_as_float(w.x & 0xFFFF0000u);
    out[2] = __uint_as_float(w.y << 16); out[3] = __uint_as_float(w.y & 0xFFFF0000u);
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    out[0] = __uint_as_float(w << 16); out[1] = __uint_as_float(w & 0xFFFF0000u);
  }
}
template <int N>
__device__ __forceinline__ void load_dims(const float* p, float* out) {
  if constexpr (N == 8) {
    load_dims<4>(p, out);
    load_dims<4>(p + 4, out + 4);
  } else if constexpr (N == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    out[0] = w.x; out[1] = w.y; out[2] = w.z; out[3] = w.w;
  } else {
    const float2 w = *reinterpret_cast<const float2*>(p);
    out[0] = w.x; out[1] = w.y;
  }
}

template <typename KV, int D>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const float* __restrict__ qh, const KV* __restrict__ k,
                    const KV* __restrict__ v,
                    const int* __restrict__ n_past_arr,
                    const float* __restrict__ sinks,  // (Hkv, NQ) or null
                    float* __restrict__ out, int S, int Hkv, int NQ, int T,
                    float scale, int window, float softcap) {
  using TL = Tile<KV, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* stages = reinterpret_cast<KV*>(smem_raw);
  __shared__ __align__(16) float qs[QT][D];
  __shared__ __align__(16) float ps[QT][BK];
  __shared__ float m_s[QT], l_s[QT], alpha_s[QT];
  constexpr int DPT = D / 32;  // P.V: head dims per lane

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / Hkv, h = bh % Hkv;
  const int q0 = blockIdx.y * QT;
  const int n_past = n_past_arr[b];
  const int hi = min(n_past + T, S);  // live rows end
  const int lo = window > 0 ? max(0, n_past + 1 - window) : 0;
  const size_t row_stride = (size_t)Hkv * D;
  const KV* kb = k + (size_t)b * S * row_stride + (size_t)h * D;
  const KV* vb = v + (size_t)b * S * row_stride + (size_t)h * D;

  auto issue = [&](int t0, int stage) {
    KV* ks = stages + stage * TL::STAGE;
    KV* vs = ks + BK * TL::LD;
    for (int c = tid; c < 2 * BK * TL::CHUNKS; c += NT) {
      const int is_v = c >= BK * TL::CHUNKS;
      const int cc = c - is_v * BK * TL::CHUNKS;
      const int j = cc / TL::CHUNKS, e = (cc % TL::CHUNKS) * (16 / sizeof(KV));
      const bool valid = t0 + j < hi;
      const KV* src = (is_v ? vb : kb) + (size_t)(valid ? t0 + j : lo) * row_stride + e;
      cp_async16((is_v ? vs : ks) + j * TL::LD + e, src, valid);
    }
    cp_async_commit();
  };

  const int ntiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  if (ntiles > 0) issue(lo, 0);

  for (int i = tid; i < QT * D; i += NT) {
    const int qi = i / D, d = i % D;
    qs[qi][d] = (q0 + qi < NQ) ? qh[((size_t)bh * NQ + q0 + qi) * D + d] : 0.f;
  }
  if (tid < QT) {
    m_s[tid] = lcg::kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) acc[e] = 0.f;

  const int kj = tid / KSPLIT, kr = tid % KSPLIT;  // score phase: key, part
  const int warp = tid / 32, lane = tid % 32;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = lo + it * BK;
    if (it + 1 < ntiles) {
      issue(t0 + BK, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const KV* ks = stages + (it & 1) * TL::STAGE;
    const KV* vs = ks + BK * TL::LD;

    // scores: KSPLIT threads per key take interleaved 8-element chunks of
    // the dot, so the 4 query chunks they read lie in different banks
    float dot[QT];
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) dot[qi] = 0.f;
#pragma unroll
    for (int d = kr * 8; d < D; d += 8 * KSPLIT) {
      float kv8[8];
      lcg::load8(ks + kj * TL::LD + d, kv8);
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[qi][d]);
        const float4 c = *reinterpret_cast<const float4*>(&qs[qi][d + 4]);
        dot[qi] += a.x * kv8[0] + a.y * kv8[1] + a.z * kv8[2] + a.w * kv8[3] +
                   c.x * kv8[4] + c.y * kv8[5] + c.z * kv8[6] + c.w * kv8[7];
      }
    }
    const int kp = t0 + kj;
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
#pragma unroll
      for (int o = 1; o < KSPLIT; o <<= 1)
        dot[qi] += __shfl_xor_sync(0xffffffffu, dot[qi], o);
      if (kr == qi % KSPLIT) {
        const int qpos = n_past + (q0 + qi) % T;
        float sc = dot[qi] * scale;
        if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
        const bool ok = kp < hi && kp <= qpos && (window <= 0 || kp > qpos - window);
        ps[qi][kj] = ok ? sc : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns query w
    {
      const int qi = warp;
      float mx = lcg::kNegInf;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, ps[qi][j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[qi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float sv = ps[qi][j];
        const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
        ps[qi][j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[qi] = alpha;
        l_s[qi] = l_s[qi] * alpha + sum;
        m_s[qi] = m_new;
      }
    }
    __syncthreads();

    // P.V from shared memory: warp w owns query w, lane owns DPT head dims;
    // masked keys have p = 0 and rows past the live end were zero-filled
    {
      const int qi = warp;
      const float alpha = alpha_s[qi];
      const int nk4 = (min(BK, hi - t0) + 3) & ~3;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[e] *= alpha;
      for (int j = 0; j < nk4; j += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(&ps[qi][j]);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vv[DPT];
          load_dims<DPT>(vs + (j + u) * TL::LD + lane * DPT, vv);
#pragma unroll
          for (int e = 0; e < DPT; ++e) acc[e] = fmaf(pj[u], vv[e], acc[e]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's issue
  }

  const int qi = warp;
  if (q0 + qi < NQ) {
    float denom = l_s[qi], alpha = 1.f;
    if (sinks != nullptr) {  // the sink joins the running max, then the sum
      const float sk = sinks[h * NQ + q0 + qi];
      const float m_new = fmaxf(m_s[qi], sk);
      alpha = expf(m_s[qi] - m_new);
      denom = denom * alpha + expf(sk - m_new);
    }
    const float inv = alpha / fmaxf(denom, 1e-30f);
    float* o = out + ((size_t)bh * NQ + q0 + qi) * D + lane * DPT;
#pragma unroll
    for (int e = 0; e < DPT; ++e) o[e] = acc[e] * inv;
  }
}

template <typename KV, int D>
cudaError_t launch_d(const float* qh, const void* k, const void* v,
                     const int* n_past, const float* sinks, float* out, int B,
                     int S, int Hkv, int NQ, int T, float scale, int window,
                     float softcap, cudaStream_t st) {
  auto kern = flash_decode_kernel<KV, D>;
  const size_t smem = Tile<KV, D>::bytes;
  static bool smem_set = false;  // once, so later launches may be graph-captured
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  dim3 grid(B * Hkv, (NQ + QT - 1) / QT);
  kern<<<grid, NT, smem, st>>>(qh, static_cast<const KV*>(k),
                               static_cast<const KV*>(v), n_past, sinks, out,
                               S, Hkv, NQ, T, scale, window, softcap);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t launch(int D, const float* qh, const void* k, const void* v,
                   const int* n_past, const float* sinks, float* out, int B,
                   int S, int Hkv, int NQ, int T, float scale, int window,
                   float softcap, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_d<KV, 64>(qh, k, v, n_past, sinks, out, B, S, Hkv, NQ, T,
                              scale, window, softcap, st);
    case 128:
      return launch_d<KV, 128>(qh, k, v, n_past, sinks, out, B, S, Hkv, NQ, T,
                               scale, window, softcap, st);
    case 256:  // bf16 only: two f32 stages of 256-wide rows exceed 227 KB
      if constexpr (sizeof(KV) == 2)
        return launch_d<KV, 256>(qh, k, v, n_past, sinks, out, B, S, Hkv, NQ,
                                 T, scale, window, softcap, st);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// kv_bf16 != 0: the cache is bf16, else f32.  n_past: int32 (B,) on the card.
LCG_EXPORT int lcg_flash_decode(int kv_bf16, int D, const float* qh,
                                const void* k, const void* v,
                                const int* n_past, const float* sinks,
                                float* out, int B, int S, int Hkv, int NQ,
                                int T, float scale, int window, float softcap,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? launch<__nv_bfloat16>(D, qh, k, v, n_past, sinks, out, B, S,
                                         Hkv, NQ, T, scale, window, softcap, st)
                 : launch<float>(D, qh, k, v, n_past, sinks, out, B, S, Hkv,
                                 NQ, T, scale, window, softcap, st);
}
