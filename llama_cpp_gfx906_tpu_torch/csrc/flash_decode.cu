// K3 flash_decode: attention for a few new queries per KV head (G*T <= 128)
// over an already-updated KV cache.
//
// Replaces: llama_cpp_gfx906_tpu/ops/flash_decode.py  _decode_kernel
// (launched by _flash_decode_call, wrapper flash_decode), for bf16, f32 or
// int8 KV with GQA, a per-sequence fill level n_past, sliding window, logit
// softcap, attention sinks, a batch-shared prefix segment, ALiBi and
// self-extend (logical) positions.
//
// Contract: qh (B, Hkv, NQ, D) f32 holds the NQ = G*T queries of each KV
// head, lane u = g*T + t (query head h*G + g, new token t); the cache
// (B, S, Hkv, D) already holds the T new rows at n_past .. n_past+T-1.
// Query t sits at position n_past + t and sees keys k with k <= n_past + t
// and, with a window W > 0, k > n_past + t - W.  A sink logit per lane joins
// the softmax denominator only.  Output (B, Hkv, NQ, D) f32.
//
// int8 mode: the cache holds int8 rows and one f32 scale per (row, KV head),
// kscale / vscale (B, S, Hkv).  The K scale multiplies the score (the dot
// runs on the int8 values), the V scale multiplies p before P.V (the
// softmax sum takes p without it), as the JAX kernel folds them; no
// dequantized copy of the cache is ever built.
//
// Shared-prefix mode: S0 rows shk / shv (S0, Hkv, D), stored once for the
// whole batch in the compute type (bf16 or f32, also beside an int8 cache),
// sit at logical positions 0 .. S0-1 and the own rows at S0 + row.  Every
// block walks the shared rows first, then its own live rows, in one online
// softmax; the shared rows are all causally visible, the window applies
// over logical positions.
//
// ALiBi mode (slopes (Hkv, NQ) f32 per query lane, or null): each score,
// after the softcap and before the mask, loses slope * (q_pos - k_pos), the
// positions of the segment's own coordinates (shared rows at 0 .. S0-1 and
// queries at S0 + n_past + t; own rows at their row and queries at
// n_past + t) or, in the self-extend mode, the logical ones.
//
// Self-extend mode (kv_pos (B, S) and q_pos (B, T) int32, or null): row r
// of sequence b sits at logical position kv_pos[b, r], query t at
// q_pos[b, t]; a row is seen where its logical position is at most the
// query's (and, with a window, above q - W) and it is live (r < n_past +
// T).  Logical positions do not follow rows, so no row is skipped by the
// window: the block walks every live row and stages the 64 positions of a
// tile beside its K and V rows.  Not with a shared segment (the JAX kernel
// raises there too).  The two modes share one instantiation flag (EXT),
// each on or off at run time inside it: as runtime branches in every
// instantiation they cost the other modes 6-8% (measured at n_past 3000),
// as a flag they double K3's instantiations (its build still runs beside
// decode_stream.cu's, which takes far longer).
//
// Bound on the card: the live KV bytes read once, 2 * n_live * D * sizeof(KV)
// per KV head, plus 4 bytes of scale per row and head in the int8 mode, plus
// the shared rows (read by every slot's block: B times from the kernel, once
// from device memory when L2 serves the repeats); the flops per byte are
// ~G, far below the ridge.  Design:
//   - one block per (batch, KV head) and tile of 8 queries: K and V are read
//     once for all G*T queries of the head, in the stored (B, S, Hkv, D)
//     layout, with no transpose;
//   - only the live rows [max(0, n_past+1-W), n_past+T) are walked (and the
//     shared rows inside the window; with logical positions every live
//     row), in tiles of 64 keys, so the traffic follows n_past, not the
//     allocation; the block reads n_past itself, so the host never
//     synchronises;
//   - the K and V rows of a tile stream into shared memory with 16-byte
//     cp.async copies (16 dims of int8, 8 of bf16, 4 of f32), and the
//     int8 mode's scales (and the self-extend mode's positions) with 4-byte
//     ones beside them, double-buffered: the
//     next tile is in flight while the current one computes;
//   - scores: 4 threads per key split the head dim and meet by shuffles;
//     online softmax per query in f32 (one warp per query); P.V: the same
//     warp owns its query, each lane D/32 head dims, 4 keys per step.
// At B = 1 the 8 KV heads of a llama-3 8B layer give 8 blocks on 132 SMs
// (32 at B = 4): the kernel cannot approach the bandwidth bound there.
// Splitting the key range over more blocks (split-K with a merge) is the
// next step.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr int BK = 64;   // keys per tile
constexpr int QT = 8;    // queries per block (one softmax warp each)
constexpr int KSPLIT = NT / BK;  // threads per key in the score phase

template <typename E, int D>
struct Tile {
  // rows padded by 64 bytes: the 2 keys a quarter-warp reads hit other banks
  static constexpr int LD = D + 64 / sizeof(E);
  static constexpr int CHUNKS = D * sizeof(E) / 16;    // 16-byte chunks/row
  static constexpr int STAGE = 2 * BK * LD;             // K and V rows
  static constexpr size_t bytes = sizeof(E) * 2 * STAGE;
};

// dynamic shared memory of one block: the larger of the own and shared tiles
template <typename KV, typename SH, int D>
constexpr size_t stage_bytes() {
  return Tile<KV, D>::bytes > Tile<SH, D>::bytes ? Tile<KV, D>::bytes
                                                 : Tile<SH, D>::bytes;
}

template <int D>
struct __align__(16) Shared {
  float qs[QT][D];
  float ps[QT][BK];
  float sc[2][2][BK];  // int8 mode: [stage][K, V][key] scales
  int kpos[2][BK];     // self-extend mode: [stage][key] logical positions
  float slope[QT];     // ALiBi mode: each query's slope
  int qlog[QT];        // self-extend mode: each query's logical position
  float m[QT], l[QT], alpha[QT];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n consecutive elements (n = 2, 4 or 8, aligned to their size) as f32
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
template <int N>
__device__ __forceinline__ void load_dims(const int8_t* p, float* out) {
  if constexpr (N == 8) {
    lcg::load8(p, out);
  } else if constexpr (N == 4) {
    lcg::unpack_s8x4(*reinterpret_cast<const uint32_t*>(p), out);
  } else {
    const uint16_t w = *reinterpret_cast<const uint16_t*>(p);
    out[0] = static_cast<float>(static_cast<int8_t>(w & 0xFFu));
    out[1] = static_cast<float>(static_cast<int8_t>(w >> 8));
  }
}

// One segment of rows [lo, hi) into the running softmax of the block's
// queries.  Row r of the segment lies at kb + r * row_stride (its scales, in
// the int8 mode, at ksb / vsb + r * scale_stride; its logical position, in
// the self-extend mode, at posb[r], the queries' at sh.qlog); query t of the
// block sits at qpos0 + t in the segment's row coordinates.  ``alibi``: the
// scores take the slopes in sh.slope.  Both only where EXT.
template <typename E, int D, bool EXT>
__device__ __forceinline__ void walk(const E* __restrict__ kb,
                                     const E* __restrict__ vb,
                                     const float* __restrict__ ksb,
                                     const float* __restrict__ vsb,
                                     const int* __restrict__ posb,
                                     size_t row_stride, int scale_stride,
                                     int lo, int hi, int qpos0, int T, int q0,
                                     float scale, int window, float softcap,
                                     bool alibi, E* stages, Shared<D>& sh,
                                     float (&acc)[D / 32]) {
  using TL = Tile<E, D>;
  constexpr bool QUANT = std::is_same<E, int8_t>::value;
  constexpr int DPT = D / 32;  // P.V: head dims per lane
  const int tid = threadIdx.x;

  auto issue = [&](int t0, int stage) {
    E* ks = stages + stage * TL::STAGE;
    E* vs = ks + BK * TL::LD;
    for (int c = tid; c < 2 * BK * TL::CHUNKS; c += NT) {
      const int is_v = c >= BK * TL::CHUNKS;
      const int cc = c - is_v * BK * TL::CHUNKS;
      const int j = cc / TL::CHUNKS, e = (cc % TL::CHUNKS) * (16 / sizeof(E));
      const bool valid = t0 + j < hi;
      const E* src = (is_v ? vb : kb) + (size_t)(valid ? t0 + j : lo) * row_stride + e;
      cp_async16((is_v ? vs : ks) + j * TL::LD + e, src, valid);
    }
    if constexpr (QUANT) {
      if (tid < 2 * BK) {
        const int is_v = tid >= BK, j = tid % BK;
        const bool valid = t0 + j < hi;
        const float* src =
            (is_v ? vsb : ksb) + (size_t)(valid ? t0 + j : lo) * scale_stride;
        cp_async4(&sh.sc[stage][is_v][j], src, valid);
      }
    }
    if constexpr (EXT) {
      if (posb != nullptr && tid >= 2 * BK && tid < 3 * BK) {
        const int j = tid - 2 * BK;
        const bool valid = t0 + j < hi;
        cp_async4(&sh.kpos[stage][j], posb + (valid ? t0 + j : lo), valid);
      }
    }
    cp_async_commit();
  };

  const int ntiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  if (ntiles > 0) issue(lo, 0);
  const int kj = tid / KSPLIT, kr = tid % KSPLIT;  // score phase: key, part
  const int warp = tid / 32, lane = tid % 32;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = lo + it * BK;
    const int stage = it & 1;
    if (it + 1 < ntiles) {
      issue(t0 + BK, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const E* ks = stages + stage * TL::STAGE;
    const E* vs = ks + BK * TL::LD;

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
        const float4 a = *reinterpret_cast<const float4*>(&sh.qs[qi][d]);
        const float4 c = *reinterpret_cast<const float4*>(&sh.qs[qi][d + 4]);
        dot[qi] += a.x * kv8[0] + a.y * kv8[1] + a.z * kv8[2] + a.w * kv8[3] +
                   c.x * kv8[4] + c.y * kv8[5] + c.z * kv8[6] + c.w * kv8[7];
      }
    }
    const int kp = t0 + kj;
    const float kscale = QUANT ? sh.sc[stage][0][kj] : 1.f;
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
#pragma unroll
      for (int o = 1; o < KSPLIT; o <<= 1)
        dot[qi] += __shfl_xor_sync(0xffffffffu, dot[qi], o);
      if (kr == qi % KSPLIT) {
        // the query's and the key's positions: physical (in the segment's
        // coordinates) or, in the self-extend mode, logical
        const int qph = qpos0 + (q0 + qi) % T;
        int qp = qph, kq = kp;
        float sc = dot[qi] * kscale * scale;
        if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
        if constexpr (EXT) {
          if (posb != nullptr) {
            qp = sh.qlog[qi];
            kq = sh.kpos[stage][kj];
          }
          if (alibi) sc -= sh.slope[qi] * static_cast<float>(qp - kq);
        }
        const bool ok = kp < hi && kq <= qp && (window <= 0 || kq > qp - window);
        sh.ps[qi][kj] = ok ? sc : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns query w; the int8 mode's V scale joins p
    // after the sum
    {
      const int qi = warp;
      float mx = lcg::kNegInf;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, sh.ps[qi][j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sh.m[qi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float sv = sh.ps[qi][j];
        const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
        sh.ps[qi][j] = QUANT ? p * sh.sc[stage][1][j] : p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sh.alpha[qi] = alpha;
        sh.l[qi] = sh.l[qi] * alpha + sum;
        sh.m[qi] = m_new;
      }
    }
    __syncthreads();

    // P.V from shared memory: warp w owns query w, lane owns DPT head dims;
    // masked keys have p = 0 and rows past the live end were zero-filled
    {
      const int qi = warp;
      const float alpha = sh.alpha[qi];
      const int nk4 = (min(BK, hi - t0) + 3) & ~3;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[e] *= alpha;
      for (int j = 0; j < nk4; j += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(&sh.ps[qi][j]);
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
}

template <typename KV, typename SH, bool SHARED, bool EXT, int D>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const float* __restrict__ qh, const KV* __restrict__ k,
                    const KV* __restrict__ v,
                    const float* __restrict__ kscale,  // (B, S, Hkv) or null
                    const float* __restrict__ vscale,
                    const SH* __restrict__ shk,  // (S0, Hkv, D) or null
                    const SH* __restrict__ shv, int S0,
                    const int* __restrict__ n_past_arr,
                    const float* __restrict__ sinks,  // (Hkv, NQ) or null
                    const float* __restrict__ slopes,  // (Hkv, NQ) or null
                    const int* __restrict__ kv_pos,    // (B, S) or null
                    const int* __restrict__ q_pos,     // (B, T) or null
                    float* __restrict__ out, int S, int Hkv, int NQ, int T,
                    float scale, int window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared<D> sh;
  constexpr int DPT = D / 32;
  // slot: bit 0 int8, bit 1 shared, bit 2 ALiBi, bit 3 logical positions
  const bool alibi = slopes != nullptr;
  lcg::count_launch((std::is_same<KV, int8_t>::value ? 1 : 0) + (SHARED ? 2 : 0) +
                    (alibi ? 4 : 0) + (kv_pos != nullptr ? 8 : 0));

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / Hkv, h = bh % Hkv;
  const int q0 = blockIdx.y * QT;
  const int n_past = n_past_arr[b];
  const size_t row_stride = (size_t)Hkv * D;

  for (int i = tid; i < QT * D; i += NT) {
    const int qi = i / D, d = i % D;
    sh.qs[qi][d] = (q0 + qi < NQ) ? qh[((size_t)bh * NQ + q0 + qi) * D + d] : 0.f;
  }
  if (tid < QT) {
    const int lane = min(q0 + tid, NQ - 1);
    sh.m[tid] = lcg::kNegInf;
    sh.l[tid] = 0.f;
    sh.slope[tid] = alibi ? slopes[h * NQ + lane] : 0.f;
    sh.qlog[tid] = q_pos != nullptr ? q_pos[b * T + lane % T] : 0;
  }
  float acc[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) acc[e] = 0.f;

  if constexpr (SHARED) {  // logical rows 0 .. S0-1, queries at S0 + n_past + t
    const int qpos0 = S0 + n_past;
    const int lo = window > 0 ? max(0, qpos0 + 1 - window) : 0;
    walk<SH, D, EXT>(shk + (size_t)h * D, shv + (size_t)h * D, nullptr, nullptr,
                nullptr, row_stride, 0, lo, S0, qpos0, T, q0, scale, window,
                softcap, alibi, reinterpret_cast<SH*>(smem_raw), sh, acc);
  }
  {
    const int hi = min(n_past + T, S);  // live rows end
    // logical positions do not follow rows: no window skip with them
    const int lo = (window > 0 && kv_pos == nullptr) ? max(0, n_past + 1 - window) : 0;
    const size_t base = (size_t)b * S * row_stride + (size_t)h * D;
    const size_t sbase = (size_t)b * S * Hkv + h;
    walk<KV, D, EXT>(k + base, v + base,
                kscale != nullptr ? kscale + sbase : nullptr,
                vscale != nullptr ? vscale + sbase : nullptr,
                kv_pos != nullptr ? kv_pos + (size_t)b * S : nullptr, row_stride,
                Hkv, lo, hi, n_past, T, q0, scale, window, softcap, alibi,
                reinterpret_cast<KV*>(smem_raw), sh, acc);
  }

  const int qi = tid / 32, lane = tid % 32;
  if (q0 + qi < NQ) {
    float denom = sh.l[qi], alpha = 1.f;
    if (sinks != nullptr) {  // the sink joins the running max, then the sum
      const float sk = sinks[h * NQ + q0 + qi];
      const float m_new = fmaxf(sh.m[qi], sk);
      alpha = expf(sh.m[qi] - m_new);
      denom = denom * alpha + expf(sk - m_new);
    }
    const float inv = alpha / fmaxf(denom, 1e-30f);
    float* o = out + ((size_t)bh * NQ + q0 + qi) * D + lane * DPT;
#pragma unroll
    for (int e = 0; e < DPT; ++e) o[e] = acc[e] * inv;
  }
}

struct Args {
  const float* qh;
  const void *k, *v;
  const float *kscale, *vscale;
  const void *shk, *shv;
  int S0;
  const int* n_past;
  const float* sinks;
  const float* slopes;
  const int *kv_pos, *q_pos;
  float* out;
  int B, S, Hkv, NQ, T;
  float scale;
  int window;
  float softcap;
};

template <typename KV, typename SH, bool SHARED, bool EXT, int D>
cudaError_t launch_d(const Args& a, cudaStream_t st) {
  auto kern = flash_decode_kernel<KV, SH, SHARED, EXT, D>;
  constexpr size_t smem = stage_bytes<KV, SH, D>();
  static bool smem_set = false;  // once, so later launches may be graph-captured
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  dim3 grid(a.B * a.Hkv, (a.NQ + QT - 1) / QT);
  kern<<<grid, NT, smem, st>>>(
      a.qh, static_cast<const KV*>(a.k), static_cast<const KV*>(a.v), a.kscale,
      a.vscale, static_cast<const SH*>(a.shk), static_cast<const SH*>(a.shv),
      a.S0, a.n_past, a.sinks, a.slopes, a.kv_pos, a.q_pos, a.out, a.S, a.Hkv,
      a.NQ, a.T, a.scale, a.window, a.softcap);
  return cudaGetLastError();
}

constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory per block

template <typename KV, typename SH, bool SHARED, bool EXT>
cudaError_t launch_s(int D, const Args& a, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_d<KV, SH, SHARED, EXT, 64>(a, st);
    case 128:
      return launch_d<KV, SH, SHARED, EXT, 128>(a, st);
    case 256:  // two f32 stages of 256-wide rows exceed 227 KB
      if constexpr (stage_bytes<KV, SH, 256>() <= kMaxSmem)
        return launch_d<KV, SH, SHARED, EXT, 256>(a, st);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// the shared mode and the ALiBi / logical-position modes are instantiations
// of their own, so a profiler trace tells them apart by name
template <typename KV, typename SH, bool EXT>
cudaError_t launch_x(int D, const Args& a, cudaStream_t st) {
  return a.S0 > 0 ? launch_s<KV, SH, true, EXT>(D, a, st)
                  : launch_s<KV, SH, false, EXT>(D, a, st);
}
template <typename KV, typename SH>
cudaError_t launch(int D, const Args& a, cudaStream_t st) {
  return (a.slopes != nullptr || a.kv_pos != nullptr) ? launch_x<KV, SH, true>(D, a, st)
                                                      : launch_x<KV, SH, false>(D, a, st);
}

}  // namespace

// kv_kind: 0 f32, 1 bf16, 2 int8 (with kscale / vscale (B, S, Hkv) f32).
// sh_kind: the shared rows' type, 0 f32 or 1 bf16 (S0 > 0); beside a bf16 or
// f32 cache it must be the cache's.  n_past: int32 (B,) on the card.
// slopes (Hkv, NQ) f32, kv_pos (B, S) and q_pos (B, T) int32: null when off;
// kv_pos and q_pos come together, and not with S0 > 0.
LCG_EXPORT int lcg_flash_decode(int kv_kind, int sh_kind, int D,
                                const float* qh, const void* k, const void* v,
                                const float* kscale, const float* vscale,
                                const void* shk, const void* shv, int S0,
                                const int* n_past, const float* sinks,
                                const float* slopes, const int* kv_pos,
                                const int* q_pos, float* out, int B, int S,
                                int Hkv, int NQ, int T, float scale, int window,
                                float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{qh,     k,      v,      kscale, vscale, shk, shv, S0,
               n_past, sinks,  slopes, kv_pos, q_pos,  out, B,   S,
               Hkv,    NQ,     T,      scale,  window, softcap};
  if (S0 > 0 && kv_kind != 2 && sh_kind != kv_kind) return cudaErrorInvalidValue;
  if ((kv_pos == nullptr) != (q_pos == nullptr) || (kv_pos != nullptr && S0 > 0))
    return cudaErrorInvalidValue;
  switch (kv_kind) {
    case 0:
      return launch<float, float>(D, a, st);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(D, a, st);
    case 2:
      return sh_kind == 1 ? launch<int8_t, __nv_bfloat16>(D, a, st)
                          : launch<int8_t, float>(D, a, st);
    default:
      return cudaErrorInvalidValue;
  }
}
