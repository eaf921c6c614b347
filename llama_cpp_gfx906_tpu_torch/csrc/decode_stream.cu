// K6 decode_stream and K7 decode_step: one decode token for each of B <= 8
// slots through the whole layer stack, in one persistent launch.
//
// Replaces: llama_cpp_gfx906_tpu/ops/decode_stream.py  _kernel (K6, launched
// by fused_decode_step_streamed) and ops/decode_step.py  _kernel (K7,
// fused_decode_step), for the dense llama modes: int8 or nib4c weights with
// plain or folded scales and affine mins, a fused q|k|v or split-v (q|k
// fused, v apart) layout, NORM/NEOX rope, per-layer sliding windows, silu,
// bf16 or f32 KV.  K7 is the instantiation with B = 1, int8 weights and
// plain scales (its own C entry point); its gate picks it.  Not ported yet:
// the MoE branch, qk-norm, post-norms, dual rope bases and gelu.
//
// Per layer (x: the f32 carry, B rows):
//   P1  h = rms(x) * attn_norm, bf16;  qkv = h · Wqkv (and h · Wv)
//   P2  rope q, k; write the new K/V row at n_past; the self term's score;
//       split-K over the live rows [lo, n_past) of every (slot, KV head):
//       each split's maximum score
//   P3  each split: p = exp(score - M) against the maximum M over all
//       splits and the self term, partial l = sum p and acc = bf16(p) · V
//   P4  merge the partials with the self term -> o (bf16)
//   P5  attn = o · Wo
//   P6  x = bf16(x) + bf16(attn);  h2 = rms(x) * ffn_norm, bf16;  gu = h2 · Wgu
//   P7  y = bf16(silu(bf16(g))) * bf16(u);  mlp = y · Wdown
// and the next layer's P1 adds x = bf16(x) + bf16(mlp).  A grid-wide
// barrier ends each phase (7 per layer); every block recomputes the RMS
// norm it needs instead of waiting on another barrier.
//
// Bound on the card: the weight bytes of every layer plus the live KV, read
// once per step (B <= 8 rows ride the same weight stream).  Design:
//   - one cooperative launch (co-resident blocks, sized by the occupancy
//     query) loops over the layers; the launch reads n_past on the device
//     and takes its per-layer planes from a device table built at load
//     time, so a step can be captured in a CUDA graph;
//   - GEMVs: work units (128-column tile x K segment) of K1/K2's tile
//     (gemv_tile.cuh) spread over all blocks, partial sums by atomicAdd;
//   - attention: each slot's live rows are split over blocks (split-K), so
//     B = 1 still fills the card (K3 gets one block per KV head); two
//     passes over the keys (P2, P3) make every split round p against the
//     same maximum, so the result does not depend on the grid; the
//     current token's K/V never round-trips: its score is a self term;
//   - the barrier is a generation-counted atomic barrier; its count returns
//     to 0 after every barrier, so the same buffers serve every replay;
//   - data written during the launch is read with ld.global.cg (L2), never
//     from a stale L1 line.
// Numerics follow the JAX kernel's rounding points: h is bf16 before every
// GEMV; int8 weights dequantize as the f32 product rounded to bf16 (nib4c
// products stay exact in f32, as the JAX groupdot schedule gives); f32
// accumulation; mins as (per-group sum of x) * m; q, k rope in f32 from
// bf16-rounded projections; p rounds to bf16 before P·V; the residual adds
// round to bf16.

#include "gemv_tile.cuh"

namespace {

using lcg::bf16r;
using lcg::GT_NT;
using lcg::GT_SMEM_FLOATS;
using lcg::GT_TN;

constexpr int NT = GT_NT;
constexpr int NWARP = NT / 32;
constexpr int TABLE_W = 28;   // per layer: 5 projections x 5 planes, 2 norms, window
constexpr int NPROJ = 5;
enum { P_QKV = 0, P_V = 1, P_O = 2, P_GU = 3, P_DN = 4 };
constexpr int T_ANORM = 25, T_FNORM = 26, T_WINDOW = 27;
constexpr int KT = 64;          // keys per attention tile
constexpr int MAX_G = 16;       // query heads per KV head
constexpr int MAX_QDIM = 4096;  // G * Dh
constexpr int MAX_NOUT = MAX_QDIM / NT;
constexpr int MAX_SPLIT = 32;   // the merge gives one lane per split
constexpr int SM_SC = MAX_QDIM;              // scores (MAX_G x KT)
constexpr int SM_K = SM_SC + MAX_G * KT;     // the new K row (Dh <= 512)
static_assert(SM_K + 512 <= GT_SMEM_FLOATS, "attention smem layout");

struct ProjDims {
  int K, N, group, sgroup, ck, seg, nib;
};

// Mirrors DecodeArgs in ops/decode_stream.py (ctypes).
struct DecodeArgs {
  const long long* table;  // (L, TABLE_W) plane addresses, norms, windows
  void* kc;                // (L, B, S, Hkv*Dh) KV, updated in place
  void* vc;
  const int* n_past;       // (B,)
  const float* inv_freq;   // (Dh/2,)
  const float* x0;         // (MP, D) the embedded tokens, f32
  float* xin;              // (MP, D) layer input
  float* xmid;             // (MP, D) after the attention residual
  float* xout;             // (MP, D) result
  float* qkv_acc;          // (MP, Nqkv) GEMV accumulators, zeroed by the
  float* o_acc;            // (MP, D)    caller before the launch
  float* gu_acc;           // (MP, 2F)
  float* dn_acc;           // (MP, D)
  float* obuf;             // (MP, Hq*Dh) attention output, bf16-valued
  float* part;             // (B, Hkv, nsplit, G, Dh + 2) split partials
  float* selfs;            // (B, Hq) self-term scores
  unsigned* bar;           // barrier count and generation, zero at rest
  ProjDims proj[NPROJ];
  int L, B, D, Hq, Hkv, Dh, F, S, nsplit, split_v, interleaved;
  float scale, eps;
};

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }

__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void zero_grid(float* p, int n) {
  for (int i = blockIdx.x * NT + threadIdx.x; i < n; i += gridDim.x * NT)
    p[i] = 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rs[m] = rsqrt(mean_k src(m, k)^2 + eps) for the MP rows, in every block
template <int MP, class SRC>
__device__ __forceinline__ void row_rms(SRC src, int B, int D, float eps,
                                        float* red, float* rs) {
  float acc[MP];
#pragma unroll
  for (int m = 0; m < MP; ++m) acc[m] = 0.f;
  for (int k = threadIdx.x; k < D; k += NT) {
#pragma unroll
    for (int m = 0; m < MP; ++m)
      if (m < B) {
        const float v = src(m, k);
        acc[m] += v * v;
      }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int m = 0; m < MP; ++m) {
    const float v = warp_sum(acc[m]);
    if (lane == 0) red[warp * MP + m] = v;
  }
  __syncthreads();
  if (threadIdx.x < MP) {
    float s = 0.f;
    for (int w = 0; w < NWARP; ++w) s += red[w * MP + threadIdx.x];
    rs[threadIdx.x] = threadIdx.x < B ? rsqrtf(s / D + eps) : 0.f;
  }
  __syncthreads();
}

__device__ __forceinline__ int gemv_units(const ProjDims& p) {
  const int rows = p.nib ? p.K / 2 : p.K;
  return ((p.N + GT_TN - 1) / GT_TN) * (rows / p.seg);
}

// unit u of projection p (planes: q, s, m, sd, md addresses) into out
template <int MP, bool FOLDED, bool NIB_OK, class XF>
__device__ __forceinline__ void gemv_unit(XF xf, const ProjDims& p,
                                          const long long* planes, float* out,
                                          int out_ld, int u, float* smem) {
  const int8_t* q = reinterpret_cast<const int8_t*>(planes[0]);
  const void* s = reinterpret_cast<const void*>(planes[1]);
  const void* mn = reinterpret_cast<const void*>(planes[2]);
  const float* sd = reinterpret_cast<const float*>(planes[3]);
  const float* md = reinterpret_cast<const float*>(planes[4]);
  const int ntn = (p.N + GT_TN - 1) / GT_TN;
  const int sg = FOLDED ? p.sgroup : 1;
  if (NIB_OK && p.nib)
    lcg::gemv_tile<MP, true, FOLDED, false>(xf, q, s, mn, sd, md, out, out_ld,
                                            p.K, p.N, p.group, sg, p.ck, p.seg,
                                            u % ntn, u / ntn, smem);
  else
    lcg::gemv_tile<MP, false, FOLDED, true>(xf, q, s, mn, sd, md, out, out_ld,
                                            p.K, p.N, p.group, sg, p.ck, p.seg,
                                            u % ntn, u / ntn, smem);
}

// every unit of one projection (and of a second one, when given) over the
// grid
template <int MP, bool FOLDED, bool NIB_OK, class XF>
__device__ __forceinline__ void gemv_phase(XF xf, const DecodeArgs& a,
                                           const long long* tb, int p0,
                                           float* out0, int p1, float* out1,
                                           int out_ld, float* smem) {
  const int n0 = gemv_units(a.proj[p0]);
  const int n1 = p1 >= 0 ? gemv_units(a.proj[p1]) : 0;
  for (int u = blockIdx.x; u < n0 + n1; u += gridDim.x) {
    __syncthreads();  // the previous unit's reduction still reads smem
    if (u < n0)
      gemv_unit<MP, FOLDED, NIB_OK>(xf, a.proj[p0], tb + 5 * p0, out0, out_ld,
                                    u, smem);
    else
      gemv_unit<MP, FOLDED, NIB_OK>(xf, a.proj[p1], tb + 5 * p1, out1, out_ld,
                                    u - n0, smem);
  }
}

// element d of a rotated head whose raw projection starts at v (f32,
// rounded to bf16 first, as the JAX kernel rounds qkv)
__device__ __forceinline__ float rope_at(const float* v, int d, int Dh,
                                         float pos, const float* inv_freq,
                                         int interleaved) {
  const int half = Dh / 2;
  int pd, fi;
  float sgn;
  if (interleaved) {  // ggml NORM: pairs (2i, 2i+1)
    fi = d >> 1;
    pd = d ^ 1;
    sgn = (d & 1) ? 1.f : -1.f;
  } else {  // NEOX: pairs (i, i + Dh/2)
    fi = d < half ? d : d - half;
    pd = d < half ? d + half : d - half;
    sgn = d < half ? -1.f : 1.f;
  }
  const float ang = pos * inv_freq[fi];
  const float c = cosf(ang), sn = sinf(ang) * sgn;
  return bf16r(ldcg(v + d)) * c + bf16r(ldcg(v + pd)) * sn;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(w.x << 16); o[1] = __uint_as_float(w.x & 0xFFFF0000u);
  o[2] = __uint_as_float(w.y << 16); o[3] = __uint_as_float(w.y & 0xFFFF0000u);
}
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  o[0] = w.x; o[1] = w.y; o[2] = w.z; o[3] = w.w;
}

// The attention of one (slot b, KV head h, split s) unit over the split's
// share [r0, r1) of the live rows, in two passes with a grid barrier
// between them, so that every split rounds p = exp(score - M) to bf16
// against the same M, the maximum over all live rows and the self term (as
// the plain version does; the result does not depend on the split count):
//   PV = false (P2): each query head's maximum score over the split into
//     part's m slot; split 0 also writes the new K/V row at n_past and the
//     self term's score;
//   PV = true (P3): l = sum p and acc = bf16(p) · V into part.
template <bool PV, typename KV>
__device__ void attn_unit(const DecodeArgs& a, int l, int window, int b,
                          int h, int s, float* smem, float* m_s, float* l_s) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Dh = a.Dh, G = a.Hq / a.Hkv, HD = a.Hkv * Dh, Dq = a.Hq * Dh;
  const int Nqkv = Dq + 2 * HD;
  const int np = a.n_past[b];
  const float pos = (float)np;
  const float* qk = a.qkv_acc + (size_t)b * Nqkv;
  const size_t lb = (size_t)l * a.B + b;
  KV* kc = static_cast<KV*>(a.kc) + lb * a.S * HD + (size_t)h * Dh;
  KV* vc = static_cast<KV*>(a.vc) + lb * a.S * HD + (size_t)h * Dh;
  float* qs = smem;           // (G, Dh) rotated queries, bf16-valued
  float* sc = smem + SM_SC;   // (G, KT) scores, then probabilities
  float* ks = smem + SM_K;    // (Dh,) the new K row, bf16-valued
  float* pp = a.part + (((size_t)(b * a.Hkv + h) * a.nsplit + s) * G) * (Dh + 2);
  const size_t stride = (size_t)G * (Dh + 2);  // between splits

  for (int i = tid; i < G * Dh; i += NT) {
    const int g = i / Dh, d = i % Dh;
    qs[i] = bf16r(rope_at(qk + (size_t)(h * G + g) * Dh, d, Dh, pos,
                          a.inv_freq, a.interleaved));
  }
  if (tid < G) {
    float M = lcg::kNegInf;
    if (PV) {
      const float* pm = pp - (size_t)s * stride + (size_t)tid * (Dh + 2) + Dh;
      M = ldcg(a.selfs + (size_t)b * a.Hq + h * G + tid);
      for (int sp = 0; sp < a.nsplit; ++sp) M = fmaxf(M, ldcg(pm + sp * stride));
    }
    m_s[tid] = M;
    l_s[tid] = 0.f;
  }
  if (!PV && s == 0) {  // the new row: into the cache at n_past, self term
    for (int d = tid; d < Dh; d += NT) {
      const float kr = rope_at(qk + Dq + (size_t)h * Dh, d, Dh, pos,
                               a.inv_freq, a.interleaved);
      const float vv = bf16r(ldcg(qk + Dq + HD + (size_t)h * Dh + d));
      if (np < a.S) {
        lcg::from_float(kr, kc + (size_t)np * HD + d);
        lcg::from_float(vv, vc + (size_t)np * HD + d);
      }
      ks[d] = bf16r(kr);
    }
  }
  __syncthreads();
  if (!PV && s == 0) {
    for (int g = warp; g < G; g += NWARP) {
      float v = 0.f;
      for (int d = lane; d < Dh; d += 32) v += qs[g * Dh + d] * ks[d];
      v = warp_sum(v);
      if (lane == 0) a.selfs[(size_t)b * a.Hq + h * G + g] = v * a.scale;
    }
  }

  const int live = min(np, a.S);  // a full cache reads its S rows
  const int lo = window > 0 ? max(np - window + 1, 0) : 0;
  const int per = (live - lo + a.nsplit - 1) / a.nsplit;
  const int r0 = lo + s * per, r1 = min(r0 + per, live);
  const int nout = G * Dh;
  float acc[MAX_NOUT];
#pragma unroll
  for (int i = 0; i < MAX_NOUT; ++i) acc[i] = 0.f;

  for (int t0 = r0; t0 < r1; t0 += KT) {
    const int nk = min(KT, r1 - t0);
    // scores: a warp per key, each lane 4 head dims per 128
    for (int j = warp; j < nk; j += NWARP) {
      const KV* krow = kc + (size_t)(t0 + j) * HD;
      float dot[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) dot[g] = 0.f;
      for (int c = lane * 4; c < Dh; c += 128) {
        float kf[4];
        load4(krow + c, kf);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) {
            const float* qg = qs + g * Dh + c;
            dot[g] += qg[0] * kf[0] + qg[1] * kf[1] + qg[2] * kf[2] +
                      qg[3] * kf[3];
          }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) {
          const float v = warp_sum(dot[g]);
          if (lane == 0) sc[g * KT + j] = v * a.scale;
        }
    }
    __syncthreads();
    // a warp per query head: the running maximum, or p and its sum
    for (int g = warp; g < G; g += NWARP) {
      if (!PV) {
        float mx = lcg::kNegInf;
        for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, sc[g * KT + j]);
        mx = warp_max(mx);
        if (lane == 0) m_s[g] = fmaxf(m_s[g], mx);
      } else {
        const float M = m_s[g];
        float sum = 0.f;
        for (int j = lane; j < nk; j += 32) {
          const float p = expf(sc[g * KT + j] - M);
          sc[g * KT + j] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) l_s[g] += sum;
      }
    }
    __syncthreads();
    if (PV) {
      // P·V with p rounded to bf16: thread owns outputs o = tid + i*NT
#pragma unroll
      for (int i = 0; i < MAX_NOUT; ++i) {
        const int o = tid + i * NT;
        if (o < nout) {
          const int g = o / Dh, d = o % Dh;
          float v = acc[i];
          const KV* vcol = vc + (size_t)t0 * HD + d;
          for (int j = 0; j < nk; ++j)
            v = fmaf(bf16r(sc[g * KT + j]), lcg::to_float(vcol[(size_t)j * HD]), v);
          acc[i] = v;
        }
      }
      __syncthreads();  // sc is rewritten by the next tile
    }
  }

  if (PV) {
#pragma unroll
    for (int i = 0; i < MAX_NOUT; ++i) {
      const int o = tid + i * NT;
      if (o < nout) pp[(size_t)(o / Dh) * (Dh + 2) + o % Dh] = acc[i];
    }
    if (tid < G) pp[(size_t)tid * (Dh + 2) + Dh + 1] = l_s[tid];
  } else if (tid < G) {
    pp[(size_t)tid * (Dh + 2) + Dh] = m_s[tid];
  }
}

// P4: merge the splits of one (slot, query head) with its self term; a warp
__device__ void merge_head(const DecodeArgs& a, int b, int qi) {
  const int lane = threadIdx.x % 32;
  const int Dh = a.Dh, G = a.Hq / a.Hkv, h = qi / G, g = qi % G;
  const int HD = a.Hkv * Dh, Dq = a.Hq * Dh, Nqkv = Dq + 2 * HD;
  const float* pp = a.part + ((size_t)(b * a.Hkv + h) * a.nsplit * G + g) * (Dh + 2);
  const size_t stride = (size_t)G * (Dh + 2);  // between splits
  const float ss = ldcg(a.selfs + (size_t)b * a.Hq + qi);
  float ms = lcg::kNegInf, ls = 0.f;
  if (lane < a.nsplit) {
    ms = ldcg(pp + lane * stride + Dh);
    ls = ldcg(pp + lane * stride + Dh + 1);
  }
  const float ws = expf(ss - fmaxf(warp_max(ms), ss));  // every split used M
  const float den = warp_sum(ls) + ws;
  const float* vrow = a.qkv_acc + (size_t)b * Nqkv + Dq + HD + (size_t)h * Dh;
  for (int d = lane; d < Dh; d += 32) {
    float o = 0.f;
    for (int sp = 0; sp < a.nsplit; ++sp) o += ldcg(pp + sp * stride + d);
    o += ws * bf16r(ldcg(vrow + d));
    a.obuf[(size_t)b * Dq + (size_t)qi * Dh + d] = bf16r(o / den);
  }
}

template <int MP, bool FOLDED, bool NIB_OK, typename KV>
__global__ void __launch_bounds__(NT, 1)
decode_kernel(const __grid_constant__ DecodeArgs a) {
  __shared__ __align__(16) float smem[GT_SMEM_FLOATS];
  __shared__ float red[NWARP * MP], rs[MP];
  __shared__ float m_s[MAX_G], l_s[MAX_G];
  const int B = a.B, D = a.D, F = a.F;
  const int Dq = a.Hq * a.Dh, HD = a.Hkv * a.Dh;
  const int Nqkv = Dq + 2 * HD;
  const int warp = threadIdx.x / 32;

  for (int l = 0; l < a.L; ++l) {
    const long long* tb = a.table + (size_t)l * TABLE_W;
    const float* anorm = reinterpret_cast<const float*>(tb[T_ANORM]);
    const float* fnorm = reinterpret_cast<const float*>(tb[T_FNORM]);
    const int window = (int)tb[T_WINDOW];

    // P1: x (the embedding, or the last layer's residual), rms, q|k|v
    auto xsrc = [&](int m, int k) -> float {
      if (l == 0) return a.x0[(size_t)m * D + k];
      return bf16r(ldcg(a.xmid + (size_t)m * D + k) +
                   bf16r(ldcg(a.dn_acc + (size_t)m * D + k)));
    };
    row_rms<MP>(xsrc, B, D, a.eps, red, rs);
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < B * D; i += NT) a.xin[i] = xsrc(i / D, i % D);
    auto hsrc = [&](int m, int k) -> float {
      return m < B ? bf16r(xsrc(m, k) * rs[m] * anorm[k]) : 0.f;
    };
    gemv_phase<MP, FOLDED, NIB_OK>(hsrc, a, tb, P_QKV, a.qkv_acc,
                                   a.split_v ? P_V : -1,
                                   a.qkv_acc + a.proj[P_QKV].N, Nqkv, smem);
    grid_sync(a.bar);

    // P2, P3: the attention partials in two passes (maxima, then p and
    // P·V); the accumulators of P5 and P6 are free
    zero_grid(a.o_acc, MP * D);
    zero_grid(a.gu_acc, MP * 2 * F);
    const int nu = B * a.Hkv * a.nsplit;
    for (int u = blockIdx.x; u < nu; u += gridDim.x) {
      __syncthreads();
      const int s = u % a.nsplit, bh = u / a.nsplit;
      attn_unit<false, KV>(a, l, window, bh / a.Hkv, bh % a.Hkv, s, smem,
                           m_s, l_s);
    }
    grid_sync(a.bar);
    for (int u = blockIdx.x; u < nu; u += gridDim.x) {
      __syncthreads();
      const int s = u % a.nsplit, bh = u / a.nsplit;
      attn_unit<true, KV>(a, l, window, bh / a.Hkv, bh % a.Hkv, s, smem,
                          m_s, l_s);
    }
    grid_sync(a.bar);

    // P4: merge; dn_acc (read in P1) is free
    zero_grid(a.dn_acc, MP * D);
    for (int u = blockIdx.x * NWARP + warp; u < B * a.Hq;
         u += gridDim.x * NWARP)
      merge_head(a, u / a.Hq, u % a.Hq);
    grid_sync(a.bar);

    // P5: the output projection
    auto osrc = [&](int m, int k) -> float {
      return m < B ? ldcg(a.obuf + (size_t)m * Dq + k) : 0.f;
    };
    gemv_phase<MP, FOLDED, NIB_OK>(osrc, a, tb, P_O, a.o_acc, -1, nullptr, D,
                                   smem);
    grid_sync(a.bar);

    // P6: attention residual, rms, gate|up; qkv_acc (read in P4) is free
    zero_grid(a.qkv_acc, MP * Nqkv);
    auto asrc = [&](int m, int k) -> float {
      return bf16r(bf16r(ldcg(a.xin + (size_t)m * D + k)) +
                   bf16r(ldcg(a.o_acc + (size_t)m * D + k)));
    };
    row_rms<MP>(asrc, B, D, a.eps, red, rs);
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < B * D; i += NT) a.xmid[i] = asrc(i / D, i % D);
    auto h2src = [&](int m, int k) -> float {
      return m < B ? bf16r(asrc(m, k) * rs[m] * fnorm[k]) : 0.f;
    };
    gemv_phase<MP, FOLDED, NIB_OK>(h2src, a, tb, P_GU, a.gu_acc, -1, nullptr,
                                   2 * F, smem);
    grid_sync(a.bar);

    // P7: silu(gate) * up, down projection
    auto ysrc = [&](int m, int k) -> float {
      if (m >= B) return 0.f;
      const float g = bf16r(ldcg(a.gu_acc + (size_t)m * 2 * F + k));
      const float u = bf16r(ldcg(a.gu_acc + (size_t)m * 2 * F + F + k));
      return bf16r(bf16r(g / (1.f + expf(-g))) * u);
    };
    gemv_phase<MP, FOLDED, NIB_OK>(ysrc, a, tb, P_DN, a.dn_acc, -1, nullptr,
                                   D, smem);
    grid_sync(a.bar);
  }
  for (int i = blockIdx.x * NT + threadIdx.x; i < B * D; i += gridDim.x * NT)
    a.xout[i] = bf16r(ldcg(a.xmid + i) + bf16r(ldcg(a.dn_acc + i)));
}

template <int MP, bool FOLDED, bool NIB_OK, typename KV>
cudaError_t grid_of(int* grid) {
  static int cached = 0;  // once, so later launches may be graph-captured
  if (cached == 0) {
    int dev = 0, sms = 0, occ = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, decode_kernel<MP, FOLDED, NIB_OK, KV>, NT, 0);
    if (e != cudaSuccess) return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    cached = sms * (occ < 2 ? occ : 2);
  }
  *grid = cached;
  return cudaSuccess;
}

template <int MP, bool FOLDED, bool NIB_OK, typename KV>
cudaError_t launch(const DecodeArgs* a, int query_only, int* grid,
                   cudaStream_t st) {
  cudaError_t e = grid_of<MP, FOLDED, NIB_OK, KV>(grid);
  if (e != cudaSuccess || query_only) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(*grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // co-resident, or refused
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_kernel<MP, FOLDED, NIB_OK, KV>, *a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool FOLDED, typename KV>
cudaError_t dispatch_mp(int mp, const DecodeArgs* a, int query_only,
                        int* grid, cudaStream_t st) {
  switch (mp) {
    case 1: return launch<1, FOLDED, true, KV>(a, query_only, grid, st);
    case 2: return launch<2, FOLDED, true, KV>(a, query_only, grid, st);
    case 4: return launch<4, FOLDED, true, KV>(a, query_only, grid, st);
    case 8: return launch<8, FOLDED, true, KV>(a, query_only, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K6.  mp: the slots padded to 1, 2, 4 or 8 (the buffers' row count);
// folded != 0: every projection carries int8 sub-scales and f32 super
// planes; kv_bf16 != 0: the cache is bf16, else f32.  query_only != 0 sets
// *grid to the launch's block count and launches nothing.
LCG_EXPORT int lcg_decode_stream(const DecodeArgs* a, int mp, int folded,
                                 int kv_bf16, int query_only, int* grid,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return folded ? dispatch_mp<true, __nv_bfloat16>(mp, a, query_only, grid, st)
                  : dispatch_mp<false, __nv_bfloat16>(mp, a, query_only, grid, st);
  return folded ? dispatch_mp<true, float>(mp, a, query_only, grid, st)
                : dispatch_mp<false, float>(mp, a, query_only, grid, st);
}

// K7: B = 1, fused q|k|v, int8 weights with plain scales.
LCG_EXPORT int lcg_decode_step(const DecodeArgs* a, int kv_bf16,
                               int query_only, int* grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? launch<1, false, false, __nv_bfloat16>(a, query_only, grid, st)
                 : launch<1, false, false, float>(a, query_only, grid, st);
}
