// K6 decode_stream and K7 decode_step: one decode token for each of B <= 8
// slots through the whole layer stack, in one persistent launch.
//
// Replaces: llama_cpp_gfx906_tpu/ops/decode_stream.py  _kernel (K6, launched
// by fused_decode_step_streamed) and ops/decode_step.py  _kernel (K7,
// fused_decode_step), for the dense llama modes: int8 or nib4c weights with
// plain or folded scales and affine mins, a fused q|k|v or split-v (q|k
// fused, v apart) layout, NORM/NEOX rope, per-layer sliding windows, silu,
// bf16 or f32 KV, and the MoE FFN (B = 1: router, softmax or sigmoid,
// top-k, renorm and scale, then only the chosen experts' slices, with an
// optional always-on shared expert and its sigmoid gate, qwen2moe); and the
// gemma modes (GEMMA instantiations, K6 and K7): per-head q/k RMS norms
// before rope, the rope table chosen per layer by its SWA flag, the
// post-attention and post-FFN norms, gelu (tanh or erf).  The GEMMA flags
// are runtime switches, so qk-norm alone (qwen3: no post-norms, silu, one
// rope table) is the gemma instantiation with has_post = 0, and an MoE
// stack with qk-norm (qwen3moe) the instantiation with MOE and GEMMA.  K7
// is the instantiation with B = 1, int8 weights and plain scales (its own C
// entry point); its gate picks it.
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
// The gemma modes keep the 7 barriers:
//   P2/P3  every attention unit stages its heads' bf16 projections in
//          shared memory, norms each head (sum of squares over Dh, weighted
//          by q_norm / k_norm, rounded to bf16) and only then rotates them,
//          a thread per (d, partner) pair, so no rotation reads an un-normed
//          element; the K row written to the cache is the normed, rotated
//          one.  The rope table is the layer's: local (unscaled) on an SWA
//          layer, global otherwise.
//   P6     attn = bf16(rms(bf16(o)) * post_attn_norm): every block computes
//          the row's norm itself from the complete o (after P5's barrier)
//   P7     y = bf16(bf16(act(g)) * bf16(u)), act silu, gelu-tanh or gelu-erf
//   P1     the previous layer's mlp = bf16(rms(bf16(mlp)) * post_ffn_norm),
//          again computed by every block (and so the final output).
//
// An MoE layer (MOE, B = 1) replaces P6 and P7 and keeps 7 barriers:
//   P6  x, h2 as above; every block computes the router logits h2 · Wr
//       (D x E f32, from the f32 h2, as the JAX kernel) and the top-k
//       itself, as it recomputes the norm: softmax or sigmoid, k masked-max
//       passes (the first maximum on ties), renorm and scale; then the
//       gate and up GEMVs of the k chosen experts as one phase (work units
//       k x 2 x their tiles, expert e's planes at base + e * stride)
//   P7  per expert j: y = bf16(bf16(silu(g)) * bf16(u)) from the f32 gate
//       and up; mlp += w_j * (y · Wdown_j), each unit's partial sums scaled
//       by w_j before the tile's ordered sum (tile_store)
// Expert planes are int8 or nib4c with plain f32 scales (never folded,
// while the dense projections may be).  Block 0 writes the chosen ids to
// eids (L, k), so a check can tell a router near-tie from a fault.
// The shared expert (has_shexp; its planes in the dense gate|up and down
// slots of the table, as the JAX kernel streams it through the dense
// windows) adds no barrier: P6 runs its gate|up units after the chosen
// experts' (into gu_acc after their rows), every block computing the
// optional gate sigmoid(h2 · shexp_gate_inp) itself from the f32 h2 it
// staged for the router; P7 runs its down units before the experts' and
// scales their partial sums by that gate:
//   mlp = shexp_down(bf16(bf16(silu(bf16(g))) * bf16(u))) * gate
//         + sum_j w_j * expert_down_j.
//
// Bound on the card: the weight bytes of every layer plus the live KV, read
// once per step (B <= 8 rows ride the same weight stream).  Design:
//   - one cooperative launch (co-resident blocks, sized by the occupancy
//     query) loops over the layers; the launch reads n_past on the device
//     and takes its per-layer planes from a device table built at load
//     time, so a step can be captured in a CUDA graph;
//   - GEMVs: work units (128-column tile x K segment) of K1/K2's tile
//     (gemv_tile.cuh) spread over all blocks; each unit stores its
//     segment's partial sums to scratch (gpart) and the last unit of a
//     column tile to arrive (counters gcnt, zero at rest) adds them in
//     segment order into the accumulator before the phase's barrier: the
//     same bits from launch to launch, and readers read one final value
//     (the MoE down projections share one order: shared expert, then
//     expert 0, 1, ... each scaled by its weight);
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
// per layer: 5 projections x 5 planes, 2 norms, window; MoE: the router,
// then 3 expert tensors x (q, s, m bases, q stride, s stride in bytes);
// gemma: q_norm, k_norm, post_attn_norm, post_ffn_norm, the SWA flag; the
// shared expert's gate vector (f32, D; 0 without one)
constexpr int TABLE_W = 50;
constexpr int NPROJ = 8;
enum { P_QKV = 0, P_V = 1, P_O = 2, P_GU = 3, P_DN = 4, P_EG = 5, P_EU = 6,
       P_ED = 7 };
constexpr int T_ANORM = 25, T_FNORM = 26, T_WINDOW = 27, T_ROUTER = 28,
              T_EXP = 29, T_QNORM = 44, T_KNORM = 45, T_PANORM = 46,
              T_PFNORM = 47, T_SWA = 48, T_SGI = 49;
constexpr int MAX_E = 256;      // router lanes
constexpr int MAX_K = 8;        // experts per token
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
  const float* inv_freq_local;  // (Dh/2,) of the SWA layers (gemma)
  const float* x0;         // (MP, D) the embedded tokens, f32
  float* xin;              // (MP, D) layer input
  float* xmid;             // (MP, D) after the attention residual
  float* xout;             // (MP, D) result
  float* qkv_acc;          // (MP, Nqkv) GEMV results
  float* o_acc;            // (MP, D)
  float* gu_acc;           // (MP, 2F); MoE: k x (gate, up) x EF, then 2 Fs
  float* dn_acc;           // (MP, D)
  float* obuf;             // (MP, Hq*Dh) attention output, bf16-valued
  float* part;             // (B, Hkv, nsplit, G, Dh + 2) split partials
  float* selfs;            // (B, Hq) self-term scores
  unsigned* bar;           // barrier count and generation, zero at rest
  int* eids;               // (L, topk) the chosen experts (MoE)
  float* gpart;            // GEMV partial sums by segment (scratch)
  unsigned* gcnt;          // GEMV column-tile arrival counters, zero at rest
  ProjDims proj[NPROJ];
  int L, B, D, Hq, Hkv, Dh, F, S, nsplit, split_v, interleaved;
  int n_exp, topk, gating_sigmoid, wnorm;  // MoE routing
  int has_qk, has_post, act;  // gemma: qk-norm, post-norms, 0 silu 1 gelu-tanh 2 gelu-erf
  int Fs, has_shexp;       // MoE: the shared expert's FF width, and whether it exists
  float scale, eps, wscale;
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

__device__ __forceinline__ int gemv_tiles(const ProjDims& p) {
  return (p.N + GT_TN - 1) / GT_TN;
}
__device__ __forceinline__ int gemv_splits(const ProjDims& p) {
  return (p.nib ? p.K / 2 : p.K) / p.seg;
}
__device__ __forceinline__ int gemv_units(const ProjDims& p) {
  return gemv_tiles(p) * gemv_splits(p);
}

// unit u of projection p (planes: q, s, m, sd, md addresses): its column
// tile's sums go to out (row stride out_ld) through the scratch at
// a.gpart + poff and the counters at a.gcnt + coff, the unit's segment as
// split s0 + segment of the tile's nsplit, scaled by oscale
template <int MP, bool FOLDED, bool NIB_OK, class XF>
__device__ __forceinline__ void gemv_unit(XF xf, const DecodeArgs& a,
                                          const ProjDims& p,
                                          const long long* planes, float* out,
                                          int out_ld, size_t poff, int coff,
                                          int s0, int nsplit, int u,
                                          float* smem, float oscale = 1.f) {
  const int8_t* q = reinterpret_cast<const int8_t*>(planes[0]);
  const void* s = reinterpret_cast<const void*>(planes[1]);
  const void* mn = reinterpret_cast<const void*>(planes[2]);
  const float* sd = reinterpret_cast<const float*>(planes[3]);
  const float* md = reinterpret_cast<const float*>(planes[4]);
  const int ntn = gemv_tiles(p), tn = u % ntn, tk = u / ntn;
  const int sg = FOLDED ? p.sgroup : 1;
  const lcg::TileOut o{out, out_ld, a.gpart + poff, (size_t)MP * p.N,
                       a.gcnt + coff + tn, s0 + tk, nsplit, oscale};
  if (NIB_OK && p.nib)
    lcg::gemv_tile<MP, true, FOLDED, false>(xf, q, s, mn, sd, md, o, p.K, p.N,
                                            p.group, sg, p.ck, p.seg, tn, tk, 1,
                                            smem);
  else
    lcg::gemv_tile<MP, false, FOLDED, true>(xf, q, s, mn, sd, md, o, p.K, p.N,
                                            p.group, sg, p.ck, p.seg, tn, tk, 1,
                                            smem);
}

// every unit of one projection (and of a second one, when given) over the
// grid, each projection with its own scratch and counters
template <int MP, bool FOLDED, bool NIB_OK, class XF>
__device__ __forceinline__ void gemv_phase(XF xf, const DecodeArgs& a,
                                           const long long* tb, int p0,
                                           float* out0, int p1, float* out1,
                                           int out_ld, float* smem) {
  const ProjDims& d0 = a.proj[p0];
  const int n0 = gemv_units(d0);
  const int n1 = p1 >= 0 ? gemv_units(a.proj[p1]) : 0;
  const size_t poff1 = (size_t)gemv_splits(d0) * MP * d0.N;
  for (int u = blockIdx.x; u < n0 + n1; u += gridDim.x) {
    __syncthreads();  // the previous unit's reduction still reads smem
    if (u < n0)
      gemv_unit<MP, FOLDED, NIB_OK>(xf, a, d0, tb + 5 * p0, out0, out_ld, 0, 0,
                                    0, gemv_splits(d0), u, smem);
    else
      gemv_unit<MP, FOLDED, NIB_OK>(xf, a, a.proj[p1], tb + 5 * p1, out1,
                                    out_ld, poff1, gemv_tiles(d0), 0,
                                    gemv_splits(a.proj[p1]), u - n0, smem);
  }
}

// ---- MoE --------------------------------------------------------------

// The router and top-k of one token, computed by every block (no barrier):
// h2(k) yields the f32 normed row; the router is (D, Ep) f32, Ep the power
// of two >= n_exp (pad lanes masked).  Leaves the ids and weights in
// ids/wts (shared); block 0 also writes the ids to eids[l].
template <class H2>
__device__ void moe_route(const DecodeArgs& a, int l, const float* router,
                          H2 h2, float* hs, float* red, float* lg, int* ids,
                          float* wts) {
  const int tid = threadIdx.x, D = a.D, E = a.n_exp;
  int Ep = 1;
  while (Ep < E) Ep <<= 1;
  for (int k = tid; k < D; k += NT) hs[k] = h2(k);
  __syncthreads();
  // thread t owns lane t % Ep over rows t / Ep, + NT / Ep, ... (coalesced)
  const int e = tid % Ep, step = NT / Ep;
  float acc = 0.f;
  for (int k = tid / Ep; k < D; k += step)
    acc = fmaf(hs[k], router[(size_t)k * Ep + e], acc);
  red[tid] = acc;
  __syncthreads();
  if (tid < Ep) {
    float v = 0.f;
    for (int r = 0; r < step; ++r) v += red[r * Ep + tid];
    lg[tid] = tid < E ? v : lcg::kNegInf;
  }
  __syncthreads();
  if (tid == 0) {
    if (a.gating_sigmoid) {
      for (int i = 0; i < E; ++i) lg[i] = 1.f / (1.f + expf(-lg[i]));
    } else {
      float mx = lcg::kNegInf, sum = 0.f;
      for (int i = 0; i < E; ++i) mx = fmaxf(mx, lg[i]);
      for (int i = 0; i < E; ++i) {
        lg[i] = expf(lg[i] - mx);
        sum += lg[i];
      }
      for (int i = 0; i < E; ++i) lg[i] /= sum;
    }
    float wsum = 0.f;
    for (int j = 0; j < a.topk; ++j) {  // masked-max passes, first on ties
      int best = 0;
      for (int i = 1; i < E; ++i)
        if (lg[i] > lg[best]) best = i;
      ids[j] = best;
      wts[j] = lg[best];
      wsum += lg[best];
      lg[best] = lcg::kNegInf;
    }
    for (int j = 0; j < a.topk; ++j) {
      if (a.wnorm) wts[j] /= fmaxf(wsum, 1e-9f);
      if (a.wscale != 1.f) wts[j] *= a.wscale;
      if (blockIdx.x == 0) a.eids[l * a.topk + j] = ids[j];
    }
  }
  __syncthreads();
}

// expert e's planes (q, s, m, no folds) of expert tensor t (0 gate, 1 up,
// 2 down) from the layer's table row
__device__ __forceinline__ void expert_planes(const long long* tb, int t,
                                              int e, long long* planes) {
  const long long* eb = tb + T_EXP + 5 * t;
  planes[0] = eb[0] + e * eb[3];
  planes[1] = eb[1] + e * eb[4];
  planes[2] = eb[2] != 0 ? eb[2] + e * eb[4] : 0;
  planes[3] = planes[4] = 0;
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

// GEMMA: nh heads of Dh (raw f32 accumulators at src) into dst: the bf16
// projection, with w (qk-norm) each head's RMS norm weighted by w and
// rounded to bf16, then rotated by inv at pos; each thread owns both
// elements of a rotation pair, so a rotation reads only normed values.
// round_out rounds the rotated values to bf16.  hs: nh floats of scratch.
__device__ void norm_rope_heads(const float* src, int nh, int Dh, float pos,
                                const float* inv, int interleaved,
                                const float* w, float eps, bool round_out,
                                float* dst, float* hs) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool norm = w != nullptr;
  for (int i = tid; i < nh * Dh; i += NT) dst[i] = bf16r(ldcg(src + i));
  __syncthreads();
  if (norm) {
    for (int g = warp; g < nh; g += NWARP) {
      float ss = 0.f;
      for (int d = lane; d < Dh; d += 32) ss += dst[g * Dh + d] * dst[g * Dh + d];
      ss = warp_sum(ss);
      if (lane == 0) hs[g] = rsqrtf(ss / Dh + eps);
    }
    __syncthreads();
  }
  const int half = Dh / 2;
  for (int i = tid; i < nh * half; i += NT) {
    const int g = i / half, j = i % half;
    float* row = dst + g * Dh;
    const int d0 = interleaved ? 2 * j : j, d1 = interleaved ? 2 * j + 1 : j + half;
    float v0 = row[d0], v1 = row[d1];
    if (norm) {
      v0 = bf16r(v0 * hs[g] * w[d0]);
      v1 = bf16r(v1 * hs[g] * w[d1]);
    }
    const float ang = pos * inv[j];
    const float c = cosf(ang), sn = sinf(ang);
    const float r0 = v0 * c - v1 * sn, r1 = v1 * c + v0 * sn;
    row[d0] = round_out ? bf16r(r0) : r0;
    row[d1] = round_out ? bf16r(r1) : r1;
  }
  __syncthreads();
}

// the FFN activation of the gemma modes (act 0 silu, 1 gelu-tanh, 2 erf)
__device__ __forceinline__ float act_f(float g, int act) {
  if (act == 1)
    return g * (0.5f * (1.f + tanhf(0.7978845608028654f *
                                    (g + 0.044715f * (g * g * g)))));
  if (act == 2) return g * (erff(g / 1.4142135623730951f) + 1.f) * 0.5f;
  return g / (1.f + expf(-g));
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
template <bool PV, bool GEMMA, typename KV>
__device__ void attn_unit(const DecodeArgs& a, int l, int window, int b,
                          int h, int s, float* smem, float* m_s, float* l_s,
                          const long long* tb, const float* inv, float* hs) {
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

  if constexpr (GEMMA) {
    norm_rope_heads(qk + (size_t)h * G * Dh, G, Dh, pos, inv, a.interleaved,
                    a.has_qk ? reinterpret_cast<const float*>(tb[T_QNORM]) : nullptr,
                    a.eps, true, qs, hs);
  } else {
    for (int i = tid; i < G * Dh; i += NT) {
      const int g = i / Dh, d = i % Dh;
      qs[i] = bf16r(rope_at(qk + (size_t)(h * G + g) * Dh, d, Dh, pos,
                            a.inv_freq, a.interleaved));
    }
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
    if constexpr (GEMMA)  // the normed, rotated K row into ks (unrounded)
      norm_rope_heads(qk + Dq + (size_t)h * Dh, 1, Dh, pos, inv, a.interleaved,
                      a.has_qk ? reinterpret_cast<const float*>(tb[T_KNORM]) : nullptr,
                      a.eps, false, ks, hs);
    for (int d = tid; d < Dh; d += NT) {
      const float kr = GEMMA ? ks[d]
                             : rope_at(qk + Dq + (size_t)h * Dh, d, Dh, pos,
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

template <int MP, bool FOLDED, bool NIB_OK, bool MOE, bool GEMMA, typename KV>
__global__ void __launch_bounds__(NT, 1)
decode_kernel(const __grid_constant__ DecodeArgs a) {
  // K6 1 + bits (1 MoE, 2 gemma), K7 5 + gemma; a shared expert also 7
  // (kernels.py's slots)
  lcg::count_launch(NIB_OK ? 1 + MOE + 2 * GEMMA : 5 + GEMMA);
  if (MOE && a.has_shexp) lcg::count_launch(7);
  __shared__ __align__(16) float smem[GT_SMEM_FLOATS];
  __shared__ float red[NWARP * MP], rs[MP];
  __shared__ float rs_post[GEMMA ? MP : 1], hs[GEMMA ? MAX_G : 1];
  __shared__ float m_s[MAX_G], l_s[MAX_G];
  __shared__ float e_red[MOE ? NT : 1], e_lg[MOE ? MAX_E : 1];
  __shared__ float e_w[MAX_K];
  __shared__ int e_id[MAX_K];
  __shared__ float e_sig;  // the shared expert's gate (MoE)
  const int B = a.B, D = a.D, F = a.F;
  const int Dq = a.Hq * a.Dh, HD = a.Hkv * a.Dh;
  const int Nqkv = Dq + 2 * HD;
  const int warp = threadIdx.x / 32;

  for (int l = 0; l < a.L; ++l) {
    const long long* tb = a.table + (size_t)l * TABLE_W;
    const float* anorm = reinterpret_cast<const float*>(tb[T_ANORM]);
    const float* fnorm = reinterpret_cast<const float*>(tb[T_FNORM]);
    const int window = (int)tb[T_WINDOW];
    const float* inv = (GEMMA && tb[T_SWA]) ? a.inv_freq_local : a.inv_freq;
    // the previous layer's post-FFN norm (gemma): its weights, every row's scale
    const float* pf = nullptr;
    if constexpr (GEMMA) {
      if (a.has_post && l > 0) {
        pf = reinterpret_cast<const float*>((tb - TABLE_W)[T_PFNORM]);
        row_rms<MP>([&](int m, int k) { return bf16r(ldcg(a.dn_acc + (size_t)m * D + k)); },
                    B, D, a.eps, red, rs_post);
      }
    }

    // P1: x (the embedding, or the last layer's residual), rms, q|k|v
    auto xsrc = [&](int m, int k) -> float {
      if (l == 0) return a.x0[(size_t)m * D + k];
      float mb = bf16r(ldcg(a.dn_acc + (size_t)m * D + k));
      if constexpr (GEMMA)
        if (pf != nullptr) mb = bf16r(mb * rs_post[m] * pf[k]);
      return bf16r(ldcg(a.xmid + (size_t)m * D + k) + mb);
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
    // P·V)
    const int nu = B * a.Hkv * a.nsplit;
    for (int u = blockIdx.x; u < nu; u += gridDim.x) {
      __syncthreads();
      const int s = u % a.nsplit, bh = u / a.nsplit;
      attn_unit<false, GEMMA, KV>(a, l, window, bh / a.Hkv, bh % a.Hkv, s,
                                  smem, m_s, l_s, tb, inv, hs);
    }
    grid_sync(a.bar);
    for (int u = blockIdx.x; u < nu; u += gridDim.x) {
      __syncthreads();
      const int s = u % a.nsplit, bh = u / a.nsplit;
      attn_unit<true, GEMMA, KV>(a, l, window, bh / a.Hkv, bh % a.Hkv, s,
                                 smem, m_s, l_s, tb, inv, hs);
    }
    grid_sync(a.bar);

    // P4: merge
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

    // P6: attention residual, rms, gate|up
    const float* pa = nullptr;  // the post-attention norm (gemma)
    if constexpr (GEMMA) {
      if (a.has_post) {
        pa = reinterpret_cast<const float*>(tb[T_PANORM]);
        row_rms<MP>([&](int m, int k) { return bf16r(ldcg(a.o_acc + (size_t)m * D + k)); },
                    B, D, a.eps, red, rs_post);
      }
    }
    auto asrc = [&](int m, int k) -> float {
      float ab = bf16r(ldcg(a.o_acc + (size_t)m * D + k));
      if constexpr (GEMMA)
        if (pa != nullptr) ab = bf16r(ab * rs_post[m] * pa[k]);
      return bf16r(bf16r(ldcg(a.xin + (size_t)m * D + k)) + ab);
    };
    row_rms<MP>(asrc, B, D, a.eps, red, rs);
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < B * D; i += NT) a.xmid[i] = asrc(i / D, i % D);
    auto h2src = [&](int m, int k) -> float {
      return m < B ? bf16r(asrc(m, k) * rs[m] * fnorm[k]) : 0.f;
    };
    if constexpr (MOE) {
      // the router and top-k in every block, then the chosen experts' gate
      // and up: expert j's gate row at gu_acc + 2j EF, its up row after it;
      // then the shared expert's gate|up row after the experts'
      moe_route(a, l, reinterpret_cast<const float*>(tb[T_ROUTER]),
                [&](int k) { return asrc(0, k) * rs[0] * fnorm[k]; }, smem,
                e_red, e_lg, e_id, e_w);
      if (a.has_shexp) {  // its gate from the f32 h2 the router staged
        const float* sgi = reinterpret_cast<const float*>(tb[T_SGI]);
        float v = 0.f;
        if (sgi != nullptr)
          for (int k = threadIdx.x; k < D; k += NT) v = fmaf(smem[k], sgi[k], v);
        v = warp_sum(v);
        if (threadIdx.x % 32 == 0) e_red[warp] = v;
        __syncthreads();
        if (threadIdx.x == 0) {
          float t = 0.f;
          for (int w = 0; w < NWARP; ++w) t += e_red[w];
          e_sig = sgi != nullptr ? 1.f / (1.f + expf(-t)) : 1.f;
        }
        __syncthreads();
      }
      const ProjDims& pe = a.proj[P_EG];
      const int EF = pe.N, spE = gemv_splits(pe), tE = gemv_tiles(pe);
      const int ug = gemv_units(pe), uu = gemv_units(a.proj[P_EU]);
      const int ne = a.topk * (ug + uu);
      const int ns = a.has_shexp ? gemv_units(a.proj[P_GU]) : 0;
      for (int u = blockIdx.x; u < ne + ns; u += gridDim.x) {
        __syncthreads();  // smem: the router's h2, or the last unit
        if (u < ne) {
          const int j = u / (ug + uu), r = u % (ug + uu);
          const int up = r >= ug, slot = 2 * j + up;
          long long planes[5];
          expert_planes(tb, up, e_id[j], planes);
          gemv_unit<MP, false, NIB_OK>(h2src, a, a.proj[P_EG + up], planes,
                                       a.gu_acc + (size_t)slot * EF, EF,
                                       (size_t)slot * spE * EF, slot * tE, 0,
                                       spE, up ? r - ug : r, smem);
        } else {
          gemv_unit<MP, FOLDED, NIB_OK>(
              h2src, a, a.proj[P_GU], tb + 5 * P_GU,
              a.gu_acc + (size_t)2 * a.topk * EF, 2 * a.Fs,
              (size_t)2 * a.topk * spE * EF, 2 * a.topk * tE, 0,
              gemv_splits(a.proj[P_GU]), u - ne, smem);
        }
      }
    } else {
      gemv_phase<MP, FOLDED, NIB_OK>(h2src, a, tb, P_GU, a.gu_acc, -1,
                                     nullptr, 2 * F, smem);
    }
    grid_sync(a.bar);

    // P7: act(gate) * up, down projection (MoE: the shared expert's, then
    // each chosen expert's, its partial sums weighted by the expert's
    // routing weight, all in one ordered sum per column tile)
    if constexpr (MOE) {
      const int EF = a.proj[P_EG].N;
      const ProjDims& pd = a.proj[P_ED];
      const int ud = gemv_units(pd), spD = gemv_splits(pd);
      const int nsd = a.has_shexp ? gemv_units(a.proj[P_DN]) : 0;
      const int spS = a.has_shexp ? gemv_splits(a.proj[P_DN]) : 0;
      const int nsplit = spS + a.topk * spD;
      for (int u = blockIdx.x; u < nsd + a.topk * ud; u += gridDim.x) {
        __syncthreads();
        if (u < nsd) {
          const float* gs = a.gu_acc + (size_t)2 * a.topk * EF;
          auto ysrc = [&](int m, int k) -> float {
            if (m >= B) return 0.f;
            const float g = bf16r(ldcg(gs + k)), v = bf16r(ldcg(gs + a.Fs + k));
            return bf16r(bf16r(act_f(g, a.act)) * v);
          };
          gemv_unit<MP, FOLDED, NIB_OK>(ysrc, a, a.proj[P_DN], tb + 5 * P_DN,
                                        a.dn_acc, D, 0, 0, 0, nsplit, u, smem,
                                        e_sig);
          continue;
        }
        const int v0 = u - nsd, j = v0 / ud;
        const float* gr = a.gu_acc + (size_t)2 * j * EF;
        auto ysrc = [&](int m, int k) -> float {
          if (m >= B) return 0.f;
          const float g = ldcg(gr + k), v = bf16r(ldcg(gr + EF + k));
          return bf16r(bf16r(act_f(g, a.act)) * v);
        };
        long long planes[5];
        expert_planes(tb, 2, e_id[j], planes);
        gemv_unit<MP, false, NIB_OK>(ysrc, a, pd, planes, a.dn_acc, D, 0, 0,
                                     spS + j * spD, nsplit, v0 % ud, smem,
                                     e_w[j]);
      }
    } else {
      auto ysrc = [&](int m, int k) -> float {
        if (m >= B) return 0.f;
        const float g = bf16r(ldcg(a.gu_acc + (size_t)m * 2 * F + k));
        const float u = bf16r(ldcg(a.gu_acc + (size_t)m * 2 * F + F + k));
        if constexpr (GEMMA) return bf16r(bf16r(act_f(g, a.act)) * u);
        return bf16r(bf16r(g / (1.f + expf(-g))) * u);
      };
      gemv_phase<MP, FOLDED, NIB_OK>(ysrc, a, tb, P_DN, a.dn_acc, -1, nullptr,
                                     D, smem);
    }
    grid_sync(a.bar);
  }
  const float* pf = nullptr;  // the last layer's post-FFN norm (gemma)
  if constexpr (GEMMA) {
    if (a.has_post) {
      pf = reinterpret_cast<const float*>(a.table[(size_t)(a.L - 1) * TABLE_W + T_PFNORM]);
      row_rms<MP>([&](int m, int k) { return bf16r(ldcg(a.dn_acc + (size_t)m * D + k)); },
                  B, D, a.eps, red, rs_post);
    }
  }
  for (int i = blockIdx.x * NT + threadIdx.x; i < B * D; i += gridDim.x * NT) {
    float mb = bf16r(ldcg(a.dn_acc + i));
    if constexpr (GEMMA)
      if (pf != nullptr) mb = bf16r(mb * rs_post[i / D] * pf[i % D]);
    a.xout[i] = bf16r(ldcg(a.xmid + i) + mb);
  }
}

template <int MP, bool FOLDED, bool NIB_OK, bool MOE, bool GEMMA, typename KV>
cudaError_t grid_of(int* grid) {
  static int cached = 0;  // once, so later launches may be graph-captured
  if (cached == 0) {
    int dev = 0, sms = 0, occ = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, decode_kernel<MP, FOLDED, NIB_OK, MOE, GEMMA, KV>, NT, 0);
    if (e != cudaSuccess) return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    cached = sms * (occ < 2 ? occ : 2);
  }
  *grid = cached;
  return cudaSuccess;
}

template <int MP, bool FOLDED, bool NIB_OK, bool MOE, bool GEMMA, typename KV>
cudaError_t launch(const DecodeArgs* a, int query_only, int* grid,
                   cudaStream_t st) {
  cudaError_t e = grid_of<MP, FOLDED, NIB_OK, MOE, GEMMA, KV>(grid);
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
  e = cudaLaunchKernelEx(&cfg, decode_kernel<MP, FOLDED, NIB_OK, MOE, GEMMA, KV>, *a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool FOLDED, bool GEMMA, typename KV>
cudaError_t dispatch_mp(int mp, int moe, const DecodeArgs* a, int query_only,
                        int* grid, cudaStream_t st) {
  if (moe) {  // the kernel routes one token: B = 1
    if (mp != 1 || a->topk < 1 || a->topk > MAX_K || a->n_exp < a->topk ||
        a->n_exp > MAX_E || a->D > GT_SMEM_FLOATS)
      return cudaErrorInvalidValue;
    return launch<1, FOLDED, true, true, GEMMA, KV>(a, query_only, grid, st);
  }
  if (a->has_shexp) return cudaErrorInvalidValue;  // a shared expert is MoE
  switch (mp) {
    case 1: return launch<1, FOLDED, true, false, GEMMA, KV>(a, query_only, grid, st);
    case 2: return launch<2, FOLDED, true, false, GEMMA, KV>(a, query_only, grid, st);
    case 4: return launch<4, FOLDED, true, false, GEMMA, KV>(a, query_only, grid, st);
    case 8: return launch<8, FOLDED, true, false, GEMMA, KV>(a, query_only, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KV>
cudaError_t dispatch_gemma(int mp, int folded, int moe, int gemma,
                           const DecodeArgs* a, int query_only, int* grid,
                           cudaStream_t st) {
  if (gemma)
    return folded ? dispatch_mp<true, true, KV>(mp, moe, a, query_only, grid, st)
                  : dispatch_mp<false, true, KV>(mp, moe, a, query_only, grid, st);
  return folded ? dispatch_mp<true, false, KV>(mp, moe, a, query_only, grid, st)
                : dispatch_mp<false, false, KV>(mp, moe, a, query_only, grid, st);
}

}  // namespace

// K6.  mp: the slots padded to 1, 2, 4 or 8 (the buffers' row count);
// folded != 0: every dense projection carries int8 sub-scales and f32
// super planes; kv_bf16 != 0: the cache is bf16, else f32; moe != 0: the
// layers' FFN is routed (mp 1), with a shared expert where has_shexp;
// gemma != 0: the gemma instantiation (qk-norm and the gemma flags, with
// or without moe).  query_only != 0 sets *grid to the launch's block count and
// launches nothing.
LCG_EXPORT int lcg_decode_stream(const DecodeArgs* a, int mp, int folded,
                                 int kv_bf16, int moe, int gemma,
                                 int query_only, int* grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return dispatch_gemma<__nv_bfloat16>(mp, folded, moe, gemma, a, query_only, grid, st);
  return dispatch_gemma<float>(mp, folded, moe, gemma, a, query_only, grid, st);
}

// K7: B = 1, fused q|k|v, int8 weights with plain scales; gemma != 0: the
// gemma instantiation.
LCG_EXPORT int lcg_decode_step(const DecodeArgs* a, int kv_bf16, int gemma,
                               int query_only, int* grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gemma)
    return kv_bf16 ? launch<1, false, false, false, true, __nv_bfloat16>(a, query_only, grid, st)
                   : launch<1, false, false, false, true, float>(a, query_only, grid, st);
  return kv_bf16 ? launch<1, false, false, false, false, __nv_bfloat16>(a, query_only, grid, st)
                 : launch<1, false, false, false, false, float>(a, query_only, grid, st);
}
