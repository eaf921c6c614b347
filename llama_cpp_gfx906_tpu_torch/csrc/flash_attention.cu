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
// Bound on the card: the flops, 4 * D per live (query, key) pair and query
// head (QK^T and PV), against 989 TFLOP/s of bf16 tensor cores; the bytes
// (Q, K, V once, O once; int8: 1 byte per element plus 4 bytes of scale per
// row and KV head) against 3.35 TB/s, which bound only short chunks.
//
// Two bodies, each its own template and device count slot:
//
// The tensor-core body (E = bf16, a bf16 or int8 cache; slots 2 and 3),
// FlashAttention-2 style:
//   - a block of 4 warps takes 64 queries of one head, each warp 16 rows;
//     QK^T and PV run as mma.sync m16n8k16, bf16 operands, f32 sums;
//   - Q is held as A fragments in registers for the whole key loop (at
//     D 256 those 64 registers beside the 128 of the accumulator would
//     spill, so there each key tile reads Q again from shared memory);
//   - S and P stay in registers: the scale, the softcap, the masks and the
//     online softmax work on the accumulator fragments (row max and sum
//     over the 4 lanes of a quad), and P, rounded to bf16, is PV's A
//     operand as it stands;
//   - K and V tiles of 64 keys (32 at D 256, where 64 spilled) are copied
//     by cp.async, 16 bytes a thread, straight from the stored
//     (B, S, Hkv, D) rows, double-buffered so that tile j + 1 loads while
//     tile j computes; 16-byte chunks are XOR-swizzled by row so that
//     ldmatrix (V: ldmatrix.trans) reads without bank conflicts; 80 KB of
//     shared memory at D 128, 96 KB at D 256 (2 blocks an SM);
//   - key tiles wholly above the diagonal or left of the window are
//     skipped, and within a tile the 16-key slices above a warp's last
//     row; only tiles that straddle an edge are masked; query tiles are
//     issued heaviest (last) first, all heads of one tile together;
//   - the sink joins the running max, then the denominator, once at the
//     end; no atomics, no split: two launches give the same bits.
//   int8 mode, the JAX kernel's arithmetic: int8 rows (and their scales)
//   are copied as they are by cp.async and converted to bf16 in shared
//   memory (exact); the key's scale multiplies its score column before
//   `scale`, the value's scale multiplies p after the row sum and before p
//   is rounded to bf16 for PV.
//
// The FMA body (E = f32, an f32 or int8 cache; slots 0 and 1): f32 products
// by FMA out of f32 tiles in shared memory (bound by 67 TFLOP/s of f32 FMA
// at best), for full-f32 callers whose products a bf16 rounding would
// change; int8 rows are dequantized to f32 as they are staged.

#include <type_traits>

#include "common.cuh"

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* kscale;  // (B, S, Hkv) or null
  const float* vscale;
  const int* n_past;    // (B,)
  const float* sinks;   // (Hq,) or null
  void* out;
  int B, T, S, Hq, Hkv;
  float scale;
  int window;
  float softcap;
};

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// the tensor-core body

namespace tc {

constexpr int NW = 4;         // warps, 16 query rows each
constexpr int BQ = 16 * NW;   // queries per block
constexpr int NT = 32 * NW;

// keys per tile: 64, and 32 at D 256, where 64 spilled registers (int8)
template <int D>
struct Keys {
  static constexpr int BKT = D <= 128 ? 64 : 32;
};

template <typename KV, int D>
struct Smem {  // bf16 Q, K and V tiles; int8: staged rows and scales
  static constexpr int BKT = Keys<D>::BKT;
  static constexpr bool I8 = std::is_same<KV, int8_t>::value;
  static constexpr int BF_STAGES = I8 ? 1 : 2;  // int8: converted per tile
  static constexpr size_t q = size_t(BQ) * D * 2;
  static constexpr size_t kv = size_t(BKT) * D * 2 * 2 * BF_STAGES;
  static constexpr size_t i8 = I8 ? size_t(BKT) * D * 2 * 2 : 0;
  static constexpr size_t sc = I8 ? size_t(BKT) * 4 * 2 * 2 : 0;
  static constexpr size_t bytes = q + kv + i8 + sc;
};

// element offset of 16-byte chunk c of row r in a swizzled tile of D bf16
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ROWS rows of D bf16 from src (row stride `stride` elements) into a
// swizzled tile; rows >= n_valid are zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int n_valid, int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < n_valid;
    lcg::cp_async16(dst + swz<D>(r, c), src + (ok ? r : 0) * stride + c * 8, ok);
  }
}

// ROWS int8 rows of D as they are (row-major, D bytes a row)
template <int ROWS, int D>
__device__ __forceinline__ void copy_rows_i8(int8_t* dst, const int8_t* src, size_t stride,
                                             int n_valid, int tid) {
  constexpr int CH = D / 16;
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < n_valid;
    lcg::cp_async16(dst + r * D + c * 16, src + (ok ? r : 0) * stride + c * 16, ok);
  }
}

// ROWS staged int8 rows as bf16 (exact) into a swizzled tile
template <int ROWS, int D>
__device__ __forceinline__ void widen_rows(__nv_bfloat16* dst, const int8_t* src, int tid) {
  constexpr int CH = D / 16;
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const uint4 w = *reinterpret_cast<const uint4*>(src + r * D + c * 16);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    uint32_t h[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f[4];
      lcg::unpack_s8x4(words[j], f);
      h[2 * j] = pack_bf16(f[0], f[1]);
      h[2 * j + 1] = pack_bf16(f[2], f[3]);
    }
    *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * c)) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * c + 1)) = make_uint4(h[4], h[5], h[6], h[7]);
  }
}

template <typename KV, int D>
__global__ void __launch_bounds__(NT)
flash_attention_mma(const Args a) {
  using SM = Smem<KV, D>;
  constexpr int BKT = SM::BKT;
  constexpr bool I8 = SM::I8;
  constexpr bool QREG = D <= 128;  // Q's A fragments in registers
  constexpr int KS = D / 16;    // k-steps of QK^T
  constexpr int NS = BKT / 8;   // score n-tiles of a warp
  constexpr int NO = D / 8;     // output n-tiles of a warp
  constexpr int TILE = BKT * D;
  extern __shared__ __align__(128) unsigned char smraw[];
  lcg::count_launch(I8 ? 3 : 2);  // slots 2, 3: the tensor-core body
  auto* Qs = reinterpret_cast<__nv_bfloat16*>(smraw);
  __nv_bfloat16* Kt = Qs + BQ * D;                  // [BF_STAGES][TILE]
  __nv_bfloat16* Vt = Kt + SM::BF_STAGES * TILE;
  auto* K8 = reinterpret_cast<int8_t*>(Vt + SM::BF_STAGES * TILE);  // [2][TILE]
  int8_t* V8 = K8 + 2 * TILE;
  auto* Ksc = reinterpret_cast<float*>(V8 + 2 * TILE);  // [2][BKT]
  float* Vsc = Ksc + 2 * BKT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the last query tile first
  const int T = a.T, S = a.S, Hq = a.Hq, Hkv = a.Hkv, window = a.window;
  const int hk = hq / (Hq / Hkv);
  const int n_past = a.n_past[b];
  const int q_last = min(q0 + BQ, T) - 1;
  const int k_end = min(S, n_past + q_last + 1);  // exclusive
  const int k_beg = window > 0 ? max(0, n_past + q0 - window + 1) : 0;
  const size_t row_stride = (size_t)Hkv * D;
  const KV* kb = static_cast<const KV*>(a.k) + (size_t)b * S * row_stride + (size_t)hk * D;
  const KV* vb = static_cast<const KV*>(a.v) + (size_t)b * S * row_stride + (size_t)hk * D;
  const size_t sbase = (size_t)b * S * Hkv + hk;  // scale of row kp: + kp * Hkv

  // key tile kt into stage st (int8: its rows and scales as stored)
  auto load_tile = [&](int kt, int st) {
    const int c0 = kt * BKT, nv = k_end - c0;
    if constexpr (I8) {
      copy_rows_i8<BKT, D>(K8 + st * TILE, kb + (size_t)c0 * row_stride, row_stride, nv, tid);
      copy_rows_i8<BKT, D>(V8 + st * TILE, vb + (size_t)c0 * row_stride, row_stride, nv, tid);
      if (tid < 2 * BKT) {
        const int r = tid % BKT;
        const bool ok = r < nv, is_v = tid >= BKT;
        const float* src = (is_v ? a.vscale : a.kscale) + sbase +
                           (size_t)(c0 + (ok ? r : 0)) * Hkv;
        lcg::cp_async4((is_v ? Vsc : Ksc) + st * BKT + r, src, ok);
      }
    } else {
      copy_rows<BKT, D>(Kt + st * TILE, kb + (size_t)c0 * row_stride, row_stride, nv, tid);
      copy_rows<BKT, D>(Vt + st * TILE, vb + (size_t)c0 * row_stride, row_stride, nv, tid);
    }
    lcg::cp_async_commit();
  };

  copy_rows<BQ, D>(Qs, static_cast<const __nv_bfloat16*>(a.q) +
                           (((size_t)b * T + q0) * Hq + hq) * D,
                   (size_t)Hq * D, T - q0, tid);
  const int kt0 = k_beg / BKT, kt_n = (k_end + BKT - 1) / BKT;
  load_tile(kt0, 0);  // one group with Q

  const int r0 = warp * 16;                  // this warp's rows in the tile
  const int qp0 = n_past + q0 + r0 + g;      // positions of the thread's rows
  const int qp1 = qp0 + 8;
  const int kw_end = min(k_end, n_past + q0 + r0 + 16);  // the warp's last key + 1
  uint32_t qf[QREG ? KS : 1][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {lcg::kNegInf, lcg::kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = kt0; kt < kt_n; ++kt) {
    const int it = kt - kt0, st = it & 1, c0 = kt * BKT;
    lcg::cp_async_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < kt_n) load_tile(kt + 1, st ^ 1);
    const __nv_bfloat16* Kc = Kt;
    const __nv_bfloat16* Vc = Vt;
    if constexpr (I8) {
      widen_rows<BKT, D>(Kt, K8 + st * TILE, tid);
      widen_rows<BKT, D>(Vt, V8 + st * TILE, tid);
      __syncthreads();
    } else {
      Kc += st * TILE;
      Vc += st * TILE;
    }
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4(qf[ks], Qs + swz<D>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                      2 * ks + (lane >> 4)));
      }
    }
    // 16-key slices of this tile that hold a key of the warp's rows
    const int live16 = (kw_end - c0 + 15) / 16;

    // S = Q K^T, 16 rows x BKT keys a warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[ks][i];
      } else {
        ldsm_x4(qa, Qs + swz<D>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * ks + (lane >> 4)));
      }
#pragma unroll
      for (int np = 0; np < BKT / 16; ++np) {
        if (np < live16) {
          uint32_t kf[4];
          ldsm_x4(kf, Kc + swz<D>(16 * np + (lane & 7) + (lane >> 4) * 8,
                                  2 * ks + ((lane >> 3) & 1)));
          mma(s[2 * np], qa, kf);
          mma(s[2 * np + 1], qa, kf + 2);
        }
      }
    }

    // scale, softcap and masks on the fragments: s[n][e] is row
    // g + 8 (e >> 1), key c0 + 8 n + 2 tq + (e & 1)
    const bool edge = c0 + BKT > min(k_end, n_past + q0 + 1) ||
                      (window > 0 && c0 <= n_past + q_last - window);
    const float* ksc = Ksc + st * BKT;
    const float* vsc = Vsc + st * BKT;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * tq + (e & 1);
        float x = s[n][e];
        if constexpr (I8) x *= ksc[col];
        x *= a.scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        if (edge) {
          const int kp = c0 + col, qp = e < 2 ? qp0 : qp1;
          const bool live = kp < k_end && kp <= qp && (window <= 0 || kp > qp - window);
          x = live ? x : -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      const float alpha = exp2f((m[r] - mn) * kLog2e);
      m[r] = mn;
      ml[r] = mn * kLog2e;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }
    // p: the row sums take it as it is, PV after the value scale, in bf16
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[n][e], kLog2e, -ml[e >> 1]));
        l[e >> 1] += p;
        s[n][e] = p;
        if constexpr (I8) s[n][e] *= vsc[8 * n + 2 * tq + (e & 1)];
      }
    }

    // O += P V: P's fragments are PV's A operand
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      if (kk < live16) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vf[4];
          ldsm_x4_t(vf, Vc + swz<D>(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    2 * dp + (lane >> 4)));
          mma(o[2 * dp], pa, vf);
          mma(o[2 * dp + 1], pa, vf + 2);
        }
      }
    }
  }

  // the row sums over the quad; the sink joins the max, then the sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    float den = l[r], alpha = 1.f;
    if (a.sinks != nullptr) {
      const float sk = a.sinks[hq];
      const float mn = fmaxf(m[r], sk);
      alpha = expf(m[r] - mn);
      den = den * alpha + expf(sk - mn);
    }
    const float inv = alpha / fmaxf(den, 1e-30f);
    const int t = q0 + r0 + g + 8 * r;
    if (t < T) {
      auto* orow = static_cast<__nv_bfloat16*>(a.out) + (((size_t)b * T + t) * Hq + hq) * D +
                   2 * tq;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

template <typename KV, int D>
cudaError_t launch(const Args& a, cudaStream_t st) {
  auto kern = flash_attention_mma<KV, D>;
  constexpr size_t bytes = Smem<KV, D>::bytes;
  static bool smem_set = false;  // once, so later launches may be graph-captured
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  kern<<<dim3(a.Hq, a.B, (a.T + BQ - 1) / BQ), NT, bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// the FMA body (E = f32)

namespace simt {

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
    return p[i];
  }
}

template <typename KV, int D>
__global__ void __launch_bounds__(NT)
flash_attention_fma(const Args a) {
  extern __shared__ __align__(16) float sm[];
  lcg::count_launch(std::is_same<KV, int8_t>::value ? 1 : 0);  // slot 1: int8
  float* Qs = sm;
  float* Ks = Qs + Smem<D>::QS;
  float* Vs = Ks + Smem<D>::KS;
  float* Ps = Vs + Smem<D>::VS;
  constexpr int QLD = BQ + PAD, KLD = BKT + PAD, PLD = BKT + PAD;
  constexpr int DC = D / 8;  // output columns per thread
  const float* q = static_cast<const float*>(a.q);
  const int T = a.T, S = a.S, Hq = a.Hq, Hkv = a.Hkv, window = a.window;
  const float scale = a.scale, softcap = a.softcap;

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;  // 8 lanes share a row group
  const int qt = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int n_past = a.n_past[b];
  const int q0 = qt * BQ;

  // Q tile, transposed: Qs[d][r]
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    Qs[d * QLD + r] = t < T ? q[(((size_t)b * T + t) * Hq + hq) * D + d] : 0.f;
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
  const KV* kb = static_cast<const KV*>(a.k) + (size_t)b * S * row_stride + (size_t)hk * D;
  const KV* vb = static_cast<const KV*>(a.v) + (size_t)b * S * row_stride + (size_t)hk * D;
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
        kv = kv_at(kb, (size_t)kp * row_stride + d, a.kscale, si);
        vv = kv_at(vb, (size_t)kp * row_stride + d, a.vscale, si);
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
      const float4 a4 = *reinterpret_cast<const float4*>(&Qs[d * QLD + ty * 4]);
      const float4 k0 = *reinterpret_cast<const float4*>(&Ks[d * KLD + tx * 8]);
      const float4 k1 =
          *reinterpret_cast<const float4*>(&Ks[d * KLD + tx * 8 + 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
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
    if (a.sinks != nullptr) {  // the sink joins the running max, then the sum
      const float sk = a.sinks[hq];
      const float m_new = fmaxf(m_r[i], sk);
      alpha = expf(m_r[i] - m_new);
      denom = denom * alpha + expf(sk - m_new);
    }
    const float inv = alpha / fmaxf(denom, 1e-30f);
    float* orow = static_cast<float*>(a.out) + (((size_t)b * T + t) * Hq + hq) * D + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[c] = acc[i][c] * inv;
  }
}

template <typename KV, int D>
cudaError_t launch(const Args& a, cudaStream_t st) {
  auto kern = flash_attention_fma<KV, D>;
  static bool smem_set = false;  // once, so later launches may be graph-captured
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::bytes);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  kern<<<dim3((a.T + BQ - 1) / BQ, a.Hq, a.B), NT, Smem<D>::bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace simt

// f(std::integral_constant<int, D>{}) for the head dims the kernels take
template <typename F>
cudaError_t by_head_dim(int D, F&& f) {
  switch (D) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 != 0: q and output are bf16 (the tensor-core body), else f32 (the
// FMA body); kv_int8 != 0: the cache is int8 with kscale / vscale
// (B, S, Hkv) f32, else in q's type.  n_past: int32 (B,).
LCG_EXPORT int lcg_flash_attention(int bf16, int kv_int8, int D, const void* q,
                                   const void* k, const void* v,
                                   const float* kscale, const float* vscale,
                                   const int* n_past, const float* sinks,
                                   void* out, int B, int T, int S, int Hq,
                                   int Hkv, float scale, int window,
                                   float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, kv_int8 ? kscale : nullptr, kv_int8 ? vscale : nullptr, n_past, sinks,
               out, B, T, S, Hq, Hkv, scale, window, softcap};
  return by_head_dim(D, [&](auto d) {
    constexpr int Dh = decltype(d)::value;
    if (bf16)
      return kv_int8 ? tc::launch<int8_t, Dh>(a, st) : tc::launch<__nv_bfloat16, Dh>(a, st);
    return kv_int8 ? simt::launch<int8_t, Dh>(a, st) : simt::launch<float, Dh>(a, st);
  });
}
