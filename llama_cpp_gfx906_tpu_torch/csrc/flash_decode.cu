// K3 flash_decode: attention for a few new queries per KV head (G*T <= 128)
// over an already-updated KV cache.
//
// Replaces: llama_cpp_gfx906_tpu/ops/flash_decode.py  _decode_kernel
// (launched by _flash_decode_call, wrapper flash_decode), for bf16, f32 or
// int8 KV with GQA, a per-sequence fill level n_past, sliding window, logit
// softcap, attention sinks, a batch-shared prefix segment, ALiBi and
// self-extend (logical) positions.
//
// Contract: q (B, T, Hq, D) holds the new queries and the output takes the
// same shape and type (f32, or bf16), both read and written in place; the
// NQ = G*T queries of KV head h are its lanes u = g*T + t (query head
// h*G + g, new token t).  The cache (B, S, Hkv, D) already holds the T new
// rows at n_past .. n_past+T-1.  Query t sits at position n_past + t and
// sees keys k with k <= n_past + t and, with a window W > 0,
// k > n_past + t - W.  A sink logit per query head joins the softmax
// denominator only.
//
// int8 mode: the cache holds int8 rows and one f32 scale per (row, KV head),
// kscale / vscale (B, S, Hkv).  The K scale multiplies the score (the dot
// runs on the int8 values), the V scale multiplies p before P.V (the
// softmax sum takes p without it), as the JAX kernel folds them; no
// dequantized copy of the cache is ever built.
//
// Shared-prefix mode: S0 rows shk / shv (S0, Hkv, D), stored once for the
// whole batch in the compute type (bf16 or f32, also beside an int8 cache),
// sit at logical positions 0 .. S0-1 and the own rows at S0 + row.  The
// shared rows inside the window and the own live rows form one range of
// key tiles, shared ones first; the shared rows are all causally visible,
// the window applies over logical positions.
//
// ALiBi mode (slopes (Hq,) f32, or null): each score, after the softcap and
// before the mask, loses slope * (q_pos - k_pos), the positions of the
// segment's own coordinates (shared rows at 0 .. S0-1 and queries at
// S0 + n_past + t; own rows at their row and queries at n_past + t) or, in
// the self-extend mode, the logical ones.
//
// Self-extend mode (kv_pos (B, S) and q_pos (B, T) int32, or null): row r
// of sequence b sits at logical position kv_pos[b, r], query t at
// q_pos[b, t]; a row is seen where its logical position is at most the
// query's (and, with a window, above q - W) and it is live (r < n_past +
// T).  Logical positions do not follow rows, so no row is skipped by the
// window: every live row is in the range, and a tile's 16 positions are
// staged beside its K and V rows.  Not with a shared segment (the JAX
// kernel raises there too).  The ALiBi and self-extend modes share one
// instantiation flag (EXT), each on or off at run time inside it, so the
// other modes pay nothing for them.
//
// Bound on the card: the live KV bytes read once, 2 * n_live * D * sizeof(KV)
// per KV head, plus 4 bytes of scale per row and head in the int8 mode (and
// of logical position per row in the self-extend mode), plus the shared rows
// (read by every slot's blocks: B times from the kernel, once from device
// memory when L2 serves the repeats); the flops per byte are ~G, far below
// the ridge.  Design (split-KV flash-decoding):
//   - the grid is (B * Hkv, query tiles, nsplit), a query tile being 1
//     query (MHA decode: MPT, BLOOM), 4 (the 8B's G 4) or 8 (an
//     instantiation each; ops/flash_decode.py ``query_tile`` picks it).
//     Each KV head's live key tiles (16 rows each: the shared rows inside
//     the window, then the own rows [lo, hi)) are dealt out in contiguous
//     runs, split s taking tiles
//     [s * n / e, (s + 1) * n / e), where e = min(nsplit, n / min_tiles)
//     (at least 1; min_tiles is ops/flash_decode.py SPLIT_MIN_TILES, passed
//     in): a short range stays whole and skips the merge, and the blocks of
//     splits past e return at once.  The block reads n_past
//     itself, so the host never synchronises and one grid serves every
//     n_past (a captured CUDA graph replays it as n_past moves); nsplit
//     comes from the shapes alone (ops/flash_decode.py ``splits``: at most
//     two blocks an SM over the grid, at most 32 splits), so the partials'
//     workspace is bounded by that, not by S.  Two blocks fit an SM where
//     the rings take 96 KB; at Dh 256 with bf16 rows (own or shared) two
//     stages of 16 KB a warp take 128 KB, one block fits an SM and the grid
//     runs in two waves;
//   - inside a block the 4 warps split the keys, not the queries: warp w
//     takes the w-th quarter of the split's run, in order, with a softmax
//     state of its own for all of the block's queries, so one query (MPT,
//     BLOOM) or four (the 8B) keep every warp busy, and the newest keys,
//     which weigh most, stay in one running sum.  Each warp streams its tiles through a
//     ring of 2-4 stages in shared memory (as many as 96 KB allow for the
//     block's four rings, but never under 2: 3 for bf16 rows of 128, 4 for
//     int8 rows of 128, 3 for int8 rows of 256, 2 (128 KB) for bf16 rows of
//     256) with 16-byte
//     cp.async copies (and 4-byte ones for the int8 scales and the logical
//     positions), synchronised by the warp alone: no block barrier until
//     the run ends.  Rows are stored without padding, their 16-byte chunks
//     XOR-swizzled by row, so the score reads (two lanes a key) and the P.V
//     reads (lanes across the head dims) meet no bank conflicts;
//   - scores: lanes 2j and 2j + 1 take the even and odd chunks of key j's
//     row against each query in f32 and meet by one shuffle; the online
//     softmax is per warp and query (max over the tile's 16 keys by
//     shuffles; each lane keeps its share of the sum); P.V: each lane owns
//     D/32 head dims, the int8 V scale folded into p, widened in registers;
//   - the end: the warps' states merge in warp order in shared memory; with
//     one split the block then writes the output, else it stores its
//     partial (m, l, acc[D]) per query and the last block of the (slot,
//     head, query tile) to arrive (a counter from kernels.tile_counters,
//     zero at rest, which that block resets) merges the partials in split
//     order, each rescaled by exp(m_s - M): two launches on the same inputs
//     give the same bits.  The sink joins the denominator once, at that
//     last merge.  A split with no live rows is the empty partial (m =
//     -1e30, the kernels' finite minus infinity; l = 0): it stores nothing
//     and the merge, which knows the runs, weighs it 0.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NW = 4;            // warps per block
constexpr int NT = 32 * NW;      // threads per block
constexpr int SUB = 16;          // keys per warp tile, two lanes a key (KEY_TILE)
constexpr int MAX_SPLIT = 32;    // ops/flash_decode.py MAX_SPLITS
constexpr int RING_BYTES = 96 * 1024;  // the block's four rings, at 2 stages or more

template <typename E, int D>
struct Tile {
  static constexpr int EPC = 16 / (int)sizeof(E);     // elements per chunk
  static constexpr int CH = D / EPC;                  // 16-byte chunks a row
  static constexpr int ROWS = SUB * D;                // elements of K (or V)
  static constexpr int bytes = 2 * ROWS * (int)sizeof(E);  // K and V rows
};

// the chunk of row j that holds logical chunk c: the XOR keeps the 8 reads
// of a quarter-warp (4 keys, even and odd chunks) in 8 bank groups
template <int CH>
__device__ __forceinline__ int swz(int j, int c) {
  return c ^ (CH >= 8 ? 2 * (j & 3) : (j & 3));
}

// a warp's ring: stages of the own tiles or, with a shared segment, of the
// larger of the own and the shared tiles
template <typename KV, typename SH, bool SHARED, int D, int QT>
struct Ring {
  static constexpr int tile = SHARED && Tile<SH, D>::bytes > Tile<KV, D>::bytes
                                  ? Tile<SH, D>::bytes : Tile<KV, D>::bytes;
  static constexpr int fit = RING_BYTES / (NW * tile);
  static constexpr int NST = fit < 2 ? 2 : fit > 4 ? 4 : fit;
  static constexpr int warp_bytes = NST * tile;
  static constexpr size_t bytes = NW * warp_bytes;
  // the rings' memory takes the warps' acc at the end
  static_assert(bytes >= (size_t)NW * QT * D * 4, "the warps' acc outgrow the rings");
};

template <int D, int QT>
struct __align__(16) Shared {
  float qs[QT][D];
  float ps[NW][QT][SUB];     // each warp's p of its tile
  float sc[NW][4][2][SUB];   // int8 mode: [warp][stage][K, V][key] scales
  int kpos[NW][4][SUB];      // self-extend mode: [warp][stage][key] positions
  float slope[QT];           // ALiBi mode: each query's slope
  int qlog[QT];              // self-extend mode: each query's logical position
  float sink[QT];            // each query's sink logit, or -inf
  float mw[MAX_SPLIT][QT];   // the states being merged: m, l
  float lw[MAX_SPLIT][QT];
  float wt[QT][MAX_SPLIT];   // and their weights exp(m_i - M)
  float M[QT];
};

// one warp's running softmax of the block's QT queries: m is the same in
// every lane, l each lane's share of the sum, acc its D/32 head dims
template <int D, int QT>
struct State {
  float acc[QT][D / 32];
  float m[QT], l[QT];
};

using lcg::cp_async16;  // common.cuh
using lcg::cp_async4;
using lcg::cp_async_commit;
using lcg::cp_async_wait;

// one 16-byte chunk as f32: 8 bf16, 4 f32 or 16 int8 values
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* out) {
  lcg::load8(p, out);
}
__device__ __forceinline__ void load_chunk(const float* p, float* out) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  out[0] = w.x; out[1] = w.y; out[2] = w.z; out[3] = w.w;
}
__device__ __forceinline__ void load_chunk(const int8_t* p, float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  lcg::unpack_s8x4(w.x, out);
  lcg::unpack_s8x4(w.y, out + 4);
  lcg::unpack_s8x4(w.z, out + 8);
  lcg::unpack_s8x4(w.w, out + 12);
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
  if constexpr (N == 4) {
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

// One warp's tiles of one segment into its running softmax.  Row r of the
// segment lies at kb + r * row_stride (its scales, in the int8 mode, at
// ksb / vsb + r * scale_stride; its logical position, in the self-extend
// mode, at posb[r], the queries' at sh.qlog); its live rows are [lo, hi),
// cut into tiles of SUB rows, of which the warp takes k0 .. k1 - 1;
// query t of the block sits at qpos0 + t in the segment's row coordinates.
// ``alibi``: the scores take the slopes in sh.slope.  Both only where EXT.
template <typename E, int D, int QT, int NST, bool EXT>
__device__ __forceinline__ void walk(const E* __restrict__ kb,
                                     const E* __restrict__ vb,
                                     const float* __restrict__ ksb,
                                     const float* __restrict__ vsb,
                                     const int* __restrict__ posb,
                                     size_t row_stride, int scale_stride,
                                     int lo, int hi, int k0, int k1, int qpos0,
                                     int T, int q0, float scale, int window,
                                     float softcap, bool alibi, E* ring,
                                     Shared<D, QT>& sh, State<D, QT>& st) {
  using TL = Tile<E, D>;
  constexpr bool QUANT = std::is_same<E, int8_t>::value;
  constexpr int DPT = D / 32;  // P.V: head dims per lane
  constexpr int EPC = TL::EPC, CH = TL::CH;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = k1 - k0;
  if (n <= 0) return;

  // the copies: lane l takes chunk l % CH of rows l / CH + RP * p of a tile
  constexpr int RP = 32 / CH;  // rows a pass of the warp covers
  const int cl = lane % CH, jl = lane / CH;
  const E* kl = kb + cl * EPC;
  const E* vl = vb + cl * EPC;
  auto issue = [&](int i) {  // tile i of the warp's into stage i % NST
    if (i < n) {
      const int r0 = lo + (k0 + i) * SUB;
      const int stage = i % NST;
      E* ks = ring + stage * 2 * TL::ROWS;
      E* vs = ks + TL::ROWS;
#pragma unroll
      for (int p = 0; p < SUB / RP; ++p) {
        const int j = jl + RP * p;
        const bool valid = r0 + j < hi;  // else zeros, from a row that exists
        const size_t o = (size_t)(valid ? r0 + j : lo) * row_stride;
        const int dst = j * D + swz<CH>(j, cl) * EPC;
        cp_async16(ks + dst, kl + o, valid);
        cp_async16(vs + dst, vl + o, valid);
      }
      if constexpr (QUANT) {
        const int is_v = lane / SUB, j = lane % SUB;
        const bool valid = r0 + j < hi;
        cp_async4(&sh.sc[w][stage][is_v][j],
                  (is_v ? vsb : ksb) + (size_t)(valid ? r0 + j : lo) * scale_stride, valid);
      }
      if constexpr (EXT) {
        if (posb != nullptr && lane < SUB) {
          const bool valid = r0 + lane < hi;
          cp_async4(&sh.kpos[w][stage][lane], posb + (valid ? r0 + lane : lo), valid);
        }
      }
    }
    cp_async_commit();  // one group per tile, empty past the last
  };

#pragma unroll
  for (int i = 0; i < NST - 1; ++i) issue(i);
  const int kj = lane >> 1, half = lane & 1;  // score phase: key, chunk parity
  const int e0 = lane * DPT;                   // P.V: this lane's head dims
  const int vch = e0 / EPC, vin = e0 % EPC;

  for (int i = 0; i < n; ++i) {
    issue(i + NST - 1);
    cp_async_wait<NST - 1>();  // tile i has landed (this lane's copies)
    __syncwarp();              // and every lane's
    const int stage = i % NST;
    const E* ks = ring + stage * 2 * TL::ROWS;
    const E* vs = ks + TL::ROWS;
    const int t0 = lo + (k0 + i) * SUB;

    // scores: lanes 2j and 2j + 1 dot the even and odd chunks of key j
    float dot[QT];
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) dot[qi] = 0.f;
    const E* krow = ks + kj * D;
#pragma unroll
    for (int c2 = 0; c2 < CH; c2 += 2) {
      const int c = c2 + half;
      float kv[EPC];
      load_chunk(krow + swz<CH>(kj, c) * EPC, kv);
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) {
        const float* qv = &sh.qs[qi][c * EPC];
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qv + e);
          part += (a.x * kv[e] + a.y * kv[e + 1]) + (a.z * kv[e + 2] + a.w * kv[e + 3]);
        }
        dot[qi] += part;
      }
    }
    const int kp = t0 + kj;
    const float kscale = QUANT ? sh.sc[w][stage][0][kj] : 1.f;
    const float vscale = QUANT ? sh.sc[w][stage][1][kj] : 1.f;
    int kq = kp;  // the key's position: physical, or logical
    if constexpr (EXT) {
      if (posb != nullptr) kq = sh.kpos[w][stage][kj];
    }
    float s[QT], mx[QT];
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      const float d = dot[qi] + __shfl_xor_sync(0xffffffffu, dot[qi], 1);
      // the query's position: physical (in the segment's coordinates) or,
      // in the self-extend mode, logical
      const int qph = qpos0 + (q0 + qi) % T;
      int qp = qph;
      float sc = d * kscale * scale;
      if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
      if constexpr (EXT) {
        if (posb != nullptr) qp = sh.qlog[qi];
        if (alibi) sc -= sh.slope[qi] * static_cast<float>(qp - kq);
      }
      const bool ok = kp < hi && kq <= qp && (window <= 0 || kq > qp - window);
      s[qi] = ok ? sc : -INFINITY;
      mx[qi] = s[qi];
    }
    // online softmax over the tile's 16 keys (lane pairs hold one key)
#pragma unroll
    for (int o = 2; o < 32; o <<= 1) {
#pragma unroll
      for (int qi = 0; qi < QT; ++qi)
        mx[qi] = fmaxf(mx[qi], __shfl_xor_sync(0xffffffffu, mx[qi], o));
    }
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      const float m_new = fmaxf(st.m[qi], mx[qi]);
      const float p = s[qi] == -INFINITY ? 0.f : expf(s[qi] - m_new);
      const float alpha = expf(st.m[qi] - m_new);
      st.m[qi] = m_new;
      st.l[qi] = st.l[qi] * alpha + (half ? 0.f : p);
#pragma unroll
      for (int e = 0; e < DPT; ++e) st.acc[qi][e] *= alpha;
      if (!half) sh.ps[w][qi][kj] = QUANT ? p * vscale : p;
    }
    __syncwarp();

    // P.V: each lane its DPT head dims; masked keys have p = 0 and rows
    // past the live end were zero-filled
    const int nk4 = (min(SUB, hi - t0) + 3) & ~3;
    for (int j = 0; j < nk4; j += 4) {
      float pj[QT][4];
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) {
        const float4 p4 = *reinterpret_cast<const float4*>(&sh.ps[w][qi][j]);
        pj[qi][0] = p4.x; pj[qi][1] = p4.y; pj[qi][2] = p4.z; pj[qi][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[DPT];
        load_dims<DPT>(vs + (j + u) * D + swz<CH>(j + u, vch) * EPC + vin, vv);
#pragma unroll
        for (int qi = 0; qi < QT; ++qi) {
#pragma unroll
          for (int e = 0; e < DPT; ++e) st.acc[qi][e] = fmaf(pj[qi][u], vv[e], st.acc[qi][e]);
        }
      }
    }
    __syncwarp();  // ps and this stage are rewritten by later tiles
  }
  cp_async_wait<0>();
}

// Merge n softmax states of the block's queries (state i of query qi:
// m = sh.mw[i][qi], l = sh.lw[i][qi], acc row at accs + (i * QT + qi) * D:
// shared memory, or the workspace written by other blocks, GLOBAL, read
// past L1), in order i = 0, 1, ..., each weighed by exp(m_i - M) (0 for a
// state without rows), M their max: the merged acc and denominator go,
// float4 by float4, to put(qi, d, acc, L, M, sink logit).  Every thread
// calls it.
template <int D, int QT, bool GLOBAL, class Put>
__device__ __forceinline__ void merge(int n, int nq, const float* accs,
                                      Shared<D, QT>& sh, Put put) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int qi = w; qi < nq; qi += NW) {  // a warp a query: lane i, state i
    const float m = lane < n ? sh.mw[lane][qi] : lcg::kNegInf;
    const float l = lane < n ? sh.lw[lane][qi] : 0.f;
    float M = m;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    const float w = l > 0.f ? expf(m - M) : 0.f;  // a state without rows: none
    if (lane < n) sh.wt[qi][lane] = w;
    if (lane == 0) sh.M[qi] = M;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nq * D / 4; idx += NT) {
    const int qi = idx / (D / 4), d = (idx % (D / 4)) * 4;
    const float sk = sh.sink[qi];
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float L = 0.f;
    for (int i0 = 0; i0 < n; i0 += 8) {  // 8 loads in flight, then added in order
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j;
        v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < n && sh.wt[qi][i] != 0.f) {
          const float4* src = reinterpret_cast<const float4*>(accs + ((size_t)i * QT + qi) * D + d);
          v[j] = GLOBAL ? __ldcg(src) : *src;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j;
        if (i < n && sh.wt[qi][i] != 0.f) {
          const float w = sh.wt[qi][i], l = sh.lw[i][qi];
          L += w * l;
          a.x = fmaf(w, v[j].x, a.x); a.y = fmaf(w, v[j].y, a.y);
          a.z = fmaf(w, v[j].z, a.z); a.w = fmaf(w, v[j].w, a.w);
        }
      }
    }
    put(qi, d, a, L, sh.M[qi], sk);
  }
}

template <typename KV, typename SH, typename Q, bool SHARED, bool EXT, int D, int QT>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const Q* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v,
                    const float* __restrict__ kscale,  // (B, S, Hkv) or null
                    const float* __restrict__ vscale,
                    const SH* __restrict__ shk,  // (S0, Hkv, D) or null
                    const SH* __restrict__ shv, int S0,
                    const int* __restrict__ n_past_arr,
                    const float* __restrict__ sinks,   // (Hq,) or null
                    const float* __restrict__ slopes,  // (Hq,) or null
                    const int* __restrict__ kv_pos,    // (B, S) or null
                    const int* __restrict__ q_pos,     // (B, T) or null
                    Q* __restrict__ out, int S, int Hkv, int NQ, int T,
                    float scale, int window, float softcap,
                    int min_tiles,                // key tiles a split takes at least
                    float* __restrict__ part,     // the partials, nsplit > 1
                    unsigned* __restrict__ cnt) {  // (B * Hkv * query tiles)
  using R = Ring<KV, SH, SHARED, D, QT>;
  constexpr int DPT = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared<D, QT> sh;
  __shared__ unsigned s_last;
  // slot: bit 0 int8, bit 1 shared, bit 2 ALiBi, bit 3 logical positions
  const bool alibi = slopes != nullptr;
  lcg::count_launch((std::is_same<KV, int8_t>::value ? 1 : 0) + (SHARED ? 2 : 0) +
                    (alibi ? 4 : 0) + (kv_pos != nullptr ? 8 : 0));

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / Hkv, h = bh % Hkv;
  const int G = NQ / T, Hq = Hkv * G;
  const int tile_q = bh * gridDim.y + blockIdx.y;  // this (slot, head, query tile)
  const int q0 = blockIdx.y * QT, nq = min(QT, NQ - q0);
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int n_past = n_past_arr[b];
  const size_t row_stride = (size_t)Hkv * D;

  // query lane u = g*T + t of KV head h: query head h*G + g at token t,
  // q (B, T, Hq, D) in place
  for (int i = tid; i < QT * D; i += NT) {
    const int qi = i / D, d = i % D, u = q0 + qi;
    float x = 0.f;
    if (qi < nq) x = lcg::to_float(q[((size_t)(b * T + u % T) * Hq + h * G + u / T) * D + d]);
    sh.qs[qi][d] = x;
  }
  if (tid < QT) {
    const int u = min(q0 + tid, NQ - 1), hq = h * G + u / T;
    sh.slope[tid] = alibi ? slopes[hq] : 0.f;
    sh.qlog[tid] = q_pos != nullptr ? q_pos[b * T + u % T] : 0;
    sh.sink[tid] = sinks != nullptr ? sinks[hq] : -INFINITY;
  }

  // the live key tiles: the shared rows [slo, S0) inside the window, then
  // the own rows [lo, hi); this split's run of them, this warp's share
  const int hi = min(n_past + T, S);  // live rows end
  // logical positions do not follow rows: no window skip with them
  const int lo = (window > 0 && kv_pos == nullptr) ? max(0, n_past + 1 - window) : 0;
  int slo = 0, nsh = 0;
  if constexpr (SHARED) {  // logical rows 0 .. S0-1, queries at S0 + n_past + t
    slo = window > 0 ? min(S0, max(0, S0 + n_past + 1 - window)) : 0;
    nsh = (S0 - slo + SUB - 1) / SUB;
  }
  const int ntot = nsh + (hi > lo ? (hi - lo + SUB - 1) / SUB : 0);
  // the splits this n_past takes: at least min_tiles tiles each (a short
  // range stays whole and skips the merge); the others have nothing to do
  const int eff = max(1, min(nsplit, ntot / min_tiles));
  if (split >= eff) return;
  const int t0 = split * ntot / eff, t1 = (split + 1) * ntot / eff;
  // this warp's quarter of the run
  const int wa = t0 + w * (t1 - t0) / NW, wb = t0 + (w + 1) * (t1 - t0) / NW;
  __syncthreads();

  // writes the block's final output: the sink joins the denominator once
  auto put_out = [&](int qi, int d, float4 a, float L, float M, float sk) {
    float alpha = 1.f;
    if (sk > -INFINITY) {  // the sink joins the max, then the sum
      const float m_new = fmaxf(M, sk);
      alpha = expf(M - m_new);
      L = L * alpha + expf(sk - m_new);
    }
    const float s = alpha / fmaxf(L, 1e-30f);
    const int u = q0 + qi;
    Q* o = out + ((size_t)(b * T + u % T) * Hq + h * G + u / T) * D + d;
    lcg::from_float(a.x * s, o);
    lcg::from_float(a.y * s, o + 1);
    lcg::from_float(a.z * s, o + 2);
    lcg::from_float(a.w * s, o + 3);
  };
  const size_t p0 = (size_t)tile_q * nsplit;  // this tile's partials
  // (m, l) of each partial and query, after every partial's acc
  float* pml = eff > 1 ? part + (size_t)gridDim.x * gridDim.y * nsplit * QT * D : nullptr;

  if (t1 > t0 || eff == 1) {
    State<D, QT> st;
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      st.m[qi] = lcg::kNegInf;
      st.l[qi] = 0.f;
#pragma unroll
      for (int e = 0; e < DPT; ++e) st.acc[qi][e] = 0.f;
    }
    unsigned char* ring = smem_raw + w * R::warp_bytes;
    if constexpr (SHARED) {
      walk<SH, D, QT, R::NST, EXT>(shk + (size_t)h * D, shv + (size_t)h * D, nullptr,
                                   nullptr, nullptr, row_stride, 0, slo, S0, wa,
                                   min(wb, nsh), S0 + n_past, T, q0, scale, window,
                                   softcap, alibi, reinterpret_cast<SH*>(ring), sh, st);
    }
    {
      const size_t base = (size_t)b * S * row_stride + (size_t)h * D;
      const size_t sbase = (size_t)b * S * Hkv + h;
      walk<KV, D, QT, R::NST, EXT>(k + base, v + base,
                                   kscale != nullptr ? kscale + sbase : nullptr,
                                   vscale != nullptr ? vscale + sbase : nullptr,
                                   kv_pos != nullptr ? kv_pos + (size_t)b * S : nullptr,
                                   row_stride, Hkv, lo, hi, max(wa, nsh) - nsh, wb - nsh, n_past,
                                   T, q0, scale, window, softcap, alibi,
                                   reinterpret_cast<KV*>(ring), sh, st);
    }

    // the warps' states, merged in warp order: the block's state
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) st.l[qi] += __shfl_xor_sync(0xffffffffu, st.l[qi], o);
    }
    __syncthreads();  // every ring is drained: its memory takes the warps' acc
    float* wacc = reinterpret_cast<float*>(smem_raw);  // [NW][QT][D]
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
#pragma unroll
      for (int e = 0; e < DPT; ++e) wacc[(w * QT + qi) * D + lane * DPT + e] = st.acc[qi][e];
      if (lane == 0) {
        sh.mw[w][qi] = st.m[qi];
        sh.lw[w][qi] = st.l[qi];
      }
    }
    __syncthreads();
    if (eff == 1) {
      merge<D, QT, false>(NW, nq, wacc, sh, put_out);
      return;
    }
    // the partial of this split: acc (QT, D) and (m, l) per query
    float* pacc = part + (p0 + split) * QT * D;
    merge<D, QT, false>(NW, nq, wacc, sh,
                        [&](int qi, int d, float4 a, float L, float M, float) {
      *reinterpret_cast<float4*>(pacc + (size_t)qi * D + d) = a;
      if (d == 0) *reinterpret_cast<float2*>(pml + ((p0 + split) * QT + qi) * 2) =
          make_float2(M, L);
    });
    __threadfence();  // the partial is visible before the arrival counts
  }
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(cnt + tile_q, 1u) == (unsigned)eff - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last to arrive merges the partials in split order; a split without
  // tiles left none
  for (int i = tid; i < eff * nq; i += NT) {
    const int s = i / nq, qi = i % nq;
    const bool has = (s + 1) * ntot / eff > s * ntot / eff;
    float2 ml = make_float2(lcg::kNegInf, 0.f);
    if (has) ml = __ldcg(reinterpret_cast<const float2*>(pml + ((p0 + s) * QT + qi) * 2));
    sh.mw[s][qi] = ml.x;
    sh.lw[s][qi] = ml.y;
  }
  __syncthreads();
  merge<D, QT, true>(eff, nq, part + p0 * QT * D, sh, put_out);
  if (tid == 0) cnt[tile_q] = 0u;  // every split has arrived: back to rest
}

struct Args {
  const void* q;
  const void *k, *v;
  const float *kscale, *vscale;
  const void *shk, *shv;
  int S0;
  const int* n_past;
  const float* sinks;
  const float* slopes;
  const int *kv_pos, *q_pos;
  void* out;
  int B, S, Hkv, NQ, T;
  float scale;
  int window;
  float softcap;
  int nsplit, qt, min_tiles;
  float* part;
  unsigned* cnt;
};

template <typename KV, typename SH, typename Q, bool SHARED, bool EXT, int D, int QT>
cudaError_t launch_q(const Args& a, cudaStream_t st) {
  auto kern = flash_decode_kernel<KV, SH, Q, SHARED, EXT, D, QT>;
  constexpr size_t smem = Ring<KV, SH, SHARED, D, QT>::bytes;
  static bool smem_set = false;  // once, so later launches may be graph-captured
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  dim3 grid(a.B * a.Hkv, (a.NQ + QT - 1) / QT, a.nsplit);
  kern<<<grid, NT, smem, st>>>(
      static_cast<const Q*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      a.kscale, a.vscale, static_cast<const SH*>(a.shk), static_cast<const SH*>(a.shv),
      a.S0, a.n_past, a.sinks, a.slopes, a.kv_pos, a.q_pos, static_cast<Q*>(a.out), a.S,
      a.Hkv, a.NQ, a.T, a.scale, a.window, a.softcap, a.min_tiles, a.part, a.cnt);
  return cudaGetLastError();
}

template <typename KV, typename SH, typename Q, bool SHARED, bool EXT, int D>
cudaError_t launch_d(const Args& a, cudaStream_t st) {
  switch (a.qt) {
    case 1:
      return launch_q<KV, SH, Q, SHARED, EXT, D, 1>(a, st);
    case 4:
      return launch_q<KV, SH, Q, SHARED, EXT, D, 4>(a, st);
    case 8:
      return launch_q<KV, SH, Q, SHARED, EXT, D, 8>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename KV, typename SH, typename Q, bool SHARED, bool EXT>
cudaError_t launch_s(int D, const Args& a, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_d<KV, SH, Q, SHARED, EXT, 64>(a, st);
    case 128:
      return launch_d<KV, SH, Q, SHARED, EXT, 128>(a, st);
    case 256:  // f32 rows of 256 leave a lane 8 dims: more than one chunk
      if constexpr (!std::is_same<KV, float>::value && !std::is_same<SH, float>::value)
        return launch_d<KV, SH, Q, SHARED, EXT, 256>(a, st);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// the shared mode and the ALiBi / logical-position modes are instantiations
// of their own, so a profiler trace tells them apart by name; q (and the
// output) is in the compute type, which is the shared rows' where there are
// any and the cache's beside a bf16 or f32 cache
template <typename KV, typename SH, typename Q, bool EXT>
cudaError_t launch_x(int D, const Args& a, cudaStream_t st) {
  return a.S0 > 0 ? launch_s<KV, SH, Q, true, EXT>(D, a, st)
                  : launch_s<KV, SH, Q, false, EXT>(D, a, st);
}
template <typename KV, typename SH, typename Q>
cudaError_t launch(int D, const Args& a, cudaStream_t st) {
  return (a.slopes != nullptr || a.kv_pos != nullptr) ? launch_x<KV, SH, Q, true>(D, a, st)
                                                      : launch_x<KV, SH, Q, false>(D, a, st);
}

}  // namespace

// kv_kind: 0 f32, 1 bf16, 2 int8 (with kscale / vscale (B, S, Hkv) f32).
// sh_kind: the shared rows' type, 0 f32 or 1 bf16 (S0 > 0); beside a bf16 or
// f32 cache it must be the cache's.  q_kind: q's and the output's type, 0
// f32 or 1 bf16: the cache's beside a bf16 or f32 cache, the shared rows'
// (sh_kind) beside an int8 one.  q and out (B, T, Hq, D).  n_past: int32
// (B,) on the card.  sinks, slopes (Hq,) f32, kv_pos (B, S) and q_pos
// (B, T) int32: null when off; kv_pos and q_pos come together, and not with
// S0 > 0.  qt: the queries a block takes, 1, 4 or 8 (of the NQ = G*T of a
// KV head).  nsplit: 1 to 32 splits of each head's keys, of which a launch
// takes min(nsplit, live tiles / min_tiles) or 1; above 1, part holds
// the partials (at least B * Hkv * tiles * nsplit * 8 * (D + 2) floats, 8
// queries a tile or fewer) and cnt B * Hkv * tiles arrival counters, zero
// at rest.
LCG_EXPORT int lcg_flash_decode(int kv_kind, int sh_kind, int q_kind, int D,
                                const void* q, const void* k, const void* v,
                                const float* kscale, const float* vscale,
                                const void* shk, const void* shv, int S0,
                                const int* n_past, const float* sinks,
                                const float* slopes, const int* kv_pos,
                                const int* q_pos, void* out, int B, int S,
                                int Hkv, int NQ, int T, float scale, int window,
                                float softcap, int qt, int nsplit, int min_tiles, float* part,
                                unsigned* cnt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q,      k,      v,      kscale, vscale, shk,    shv,     S0,
               n_past, sinks,  slopes, kv_pos, q_pos,  out,    B,       S,
               Hkv,    NQ,     T,      scale,  window, softcap, nsplit, qt,
               min_tiles, part, cnt};
  if (S0 > 0 && kv_kind != 2 && sh_kind != kv_kind) return cudaErrorInvalidValue;
  if ((kv_pos == nullptr) != (q_pos == nullptr) || (kv_pos != nullptr && S0 > 0))
    return cudaErrorInvalidValue;
  if (nsplit < 1 || nsplit > MAX_SPLIT || min_tiles < 1 ||
      (nsplit > 1 && (part == nullptr || cnt == nullptr)))
    return cudaErrorInvalidValue;
  if (q_kind != (kv_kind == 2 ? sh_kind : kv_kind)) return cudaErrorInvalidValue;
  switch (kv_kind) {
    case 0:
      return launch<float, float, float>(D, a, st);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(D, a, st);
    case 2:
      return sh_kind == 1 ? launch<int8_t, __nv_bfloat16, __nv_bfloat16>(D, a, st)
                          : launch<int8_t, float, float>(D, a, st);
    default:
      return cudaErrorInvalidValue;
  }
}
