// K1 gemv_int8 and K2 gemv_nib4c: the decode-shape quantized GEMV
// y (M, N) = x (M, K) · W (K, Np) for M <= 8 rows of x, on tensor cores.
//
// Replaces: llama_cpp_gfx906_tpu/ops/quant_matmul.py  _qmm_int8_gemv_kernel
// (K1) and _qmm_nib4c_gemv_kernel (K2), launched by _quant_gemv_pallas, with
// the mins that the JAX wrapper takes after its kernel.  It reads the same
// device planes as the JAX package:
//   q   int8 (K, Np)             int8 format, w = q
//       int8 (K/2, Np)           nib4c: within each CK-row chunk the byte
//                                b = (lo | hi<<4) ^ 0x80 holds logical rows
//                                c*CK + r (lo) and c*CK + CK/2 + r (hi)
//   s   f32 (K/g, Np) plain scales, or int8 sub-scales when folded
//   sd  f32 (K/sgroup, Np) folded super-scales (per-256 d repeated twice)
//   m   optional mins, f32 or int8 (folded, times md f32 (K/sgroup, Np))
// and computes w[k, n] = q[k, n] * scale(k/g, n) - min(k/g, n) with
// scale = s (plain) or s * sd[k/sgroup] (folded), as the JAX nib4c kernel
// rounds: the raw integer values go through the matrix unit, each quant
// group's product is multiplied by its scale in f32, and the mins come
// from per-group f32 sums of x.
//
// Bound on the card: the weight bytes.  At M <= 8 each weight byte feeds at
// most 16 flops, far below the H100's ~295 flop/byte ridge, so the kernel is
// a stream of q (1 byte a weight int8, 0.5 nib4c) and the scale planes at
// ~3.35 TB/s; what can stop it short of that is the instructions a byte
// (the SMs issue ~9 a byte at that rate) and too few bytes in flight.
// Design:
//   - the product on tensor cores, mma.sync m16n8k16 bf16 with f32 sums:
//     the weight is the A operand (16 output columns x 16 k), x the B
//     operand (16 k x 8 tokens; tokens past M are zero), so one body serves
//     every M from 1 to 8 and M is not padded in memory.  A thread's A rows
//     (g and g + 8 of each of a warp's 4 tiles) stand for 8 adjacent
//     columns of the plane, so one 8-byte shared-memory load per k row
//     feeds the 4 tiles, and a byte permute pairs two k rows into a
//     register;
//   - the integer values become bf16 by bit operations, exactly: int8 b as
//     X + V with X = 0x4300 | (b & 0x7F) (128 + the low 7 bits) and
//     V = 0xC300 | (b & 0x80) (-128, or -256 where the sign bit is set),
//     two products into the same sums; a nibble n as 0x4300 | n = 128 + n,
//     whose 128 * (sum of x) comes off with the mins.  About 3 instructions
//     a byte with the loads and the scales, at any M, where the CUDA-core
//     dequantization took 8 at M 1 and 14-22 at M 4-8;
//   - each quant group's products go into fresh accumulators, which are
//     then multiplied by the group's scale into f32 sums; the per-group
//     sums of x come from the same tensor cores (a product with a matrix of
//     ones) and take the mins (and nib4c's 128) off.  A folded plane's
//     factors (int8 sub-scale times f32 super-scale, and the mins') are made
//     once a warp per stage, into shared memory.  The quant group and the
//     tile's columns are template parameters, so a stage's runs and steps
//     unroll;
//   - a bf16 x is one product; an f32 x is split into its bf16 high part
//     and the bf16 remainder, two products into the same sums (16 of its 24
//     bits: the result stays within ~2^-17 of the f32 product);
//   - a ring of NSTAGE stages of SK packed rows, filled by one producer warp
//     with the Tensor Memory Accelerator (cp.async.bulk.tensor: one box
//     each of the weight rows, of each K half's x slice in the caller's
//     dtype, of the scale rows, min rows and folded super rows (nib4c: both
//     K halves' rows in one 3-D box); the maps are made on the host,
//     cuTensorMapEncodeTiled, and cached by plane) completing
//     on the stage's mbarrier; 4 consumer warps wait on it and free the slot
//     on a second mbarrier.  Up to NSTAGE - 1 stages are in flight (~40 KB a
//     block at 128 columns), whatever the quant group or K.  The weight and
//     x boxes land 128-byte swizzled (64-byte for 64-column tiles), so a
//     warp's 8-byte loads of 4 k rows meet no bank twice.  A copy a row
//     (cp.async.bulk, 128-byte requests) streamed far slower on an H100:
//     the requests, not the bytes, were the limit;
//   - a block takes a tile of 128 (or 64) stored columns and the stages of
//     its K split; where the tiles are too few for the SMs, K splits over
//     up to MAX_SPLIT blocks of one thread-block cluster, each block leaves
//     its partial sums in its own shared memory, and block r of the cluster
//     adds slice r of the tile over the cluster's blocks in split order
//     (distributed shared memory: no workspace, fence, counter or second
//     pass).  quant_matmul.gemv_config picks the tile and the splits;
//   - one launch a call: x read in its own dtype (bf16 or f32), the output
//     written in the caller's (f32 or bf16) at its N logical columns.
// Two launches on the same inputs give the same bits: every sum is taken in
// a fixed order.

#include <cooperative_groups.h>
#include <cuda.h>
#include <string.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int SK = 64;              // packed rows a ring stage
constexpr int NSTAGE = 6;           // ring stages
constexpr int NCW = 4;              // consumer warps
constexpr int NT = 32 * (NCW + 1);  // and one producer warp
constexpr int MAX_SPLIT = 16;       // split-K blocks a column tile: one cluster
constexpr int MAX_M = 8;            // rows of x: the mma's 8 columns
constexpr int XBOX = 128;           // bytes of an x box row: 64 bf16 or 32 f32
constexpr uint32_t ONES = 0x3F803F80u;  // two bf16 1.0

// the TMA maps of the planes: boxes of a stage's rows of one column tile
struct Maps {
  CUtensorMap q, s, m, sd, md, x;
};

struct Args {
  Maps t;
  void* out;  // (M, N) f32 or bf16
  int M, K, N, Np, group, sgroup, ck, tn, nsplit, out_bf16, mins;
};

// x boxes a K half of a stage: SK values of x, XBOX bytes a box row
__host__ __device__ constexpr int x_boxes(bool xf32) { return SK * (xf32 ? 4 : 2) / XBOX; }

// Byte offsets of a ring stage's parts, and its size: the weight box (SK
// rows of tn bytes, swizzled), the x boxes (per K half, x_boxes of M rows
// of 128 bytes, swizzled, 1024 bytes each), the scale rows (SK / group per
// K half), the min rows, the folded super rows (one per K half each).
struct Layout {
  int q, x, s, m, sd, md, stage;
  __host__ __device__ Layout(bool nib, bool folded, bool xf32, bool mins, int tn, int group) {
    const int H = nib ? 2 : 1;
    const int srow = tn * (folded ? 1 : 4);
    const int srows = H * SK / group;
    q = 0;
    x = SK * tn;
    s = x + H * x_boxes(xf32) * 1024;
    m = s + srows * srow;
    sd = m + (mins ? srows * srow : 0);
    md = sd + (folded ? H * tn * 4 : 0);
    stage = (md + (folded && mins ? H * tn * 4 : 0) + 1023) / 1024 * 1024;
  }
};

// the byte `b` of a box whose rows are `span` bytes (128 or 64) as the TMA
// swizzle places it: 16-byte chunk bits XORed with row bits
__device__ __forceinline__ int swz(int b, int span) {
  return b ^ ((b >> 3) & (span == 128 ? 0x70 : 0x30));
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(b)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// the box of `map` at (column c0, row c1) into this block's shared memory,
// completing on bar
__device__ __forceinline__ void tma2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                      uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
      "[%1, {%2, %3}], [%4];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(saddr(bar))
      : "memory");
}

// the same at (column c0, row c1, plane c2) of a 3-D map
__device__ __forceinline__ void tma3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                      uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
      "[%1, {%2, %3, %4}], [%5];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(saddr(bar))
      : "memory");
}

template <int LUT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(LUT));
  return d;
}

// d (16 x 8 f32) += A (16 x 16 bf16) B (16 x 8 bf16)
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// byte `b` of a (row k) and of c (row k + 1) in the low bytes of the two
// 16-bit halves: an A register's two k values of one column
__device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t c, int b) {
  return __byte_perm(a, c, b | ((b + 4) << 8));
}

// (a & b) | c and b ? a ^ c : c, as lop3 tables
constexpr int AND_OR = 0xEA, SEL_XOR = 0x6A;

// the folded scales (or mins) of columns c, c + 1 at staged row `row`:
// int8 sub-scales times the K half's f32 super row
__device__ __forceinline__ float2 folded2(const unsigned char* plane, const unsigned char* sup,
                                          int row, int h, int tn, int c) {
  const uint32_t w = *reinterpret_cast<const unsigned short*>(plane + row * tn + c) ^ 0x8080u;
  const float2 d = *reinterpret_cast<const float2*>(sup + (h * tn + c) * 4);
  // int8 + 128 in the mantissa of 2^23, exactly
  return make_float2((__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540)) - 8388736.f) * d.x,
                     (__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7541)) - 8388736.f) * d.y);
}

// This thread's B fragments of k16 step k0 (stage-relative packed row) in
// K half h (its x boxes at xs): token g, k rows k0 + 2t (+1) and k0 + 2t +
// 8 (+9); an f32 x as its bf16 high part [0] and the bf16 remainder [1].
// Zero past M.
template <bool XF32>
__device__ __forceinline__ void x_frags(const unsigned char* xs, int h, int M, int g, int t,
                                        int k0, uint32_t (&b)[XF32 ? 2 : 1][2]) {
  constexpr int XE = XF32 ? 4 : 2, PER = XBOX / XE;  // values a box row
  const bool live = g < M;
  const int row = (live ? g : 0) * XBOX;
  // a k16 step lies in one box: k0 + 2t and k0 + 2t + 8 in it
  const unsigned char* p = xs + (h * x_boxes(XF32) + k0 / PER) * 1024;
  if constexpr (XF32) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float2 v = *reinterpret_cast<const float2*>(p + swz(row + (k0 % PER + 2 * t + 8 * i) * 4, 128));
      if (!live) v = make_float2(0.f, 0.f);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x - __low2float(hi),
                                                      v.y - __high2float(hi));
      b[0][i] = *reinterpret_cast<const uint32_t*>(&hi);
      b[1][i] = *reinterpret_cast<const uint32_t*>(&lo);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(p + swz(row + (k0 % PER + 2 * t + 8 * i) * 2, 128));
      b[0][i] = live ? v : 0u;
    }
  }
}

// NIB: the nib4c layout, else int8; FOLDED: int8 sub-scale planes with f32
// super planes; XF32: x in f32, else bf16; G: the quant group (16 or 32);
// TN: the tile's columns (64 or 128).  Grid (column tiles, splits), the
// splits of a tile a cluster; blocks of NCW consumer warps and one producer
// warp.
template <bool NIB, bool FOLDED, bool XF32, int G, int TN>
__global__ void __launch_bounds__(NT, 2) gemv_kernel(const __grid_constant__ Args a) {
  constexpr int H = NIB ? 2 : 1;    // K halves a packed row holds
  constexpr int XP = XF32 ? 2 : 1;  // x parts (f32: high and remainder)
  constexpr int GPR = SK / G;       // scale rows a K half of a stage
  // the consumer warps: SLABS of 64 columns across the tile, KP across each
  // stage's rows (R rows a warp), which they take in RUNS scale runs of
  // RL rows, STEPS k16 steps each
  constexpr int SLABS = TN / 64, KP = NCW / SLABS, R = SK / KP;
  constexpr int RL = R < G ? R : G, RUNS = R / RL, STEPS = RL / 16;
  constexpr int SPAN = TN;  // bytes of a weight box row
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NSTAGE], empty[NSTAGE];
  // folded planes: each consumer warp's factors of a stage, per K half and
  // scale run: the scales of its 64 columns, then what multiplies the x
  // sums (the mins, and nib4c's 128 times the scales)
  __shared__ __align__(16) float factors[FOLDED ? NCW : 1][H][RUNS][2][64];
  // 1024-byte aligned: the 128-byte swizzle's 8-row atoms start there
  unsigned char* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  lcg::count_launch(NIB ? 1 : 0);  // slot 0: int8, 1: nib4c
  const bool mins = a.mins;
  const int M = a.M;
  const Layout L(NIB, FOLDED, XF32, mins, TN, G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * TN;
  const int nst_all = (NIB ? a.K / 2 : a.K) / SK;
  const int split = blockIdx.y;
  const int st0 = split * nst_all / a.nsplit, st1 = (split + 1) * nst_all / a.nsplit;
  const int nst = st1 - st0;

  if (tid == 0) {
    for (int i = 0; i < NSTAGE; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  float acc[4][4];  // tile j: columns cb + 2j (e 0, 1) and + 1 (e 2, 3), tokens 2t + (e & 1)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp % SLABS, kpart = warp / SLABS;
  const int cb = slab * 64 + 8 * g;  // this thread's 8 columns of the tile

  if (warp == NCW) {
    // the producer: stage st0 + it into slot it % NSTAGE, once the slot is
    // free; boxes past the plane's last column arrive as zeros
    if (lane == 0) {
      const int hc = a.ck / 2;
      constexpr int SE = FOLDED ? 1 : 4;
      constexpr int XB = x_boxes(XF32), PER = XBOX / (XF32 ? 4 : 2);
      const uint32_t bytes = SK * TN + H * XB * M * XBOX + H * GPR * TN * SE * (mins ? 2 : 1) +
                             (FOLDED ? H * TN * 4 * (mins ? 2 : 1) : 0);
      for (int it = 0; it < nst; ++it) {
        const int slot = it % NSTAGE;
        if (it >= NSTAGE) mbar_wait(&empty[slot], ((it / NSTAGE) + 1) & 1);
        const int p0 = (st0 + it) * SK;  // first packed row
        unsigned char* st = smem + slot * L.stage;
        uint64_t* bar = &full[slot];
        mbar_expect_tx(bar, bytes);
        tma2d(st + L.q, &a.t.q, col0, p0, bar);
#pragma unroll
        for (int h = 0; h < H; ++h) {  // the first logical row of K half h
          const int kh = NIB ? (p0 / hc) * a.ck + p0 % hc + h * hc : p0;
#pragma unroll
          for (int xb = 0; xb < XB; ++xb)
            tma2d(st + L.x + (h * XB + xb) * 1024, &a.t.x, kh + PER * xb, 0, bar);
        }
        if constexpr (NIB) {
          // the plane rows of both K halves in one box: the planes mapped as
          // (half chunks, rows of a half chunk, columns)
          const int r = p0 % hc, c = 2 * (p0 / hc);
          tma3d(st + L.s, &a.t.s, col0, r / G, c, bar);
          if (mins) tma3d(st + L.m, &a.t.m, col0, r / G, c, bar);
          if constexpr (FOLDED) {
            tma3d(st + L.sd, &a.t.sd, col0, r / a.sgroup, c, bar);
            if (mins) tma3d(st + L.md, &a.t.md, col0, r / a.sgroup, c, bar);
          }
        } else {
          tma2d(st + L.s, &a.t.s, col0, p0 / G, bar);
          if (mins) tma2d(st + L.m, &a.t.m, col0, p0 / G, bar);
          if constexpr (FOLDED) {
            tma2d(st + L.sd, &a.t.sd, col0, p0 / a.sgroup, bar);
            if (mins) tma2d(st + L.md, &a.t.md, col0, p0 / a.sgroup, bar);
          }
        }
      }
    }
  } else {
    // a consumer warp: columns slab * 64 + [0, 64) of the tile, packed rows
    // kpart * R + [0, R) of every stage.  The byte offsets of this thread's
    // 8 columns in rows 2t, 2t + 1, 2t + 8 and 2t + 9 of a k16 step of the
    // weight box, swizzled as the box lands (the same at every step: steps
    // are 1024 bytes apart)
    int woff[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) woff[i] = swz((2 * t + (i & 1) + 8 * (i >> 1)) * SPAN + cb, SPAN);
    const bool xsums = NIB || mins;  // the runs take the x sums
    // the staged scale (and min) row of K half h's scale run r
    auto srow = [&](int h, int r) { return h * GPR + (kpart * R + r * RL) / G; };
    for (int it = 0; it < nst; ++it) {
      const int slot = it % NSTAGE;
      mbar_wait(&full[slot], (it / NSTAGE) & 1);
      const unsigned char* st = smem + slot * L.stage;
      if constexpr (FOLDED) {
        // the stage's factors, once a warp: lane l takes columns 2l, 2l + 1
        // of the warp's 64: int8 sub-scales times the f32 super row
        const int c2 = slab * 64 + 2 * lane;
        __syncwarp();  // the last stage's factors are read
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int r = 0; r < RUNS; ++r) {
            const int row = srow(h, r);
            const float2 sc = folded2(st + L.s, st + L.sd, row, h, TN, c2);
            float2 mm = mins ? folded2(st + L.m, st + L.md, row, h, TN, c2)
                             : make_float2(0.f, 0.f);
            if (NIB) mm = make_float2(fmaf(128.f, sc.x, mm.x), fmaf(128.f, sc.y, mm.y));
            *reinterpret_cast<float2*>(&factors[warp][h][r][0][2 * lane]) = sc;
            *reinterpret_cast<float2*>(&factors[warp][h][r][1][2 * lane]) = mm;
          }
        __syncwarp();
      }
#pragma unroll
      for (int r = 0; r < RUNS; ++r) {
        float d[H][4][4], ds[H][4];  // the run's products; its x sums
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ds[h][e] = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) d[h][j][e] = 0.f;
          }
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
          const int k0 = kpart * R + r * RL + 16 * s;
          uint32_t b[H][XP][2];
#pragma unroll
          for (int h = 0; h < H; ++h) x_frags<XF32>(st + L.x, h, M, g, t, k0, b[h]);
          if (xsums) {
#pragma unroll
            for (int h = 0; h < H; ++h)
#pragma unroll
              for (int p = 0; p < XP; ++p) mma(ds[h], ONES, ONES, ONES, ONES, b[h][p][0], b[h][p][1]);
          }
          // rows k0 + 2t, + 1, + 8, + 9; columns cb .. cb + 7
          const unsigned char* wq = st + L.q + k0 * SPAN;
          const uint2 w0 = *reinterpret_cast<const uint2*>(wq + woff[0]);
          const uint2 w1 = *reinterpret_cast<const uint2*>(wq + woff[1]);
          const uint2 w2 = *reinterpret_cast<const uint2*>(wq + woff[2]);
          const uint2 w3 = *reinterpret_cast<const uint2*>(wq + woff[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // tile j: A row g is column cb + 2j, row g + 8 column cb + 2j + 1
            const int by = 2 * (j & 1);
            const uint32_t r0w = j < 2 ? w0.x : w0.y, r1w = j < 2 ? w1.x : w1.y;
            const uint32_t r2w = j < 2 ? w2.x : w2.y, r3w = j < 2 ? w3.x : w3.y;
            const uint32_t P[4] = {pair(r0w, r1w, by), pair(r0w, r1w, by + 1),
                                   pair(r2w, r3w, by), pair(r2w, r3w, by + 1)};
            if constexpr (NIB) {
              uint32_t lo[4], hi[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                lo[i] = lop3<AND_OR>(P[i], 0x000F000Fu, 0x43004300u);  // 128 + lo
                hi[i] = lop3<SEL_XOR>(P[i] >> 4, 0x000F000Fu, 0x43084308u);  // 128 + hi
              }
#pragma unroll
              for (int p = 0; p < XP; ++p) {
                mma(d[0][j], lo[0], lo[1], lo[2], lo[3], b[0][p][0], b[0][p][1]);
                mma(d[H - 1][j], hi[0], hi[1], hi[2], hi[3], b[H - 1][p][0], b[H - 1][p][1]);
              }
            } else {
              uint32_t X[4], V[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                X[i] = lop3<AND_OR>(P[i], 0x007F007Fu, 0x43004300u);  // 128 + low 7 bits
                V[i] = lop3<AND_OR>(P[i], 0x00800080u, 0xC300C300u);  // -128 or -256
              }
#pragma unroll
              for (int p = 0; p < XP; ++p) {
                mma(d[0][j], X[0], X[1], X[2], X[3], b[0][p][0], b[0][p][1]);
                mma(d[0][j], V[0], V[1], V[2], V[3], b[0][p][0], b[0][p][1]);
              }
            }
          }
        }
        // the run's scales (and what multiplies its x sums) into the f32 sums
#pragma unroll
        for (int h = 0; h < H; ++h) {
          float sc[8], mm[8];
          const float* fs;
          const float* fm;
          if constexpr (FOLDED) {
            fs = &factors[warp][h][r][0][8 * g];
            fm = &factors[warp][h][r][1][8 * g];
          } else {  // plain f32 rows, straight from the stage
            fs = reinterpret_cast<const float*>(st + L.s) + srow(h, r) * TN + cb;
            fm = reinterpret_cast<const float*>(st + L.m) + srow(h, r) * TN + cb;
          }
          *reinterpret_cast<float4*>(sc) = reinterpret_cast<const float4*>(fs)[0];
          *reinterpret_cast<float4*>(sc + 4) = reinterpret_cast<const float4*>(fs)[1];
#pragma unroll
          for (int c = 0; c < 8; ++c) mm[c] = 0.f;
          if (FOLDED ? xsums : mins) {
            *reinterpret_cast<float4*>(mm) = reinterpret_cast<const float4*>(fm)[0];
            *reinterpret_cast<float4*>(mm + 4) = reinterpret_cast<const float4*>(fm)[1];
          }
          if (NIB && !FOLDED) {  // the nibbles went in as 128 + n
#pragma unroll
            for (int c = 0; c < 8; ++c) mm[c] = fmaf(128.f, sc[c], mm[c]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 2 * j + (e >> 1);
              acc[j][e] = fmaf(sc[c], d[h][j][e], acc[j][e]);
              if (xsums) acc[j][e] = fmaf(-mm[c], ds[h][e], acc[j][e]);
            }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
  }
  __syncthreads();  // the ring is drained: its space holds the partial sums

  // [kpart][token][column] f32, tokens < M
  float* part = reinterpret_cast<float*>(smem);
  if (warp < NCW) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 2 * t + (e & 1);
        if (tok < M) part[(kpart * MAX_M + tok) * TN + cb + 2 * j + (e >> 1)] = acc[j][e];
      }
  }
  __syncthreads();
  auto put = [&](int tok, int c, float v) {
    const int col = col0 + c;
    if (col >= a.N) return;
    const size_t o = (size_t)tok * a.N + col;
    if (a.out_bf16) static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(v);
    else static_cast<float*>(a.out)[o] = v;
  };
  const int n = M * TN;
  if (a.nsplit == 1) {
    for (int i = tid; i < n; i += NT) {
      const int tok = i / TN, c = i % TN;
      float v = 0.f;
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) v += part[(kk * MAX_M + tok) * TN + c];
      put(tok, c, v);
    }
    return;
  }
  // split K: block r of the cluster adds entries [r n / nsplit, (r + 1) n /
  // nsplit) of every block's partials, in split order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partials are in place
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank * n / a.nsplit + tid; i < (rank + 1) * n / a.nsplit; i += NT) {
    const int tok = i / TN, c = i % TN;
    float v = 0.f;
    for (int src = 0; src < a.nsplit; ++src) {
      const float* rp = cluster.map_shared_rank(part, src);
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) v += rp[(kk * MAX_M + tok) * TN + c];
    }
    put(tok, c, v);
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map's inputs; maps are cached by them, direct-mapped (a weight's planes
// are mapped once; an entry of another key in the same slot is replaced)
struct MapKey {
  const void* base;
  unsigned long long cols, rows, planes;
  int dtype, esize, box_cols, box_rows, box_planes, swizzle;
};

struct MapEntry {
  MapKey key;
  CUtensorMap map;
};

constexpr int MAP_CACHE = 4096;

// A map of a row-major (planes * rows, cols) plane of esize-byte elements
// seen as planes x rows x cols (2-D where planes is 1), boxes of box_planes
// x box_rows x box_cols; false if the driver refuses it.  Out-of-bounds
// elements of a box arrive as zeros.
bool map3d(CUtensorMap* out, const void* base, CUtensorMapDataType dtype, int esize,
           unsigned long long cols, unsigned long long rows, unsigned long long planes,
           int box_cols, int box_rows, int box_planes, CUtensorMapSwizzle swizzle) {
  static MapEntry cache[MAP_CACHE];
  MapKey key;
  memset(&key, 0, sizeof key);  // padding too: keys compare as bytes
  key.base = base;
  key.cols = cols;
  key.rows = rows;
  key.planes = planes;
  key.dtype = static_cast<int>(dtype);
  key.esize = esize;
  key.box_cols = box_cols;
  key.box_rows = box_rows;
  key.box_planes = box_planes;
  key.swizzle = static_cast<int>(swizzle);
  unsigned long long h = 1469598103934665603ull;  // FNV-1a over the key's bytes
  for (size_t i = 0; i < sizeof key; ++i)
    h = (h ^ reinterpret_cast<const unsigned char*>(&key)[i]) * 1099511628211ull;
  MapEntry& e = cache[h % MAP_CACHE];
  if (memcmp(&e.key, &key, sizeof key) == 0) {
    *out = e.map;
    return true;
  }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, planes};
  const cuuint64_t strides[2] = {cols * esize, rows * cols * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(box_planes)};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (enc(out, dtype, planes > 1 ? 3 : 2, const_cast<void*>(base), dims, strides, box, unit,
          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  memcpy(&e.key, &key, sizeof key);
  e.map = *out;
  return true;
}

template <bool NIB, bool FOLDED, bool XF32, int G, int TN>
cudaError_t launch(const Args& a, cudaStream_t st) {
  auto kern = gemv_kernel<NIB, FOLDED, XF32, G, TN>;
  static bool attrs_set = false;  // once, so later launches may be graph-captured
  if (!attrs_set) {  // the largest ring: with mins
    const int most = NSTAGE * Layout(NIB, FOLDED, XF32, true, TN, G).stage + 1024;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    attrs_set = true;
  }
  const Layout L(NIB, FOLDED, XF32, a.mins != 0, TN, G);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.Np + TN - 1) / TN, a.nsplit);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = NSTAGE * L.stage + 1024;  // and the alignment's slack
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.nsplit;  // the splits of a tile: one cluster
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool NIB, bool FOLDED, bool XF32>
cudaError_t dispatch_tile(const Args& a, cudaStream_t st) {
  if (a.group == 16)
    return a.tn == 64 ? launch<NIB, FOLDED, XF32, 16, 64>(a, st)
                      : launch<NIB, FOLDED, XF32, 16, 128>(a, st);
  return a.tn == 64 ? launch<NIB, FOLDED, XF32, 32, 64>(a, st)
                    : launch<NIB, FOLDED, XF32, 32, 128>(a, st);
}

template <bool NIB, bool FOLDED>
cudaError_t dispatch_x(int xf32, const Args& a, cudaStream_t st) {
  return xf32 ? dispatch_tile<NIB, FOLDED, true>(a, st) : dispatch_tile<NIB, FOLDED, false>(a, st);
}

}  // namespace

// x: (M, K) bf16, or f32 with xf32, 16-byte aligned, M 1..8; q int8 (K,
// Np), or nib4c (K/2, Np) with nib (chunk ck); s, m (K/group, Np) f32, or
// int8 with folded (then sd, md f32 (K/sgroup, Np)); m may be null; out (M,
// N) f32, or bf16 with out_bf16, every element written.  The packed K a
// multiple of SK, Np of 16, group 16 or 32; tn 64 or 128 columns a block;
// nsplit 1..MAX_SPLIT blocks over K per column tile, at most the stages
// (quant_matmul.gemv_config picks both).  Every plane 16-byte aligned.
LCG_EXPORT int lcg_gemv(int nib, int folded, int xf32, const void* x, const int8_t* q,
                        const void* s, const void* mn, const float* sd, const float* md,
                        void* out, int out_bf16, int M, int K, int N, int Np, int group,
                        int sgroup, int ck, int tn, int nsplit, void* stream) {
  const int kp = nib ? K / 2 : K;
  const int nsteps = kp / SK;
  if (M < 1 || M > MAX_M || K <= 0 || kp % SK || Np % 16 || N < 1 || N > Np ||
      (group != 16 && group != 32) || (tn != 64 && tn != 128) || nsplit < 1 ||
      nsplit > MAX_SPLIT || nsplit > nsteps ||
      (nib && (ck <= 0 || ck % (2 * SK) || K % ck || (ck / 2) % group ||
               (folded && (ck / 2) % sgroup))) ||
      (folded && (sgroup <= 0 || sgroup % SK || sgroup % group || sd == nullptr ||
                  (mn != nullptr && md == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  memset(&a, 0, sizeof a);
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8,
                            f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE,
                           sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  const int gpr = SK / group;
  const auto sdt = folded ? u8 : f32;
  const int se = folded ? 1 : 4;
  // nib4c: the scale and min planes as (half chunks, rows of a half chunk,
  // columns), so one box holds a stage's rows of both K halves
  const int halves = nib ? 2 * K / ck : 1;
  bool ok = map3d(&a.t.q, q, u8, 1, Np, kp, 1, tn, SK, 1,
                  tn == 128 ? sw128 : CU_TENSOR_MAP_SWIZZLE_64B) &&
            map3d(&a.t.s, s, sdt, se, Np, K / group / halves, halves, tn, gpr, nib ? 2 : 1,
                  none) &&
            (xf32 ? map3d(&a.t.x, x, f32, 4, K, M, 1, XBOX / 4, M, 1, sw128)
                  : map3d(&a.t.x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, M, 1, XBOX / 2, M,
                          1, sw128));
  if (mn != nullptr)
    ok = ok && map3d(&a.t.m, mn, sdt, se, Np, K / group / halves, halves, tn, gpr,
                     nib ? 2 : 1, none);
  if (folded) {
    ok = ok && map3d(&a.t.sd, sd, f32, 4, Np, K / sgroup / halves, halves, tn, 1,
                     nib ? 2 : 1, none);
    if (mn != nullptr)
      ok = ok && map3d(&a.t.md, md, f32, 4, Np, K / sgroup / halves, halves, tn, 1,
                       nib ? 2 : 1, none);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  a.out = out;
  a.M = M; a.K = K; a.N = N; a.Np = Np; a.group = group; a.sgroup = sgroup; a.ck = ck;
  a.tn = tn; a.nsplit = nsplit; a.out_bf16 = out_bf16; a.mins = mn != nullptr;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (nib)
    e = folded ? dispatch_x<true, true>(xf32, a, st) : dispatch_x<true, false>(xf32, a, st);
  else
    e = folded ? dispatch_x<false, true>(xf32, a, st) : dispatch_x<false, false>(xf32, a, st);
  return static_cast<int>(e);
}
