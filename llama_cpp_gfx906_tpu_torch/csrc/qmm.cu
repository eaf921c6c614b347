// K5 qmm: the prefill-shape dequant matmul, y (M, N) = x (M, K) · W (K, N)
// for M > 8 rows of x, in two modes:
//   int8  q int8 (K, Np), w[k, n] = q[k, n] * s[k/g, n]
//   nib4  q int8 (K/2, Np), split-K 4-bit (stacked experts whose K has no
//         nib4c chunk): byte row r holds logical row r in its low nibble
//         and row K/2 + r in its high nibble, w = nibble * s[row/g, n]
// with s f32 (K/g, Np) plain scales (g 16 or 32) and optional affine mins
// m f32 (K/g, Np): y = x · W - (per-group sums of x) · m.
//
// Replaces: llama_cpp_gfx906_tpu/ops/quant_matmul.py  _qmm_int8_kernel and
// _qmm_nib4_kernel (K5, launched by _quant_matmul_pallas), with the mins
// that the JAX wrapper takes after its kernel.
//
// Numerics as the JAX kernels: x in bf16, each weight the f32 product of
// its value and scale rounded to bf16, products summed in f32 (bf16
// tensor-core MMA, f32 accumulators); the nib4 mode runs both K halves into
// one sum.  The mins: the f32 sums of x over each group (x as bf16) times
// m, summed in f32 apart from the product and subtracted from it once, at
// the end; then the caller's dtype (f32 or bf16).  Two launches give the
// same bits: a block walks its K range in one order and split partials are
// added in split order.
//
// Bound on the card: at the prefill shapes it serves (M 100-1000 rows of x
// against weights of K, N ~ 10^3) the bf16 tensor-core rate bounds the
// cases with a few hundred rows of x or more (the 270M's 676, Mixtral's
// experts at 256, gpt-oss at 256-1000: 1-30 us); at ~100 rows, and for
// Gemma-3-4B's attn_v at 256, the bytes of x, the packed weight and its
// scales do (1.5-6 us).  The design keeps the tensor cores fed:
//   - a block computes a BM x 128 output tile (BM 128, or 64 for M <= 64
//     and where 128-row tiles leave SMs idle) with two warp groups, each a
//     64 x 128 (BM 64: 64 x 64) part by wgmma m64nNk16 bf16 with f32
//     accumulators in registers, both operands read from shared memory;
//   - K walks in steps of 64 packed rows (a 32-row tail where K is 32 times
//     an odd number: 800, gpt-oss's nib4 half of 1440); a 3- or 4-stage
//     cp.async ring in dynamic shared memory holds each step's raw
//     operands: the x tile (bf16, rows past M zero-filled; 128-byte rows
//     with 16-byte chunks XOR-swizzled by row, wgmma's K-major 128-byte
//     swizzle), the packed bytes, and only the step's scale (and min) rows,
//     64/g of them per K half; step s + 2 (s + 3) is in flight while step s
//     multiplies;
//   - the block turns a step's staged bytes into one bf16 weight tile
//     (nib4: the lo and hi tiles from the same bytes) in wgmma's MN-major
//     128-byte-swizzled layout (panels of 64 columns), each weight
//     dequantized once per block (bytes to floats by a permute into the
//     mantissa of 2^23, exact); the weight tiles are double-buffered and
//     the product is asynchronous: while the tensor cores multiply step s,
//     the same warps dequantize step s + 1, one barrier a step;
//   - the mins: as a step is dequantized the block sums each row of its x
//     tile over each group, and each thread adds (x sum) · m into a second
//     set of f32 accumulators (8 rows x 8 columns a thread, while the
//     tensor cores run), moved to the product's layout through shared
//     memory at the end;
//   - where the output tiles are fewer than the SMs (N 640, or small M) the
//     host splits K over `nsplit` blocks (quant_matmul.qmm_config mirrors
//     the choice); the splits of a tile are one thread-block cluster, each
//     block leaves its partials in its own shared memory, and block r of
//     the cluster adds slice r of the tile's partials over the cluster's
//     blocks in split order (distributed shared memory: no atomics, no
//     workspace, no counters);
//   - the epilogue subtracts the mins from the product and writes only the
//     M live rows and N logical columns, in f32 or bf16: one launch a call.
// On an H100 the tensor cores are not what binds the large cases: the x
// tiles' traffic from L2 (each 128-column block reads its rows of x), the
// dequantization (once per 128-row tile of x) and the f32 mins take longer.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int BN = 128;        // output columns per block
constexpr int BK = 64;         // packed rows per K step
constexpr int TAIL = 32;       // packed rows of a tail step
constexpr int NT = 256;        // 8 warps: two warp groups
constexpr int MAX_SPLIT = 8;   // split-K blocks per tile: one portable cluster
constexpr int MAX_SEG = 4;     // scale rows a step spans per K half (g 16)

template <int BM, bool NIB, bool MINS>
struct Cfg {
  static constexpr int H = NIB ? 2 : 1;           // K halves per packed row
  static constexpr int WN = BM == 128 ? 128 : 64;  // a warp group's columns
  static constexpr int J = WN / 8;                // a thread's float4 fragments
  static constexpr int MT = BM / 32;              // the mins' 16-row tiles a warp
  // the cp.async ring: 3 steps (the nib4 mode's 48 KB steps; int8 without
  // mins, for 2 blocks an SM), else 4
  static constexpr int STAGES = (MINS && !NIB) ? 4 : 3;
  static constexpr int X_BYTES = BM * BK * 2;     // one half's x tile
  static constexpr int Q_BYTES = BK * BN;         // the packed bytes
  static constexpr int S_BYTES = MAX_SEG * BN * 4;  // one half's scale rows
  static constexpr int STAGE = H * X_BYTES + Q_BYTES + H * S_BYTES * (MINS ? 2 : 1);
  static constexpr int W_TILE = H * BK * BN * 2;    // a step's bf16 weight tiles
  static constexpr int XS_TILE = H * MAX_SEG * BM * 4;  // a step's x sums
  // two of each: step s + 1 is dequantized while step s multiplies
  static constexpr int RING = STAGES * STAGE + 2 * W_TILE + (MINS ? 2 * XS_TILE : 0);
  static constexpr int PART = (MINS ? 2 : 1) * J * NT * 16;  // split partials
  static constexpr int SHUF = MINS ? BM * (BN + 4) * 4 : 0;   // the mins' move
  static constexpr int SMEM = 1024 + (RING > PART ? (RING > SHUF ? RING : SHUF)
                                                  : (PART > SHUF ? PART : SHUF));
};

struct Args {
  const __nv_bfloat16* x;  // (M, K)
  const int8_t* q;         // (K or K/2, Np)
  const float* s;          // (K/g, Np)
  const float* m;          // (K/g, Np) or null
  void* out;               // (M, N), f32 or bf16
  int M, K, N, Np, group, nsplit, out_bf16;
};

// element offset of 16-byte chunk c of row r in a swizzled tile whose rows
// hold ROW bf16
template <int ROW>
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROW + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// wgmma's shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x N f32 over the warp group) += A (64 x 16 bf16, K-major) * B (16 x N
// bf16, MN-major), both from shared memory
__device__ __forceinline__ void gmma_n128(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void gmma_n64(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void gmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory (stores, cp.async) made visible to
// wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^23 + byte b of w as a float: the byte in the mantissa of 2^23 (a byte
// permute at the integer rate, where a conversion runs at a quarter)
__device__ __forceinline__ float biased_byte(uint32_t w, int b) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + b));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// the product, then the mins
__device__ __forceinline__ float4 minus_mins(float4 p, float4 mn) {
  return make_float4(p.x - mn.x, p.y - mn.y, p.z - mn.z, p.w - mn.w);
}

// Two adjacent outputs (row, col), (row, col + 1) in the caller's dtype;
// columns >= N are not written.
__device__ __forceinline__ void put2(const Args& a, int row, int col, float v0, float v1) {
  const size_t o = (size_t)row * a.N + col;
  const bool pair = col + 1 < a.N && (a.N & 1) == 0;
  if (a.out_bf16) {
    auto* out = static_cast<__nv_bfloat16*>(a.out);
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
    } else {
      if (col < a.N) out[o] = __float2bfloat16_rn(v0);
      if (col + 1 < a.N) out[o + 1] = __float2bfloat16_rn(v1);
    }
  } else {
    auto* out = static_cast<float*>(a.out);
    if (pair) {
      *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
    } else {
      if (col < a.N) out[o] = v0;
      if (col + 1 < a.N) out[o + 1] = v1;
    }
  }
}

// NIB: the split-K nib4 mode, else int8; MINS: the weight has mins.
template <int BM, bool NIB, bool MINS>
__global__ void __launch_bounds__(NT, (NIB || MINS) ? 1 : 2)
qmm_kernel(const Args a) {
  using C = Cfg<BM, NIB, MINS>;
  constexpr int H = C::H, MT = C::MT, J = C::J, WN = C::WN, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned: the 128-byte swizzle's 8-row atoms start there
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  lcg::count_launch(NIB ? 1 : 0);  // slot 0: int8, 1: nib4
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2, wi = warp & 3;  // warp group, warp in it
  // the warp group's part of the tile: rows r0 + [0, 64), columns c0 + [0, WN)
  const int r0 = BM == 128 ? 64 * wg : 0, c0 = BM == 128 ? 0 : 64 * wg;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int K = a.K, Np = a.Np, group = a.group, nsplit = a.nsplit;
  const int kp = NIB ? K / 2 : K;  // packed rows; half h's x columns at h * kp
  const int nsteps = (kp + BK - 1) / BK;
  const int split = blockIdx.z;
  const int st0 = split * nsteps / nsplit, st1 = (split + 1) * nsteps / nsplit;

  unsigned char* wbase = smem + STAGES * C::STAGE;
  auto xs = [&](int slot, int h) {  // BM x 64 bf16, K-major, 128-byte swizzle
    return reinterpret_cast<__nv_bfloat16*>(smem + slot * C::STAGE + h * C::X_BYTES);
  };
  auto qs = [&](int slot) {
    return reinterpret_cast<int8_t*>(smem + slot * C::STAGE + H * C::X_BYTES);
  };
  auto ss = [&](int slot, int h) {  // scale rows; min rows after both halves'
    return reinterpret_cast<float*>(smem + slot * C::STAGE + H * C::X_BYTES + C::Q_BYTES +
                                    h * C::S_BYTES);
  };
  // 64 x 128 bf16, MN-major, 128-byte swizzle: two panels of 64 columns
  auto wt = [&](int buf, int h) {
    return reinterpret_cast<__nv_bfloat16*>(wbase + buf * C::W_TILE) + h * BK * BN;
  };
  auto xsum = [&](int buf) {  // [H][BM][MAX_SEG]
    return reinterpret_cast<float*>(wbase + 2 * C::W_TILE + buf * C::XS_TILE);
  };

  // step st's raw operands into ring slot `slot`, one cp.async group
  auto load_step = [&](int st, int slot) {
    const int k0 = st * BK, rows = min(BK, kp - k0), nseg = rows / group;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      __nv_bfloat16* dst = xs(slot, h);
      for (int i = tid; i < BM * 8; i += NT) {
        const int r = i >> 3, c = i & 7;
        if (c * 8 < rows) {
          const bool ok = m0 + r < a.M;
          lcg::cp_async16(dst + swz<BK>(r, c),
                          a.x + (size_t)(ok ? m0 + r : 0) * K + h * kp + k0 + c * 8, ok);
        }
      }
    }
    for (int i = tid; i < BK * 8; i += NT) {
      const int r = i >> 3, c = i & 7;
      if (r < rows)
        lcg::cp_async16(qs(slot) + r * BN + c * 16, a.q + (size_t)(k0 + r) * Np + n0 + c * 16,
                        true);
    }
    for (int i = tid; i < (MINS ? 2 : 1) * H * MAX_SEG * 32; i += NT) {
      const int c = i & 31, j = (i >> 5) % MAX_SEG, h = (i >> 5) / MAX_SEG % H;
      const bool is_m = MINS && i >= H * MAX_SEG * 32;
      if (j < nseg) {
        const size_t row = (size_t)(h * kp + k0) / group + j;
        // scale rows: 16-byte chunk c at c ^ ((c >> 3) & 3), so the dequant's
        // reads meet no bank twice; min rows as they are
        const int pc = is_m ? c : c ^ ((c >> 3) & 3);
        lcg::cp_async16(ss(slot, h) + (is_m ? H * MAX_SEG * BN : 0) + j * BN + pc * 4,
                        (is_m ? a.m : a.s) + row * Np + n0 + c * 4, true);
      }
    }
    lcg::cp_async_commit();
  };

  // step st (staged in `slot`) into weight tiles `buf`: thread tid takes
  // rows 2p, 2p + 1 (one group) and columns 16 c16 + [0, 16); nib4: both
  // halves from the same bytes; with mins, the step's x sums of each row and
  // group too
  auto dequant = [&](int st, int slot, int buf) {
    const int rows = min(BK, kp - st * BK);
    const int p = tid >> 3, c16 = tid & 7;
    if (2 * p < rows) {
      const int seg = 2 * p / group;  // the scale row of these rows
      float sc[H][16];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float* sp = ss(slot, h) + seg * BN;
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // chunk 4 c16 + i, swizzled as staged
          const float4 d =
              *reinterpret_cast<const float4*>(sp + 4 * ((4 * c16 + i) ^ ((c16 >> 1) & 3)));
          sc[h][4 * i] = d.x; sc[h][4 * i + 1] = d.y;
          sc[h][4 * i + 2] = d.z; sc[h][4 * i + 3] = d.w;
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = 2 * p + rr;
        const uint4 qv = *reinterpret_cast<const uint4*>(qs(slot) + r * BN + c16 * 16);
        const uint32_t words[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int h = 0; h < H; ++h) {
          uint32_t packed[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // int8: the bytes biased by 128; nib4: half h's nibbles; each
            // value exact in f32, times its scale, then rounded to bf16
            const uint32_t u = NIB ? (h ? (words[i] >> 4) & 0x0F0F0F0Fu : words[i] & 0x0F0F0F0Fu)
                                   : words[i] ^ 0x80808080u;
            constexpr float off = NIB ? 8388608.f : 8388736.f;  // 2^23 (+ 128)
            float v[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) v[b] = (biased_byte(u, b) - off) * sc[h][4 * i + b];
            packed[2 * i] = pack_bf16(v[0], v[1]);
            packed[2 * i + 1] = pack_bf16(v[2], v[3]);
          }
          // columns 16 c16 + [0, 16) are chunks 2 (c16 & 3) and + 1 of panel
          // c16 >> 2; threads of the second panel store their odd chunk
          // first: each store of a warp then meets every bank 4 times
          const uint4 lo = make_uint4(packed[0], packed[1], packed[2], packed[3]);
          const uint4 hi = make_uint4(packed[4], packed[5], packed[6], packed[7]);
          const int odd = (c16 >> 2) & 1;
          __nv_bfloat16* w = wt(buf, h) + (c16 >> 2) * (BK * 64);
          *reinterpret_cast<uint4*>(w + swz<64>(r, 2 * (c16 & 3) + odd)) = odd ? hi : lo;
          *reinterpret_cast<uint4*>(w + swz<64>(r, 2 * (c16 & 3) + 1 - odd)) = odd ? lo : hi;
        }
      }
    }
    if constexpr (MINS) {
      const int nseg = rows / group;
      float* xo = xsum(buf);
      for (int i = tid; i < H * MAX_SEG * BM; i += NT) {
        const int r = i % BM, j = i / BM % MAX_SEG, h = i / (BM * MAX_SEG);
        if (j < nseg) {
          const __nv_bfloat16* xr = xs(slot, h);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          for (int c = j * group / 8; c < (j + 1) * group / 8; ++c) {
            float v[8];
            lcg::load8(xr + swz<BK>(r, c), v);
#pragma unroll
            for (int e = 0; e < 8; ++e) part[e & 3] += v[e];
          }
          xo[(h * BM + r) * MAX_SEG + j] = (part[0] + part[1]) + (part[2] + part[3]);
        }
      }
    }
  };

  float acc[J * 4];  // fragment j: rows g, g + 8 of the warp, columns 8 j + 2 tq, + 1
  // the mins: warp (mw, nw) of 2 x 4 takes rows mw BM/2 + 16 mt + g (+ 8),
  // columns nw 32 + 8 nt + 2 tq (+ 1)
  float accm[MINS ? MT : 1][4][4];
#pragma unroll
  for (int i = 0; i < J * 4; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if constexpr (MINS) accm[i][j][e] = 0.f;
  const int mrow = (warp >> 2) * (BM / 2), mcol = (warp & 3) * 32;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (st0 + i < st1) load_step(st0 + i, i);
    else lcg::cp_async_commit();
  }
  lcg::cp_async_wait<STAGES - 2>();
  __syncthreads();  // the first step landed
  dequant(st0, 0, 0);

  for (int st = st0; st < st1; ++st) {
    const int it = st - st0, slot = it % STAGES, buf = it & 1;
    const int rows = min(BK, kp - st * BK), nseg = rows / group;
    lcg::cp_async_wait<STAGES - 3>();  // step st + 1 landed (this thread's copies)
    fence_async_smem();  // this thread's weight tiles and copies, to wgmma
    // step st's weight tiles and x sums are ready, step st + 1 landed, and
    // every warp is done with step st - 1 (its slot and buffers are free)
    __syncthreads();
    if (st + STAGES - 1 < st1) load_step(st + STAGES - 1, (it + STAGES - 1) % STAGES);
    else lcg::cp_async_commit();

    // the product of step st on the tensor cores, asynchronous
    gmma_fence();
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const __nv_bfloat16* X = xs(slot, h) + r0 * BK;
      const __nv_bfloat16* W = wt(buf, h) + (c0 / 64) * (BK * 64);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        if (ks * 16 < rows) {
          // A: 8-row atoms 1024 bytes apart, k advancing 32 bytes inside
          // them; B: 8-row atoms 1024 bytes apart, panels BK * 128 apart
          const uint64_t da = gmma_desc(X + 16 * ks, 16, 1024);
          const uint64_t db = gmma_desc(W + 16 * ks * 64, BK * 128, 1024);
          if constexpr (WN == 128) gmma_n128(acc, da, db);
          else gmma_n64(acc, da, db);
        }
      }
    }
    gmma_commit();

    // meanwhile: step st + 1 into the other buffers, and step st's mins
    if (st + 1 < st1) dequant(st + 1, (it + 1) % STAGES, buf ^ 1);
    if constexpr (MINS) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float4 xr[MT][2];  // the thread's rows' sums, one per group
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            xr[mt][e] = *reinterpret_cast<const float4*>(
                xsum(buf) + (h * BM + mrow + 16 * mt + g + 8 * e) * MAX_SEG);
#pragma unroll
        for (int j = 0; j < MAX_SEG; ++j) {
          if (j < nseg) {
            const float* mv = ss(slot, h) + H * MAX_SEG * BN + j * BN + mcol + 2 * tq;
            float2 mc[4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mc[nt] = *reinterpret_cast<const float2*>(mv + 8 * nt);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const float* x0 = reinterpret_cast<const float*>(&xr[mt][0]);
              const float* x1 = reinterpret_cast<const float*>(&xr[mt][1]);
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                accm[mt][nt][0] = fmaf(x0[j], mc[nt].x, accm[mt][nt][0]);
                accm[mt][nt][1] = fmaf(x0[j], mc[nt].y, accm[mt][nt][1]);
                accm[mt][nt][2] = fmaf(x1[j], mc[nt].x, accm[mt][nt][2]);
                accm[mt][nt][3] = fmaf(x1[j], mc[nt].y, accm[mt][nt][3]);
              }
            }
          }
        }
      }
    }
    gmma_wait();  // step st's tiles are free for step st + 2
  }
  lcg::cp_async_wait<0>();  // only empty groups remain
  __syncthreads();          // every warp is done with the ring

  // the mins into the product's layout, through shared memory ([BM][BN + 4])
  float mn[J * 4];
#pragma unroll
  for (int i = 0; i < J * 4; ++i) mn[i] = 0.f;
  if constexpr (MINS) {
    float* sh = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(sh + (mrow + 16 * mt + g + 8 * e) * (BN + 4) + mcol +
                                     8 * nt + 2 * tq) =
              make_float2(accm[mt][nt][2 * e], accm[mt][nt][2 * e + 1]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 v = *reinterpret_cast<const float2*>(
            sh + (r0 + 16 * wi + g + 8 * e) * (BN + 4) + c0 + 8 * j + 2 * tq);
        mn[4 * j + 2 * e] = v.x;
        mn[4 * j + 2 * e + 1] = v.y;
      }
    __syncthreads();  // the buffer is reused by the split partials
  }

  // fragment j of this thread: rows g and g + 8 of the warp, columns 8 j +
  // 2 tq and + 1 of the warp group's part
  auto store = [&](int j, float4 y) {
    const int row = m0 + r0 + 16 * wi + g;
    const int col = n0 + c0 + 8 * j + 2 * tq;
    if (row < a.M) put2(a, row, col, y.x, y.y);
    if (row + 8 < a.M) put2(a, row + 8, col, y.z, y.w);
  };
  auto frag = [](const float* f, int j) {
    return make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
  };

  if (nsplit == 1) {
#pragma unroll
    for (int j = 0; j < J; ++j) store(j, minus_mins(frag(acc, j), frag(mn, j)));
    return;
  }

  // split K: the partials stay in this block's shared memory, [J][NT]
  // float4s (then the mins'), and block r of the cluster adds fragments
  // [r J / nsplit, (r + 1) J / nsplit) of every block in split order
  cg::cluster_group cluster = cg::this_cluster();
  float4* part = reinterpret_cast<float4*>(smem);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    part[j * NT + tid] = frag(acc, j);
    if constexpr (MINS) part[(J + j) * NT + tid] = frag(mn, j);
  }
  cluster.sync();  // every split's partials are in place
  const int rank = static_cast<int>(cluster.block_rank());
  for (int j = rank * J / nsplit; j < (rank + 1) * J / nsplit; ++j) {
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f), m4 = p;
    for (int src = 0; src < nsplit; ++src) {
      const float4* rp = cluster.map_shared_rank(part, src);
      p = add4(p, rp[j * NT + tid]);
      if constexpr (MINS) m4 = add4(m4, rp[(J + j) * NT + tid]);
    }
    store(j, minus_mins(p, m4));
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <int BM, bool NIB, bool MINS>
cudaError_t launch(const Args& a, cudaStream_t st) {
  auto kern = qmm_kernel<BM, NIB, MINS>;
  constexpr int bytes = Cfg<BM, NIB, MINS>::SMEM;
  static bool smem_set = false;  // once, so later launches may be graph-captured
  if (!smem_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Np / BN, (a.M + BM - 1) / BM, a.nsplit);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.nsplit;  // the splits of a tile: one cluster
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool NIB>
int dispatch(const void* x, const int8_t* q, const float* s, const float* m, void* out,
             int M, int K, int N, int Np, int group, int bm, int nsplit, int out_bf16,
             void* stream) {
  const int kp = NIB ? K / 2 : K;
  const int nsteps = (kp + BK - 1) / BK;
  if (M <= 0 || kp % TAIL || (NIB && K % 2) || Np % BN || N <= 0 || N > Np ||
      (group != 16 && group != 32) || kp % group || (bm != 64 && bm != 128) ||
      nsplit < 1 || nsplit > MAX_SPLIT || nsplit > nsteps)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(x), q, s, m, out, M, K, N, Np, group,
               nsplit, out_bf16};
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (m != nullptr)
    e = bm == 128 ? launch<128, NIB, true>(a, st) : launch<64, NIB, true>(a, st);
  else
    e = bm == 128 ? launch<128, NIB, false>(a, st) : launch<64, NIB, false>(a, st);
  return static_cast<int>(e);
}

}  // namespace

// x: bf16 (M, K), 16-byte aligned rows; q int8 (K, Np); s, m f32 (K/g, Np)
// (m may be null); out (M, N) f32, or bf16 with out_bf16, every element
// written.  K a multiple of 32, Np of 128, g 16 or 32; bm 64 or 128 rows a
// block; nsplit 1..8 blocks over K per output tile, at most the 64-row K
// steps (quant_matmul.qmm_config picks both).
LCG_EXPORT int lcg_qmm_int8(const void* x, const int8_t* q, const float* s, const float* m,
                            void* out, int M, int K, int N, int Np, int group, int bm,
                            int nsplit, int out_bf16, void* stream) {
  return dispatch<false>(x, q, s, m, out, M, K, N, Np, group, bm, nsplit, out_bf16, stream);
}

// The nib4 mode: q (K/2, Np) split-K nibbles, s and m (K/group, Np) over the
// logical rows; K/2 a multiple of 32.
LCG_EXPORT int lcg_qmm_nib4(const void* x, const int8_t* q, const float* s, const float* m,
                            void* out, int M, int K, int N, int Np, int group, int bm,
                            int nsplit, int out_bf16, void* stream) {
  return dispatch<true>(x, q, s, m, out, M, K, N, Np, group, bm, nsplit, out_bf16, stream);
}
