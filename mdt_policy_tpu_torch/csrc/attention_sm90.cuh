// Multi-head attention over the packed (B, T, 3C) qkv projection on the
// tensor cores, for Hopper (sm_90a): the body of kernel B1
// (fused_qkv_attention.cu), of the attention core of kernel B4
// (attention_halfblock.cu) for bf16 calls with 64-wide heads and T <= 208,
// which is every tower call, and of B1's microbench variants V1
// (attn_pair_grid.cu) and V3 (attn_pair_v3.cu). Every other B1 / B4 call
// (f32, other head widths) runs mha_core.cuh; the wrappers pick the body
// (ops/fused_qkv_attention.py, _sm90_body).
//
// Contract, mha_core.cuh's (the Pallas TPU kernels _kernel / _kernel_pair of
// mdt_policy_tpu/ops/fused_qkv_attention.py): qkv (B, T, 3C) row-major,
// [q | k | v], H interleaved 64-wide head slices in each, read as the qkv
// projection writes it; out (B, T, C) row-major, each head at its column
// slice, as the out-projection reads it. Per head: f32 scores q.k / 8, an
// optional causal mask, an f32 max-subtracted softmax, probabilities rounded
// to bf16, P.V accumulated in f32 and rounded to bf16. The exponential is
// 2^(s log2(e) / 8 - max log2(e) / 8) (one FMA and ex2.approx: a few f32
// ulps from exp(s / 8 - max / 8)) and p = bf16(e * (1 / l)), one reciprocal
// a row, within one f32 ulp of e / l before the bf16 rounding.
//
// V3's options (the template parameter FLAGS, the bits of Flags; 0 is the
// contract above, which B1, B4 and V1 run) move the rounding points as the
// TPU kernel tools/attn_kernel_round3.py (make_pair_v3) of the JAX
// repository moves them (ops/pair_attention.py):
//   kExp2        q <- bf16(q * bf16(log2(e) / 8)) before S, no later scale,
//                e = 2^(s - max). Each warpgroup scales its own 64-row tile
//                of the Q box in shared memory in place before its first S
//                wgmma; the generic-proxy writes are fenced to the async
//                proxy and the warpgroup meets at a named barrier first.
//   kMxuSum      e rounded to bf16, P = e, out = bf16(O * (1 / sum)) (within
//                an f32 ulp of O / sum) with the row sum of the rounded e
//                taken in f32 registers: the TPU kernel's ones column
//                appended to V adds the same f32 values in another order,
//                and needs no n72 P.V product. Takes precedence over
//                kBf16Softmax.
//   kNoMax       (with kMxuSum) no max pass: e = exp(s); a probe of the
//                max pass's cost, numerically unsafe.
//   kBf16Softmax e = bf16(exp(bf16(s - max))), the sum in f32 over the bf16
//                e, p = bf16(e * bf16(1 / sum)); exp even under kExp2, as
//                in the TPU kernel.
// Every option is an `if constexpr`: a branch that is not uniform across a
// warpgroup before a wgmma would serialize them all (C7520).
//
// Design. A work item is one (image, head): 64 query rows a tile, T
// rounded up to 64 (4 tiles at T = 196, 197; 2 at T = 77). Persistent blocks
// of 3 warpgroups, one an SM, walk the items (blockIdx.x, + gridDim.x, ...)
// in an order given by the caller: image by image (ImageMajor, B1 and B4),
// or the TPU pair grid's (PairGrid, V1 and V3: image blocks of block_b, head
// pairs, then within one (block, pair) its two heads' images; a ragged
// last block stops at B, nothing is padded, and block_b changes only which
// items run side by side). The blocks take single (image, head) items in
// turn, not the TPU's (block, pair) items of 2 block_b: 192 of those (1024
// images at block_b 16, 3 pairs) on 132 SMs would run 64 items on some SMs
// against 47 on average.
// Thread 0 loads each item's boxes by TMA from one 3-D tensor map of the
// packed tensor (dims 3C channels, T rows, B images; a box is 64 channels =
// 128 bytes wide, swizzled in 128-byte rows): K and V, 16 NS rows each, and
// Q, T rounded up to 64 rows; rows past T arrive as zeros. Two stages: the
// next item's boxes are in flight while the warpgroups work on this one, and
// a stage is refilled once all 12 warps have released it (one mbarrier
// pair a stage). Each item's K and V are read once for all its query tiles.
// The tiles of successive items are dealt to the warpgroups in turn, so
// that 4 tiles an item keep 3 warpgroups equally busy. A warpgroup's tile:
// S = Q K^T as 4 wgmma m64n208k16 (m64n80k16 for T <= 80) with both
// operands in shared memory, the 64 x 16 NS scores in registers (104 f32 a
// thread, the m16n8 accumulator layout: row 16 w + lane / 4 (+ 8), key
// 8 n + 2 (lane % 4) (+ 1)); the exact softmax over the row (max and sum
// reduced across the quad of lanes that holds a row; padded keys and, under
// the causal mask, keys past the row get -inf, so e = 0, as the contract's
// finfo(f32).min gives); P packed to bf16 A fragments in registers; O = P V
// as 13 (or 5) wgmma m64n64k16 with V read MN-major from shared memory;
// rows < T stored from registers. Every key step is computed for every tile
// and every warp computes its rows' softmax, rows past T included: a
// branch that differs between the warps of a warpgroup before a wgmma makes
// ptxas serialize every wgmma (warning C7520).
//
// What bounds it on the H100: at the towers' training shapes ((256, 196,
// 1152) H=6, (128, 197, 2304) H=12) a call moves ~154 MB (qkv in, out) and
// does ~15 GFLOP: the bytes bound it (0.046 ms at 3.35 TB/s, 0.015 ms of
// tensor time); at the microbench's ((1024, 196, 1152) H=6, (512, 197, 2304)
// H=12) ~617 MB and ~61 GFLOP (0.184 ms). The time goes to the softmax's
// scalar work (~6 instructions a score, on 256 rows for 196) and the
// latency between each tile's two products, with 12 warps an SM (168
// registers a thread).

#pragma once

#include "sm90.cuh"  // mbarriers, TMA, wgmma descriptors and fences, the launch's set-up

#include <cuda_bf16.h>
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace attn90 {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 64;
constexpr int kQueryTile = 64;             // query rows of a warpgroup's tile (wgmma's M)
constexpr int kWarpgroups = 3;             // of a block, one block an SM
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kShortSteps = 5;             // 16-key steps held for T <= 80
constexpr int kMaxSteps = 13;              // ... for T <= 208
constexpr float kLog2eScale = 0.125f * 1.4426950408889634f;  // 64^-1/2 log2(e)
constexpr float kLog2e = 1.4426950408889634f;

// V3's options, the bits of FLAGS (see the header); 0 is B1's contract
enum Flags : int { kExp2 = 1, kMxuSum = 2, kNoMax = 4, kBf16Softmax = 8 };

// 16-key steps a call's registers hold, and its shared memory: two stages of
// K and V boxes (16 NS rows of 128 bytes) and a Q box (64-row tiles), 1024-
// byte aligned for the 128-byte swizzle, and four mbarriers
__host__ __device__ constexpr int key_steps(int seq) {
  return (seq + 15) / 16 <= kShortSteps ? kShortSteps : kMaxSteps;
}
__host__ __device__ constexpr uint32_t kv_box_bytes(int ns) { return ns * 16 * 128; }
__host__ __device__ constexpr int q_box_rows(int ns) {
  return (16 * ns + kQueryTile - 1) / kQueryTile * kQueryTile;
}
__host__ __device__ constexpr uint32_t stage_bytes(int ns) {
  return 2 * kv_box_bytes(ns) + q_box_rows(ns) * 128;
}
inline size_t smem_bytes(int seq) {
  return 1024 + 2 * stage_bytes(key_steps(seq)) + 4 * sizeof(uint64_t);
}

__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the two bf16 of a pack() as f32, exactly
__device__ __forceinline__ float lo_of(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_of(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// a * b on bf16 pairs, each product rounded once to bf16 (= the f32
// product of two bf16, exact, rounded to bf16)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- wgmma shapes of the tile ------------------------------------------------

// O (64 x 64) += P (registers) V: V from shared memory, MN-major (trans-b)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// S (64 x 16 NS keys) += Q K^T, both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 "
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n208(float (&d)[104], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103 "
      "}, %104, %105, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}


// --- the tile ----------------------------------------------------------------

// The softmax of a thread's two score rows, in place. s[j][e] is the score
// of key 16 j + 8 (e / 4) + 2 t + (e & 1) of row r_lo for e % 4 < 2, else
// r_hi; keys at or past lim_lo / lim_hi get -inf (only the key steps that
// cross a limit are tested). Leaves e in s and returns each row's 1 / sum e
// (bf16(1 / sum e) under kBf16Softmax). Under kMxuSum and kBf16Softmax,
// whose e is rounded to bf16, each pair e (e + 1) is rounded by one pack()
// and left packed in s[j][e] (its bits; s[j][e + 1] is dead), the rounded
// values summed from the pack. The max and the sum of a row run
// as four independent chains (one per n8 tile half and e & 1), so that they
// do not wait on one another.
template <int NS, int FLAGS>
__device__ __forceinline__ void softmax_rows(float (&s)[NS][8], int t, int lim_lo, int lim_hi,
                                             float& inv_lo, float& inv_hi) {
  constexpr bool kMxu = FLAGS & kMxuSum;
  constexpr bool kBfs = !kMxu && (FLAGS & kBf16Softmax);
  constexpr bool kMax = !(kMxu && (FLAGS & kNoMax));
  // s is raw q.k, or q.k log2(e) / 8 under kExp2 (q scaled in the tile)
  constexpr float kExpScale = (FLAGS & kExp2) ? 1.f : kLog2eScale;   // to the exponent of 2
  constexpr float kScoreScale = (FLAGS & kExp2) ? 1.f : 0.125f;      // to the contract's s
  constexpr int kChains = 4;
  const int lim_min = min(lim_lo, lim_hi);
  float m[2][kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) m[0][c] = m[1][c] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const bool edge = 16 * j + 16 > lim_min;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int hi = (e >> 1) & 1, c = (e & 1) | ((e >> 2) << 1);
      float x = s[j][e];
      if (edge && 16 * j + 8 * (e >> 2) + 2 * t + (e & 1) >= (hi ? lim_hi : lim_lo)) x = -INFINITY;
      s[j][e] = x;
      if constexpr (kMax) m[hi][c] = fmaxf(m[hi][c], x);
    }
  }
  float mc[2] = {0.f, 0.f};  // the max, in the units the exponent subtracts it in
  if constexpr (kMax) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = m[r][0];
#pragma unroll
      for (int c = 1; c < kChains; ++c) v = fmaxf(v, m[r][c]);
      mc[r] = quad_max(v) * (kBfs ? kScoreScale : kExpScale);
    }
  }
  float l[2][kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) l[0][c] = l[1][c] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if constexpr (kMxu || kBfs) {
#pragma unroll
      for (int e = 0; e < 8; e += 2) {  // a pair of one row: keys e, e + 1
        const int hi = (e >> 1) & 1, c = (e >> 2) << 1;
        float e0, e1;
        if constexpr (kBfs) {  // exp(bf16(s - max))
          const uint32_t d = pack(fmaf(s[j][e], kScoreScale, -mc[hi]),
                                  fmaf(s[j][e + 1], kScoreScale, -mc[hi]));
          e0 = ex2(lo_of(d) * kLog2e);
          e1 = ex2(hi_of(d) * kLog2e);
        } else {
          e0 = ex2(fmaf(s[j][e], kExpScale, -mc[hi]));
          e1 = ex2(fmaf(s[j][e + 1], kExpScale, -mc[hi]));
        }
        const uint32_t ev = pack(e0, e1);  // bf16(e)
        s[j][e] = __uint_as_float(ev);
        l[hi][c] += lo_of(ev);
        l[hi][c | 1] += hi_of(ev);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int hi = (e >> 1) & 1, c = (e & 1) | ((e >> 2) << 1);
        const float ev = ex2(fmaf(s[j][e], kExpScale, -mc[hi]));
        s[j][e] = ev;
        l[hi][c] += ev;
      }
    }
  }
  float sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = l[r][0];
#pragma unroll
    for (int c = 1; c < kChains; ++c) v += l[r][c];
    sum[r] = quad_sum(v);
  }
  inv_lo = 1.f / sum[0];  // p = e * (1 / l)
  inv_hi = 1.f / sum[1];
  if constexpr (kBfs) {
    inv_lo = rb(inv_lo);
    inv_hi = rb(inv_hi);
  }
}

// kExp2's q <- bf16(q * bf16(log2(e) / 8)) over one warpgroup's 64-row tile
// of the Q box (8 KB at shared address `tile`), in place, on bf16 pairs (one
// rounding of the exact product, as the f32 product rounded to bf16). The
// factor is the same for every element, so the pass ignores the 128-byte
// swizzle and walks the bytes linearly, 16 a thread a step. The writes are
// generic-proxy and the tile's wgmma reads async-proxy: every thread fences
// its writes to the async proxy and the warpgroup meets at its named
// barrier before any of its warps issues the first wgmma (without both, a
// wgmma may read q unscaled).
__device__ __forceinline__ void scale_q_tile(uint32_t tile) {
  const float c = rb(kLog2eScale);
  const uint32_t c2 = pack(c, c);
  const uint32_t tid = threadIdx.x & 127;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t at = tile + (k * 128 + tid) * 16;
    uint32_t w[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "r"(at));
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = mul_bf16x2(w[i], c2);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(at), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]) : "memory");
  }
  fence_proxy_async();
  bar_sync(1 + (threadIdx.x >> 7), 128);
}

// One warpgroup's tile: query rows q0 .. q0 + 63 of the item whose Q, K and
// V boxes sit at q_addr, k_addr, v_addr; writes rows < seq of its head's
// columns `col` of `out_img` (T, C).
template <int NS, int FLAGS>
__device__ __forceinline__ void tile64(bf16* __restrict__ out_img, int seq, int C, int col,
                                       int q0, int causal, uint32_t q_addr, uint32_t k_addr,
                                       uint32_t v_addr) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r_lo = q0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2), r_hi = r_lo + 8;

  float s[NS][8];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) s[j][e] = 0.f;
  float (&sf)[NS * 8] = *reinterpret_cast<float(*)[NS * 8]>(&s[0][0]);
  if constexpr ((FLAGS & kExp2) != 0) scale_q_tile(q_addr + q0 * 128);
  wg_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {  // 16 channels a step: 32 bytes into the swizzled rows
    const uint64_t dq = sw128_desc(q_addr + q0 * 128 + kc * 32, 16, 1024);
    const uint64_t dk = sw128_desc(k_addr + kc * 32, 16, 1024);
    if constexpr (NS == kMaxSteps) wgmma_ss_n208(sf, dq, dk);
    else wgmma_ss_n80(sf, dq, dk);
  }
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) pin(s[j][e]);

  constexpr bool kMxu = FLAGS & kMxuSum;
  constexpr bool kBfs = !kMxu && (FLAGS & kBf16Softmax);
  float inv_lo, inv_hi;
  softmax_rows<NS, FLAGS>(s, t, causal ? min(seq, r_lo + 1) : seq,
                          causal ? min(seq, r_hi + 1) : seq, inv_lo, inv_hi);
  uint32_t pa[NS][4];  // P of key step j as the m16k16 A fragment
  if constexpr (kMxu || kBfs) {  // e is packed in s[j][even]
    // P = e under kMxuSum (the sum divides O), else bf16(e * bf16(1 / sum))
    const uint32_t f_lo = pack(inv_lo, inv_lo), f_hi = pack(inv_hi, inv_hi);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t ev = __float_as_uint(s[j][2 * k]);
        pa[j][k] = kMxu ? ev : mul_bf16x2(ev, (k & 1) ? f_hi : f_lo);
      }
  } else {  // P = e * (1 / sum)
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      pa[j][0] = pack(s[j][0] * inv_lo, s[j][1] * inv_lo);
      pa[j][1] = pack(s[j][2] * inv_hi, s[j][3] * inv_hi);
      pa[j][2] = pack(s[j][4] * inv_lo, s[j][5] * inv_lo);
      pa[j][3] = pack(s[j][6] * inv_hi, s[j][7] * inv_hi);
    }
  }

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  wg_fence();
#pragma unroll
  for (int j = 0; j < NS; ++j)  // 16 keys a step: 16 rows of 128 bytes into V
    wgmma_pv(o, pa[j], sw128_desc(v_addr + j * 16 * 128, 1024, 1024));
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int i = 0; i < 32; ++i) pin(o[i]);
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pin(pa[j][e]);
  if constexpr (kMxu) {  // out = O * (1 / sum of the rounded e)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? inv_hi : inv_lo;
  }

  bf16* o_lo = out_img + static_cast<size_t>(r_lo) * C + col;
  bf16* o_hi = out_img + static_cast<size_t>(r_hi) * C + col;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {  // o[4 nt + e]: channels 8 nt + 2 t (+ 1)
    const int c = nt * 8 + 2 * t;
    if (r_lo < seq)
      *reinterpret_cast<__nv_bfloat162*>(o_lo + c) = __floats2bfloat162_rn(o[4 * nt], o[4 * nt + 1]);
    if (r_hi < seq)
      *reinterpret_cast<__nv_bfloat162*>(o_hi + c) =
          __floats2bfloat162_rn(o[4 * nt + 2], o[4 * nt + 3]);
  }
}

// --- the order of the items ----------------------------------------------------

// Item w as (image b, head h): image by image (B1, B4)
struct ImageMajor {
  __device__ __forceinline__ void operator()(int w, int /*B*/, int H, int& b, int& h) const {
    b = w / H;
    h = w - b * H;
  }
};

// The TPU pair grid's order (V1, V3): image blocks of block_b, each block's
// head pairs, and within one (block, pair) its first head's images, then
// its second's. The last block holds B mod block_b images where that is
// not 0: its items stop at B.
struct PairGrid {
  int block_b;
  __device__ __forceinline__ void operator()(int w, int B, int H, int& b, int& h) const {
    const int blk = w / (block_b * H);  // every block before the last is full
    const int nb = min(block_b, B - blk * block_b);
    const int r = w - blk * block_b * H;  // < nb H
    const int pair = r / (2 * nb), q = r - pair * 2 * nb;
    const int second = q >= nb;
    b = blk * block_b + q - second * nb;
    h = 2 * pair + second;
  }
};

// `v`, hidden from the optimizer. V1 and V3 pass their causal flag, 0,
// through it: as a constant it lets the compiler hoist every tile's key
// masks out of the item loop into registers, which then spill at 168.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// The work of one persistent block (see the design above). map_kv's box is
// 16 NS rows, map_q's q_box_rows(NS); `smem` is smem_bytes(seq) long.
template <int NS, int FLAGS = 0, typename Order = ImageMajor>
__device__ __forceinline__ void attention_block(const CUtensorMap* map_kv, const CUtensorMap* map_q,
                                                bf16* __restrict__ out, int B, int seq, int C,
                                                int H, int causal, unsigned char* smem,
                                                Order order = {}) {
  constexpr uint32_t box = kv_box_bytes(NS);
  constexpr uint32_t stage = stage_bytes(NS);
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;  // stage st: K, V, Q at base + st * stage
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (base - raw) + 2 * stage);
  uint64_t* empty = full + 2;
  const int items = B * H;
  auto load = [&](int w, int st) {  // item w's K, V and Q into stage st
    mbar_expect_tx(&full[st], stage);
    int b, h;
    order(w, B, H, b, h);
    const uint32_t at = base + st * stage;
    tma_load_3d(at, map_kv, &full[st], C + h * kHeadDim, 0, b);
    tma_load_3d(at + box, map_kv, &full[st], 2 * C + h * kHeadDim, 0, b);
    tma_load_3d(at + 2 * box, map_q, &full[st], h * kHeadDim, 0, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init(&empty[0], kThreads / 32);
    mbar_init(&empty[1], kThreads / 32);
    mbar_init_fence();
    if (static_cast<int>(blockIdx.x) < items) load(blockIdx.x, 0);
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int tiles = (seq + kQueryTile - 1) / kQueryTile;
  int i = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x, ++i) {
    const int st = i & 1;
    if (threadIdx.x == 0 && w + static_cast<int>(gridDim.x) < items) {
      if (i >= 1) mbar_wait(&empty[st ^ 1], ((i - 1) >> 1) & 1);  // item i - 1 released it
      load(w + gridDim.x, st ^ 1);
    }
    mbar_wait(&full[st], (i >> 1) & 1);
    int b, h;
    order(w, B, H, b, h);
    const uint32_t at = base + st * stage;
    // the block's tiles in sequence, tile k to warpgroup k % kWarpgroups: a
    // function of the item counter, which ptxas can see is uniform
    for (int qt = (wg + kWarpgroups - (i * tiles) % kWarpgroups) % kWarpgroups; qt < tiles;
         qt += kWarpgroups)
      tile64<NS, FLAGS>(out + static_cast<size_t>(b) * seq * C, seq, C, h * kHeadDim,
                        qt * kQueryTile, causal, at + 2 * box, at, at + box);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
}

// --- the launch ----------------------------------------------------------------

// The packed qkv as a 3-D tensor map: dims (3C channels, T rows, B images),
// a box of 64 channels x `rows` rows x 1 image, 128-byte swizzle; rows past
// T read as zeros. TMA needs a 16-byte aligned base and row stride (the
// wrapper checks the base; 3C bf16 is a multiple of 384 bytes).
inline int make_qkv_map(CUtensorMap* map, const void* qkv, int B, int seq, int C, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(3 * C), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(3 * C) * sizeof(bf16),
                                 static_cast<cuuint64_t>(seq) * 3 * C * sizeof(bf16)};
  const cuuint32_t box[3] = {kHeadDim, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError;
}

// Launches `short_kernel` (NS = kShortSteps, T <= 80) or `long_kernel`
// (kMaxSteps), __global__ wrappers of attention_block whose arguments are
// (map_kv, map_q, out, B, seq, C, H, args...), on `stream`: one block an SM,
// or one an item where there are fewer. Returns the first error (0 on
// success; kTensorMapError for a refused tensor map). The caller checks the
// domain: bf16, C = 64 H, 1 <= T <= 208, 16-byte aligned qkv.
template <typename Kernel, typename... Args>
inline int launch(Kernel short_kernel, Kernel long_kernel, const void* qkv, void* out, int B,
                  int seq, int C, int H, cudaStream_t stream, Args... args) {
  const int ns = key_steps(seq);
  const Kernel kernel = ns == kShortSteps ? short_kernel : long_kernel;
  CUtensorMap map_kv, map_q;
  if (int rc = make_qkv_map(&map_kv, qkv, B, seq, C, 16 * ns)) return rc;
  if (int rc = make_qkv_map(&map_q, qkv, B, seq, C, q_box_rows(ns))) return rc;
  const size_t smem = smem_bytes(seq);
  int sms = 0;
  const cudaError_t err =
      prepare_launch(reinterpret_cast<const void*>(kernel), static_cast<int>(smem), &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<std::min(B * H, sms), kThreads, smem, stream>>>(map_kv, map_q, static_cast<bf16*>(out),
                                                           B, seq, C, H, args...);
  return static_cast<int>(cudaGetLastError());
}

// The registers a thread and the local memory a thread (where spills land;
// 0 without) of the kernel that `launch` runs for `seq` rows. Returns the
// error of cudaFuncGetAttributes (0 on success).
template <typename Kernel>
inline int kernel_attributes(Kernel short_kernel, Kernel long_kernel, int seq, int* regs,
                             int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, reinterpret_cast<const void*>(key_steps(seq) == kShortSteps ? short_kernel
                                                                      : long_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // namespace attn90
