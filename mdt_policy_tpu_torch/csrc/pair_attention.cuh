// Head-pair attention over the packed (B, T, 3C) qkv projection, on the
// tensor cores: the shared body of the B1 variants V1 (attn_pair_grid.cu) and
// V3 (attn_pair_v3.cu), for Hopper (sm_90a), bf16 in and out.
//
// Contract, identical to the Pallas TPU kernels tools/attn_kernel_experiment.py
// (make_pair_grid) and tools/attn_kernel_round3.py (make_pair_v3) of the JAX
// repository, and to pair_attention_reference in ops/pair_attention.py:
//   qkv (B, T, 3C) row-major, [q | k | v], C % 128 == 0, 64-wide heads;
//   out (B, T, C). Per head, f32 scores q.k; without options scaled by 1/8,
//   e = exp(s - max), p = bf16(e / sum e), out = bf16(f32 sum p.v). The
//   options (FLAGS, V3 only) move the rounding points:
//     kExp2        q <- bf16(q * bf16(log2(e) / 8)), no later scale, exp2;
//     kMxuSum      e = bf16(exp(s - max)), [acc | sum] = e . [v | 1] in one
//                  product, out = bf16(acc / sum); precedes kBf16Softmax;
//     kNoMax       (with kMxuSum) no max subtraction: unsafe, a probe;
//     kBf16Softmax e = bf16(exp(bf16(s - max))), sum in f32,
//                  p = bf16(e * bf16(1 / sum)); exp even under kExp2, as
//                  in the TPU kernel.
//
// Design (correct and simple first): one block of 4 warps per (64-row query
// tile, head pair, block of block_b images); the block walks its images. For
// each image it copies the pair's K and V slices (T rows of 128 channels at
// columns C + 128 p and 2C + 128 p, row stride 3C) into shared memory with
// cp.async, T padded to a multiple of 16 (at most 208) with zero rows, and
// rows padded to 136 elements so that the 8 rows of an ldmatrix hit 8
// different bank groups: 2 x 208 x 272 bytes = 110.5 KB, two blocks an SM.
// Each warp owns 16 query rows and, per head: loads its q fragments from
// global memory; S = Q K^T on mma.sync.m16n8k16 (bf16 -> f32) into 26 n8
// accumulator tiles, the whole score row in registers; an exact two-pass
// softmax over the row (max and sum shuffled across the 4 lanes of a quad;
// keys past T get -inf, so e = 0); then P V on mma.sync with the score
// accumulators repacked as the A fragments (the m16n8 C layout of two n8
// tiles is the m16k16 A layout) and V read by ldmatrix.trans. Under
// kMxuSum a ninth n8 tile with B = 1 in its first column gives the row sums
// of the rounded e from the same A fragments. A ragged batch is covered
// exactly (the last block stops at B); query rows past T are computed on
// zeros and not stored; warps whose rows all lie past T skip the work.
//
// What bounds it on the H100: at the microbench's shapes ((1024, 196, 1152)
// H=6 and (512, 197, 2304) H=12) a call moves ~617 MB (qkv in, out) and does
// ~61 GFLOP, so the bytes bound it (0.184 ms at 3.35 TB/s, against 0.062 ms
// of bf16 tensor-core time). This kernel reads K/V once per query tile (4
// times an image, from L2 after the first), waits for each image's copy
// before its products, and runs mma.sync at a fraction of wgmma's rate; the
// TMA-fed, double-buffered wgmma body of B1 is attention_sm90.cuh.

#pragma once

#include "sm90.cuh"  // smem_u32

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace pair {

using bf16 = __nv_bfloat16;
using sm90::smem_u32;

constexpr int kHeadDim = 64;
constexpr int kPairCols = 2 * kHeadDim;          // channels of one head pair
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQueryTile = kWarps * 16;          // 16 query rows a warp
constexpr int kMaxSeq = 208;
constexpr int kKeySteps = kMaxSeq / 16;          // k16 steps of P.V
constexpr int kLd = kPairCols + 8;               // padded shared row, elements

enum Flags : int { kExp2 = 1, kMxuSum = 2, kNoMax = 4, kBf16Softmax = 8 };

inline int padded_seq(int seq) { return (seq + 15) / 16 * 16; }
inline size_t smem_bytes(int seq) {
  return 2 * static_cast<size_t>(padded_seq(seq)) * kLd * sizeof(bf16);
}

__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16(v)); }

// 16-byte async copy; `valid` false zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 of q times the bf16 constant c, each product rounded to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float c) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack(f.x * c, f.y * c);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One warp, one head: query rows row0 .. row0 + 15 of image `img`, head
// channels `col` (of q; k and v sit C and 2C further), read from K/V in
// shared memory at column `hcol`; writes rows < seq of `out_img` (T, C).
template <int FLAGS>
__device__ __forceinline__ void head(const bf16* __restrict__ img, bf16* __restrict__ out_img,
                                     int seq, int C, int col, int hcol, int row0, int nsteps,
                                     const bf16* k_s, const bf16* v_s) {
  constexpr bool kMxu = FLAGS & kMxuSum;
  constexpr bool kE2 = FLAGS & kExp2;
  constexpr bool kBfs = !kMxu && (FLAGS & kBf16Softmax);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t rs = 3 * static_cast<size_t>(C);
  const int r_lo = row0 + g, r_hi = r_lo + 8;

  // q fragments of the m16k16 A layout, straight from global memory
  uint32_t qa[4][4];
  const bf16* q_lo = img + static_cast<size_t>(r_lo) * rs + col;
  const bf16* q_hi = img + static_cast<size_t>(r_hi) * rs + col;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int c = kc * 16 + 2 * t;
    qa[kc][0] = r_lo < seq ? __ldg(reinterpret_cast<const unsigned int*>(q_lo + c)) : 0u;
    qa[kc][1] = r_hi < seq ? __ldg(reinterpret_cast<const unsigned int*>(q_hi + c)) : 0u;
    qa[kc][2] = r_lo < seq ? __ldg(reinterpret_cast<const unsigned int*>(q_lo + c + 8)) : 0u;
    qa[kc][3] = r_hi < seq ? __ldg(reinterpret_cast<const unsigned int*>(q_hi + c + 8)) : 0u;
    if (kE2) {
      const float cq = rb(static_cast<float>(0.125 * 1.4426950408889634));
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[kc][e] = scale_pair(qa[kc][e], cq);
    }
  }

  // S = Q K^T: n8 tile n holds keys 8n .. 8n + 7
  float s[2 * kKeySteps][4];
#pragma unroll
  for (int j = 0; j < kKeySteps; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * j][e] = s[2 * j + 1][e] = 0.f;
    if (j < nsteps) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t r[4];
        ldmatrix_x4(r, k_s + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * kLd + hcol + kc * 16
                           + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j], qa[kc], r[0], r[1]);
        mma_bf16(s[2 * j + 1], qa[kc], r[2], r[3]);
      }
    }
  }

  // scale, mask the padded keys, row max (c0, c1: row g; c2, c3: row g + 8)
  const float scale = kE2 ? 1.f : 0.125f;
  float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
  for (int n = 0; n < 2 * kKeySteps; ++n) {
    if (n < 2 * nsteps) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = n * 8 + 2 * t + (e & 1) < seq ? s[n][e] * scale : -INFINITY;
        s[n][e] = x;
        if (e < 2) m_lo = fmaxf(m_lo, x); else m_hi = fmaxf(m_hi, x);
      }
    }
  }
  m_lo = quad_max(m_lo);
  m_hi = quad_max(m_hi);

  // e in place, and its f32 row sums (under kMxuSum the product takes them)
  float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
  for (int n = 0; n < 2 * kKeySteps; ++n) {
    if (n < 2 * nsteps) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float m = e < 2 ? m_lo : m_hi;
        float ev;
        if (kMxu) {
          const float d = (FLAGS & kNoMax) ? x : x - m;
          ev = rb(kE2 ? exp2f(d) : expf(d));
        } else if (kBfs) {
          ev = rb(expf(rb(x - m)));
        } else {
          ev = kE2 ? exp2f(x - m) : expf(x - m);
        }
        s[n][e] = ev;
        if (e < 2) l_lo += ev; else l_hi += ev;
      }
    }
  }
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  // what multiplies (kBfs) or divides (softmax) e into p
  const float f_lo = kBfs ? rb(1.f / l_lo) : l_lo;
  const float f_hi = kBfs ? rb(1.f / l_hi) : l_hi;
  auto prob = [&](float ev, bool hi) -> float {
    if (kMxu) return ev;
    if (kBfs) return ev * (hi ? f_hi : f_lo);
    return __fdiv_rn(ev, hi ? f_hi : f_lo);
  };

  // O = P V (+ the ones column under kMxuSum)
  float o[8][4];
  float osum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  const uint32_t ones = g == 0 ? 0x3F803F80u : 0u;  // B = 1 in column 0
#pragma unroll
  for (int j = 0; j < kKeySteps; ++j) {
    if (j < nsteps) {
      uint32_t a[4];
      a[0] = pack(prob(s[2 * j][0], false), prob(s[2 * j][1], false));
      a[1] = pack(prob(s[2 * j][2], true), prob(s[2 * j][3], true));
      a[2] = pack(prob(s[2 * j + 1][0], false), prob(s[2 * j + 1][1], false));
      a[3] = pack(prob(s[2 * j + 1][2], true), prob(s[2 * j + 1][3], true));
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, v_s + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + hcol
                                 + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], a, r[2], r[3]);
      }
      if (kMxu) mma_bf16(osum, a, ones, ones);
    }
  }

  float d_lo = 1.f, d_hi = 1.f;  // row sums of the rounded e, from lane 4g
  if (kMxu) {
    d_lo = __shfl_sync(0xffffffffu, osum[0], lane & ~3);
    d_hi = __shfl_sync(0xffffffffu, osum[2], lane & ~3);
  }
  bf16* o_lo = out_img + static_cast<size_t>(r_lo) * C + col;
  bf16* o_hi = out_img + static_cast<size_t>(r_hi) * C + col;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = kMxu ? __fdiv_rn(o[nt][e], e < 2 ? d_lo : d_hi) : o[nt][e];
    if (r_lo < seq) *reinterpret_cast<__nv_bfloat162*>(o_lo + c) = __floats2bfloat162_rn(y[0], y[1]);
    if (r_hi < seq) *reinterpret_cast<__nv_bfloat162*>(o_hi + c) = __floats2bfloat162_rn(y[2], y[3]);
  }
}

// The work of one block: query tile blockIdx.x, head pair blockIdx.y, images
// blockIdx.z * block_b .. min(B, (blockIdx.z + 1) * block_b) - 1. `smem` is
// the block's dynamic shared memory, smem_bytes(seq) long.
template <int FLAGS>
__device__ __forceinline__ void pair_block(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                                           int B, int seq, int C, int block_b,
                                           unsigned char* smem) {
  const int tp = (seq + 15) & ~15;
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + static_cast<size_t>(tp) * kLd;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kQueryTile + warp * 16;
  const int col0 = blockIdx.y * kPairCols;
  const size_t rs = 3 * static_cast<size_t>(C);
  const int b_end = min(B, static_cast<int>(blockIdx.z + 1) * block_b);
  for (int b = blockIdx.z * block_b; b < b_end; ++b) {
    const bf16* img = qkv + static_cast<size_t>(b) * seq * rs;
    __syncthreads();  // every warp is done with the previous image's K/V
    for (int i = threadIdx.x; i < tp * 16; i += kThreads) {  // 16 chunks of 16 bytes a row
      const int j = i >> 4, c = (i & 15) * 8;
      const bool ok = j < seq;  // rows past T are zero-filled
      const bf16* src = img + static_cast<size_t>(ok ? j : 0) * rs + col0 + c;
      cp_async16(k_s + j * kLd + c, src + C, ok);
      cp_async16(v_s + j * kLd + c, src + 2 * C, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (row0 < seq) {
      bf16* out_img = out + static_cast<size_t>(b) * seq * C;
#pragma unroll 1
      for (int h = 0; h < 2; ++h)
        head<FLAGS>(img, out_img, seq, C, col0 + h * kHeadDim, h * kHeadDim, row0, tp / 16,
                    k_s, v_s);
    }
  }
}

// Launches `kernel` (a __global__ wrapper of pair_block) over the whole batch
// on `stream`; returns cudaGetLastError() (0 on success). The caller checks
// seq <= kMaxSeq, C % kPairCols == 0 and the shared-memory budget.
inline int launch_pair(void (*kernel)(const bf16*, bf16*, int, int, int, int),
                       const void* qkv, void* out, int B, int seq, int C, int block_b,
                       cudaStream_t stream) {
  const size_t smem = smem_bytes(seq);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kQueryTile - 1) / kQueryTile, C / kPairCols,
                  (B + block_b - 1) / block_b);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
                                           B, seq, C, block_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pair
