// The tile GEMM of the half-block kernels (attention_halfblock.cu, B4, and
// mlp_halfblock.cu, B5), for Hopper (sm_90a), bf16 in and out:
//
//     out (M, n_out) = epilogue( prologue(A) (M, K) . W^T )
//
// A is row-major (M, K); W is a torch Linear weight, row-major (n_w, K), so
// both operands are K-contiguous, the layout mma.sync's row.col form takes.
//
//   prologue  kPlain  A as it is
//             kRms    x / bf16(max(||x||_2 * K^-1/2, eps)), rounded to bf16,
//                     then * g, rounded (mdt_policy_tpu/ops/attention_halfblock.py
//                     _norm, norm="rms")
//             kLn     bf16((x - mean) * rsqrt(var + eps)) * g + b, each step
//                     rounded to bf16, statistics in f32 (_norm, norm="ln")
//   epilogue  kBias      bf16(bf16(acc) + bias)                       (qkv)
//             kQuickGelu h = bf16(bf16(acc) + bias); h * sigmoid(1.702 h)
//             kSwiGlu    W holds 2 * n_out rows, [proj | gate]: proj column j
//                        and gate column n_out + j meet in one thread;
//                        proj * (gate * sigmoid(gate))
//             kResidual  res + [gamma *] bf16(bf16(acc) + bias)  (projection
//                        back onto the residual stream)
// Every elementwise step is taken in f32 on bf16 values and rounded to bf16,
// the rounding points of the plain PyTorch versions in ops/attention_halfblock.py
// and ops/mlp_halfblock.py; the products accumulate in f32.
//
// Design (correct and simple first): a 128 x 128 output tile per block of 8
// warps (2 x 4, 64 x 32 each), the K loop in steps of 32 through a 3-stage
// cp.async ring in shared memory (rows padded to 40 elements so that ldmatrix
// reads hit 8 different bank groups), ldmatrix.x4 fragments and
// mma.sync.m16n8k16 bf16 -> f32. Rows past M are zero-filled on load and not
// stored. The normalizing prologue takes each row's statistics in a first
// pass over the block's 128 rows (one f32 divisor, or mean and rstd, per row
// in shared memory) and normalizes each A tile in shared memory once it has
// arrived, before the fragments are read. No atomics and no split K: every
// run sums in the same order, so a recomputed row is bit-identical.
//
// What bounds it on the H100: at the towers' shapes (K = 384..3072, N up to
// 3072, M = 9856..25088 rows) the products are above the bf16 ridge, so the
// bound is the tensor cores. mma.sync reaches a fraction of what wgmma would;
// a later change moves the main loop to wgmma fed by TMA with a producer warp.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace hbgemm {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;        // rows of A per block
constexpr int kBN = 128;        // rows of W per block
constexpr int kBK = 32;         // depth of one pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kLds = kBK + 8;   // padded shared-memory row, in elements

enum Prologue : int { kPlain = 0, kRms = 1, kLn = 2 };
enum Epilogue : int { kBias = 0, kQuickGelu = 1, kSwiGlu = 2, kResidual = 3 };

struct Args {
  const bf16* a;      // (M, K)
  const bf16* w;      // (n_w, K), n_w = n_out, or 2 * n_out for kSwiGlu
  const bf16* bias;   // (n_w,)
  const bf16* g;      // (K,) norm gain                     [kRms, kLn]
  const bf16* b;      // (K,) norm bias, or nullptr          [kLn]
  const bf16* res;    // (M, n_out) residual stream          [kResidual]
  const bf16* gamma;  // (n_out,) LayerScale, or nullptr     [kResidual]
  bf16* out;          // (M, n_out)
  int M, K, n_out;
  float eps;          // norm clamp (kRms) or variance epsilon (kLn)
  float norm_scale;   // K^-1/2 (kRms)
};

// Output columns of one block: a kSwiGlu block reads 64 proj and 64 gate rows.
template <int EPI> __host__ __device__ constexpr int out_cols() {
  return EPI == kSwiGlu ? kBN / 2 : kBN;
}

inline size_t smem_bytes() {
  return static_cast<size_t>(kStages) * (kBM + kBN) * kLds * sizeof(bf16)
         + 2 * kBM * sizeof(float);
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// First row, within the block's W tile, of warp column `wn`'s n8 block `ni`.
// kSwiGlu: blocks 0-1 are proj rows, 2-3 the gate rows of the same columns.
template <int EPI> __device__ __forceinline__ int w_tile_row(int wn, int ni) {
  if (EPI == kSwiGlu) return ni < 2 ? wn * 16 + ni * 8 : kBN / 2 + wn * 16 + (ni - 2) * 8;
  return wn * 32 + ni * 8;
}

template <int PRO, int EPI>
__global__ void __launch_bounds__(kThreads)
halfblock_gemm_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);                            // kStages x kBM x kLds
  bf16* sw = sa + kStages * kBM * kLds;                                // kStages x kBN x kLds
  float* stat0 = reinterpret_cast<float*>(sw + kStages * kBN * kLds);  // per row: divisor or mean
  float* stat1 = stat0 + kBM;                                          // per row: rstd

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * out_cols<EPI>();
  const int M = p.M, K = p.K;
  const int ktiles = K / kBK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    bf16* a_s = sa + stage * kBM * kLds;
    bf16* w_s = sw + stage * kBN * kLds;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * kThreads;  // 512 chunks: row q / 4, 16 bytes (q % 4)
      const int r = q >> 2, c = (q & 3) * 8;
      const bool ok = m0 + r < M;
      cp_async16(a_s + r * kLds + c, p.a + static_cast<size_t>(ok ? m0 + r : 0) * K + k0 + c, ok);
      const int wr = EPI == kSwiGlu && r >= kBN / 2 ? p.n_out + n0 + r - kBN / 2 : n0 + r;
      cp_async16(w_s + r * kLds + c, p.w + static_cast<size_t>(wr) * K + k0 + c, true);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }

  if (PRO != kPlain) {  // row statistics, while the first stages load
    for (int r = warp; r < kBM; r += kThreads / 32) {
      float s0 = 1.f, s1 = 0.f;  // rows past M: harmless values, never stored
      if (m0 + r < M) {
        const bf16* row = p.a + static_cast<size_t>(m0 + r) * K;
        float sum = 0.f;
        for (int k = lane * 8; k < K; k += 256) {
          const uint4 v = *reinterpret_cast<const uint4*>(row + k);
          const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j) sum += PRO == kRms ? bf(e[j]) * bf(e[j]) : bf(e[j]);
        }
        sum = warp_sum(sum);
        if (PRO == kRms) {
          s0 = rb(fmaxf(sqrtf(sum) * p.norm_scale, p.eps));  // the divisor, in bf16
        } else {
          const float mean = sum / K;
          float sq = 0.f;
          for (int k = lane * 8; k < K; k += 256) {
            const uint4 v = *reinterpret_cast<const uint4*>(row + k);
            const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float d = bf(e[j]) - mean;
              sq += d * d;
            }
          }
          s0 = mean;
          s1 = rsqrtf(warp_sum(sq) / K + p.eps);
        }
      }
      if (lane == 0) {
        stat0[r] = s0;
        stat1[r] = s1;
      }
    }
  }

  // normalize the A tile of `stage` in place (after it has arrived)
  auto normalize_stage = [&](int stage, int kt) {
    bf16* a_s = sa + stage * kBM * kLds;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * kThreads;
      const int r = q >> 2, c = (q & 3) * 8;
      const int k = kt * kBK + c;
      uint4 v = *reinterpret_cast<uint4*>(a_s + r * kLds + c);
      const uint4 gv = __ldg(reinterpret_cast<const uint4*>(p.g + k));
      uint4 bv = make_uint4(0, 0, 0, 0);
      if (PRO == kLn && p.b != nullptr) bv = __ldg(reinterpret_cast<const uint4*>(p.b + k));
      bf16* e = reinterpret_cast<bf16*>(&v);
      const bf16* ge = reinterpret_cast<const bf16*>(&gv);
      const bf16* be = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float y;
        if (PRO == kRms) {
          y = rb(rb(__fdiv_rn(bf(e[j]), stat0[r])) * bf(ge[j]));
        } else {
          y = rb(rb((bf(e[j]) - stat0[r]) * stat1[r]) * bf(ge[j]));
          if (p.b != nullptr) y = rb(y + bf(be[j]));
        }
        e[j] = __float2bfloat16(y);
      }
      *reinterpret_cast<uint4*>(a_s + r * kLds + c) = v;
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has arrived for every thread; stage kt-1 is free
    const int nk = kt + kStages - 1;
    if (nk < ktiles) load_stage(nk % kStages, nk);
    cp_async_commit();
    const int stage = kt % kStages;
    if (PRO != kPlain) {
      normalize_stage(stage, kt);
      __syncthreads();
    }
    const bf16* a_s = sa + stage * kBM * kLds;
    const bf16* w_s = sw + stage * kBN * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], a_s + (wm * 64 + mi * 16 + (lane & 15)) * kLds + kk + (lane >> 4) * 8);
      uint32_t bfr[4][2];
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        uint32_t r4[4];
        const int nb = w_tile_row<EPI>(wn, 2 * pr);  // 16 contiguous W rows
        ldmatrix_x4(r4, w_s + (nb + (lane & 7) + ((lane >> 4) << 3)) * kLds + kk
                            + ((lane >> 3) & 1) * 8);
        bfr[2 * pr][0] = r4[0];
        bfr[2 * pr][1] = r4[1];
        bfr[2 * pr + 1][0] = r4[2];
        bfr[2 * pr + 1][1] = r4[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: thread holds columns 2t, 2t+1 of rows g and g + 8 of each m16n8 tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= M) continue;
      bf16* orow = p.out + static_cast<size_t>(row) * p.n_out;
#pragma unroll
      for (int ni = 0; ni < (EPI == kSwiGlu ? 2 : 4); ++ni) {
        const int col = n0 + (EPI == kSwiGlu ? wn * 16 : wn * 32) + ni * 8 + 2 * t;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = rb(rb(acc[mi][ni][half * 2 + e]) + bf(p.bias[col + e]));
          if (EPI == kSwiGlu) {
            const float gate = rb(rb(acc[mi][ni + 2][half * 2 + e]) + bf(p.bias[p.n_out + col + e]));
            y[e] = a * rb(gate * rb(sigmoid(gate)));
          } else if (EPI == kQuickGelu) {
            y[e] = a * rb(sigmoid(rb(1.702f * a)));
          } else if (EPI == kResidual) {
            const float v = p.gamma != nullptr ? rb(a * bf(p.gamma[col + e])) : a;
            y[e] = bf(p.res[static_cast<size_t>(row) * p.n_out + col + e]) + v;
          } else {
            y[e] = a;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(y[0], y[1]);
      }
    }
  }
}

// Launches one GEMM on `stream`; returns cudaGetLastError() (0 on success).
// The caller guarantees K % kBK == 0 and n_out % out_cols<EPI>() == 0.
template <int PRO, int EPI>
int launch_gemm(const Args& p, cudaStream_t stream) {
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(halfblock_gemm_kernel<PRO, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_out / out_cols<EPI>(), (p.M + kBM - 1) / kBM);
  halfblock_gemm_kernel<PRO, EPI><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// kRms or kLn prologue, chosen at run time
template <int EPI>
int launch_norm_gemm(const Args& p, int norm_is_ln, cudaStream_t stream) {
  return norm_is_ln ? launch_gemm<kLn, EPI>(p, stream) : launch_gemm<kRms, EPI>(p, stream);
}

inline float inv_sqrt(int k) { return static_cast<float>(1.0 / std::sqrt(static_cast<double>(k))); }

}  // namespace hbgemm
