// The norm pass and the tile GEMM of the half-block kernels B4
// (ops/attention_halfblock.py) and B5 (ops/mlp_halfblock.py), for Hopper
// (sm_90a), bf16 in and out. A half-block call runs
//
//     xn  (M, C)     = halfblock_norm(x)                      once a row
//     out (M, n_out) = epilogue( A (M, K) . W^T )             halfblock_gemm
//
// (B5: norm, W1 GEMM, W2 GEMM; B4: norm, qkv GEMM, attention core, projection
// GEMM), from the same stream, one scratch tensor between each two.
//
//   halfblock_norm  kRms  x / bf16(max(||x||_2 * C^-1/2, eps)), rounded to
//                         bf16, then * g, rounded (the _norm of
//                         mdt_policy_tpu/ops/attention_halfblock.py, "rms")
//                   kLn   bf16((x - mean) * rsqrt(var + eps)) * g + b, each
//                         step rounded to bf16, statistics in f32 ("ln")
//   epilogue  kBias      bf16(bf16(acc) + bias)                        (qkv)
//             kQuickGelu h = bf16(bf16(acc) + bias); h * sigmoid(1.702 h)
//             kSwiGlu    W holds 2 * n_out rows, [proj | gate]: proj column j
//                        and gate column n_out + j meet in one thread;
//                        proj * (gate * sigmoid(gate))
//             kResidual  res + [gamma *] bf16(bf16(acc) + bias)  (projection
//                        back onto the residual stream)
// Every elementwise step is taken in f32 on bf16 values and rounded to bf16,
// the rounding points of the plain versions (ops/halfblock_gemm.py); the
// products accumulate in f32. A is row-major (M, K); W is a torch Linear
// weight, row-major (n_w, K): both K-contiguous.
//
// The norm: one warp a row, the row held in registers as 16-byte vectors
// (C <= 1024), written once as bf16, so that the GEMM reads a plain A.
//
// The GEMM: persistent blocks, one an SM, walk the 128 x 128 output tiles
// (128 rows of A by 128 rows of W; a kSwiGlu tile holds 64 proj and the 64
// gate rows of the same hidden columns, so it writes 64 columns), column
// blocks fastest, so that the blocks in flight share their rows of A in L2.
// Warpgroup 0 gives up its registers (setmaxnreg) and one of its threads
// keeps a ring of 5 stages full by TMA: each stage an A box (64 deep, 128
// rows) and two W boxes (64 rows each), 128-byte swizzled, with a full and
// an empty mbarrier; it runs ahead across tiles. Warpgroups 1 and 2 take
// the block's tiles in turn (ping-pong): each runs a whole tile's main loop
// (8 wgmma m64n128k16 a stage, both operands from shared memory, 128 f32
// accumulators a thread) while the other runs its epilogue, handing over
// at named barriers, and releases each stage once the wgmmas after it are
// issued. The epilogue rounds the accumulators to bf16 into a padded
// shared tile, 64 rows at a time, and applies the epilogue along rows, 16
// bytes a thread (bias, gamma, residual and output as 16-byte vectors; the
// residual rows prefetched into L2 at the tile's start). Nothing before a
// wgmma branches differently between the warps of a warpgroup (ptxas would
// serialize every wgmma, warning C7520). No atomics and no split K: a rerun
// is bit-identical.
//
// What bounds it on the H100: at the towers' shapes (M = 9,856..39,424
// rows, K = 384..3,072, N = 384..3,072) the GEMMs are above the bf16 ridge:
// the tensor cores; the norm pass moves 4 * M * C bytes.

#include "sm90.cuh"

#include <cuda_bf16.h>
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kBM = 128;                 // rows of A a tile
constexpr int kBN = 128;                 // rows of W a tile, wgmma's N
constexpr int kBK = 64;                  // depth of a stage: one 128-byte swizzled row
constexpr int kStages = 5;
constexpr int kConsumers = 2;            // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kPitch = kBN + 8;          // staged epilogue row, elements: no bank conflicts
constexpr uint32_t kABytes = kBM * kBK * 2;
constexpr uint32_t kWBytes = kBN * kBK * 2;
constexpr uint32_t kStageBytes = kABytes + kWBytes;
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kConsumers * 64 * kPitch * 2
                           + 2 * kStages * 8;
constexpr int kNormRows = 8;             // rows of a norm block, a warp each
constexpr int kNormVecs = 4;             // 16-byte vectors a lane holds: C <= 1024

enum Epilogue : int { kBias = 0, kQuickGelu = 1, kSwiGlu = 2, kResidual = 3 };

struct Args {
  const bf16* bias;   // (n_w,)
  const bf16* res;    // (M, n_out) residual stream          [kResidual]
  const bf16* gamma;  // (n_out,) LayerScale, or nullptr     [kResidual]
  bf16* out;          // (M, n_out)
  int M, K, n_out;
};

// output columns of a tile
template <int EPI> __host__ __device__ constexpr int out_cols() {
  return EPI == kSwiGlu ? kBN / 2 : kBN;
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16(v)); }
// 1 / (1 + e^-v) from ex2.approx and a fast reciprocal: a few f32 ulps from
// 1.f / (1.f + expf(-v)), well below the bf16 rounding that follows, at a
// fifth of the instructions (the IEEE division and expf dominated the
// activation epilogues)
__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// --- the norm -------------------------------------------------------------------

template <bool LN>
__global__ void __launch_bounds__(kNormRows * 32)
halfblock_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                      const bf16* __restrict__ b, bf16* __restrict__ out, int M, int C,
                      float eps, float scale) {
  const int row = blockIdx.x * kNormRows + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + static_cast<size_t>(row) * C;
  uint4 v[kNormVecs];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kNormVecs; ++j) {  // lane's vectors j: elements 8 (lane + 32 j) ..
    const int k = (lane + 32 * j) * 8;
    if (k < C) {
      v[j] = *reinterpret_cast<const uint4*>(xr + k);
      const bf16* e = reinterpret_cast<const bf16*>(&v[j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += LN ? bf(e[i]) : bf(e[i]) * bf(e[i]);
    }
  }
  sum = warp_sum(sum);
  float s0, s1 = 0.f;  // RMS: the bf16 divisor; LN: mean and rstd
  if (LN) {
    s0 = sum / C;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kNormVecs; ++j) {
      if ((lane + 32 * j) * 8 < C) {
        const bf16* e = reinterpret_cast<const bf16*>(&v[j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = bf(e[i]) - s0;
          sq += d * d;
        }
      }
    }
    s1 = rsqrtf(warp_sum(sq) / C + eps);
  } else {
    s0 = rb(fmaxf(sqrtf(sum) * scale, eps));
  }
  bf16* orow = out + static_cast<size_t>(row) * C;
#pragma unroll
  for (int j = 0; j < kNormVecs; ++j) {
    const int k = (lane + 32 * j) * 8;
    if (k < C) {
      const uint4 gv = __ldg(reinterpret_cast<const uint4*>(g + k));
      uint4 bv = make_uint4(0, 0, 0, 0);
      if (LN && b != nullptr) bv = __ldg(reinterpret_cast<const uint4*>(b + k));
      bf16* e = reinterpret_cast<bf16*>(&v[j]);
      const bf16* ge = reinterpret_cast<const bf16*>(&gv);
      const bf16* be = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float y;
        if (LN) {
          y = rb(rb((bf(e[i]) - s0) * s1) * bf(ge[i]));
          if (b != nullptr) y = rb(y + bf(be[i]));
        } else {
          y = rb(rb(__fdiv_rn(bf(e[i]), s0)) * bf(ge[i]));
        }
        e[i] = __float2bfloat16(y);
      }
      *reinterpret_cast<uint4*>(orow + k) = v[j];
    }
  }
}

// --- the GEMM -------------------------------------------------------------------

// D (64 x 128) += A (64 x 16) B^T, both from shared memory, K-major
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The epilogue of one consumer warpgroup's 64 x 128 accumulator tile: rows
// row0 .. row0 + 63, output columns col0 .. col0 + out_cols - 1. `st` is
// the warpgroup's staged tile (64 x kPitch), `tid` the thread within the
// warpgroup.
template <int EPI>
__device__ __forceinline__ void epilogue(const Args& p, const float (&acc)[64], bf16* st,
                                         int row0, int col0, int tid, int bar_id) {
  // acc[4 i + e]: row 16 warp + lane / 4 (+ 8 for e >= 2), column 8 i + 2 (lane % 4) + e % 2
  const int r = 16 * (tid >> 5) + ((tid & 31) >> 2), c = 2 * (tid & 3);
  bar_sync(bar_id, 128);  // the previous tile's reads of `st` are done
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    *reinterpret_cast<__nv_bfloat162*>(st + r * kPitch + 8 * i + c) =
        __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<__nv_bfloat162*>(st + (r + 8) * kPitch + 8 * i + c) =
        __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
  }
  bar_sync(bar_id, 128);
  constexpr int kChunks = out_cols<EPI>() / 8;  // 16-byte chunks of an output row
#pragma unroll  // a fixed count, so that every iteration's loads are issued together
  for (int i = 0; i < 64 * kChunks / 128; ++i) {
    const int q = tid + 128 * i, rr = q / kChunks, c8 = (q % kChunks) * 8;
    const int row = min(row0 + rr, p.M - 1), col = col0 + c8;  // rows past M: not stored
    const uint4 av = *reinterpret_cast<const uint4*>(st + rr * kPitch + c8);
    const uint4 bv = __ldg(reinterpret_cast<const uint4*>(p.bias + col));
    uint4 gv = av, gbv = bv, rv = av, yv;
    if (EPI == kSwiGlu) {
      gv = *reinterpret_cast<const uint4*>(st + rr * kPitch + kBN / 2 + c8);
      gbv = __ldg(reinterpret_cast<const uint4*>(p.bias + p.n_out + col));
    }
    if (EPI == kResidual) {
      rv = __ldg(reinterpret_cast<const uint4*>(p.res + static_cast<size_t>(row) * p.n_out + col));
      if (p.gamma != nullptr) gbv = __ldg(reinterpret_cast<const uint4*>(p.gamma + col));
    }
    // A sum or product of two bf16 values rounded to bf16 is the same
    // whether taken in f32 and rounded or on bf16 pairs: a product is exact
    // in f32, and so is a sum unless the exponents differ by more than 15,
    // where the smaller is far below half an ulp of the larger and both
    // round to the larger. So those steps run on pairs; the sigmoid and the
    // 1.702 scaling run in f32.
    using bf2 = __nv_bfloat162;
    const bf2* a = reinterpret_cast<const bf2*>(&av);
    const bf2* b = reinterpret_cast<const bf2*>(&bv);
    const bf2* ga = reinterpret_cast<const bf2*>(&gv);
    const bf2* gb = reinterpret_cast<const bf2*>(&gbv);
    const bf2* rs = reinterpret_cast<const bf2*>(&rv);
    bf2* y = reinterpret_cast<bf2*>(&yv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bf2 h = __hadd2(a[j], b[j]);
      if (EPI == kQuickGelu) {
        const float2 hf = __bfloat1622float2(h);
        y[j] = __hmul2(h, __floats2bfloat162_rn(sigmoid(rb(1.702f * hf.x)),
                                                sigmoid(rb(1.702f * hf.y))));
      } else if (EPI == kSwiGlu) {
        const bf2 gate = __hadd2(ga[j], gb[j]);
        const float2 gf = __bfloat1622float2(gate);
        y[j] = __hmul2(h, __hmul2(gate, __floats2bfloat162_rn(sigmoid(gf.x), sigmoid(gf.y))));
      } else if (EPI == kResidual) {
        y[j] = __hadd2(rs[j], p.gamma != nullptr ? __hmul2(h, gb[j]) : h);
      } else {
        y[j] = h;
      }
    }
    if (row0 + rr < p.M)
      *reinterpret_cast<uint4*>(p.out + static_cast<size_t>(row0 + rr) * p.n_out + col) = yv;
  }
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
halfblock_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_w, const Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;  // stage s: A, then W, at base + s * kStageBytes
  bf16* staged = reinterpret_cast<bf16*>(smem + (base - raw) + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + kConsumers * 64 * kPitch);
  uint64_t* empty = full + kStages;
  const int n_tiles = p.n_out / out_cols<EPI>();
  const int tiles = (p.M + kBM - 1) / kBM * n_tiles;
  const int ksteps = p.K / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each warp of the consuming warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {  // the producer
    regs_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles * kBM;
        const int w0 = t % n_tiles * out_cols<EPI>();
        const int w1 = EPI == kSwiGlu ? p.n_out + w0 : w0 + kBN / 2;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);  // its last reader released it
          const uint32_t at = base + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(at, &map_a, &full[s], ks * kBK, m0);
          tma_load_2d(at + kABytes, &map_w, &full[s], ks * kBK, w0);
          tma_load_2d(at + kABytes + kWBytes / 2, &map_w, &full[s], ks * kBK, w1);
        }
      }
    }
  } else {  // the consumers: warpgroup cw takes the block's tiles cw, cw + 2, ...
    regs_inc<232>();
    const int cw = wg - 1, tid = threadIdx.x & 127, lane = threadIdx.x & 31;
    bf16* st = staged + cw * 64 * kPitch;
    // The two take turns at the tensor cores: a warpgroup starts a tile's
    // main loop once the other has issued the previous tile's (named
    // barriers 3 and 4), so that one's epilogue overlaps the other's main
    // loop, and a stage is never awaited before the fill it waits for has
    // been issued (the parity of its mbarrier would not tell them apart).
    for (int i = cw; blockIdx.x + i * gridDim.x < tiles; i += kConsumers) {
      const int t = blockIdx.x + i * gridDim.x;
      const bool next = blockIdx.x + (i + 1) * gridDim.x < tiles;
      if (i > 0) bar_sync(4 - cw, 2 * 128);  // tile i - 1's main loop is issued
      float acc[2][64];  // rows 0-63 and 64-127 of the tile
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[h][j] = 0.f;
      if (EPI == kResidual) {  // the epilogue's residual rows into L2 while the main loop runs
        const bf16* r = p.res + static_cast<size_t>(min(t / n_tiles * kBM + tid, p.M - 1)) * p.n_out
                        + t % n_tiles * kBN;
        asm volatile("prefetch.global.L2 [%0];\n" :: "l"(r));
        asm volatile("prefetch.global.L2 [%0];\n" :: "l"(r + kBN / 2));
      }
      int it = i * ksteps;  // the ring position of this tile's first stage
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const uint32_t at = base + s * kStageBytes;
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < kBK / 16; ++kc) {  // 16 deep a step: 32 bytes into the swizzled rows
          const uint64_t dw = sw128_desc(at + kABytes + kc * 32, 16, 1024);
          wgmma_m64n128(acc[0], sw128_desc(at + kc * 32, 16, 1024), dw);
          wgmma_m64n128(acc[1], sw128_desc(at + 64 * 128 + kc * 32, 16, 1024), dw);
        }
        wg_commit();
        wg_wait<1>();  // the previous stage's wgmmas are done: release it
        if (ks > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
        }
      }
      if (next) bar_arrive(3 + cw, 2 * 128);  // the other warpgroup's turn
      wg_wait<0>();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 64; ++j) pin(acc[h][j]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      const int row0 = t / n_tiles * kBM, col0 = t % n_tiles * out_cols<EPI>();
      epilogue<EPI>(p, acc[0], st, row0, col0, tid, 1 + cw);
      epilogue<EPI>(p, acc[1], st, row0 + 64, col0, tid, 1 + cw);
    }
  }
}

template <bool LN>
int launch_norm(const void* x, const void* g, const void* b, void* out, int M, int C,
                float eps, cudaStream_t stream) {
  halfblock_norm_kernel<LN><<<(M + kNormRows - 1) / kNormRows, kNormRows * 32, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), M, C, eps,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(C))));
  return static_cast<int>(cudaGetLastError());
}

template <int EPI>
int launch_gemm(const void* a, const void* w, const Args& p, cudaStream_t stream) {
  const auto kernel = halfblock_gemm_kernel<EPI>;
  int sms = 0;
  const cudaError_t err = prepare_launch(reinterpret_cast<const void*>(kernel), kSmemBytes, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_a, map_w;
  if (int rc = make_rows_map(&map_a, a, p.M, p.K, kBM)) return rc;
  if (int rc = make_rows_map(&map_w, w, EPI == kSwiGlu ? 2 * p.n_out : p.n_out, p.K, kBN / 2))
    return rc;
  const int tiles = (p.M + kBM - 1) / kBM * (p.n_out / out_cols<EPI>());
  kernel<<<std::min(tiles, sms), kThreads, kSmemBytes, stream>>>(map_a, map_w, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// norm(x) (M, C) -> out (M, C) on `stream`; b may be null (LayerNorm only).
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// shape outside the kernel's domain (C a multiple of 8, at most 1024).
int mdt_halfblock_norm(const void* x, const void* g, const void* b, void* out, int M, int C,
                       int is_ln, float eps, void* stream) {
  if (M < 1 || C < 8 || C % 8 || C > kNormVecs * 32 * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_ln ? launch_norm<true>(x, g, b, out, M, C, eps, s)
               : launch_norm<false>(x, g, b, out, M, C, eps, s);
}

// out (M, n_out) = epilogue(a (M, K) . w^T) on `stream` (see the top of this
// file; w has 2 n_out rows for kSwiGlu; res and gamma for kResidual, gamma
// may be null). Returns cudaGetLastError() (0 on success), kTensorMapError
// (-1) for a refused tensor map, or cudaErrorInvalidValue for a shape
// outside the kernel's domain (K a multiple of 64, n_out of a tile's
// output columns). Every pointer is 16-byte aligned (the caller checks).
int mdt_halfblock_gemm(const void* a, const void* w, const void* bias, const void* res,
                       const void* gamma, void* out, int M, int K, int n_out, int epilogue,
                       void* stream) {
  const int cols = epilogue == kSwiGlu ? out_cols<kSwiGlu>() : out_cols<kBias>();
  if (M < 1 || K < kBK || K % kBK || n_out < cols || n_out % cols || epilogue < kBias ||
      epilogue > kResidual)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
               static_cast<const bf16*>(gamma), static_cast<bf16*>(out), M, K, n_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kBias: return launch_gemm<kBias>(a, w, p, s);
    case kQuickGelu: return launch_gemm<kQuickGelu>(a, w, p, s);
    case kSwiGlu: return launch_gemm<kSwiGlu>(a, w, p, s);
    default: return launch_gemm<kResidual>(a, w, p, s);
  }
}

}  // extern "C"
