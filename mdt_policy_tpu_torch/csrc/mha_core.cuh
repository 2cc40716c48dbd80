// Multi-head attention over the packed (B, T, 3C) qkv projection: the body of
// kernel B1 (fused_qkv_attention.cu), shared with the attention half-block
// (attention_halfblock.cu), which runs it between its two projections.
//
// Contract, identical to the Pallas TPU kernel
// mdt_policy_tpu/ops/fused_qkv_attention.py (_kernel / _kernel_pair):
//   qkv (B, T, 3C) row-major, laid out [q | k | v] along the channel axis,
//   each C wide with n_heads interleaved head slices of dh = C / n_heads.
//   out (B, T, C): per head, f32 scores q.k * dh^-0.5, optional causal mask,
//   f32 max-subtracted softmax, probabilities rounded to the input dtype,
//   P.V accumulated in f32 and rounded to the input dtype, written at the
//   head's column slice. Inputs and output are float32 or bfloat16.
//
// Design (correct and simple first): one block per (query tile, head, image).
// The block copies its head's K and V rows out of the strided packed tensor
// (row stride 3C; K at column C + h*dh, V at 2C + h*dh) into dynamic shared
// memory, rows padded so that lanes reading different keys hit different
// banks. Each warp then walks its query rows: it keeps the q row and the
// row's scores in its own shared scratch, computes the scores one key per
// lane, reduces max and sum with shuffles, and accumulates P.V one output
// channel per lane. The grid covers B exactly: no padding of a ragged batch.
//
// What bounds it on the H100: at the replan's batch (B = 2 images, 6 heads,
// 4 query tiles = 48 blocks) the card is mostly idle and the time is launch
// and latency. At training batch it does CUDA-core FMAs only; its operational
// intensity (~2*T*dh FLOPs per 2*dh*2 bytes of K/V per query) stays far below
// the ~295 FLOP/byte bf16 ridge, but the work is done on FP32 units, not the
// tensor cores. So bf16 calls with 64-wide heads (every tower call) run the
// wgmma body fed by TMA in attention_sm90.cuh instead; this body serves f32
// and the other head widths.
//
// A translation unit defines its own __global__ entry around mha_block (so
// that each library's kernel keeps its own name in a profile) and launches it
// with launch_mha.

#pragma once

#include "sm90.cuh"  // prepare_launch

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cmath>
#include <cstddef>

namespace mha {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kQueryTile = kWarps * kRowsPerWarp;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row padding in elements: makes the K row stride an odd number of 32-bit
// words, so the 32 lanes of a warp (one key each) read 32 different banks.
template <typename T> __host__ __device__ constexpr int row_pad() { return sizeof(T) == 2 ? 2 : 1; }

template <typename T>
__host__ __device__ size_t kv_bytes(int seq, int dh) {
  size_t b = 2 * static_cast<size_t>(seq) * (dh + row_pad<T>()) * sizeof(T);
  return (b + 15) & ~static_cast<size_t>(15);
}

template <typename T>
size_t smem_bytes(int seq, int dh) {
  return kv_bytes<T>(seq, dh) + static_cast<size_t>(kWarps) * (dh + seq) * sizeof(float);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The work of one block: query tile blockIdx.x, head blockIdx.y, image
// blockIdx.z. `smem` is the block's dynamic shared memory, smem_bytes<T> long.
template <typename T>
__device__ __forceinline__ void mha_block(const T* __restrict__ qkv, T* __restrict__ out,
                                          int seq, int C, int dh, float scale, int causal,
                                          unsigned char* smem) {
  const int ks = dh + row_pad<T>();
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + static_cast<size_t>(seq) * ks;
  float* scratch = reinterpret_cast<float*>(smem + kv_bytes<T>(seq, dh));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* q_w = scratch + static_cast<size_t>(warp) * (dh + seq);  // this warp's q row
  float* p_w = q_w + dh;                                          // its scores / probs

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kQueryTile;
  const size_t row = 3 * static_cast<size_t>(C);
  const T* img = qkv + static_cast<size_t>(b) * seq * row;

  // causal: no query of this tile reads a key past the tile's last row
  const int n_keys = causal ? min(seq, q0 + kQueryTile) : seq;
  for (int idx = threadIdx.x; idx < n_keys * dh; idx += blockDim.x) {
    const int j = idx / dh;
    const int d = idx - j * dh;
    const T* r = img + j * row + h * dh + d;
    k_s[j * ks + d] = r[C];
    v_s[j * ks + d] = r[2 * C];
  }
  __syncthreads();

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = q0 + warp * kRowsPerWarp + rr;
    if (i >= seq) break;
    const T* q = img + i * row + h * dh;
    for (int d = lane; d < dh; d += 32) q_w[d] = to_f32(q[d]);
    __syncwarp();

    const int kend = causal ? i + 1 : seq;  // masked keys get probability 0
    float m = -FLT_MAX;
    for (int j = lane; j < kend; j += 32) {
      const T* kr = k_s + j * ks;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(q_w[d], to_f32(kr[d]), s);
      s *= scale;
      p_w[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < kend; j += 32) {
      const float e = expf(p_w[j] - m);
      p_w[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < kend; j += 32) {
      p_w[j] = to_f32(from_f32<T>(p_w[j] / l));  // probs in the input dtype
    }
    __syncwarp();

    T* o = out + (static_cast<size_t>(b) * seq + i) * C + h * dh;
    for (int d = lane; d < dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < kend; ++j) acc = fmaf(p_w[j], to_f32(v_s[j * ks + d]), acc);
      o[d] = from_f32<T>(acc);
    }
    __syncwarp();
  }
}

// Launches `kernel` (a __global__ wrapper of mha_block<T>) over the whole
// batch on `stream`; returns cudaGetLastError() (0 on success).
template <typename T>
int launch_mha(void (*kernel)(const T*, T*, int, int, int, float, int),
               const void* qkv, void* out, int B, int seq, int C, int H, int causal,
               cudaStream_t stream) {
  const int dh = C / H;
  const size_t smem = smem_bytes<T>(seq, dh);
  int sms = 0;
  const cudaError_t err =
      sm90::prepare_launch(reinterpret_cast<const void*>(kernel), static_cast<int>(smem), &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kQueryTile - 1) / kQueryTile, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), seq, C, dh,
      static_cast<float>(1.0 / sqrt(static_cast<double>(dh))), causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mha
