// Self-attention over tiny sequences, for Hopper (sm_90a): kernel B2.
//
// Replaces the Pallas TPU kernel mdt_policy_tpu/ops/pallas_attention.py
// (small_seq_mha: _small_seq_mha_impl / _mha_kernel). Contract:
//   q, k, v (B, H, T, D), equal shapes and dtype (float32 or bfloat16), any
//   strides (the wrapper passes the transposed (B, T, H, D) views of the
//   denoiser's projections as they are, without a copy); T <= 32, D <= 128.
//   q is multiplied by D^-1/2 in its own dtype; scores q.k accumulate in f32;
//   with `causal`, key j is kept for query i when j <= i (masked scores are
//   finfo(f32).min, so their probability is exactly 0); f32 max-subtracted
//   softmax; probabilities rounded to v's dtype; P.V accumulated in f32 and
//   rounded to q's dtype.
//   out is written in (B, T, H, D) memory order, so the head merge that
//   follows (transpose(1, 2).reshape(B, T, H*D)) is free.
//
// Design (correct and simple first): one warp per (b, h) row, several rows
// per block, as many as fit 48 KB of shared memory (8 at the denoisers'
// T = 3..10, D = 48..64; 1 at T = 32, D = 128). The warp copies its row's K
// and V into shared memory as f32, rows padded to D + 1 so that the 32 lanes
// (one key each) read 32 different banks. Then for each query i: the lanes
// hold q_i (one channel per lane and 32-channel chunk) and broadcast it with
// shuffles; lane j forms the score of key j in a register; max and sum come
// from warp shuffles; the probability of key j stays on lane j, and P.V is
// accumulated with one output channel per lane, each p_j broadcast by a
// shuffle. Nothing is padded in device memory and nothing but the output is
// written.
//
// What bounds it on the H100: it reads q, k and v once and writes the output
// once, 4*B*H*T*D*itemsize bytes, against 4*B*H*T^2*D FLOPs (fewer when
// causal). At T = 10 that is T/itemsize = 2.5 FLOPs per byte in f32, far below
// the ridge of the f32 peak over HBM bandwidth (67e12 / 3.35e12 = 20), so the
// least time is the bytes over 3.35 TB/s: about 19 us at (1024, 8, 10, 48)
// f32. At the replan's B = 1 (8 rows: one block) the card is idle and the
// time is the launch. The design does what the bytes bound asks: one pass
// over the inputs, the scores and probabilities never leave registers, and
// the output is stored once in the layout its consumer reads. A later change
// can vectorise the loads (16 bytes a lane) and give a block more rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>

namespace {

constexpr int kMaxSeq = 32;
constexpr int kMaxDim = 128;
constexpr int kChunks = kMaxDim / 32;
constexpr int kMaxWarps = 8;
constexpr size_t kSmemBudget = 48 * 1024;  // no opt-in attribute needed below this

// element strides of q, k, v over (B, H, T, D)
struct Strides {
  long long q[4], k[4], v[4];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the value a T-typed tensor would hold
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_per_warp(int seq, int dim) {
  return 2 * static_cast<size_t>(seq) * (dim + 1) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
small_seq_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int rows,
                     int heads, int seq, int dim, Strides st, float scale,
                     int causal) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // whole warps only: no block-wide barrier follows
  const int b = row / heads, h = row - b * heads;
  const int ld = dim + 1;
  float* ks = smem + static_cast<size_t>(warp) * 2 * seq * ld;
  float* vs = ks + seq * ld;

  const T* qrow = q + b * st.q[0] + h * st.q[1];
  const T* krow = k + b * st.k[0] + h * st.k[1];
  const T* vrow = v + b * st.v[0] + h * st.v[1];
  for (int idx = lane; idx < seq * dim; idx += 32) {
    const int j = idx / dim, d = idx - j * dim;
    ks[j * ld + d] = to_f32(krow[j * st.k[2] + d * st.k[3]]);
    vs[j * ld + d] = to_f32(vrow[j * st.v[2] + d * st.v[3]]);
  }
  __syncwarp();

  const float scale_t = round_to<T>(scale);  // D^-1/2 in q's dtype
  const float* kj = ks + (lane < seq ? lane : seq - 1) * ld;  // lane j's key
  T* orow = out + (static_cast<long long>(b) * seq * heads + h) * dim;

  for (int i = 0; i < seq; ++i) {
    float qreg[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = c * 32 + lane;
      qreg[c] = d < dim ? round_to<T>(to_f32(qrow[i * st.q[2] + d * st.q[3]]) * scale_t)
                        : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c * 32 >= dim) break;
      const int width = min(32, dim - c * 32);
      for (int l = 0; l < width; ++l)
        s = fmaf(__shfl_sync(0xffffffffu, qreg[c], l), kj[c * 32 + l], s);
    }
    const bool keep = lane < seq && (!causal || lane <= i);
    const float m = warp_max(keep ? s : -FLT_MAX);
    const float e = keep ? expf(s - m) : 0.f;
    const float p = round_to<T>(e / warp_sum(e));

    float acc[kChunks] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < seq; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const float* vj = vs + j * ld;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = c * 32 + lane;
        if (d < dim) acc[c] = fmaf(pj, vj[d], acc[c]);
      }
    }
    T* o = orow + static_cast<long long>(i) * heads * dim;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = c * 32 + lane;
      if (d < dim) o[d] = from_f32<T>(acc[c]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H,
           int seq, int dim, const long long* strides, float scale, int causal,
           cudaStream_t stream) {
  if (B < 1 || H < 1 || seq < 1 || seq > kMaxSeq || dim < 1 || dim > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int a = 0; a < 4; ++a) {
    st.q[a] = strides[a];
    st.k[a] = strides[4 + a];
    st.v[a] = strides[8 + a];
  }
  const size_t per_warp = smem_per_warp(seq, dim);
  int warps = static_cast<int>(kSmemBudget / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const int rows = B * H;
  const int blocks = (rows + warps - 1) / warps;
  small_seq_mha_kernel<T><<<blocks, warps * 32, warps * per_warp, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), rows, H, seq, dim, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; `strides` holds the 12 element strides of q, k and v
// over (B, H, T, D). Returns cudaGetLastError() (0 on success).
int mdt_small_seq_mha(const void* q, const void* k, const void* v, void* out, int B,
                      int H, int seq, int dim, const long long* strides, float scale,
                      int causal, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, B, H, seq, dim, strides, scale,
                                         causal, s)
                 : launch<float>(q, k, v, out, B, H, seq, dim, strides, scale, causal, s);
}

}  // extern "C"
