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
// What bounds it on the H100: it reads q, k and v once and writes the output
// once, 4*B*H*T*D*itemsize bytes, against 4*B*H*T^2*D FLOPs (fewer when
// causal). At T = 10 that is T/itemsize = 2.5 FLOPs per byte in f32, far below
// the ridge of the f32 peak over HBM bandwidth (67e12 / 3.35e12 = 20), so the
// least time is the bytes over 3.35 TB/s: about 19 us at (1024, 8, 10, 48)
// f32. At the replan's B = 1 (8 rows) the bytes take nanoseconds and the time
// is latency: a launch, one round trip to device memory for the inputs, the
// dependent steps of one query's work, and the store.
//
// Design: one block per (b, h) row, one warp per query, so a row's queries
// run in parallel and the chain of dependent steps is one query's. Warp i
// loads token i of q, k and v (16-byte vectors where the last stride is 1
// and the rest are multiples of the vector, as in the denoiser's views;
// else element by element; lanes walk the channels, so no index is
// divided) and stores them to shared memory as f32, q scaled by D^-1/2 and
// rounded in q's dtype. K and V rows are padded to D + 1 floats, so that
// the 32 lanes (one key each) read 32 different banks; Q rows are 16-byte
// aligned and read as float4 broadcasts. After one barrier, lane j forms
// the score of key j with four independent partial sums (no shuffle per
// channel); max and sum take 5 shuffles each; P.V runs one output channel
// per lane, each p_j broadcast by a shuffle. Where B*H rows fill the card at
// least twice over, a block takes several short rows (T <= 4) so that
// blocks stay near 8 warps. No tensor cores: the contract is f32 scores and
// f32 P.V on tiles of at most 32 x 32, and TF32 would round both. Measured
// against the bytes bound at B*H in the thousands (3.9x at (1024, 8, 10,
// 48)): blocks that stayed resident and fetched the next row during this
// one's compute ran slower, at twice the registers and half the resident
// blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <atomic>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kMaxSeq = 32;
constexpr int kMaxDim = 128;
constexpr int kChunks = kMaxDim / 32;
constexpr int kTargetWarps = 8;
// two blocks for each of the H100's 132 SMs: below this, rows stay one a block
constexpr int kFillBlocks = 2 * 132;
constexpr int kMaxSmem = 96 * 1024;  // opted in once per kernel instance and device
constexpr int kMaxDevices = 64;

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

// N contiguous values of T: one 16-byte load
template <typename T, int N>
struct alignas(16) Vec {
  T v[N];
};

// Shared-memory row lengths in floats: Q rows a multiple of 4 (float4
// reads), K and V rows D + 1 (odd: lane j's key j lands in bank j's column).
// A (b, h) row's tiles take a multiple of 4 floats, so that the next row's
// Q tile starts on a 16-byte boundary too.
__host__ __device__ inline int q_ld(int dim) { return (dim + 3) & ~3; }
__host__ __device__ inline int kv_ld(int dim) { return dim + 1; }
__host__ __device__ inline int row_floats(int seq, int dim) {
  return (seq * (q_ld(dim) + 2 * kv_ld(dim)) + 3) & ~3;
}

// A lane's share of one token row of q, k or v, held in registers from its
// load from device memory until its store to shared memory as f32 (times
// `mul` rounded to T for q). The vector path (channels contiguous, 16-byte
// aligned rows) loads one 16-byte vector a lane: D <= 128 is at most 32 of
// them; the element path loads channels lane, lane + 32, ...
template <typename T, bool kVec> struct RowRegs;

template <typename T> struct RowRegs<T, true> {
  static constexpr int V = 16 / sizeof(T);
  Vec<T, V> x;
  __device__ __forceinline__ void load(const T* row, long long, int dim, int lane) {
    if (lane * V < dim) x = *reinterpret_cast<const Vec<T, V>*>(row + lane * V);
  }
  __device__ __forceinline__ void store(float* dst, int dim, int lane, bool scaled,
                                        float mul) const {
    if (lane * V >= dim) return;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float f = to_f32(x.v[e]);
      dst[lane * V + e] = scaled ? round_to<T>(f * mul) : f;
    }
  }
};

template <typename T> struct RowRegs<T, false> {
  T x[kChunks];
  __device__ __forceinline__ void load(const T* row, long long s3, int dim, int lane) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (lane + 32 * c < dim) x[c] = row[(lane + 32 * c) * s3];
  }
  __device__ __forceinline__ void store(float* dst, int dim, int lane, bool scaled,
                                        float mul) const {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (lane + 32 * c >= dim) break;
      const float f = to_f32(x[c]);
      dst[lane + 32 * c] = scaled ? round_to<T>(f * mul) : f;
    }
  }
};

// Query i of one (b, h) row from its staged tiles: scores, softmax, P.V,
// the output row written at `o`.
template <typename T>
__device__ __forceinline__ void attend(const float* qs, const float* ks, const float* vs,
                                       int seq, int dim, int i, int lane, int causal,
                                       T* __restrict__ o) {
  const int ldq = q_ld(dim), ldkv = kv_ld(dim);
  // score of key j = lane, four independent partial sums
  const float* kj = ks + (lane < seq ? lane : seq - 1) * ldkv;
  const float* qi = qs + i * ldq;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int d = 0;
  for (; d + 4 <= dim; d += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(qi + d);
    s0 = fmaf(qv.x, kj[d], s0);
    s1 = fmaf(qv.y, kj[d + 1], s1);
    s2 = fmaf(qv.z, kj[d + 2], s2);
    s3 = fmaf(qv.w, kj[d + 3], s3);
  }
  for (; d < dim; ++d) s0 = fmaf(qi[d], kj[d], s0);
  const float s = (s0 + s1) + (s2 + s3);

  const bool keep = lane < seq && (!causal || lane <= i);
  const float m = warp_max(keep ? s : -FLT_MAX);
  const float e = keep ? expf(s - m) : 0.f;
  const float p = round_to<T>(e / warp_sum(e));

  float acc[kChunks] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < seq; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
    const float* vj = vs + j * ldkv;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int dd = c * 32 + lane;
      if (dd < dim) acc[c] = fmaf(pj, vj[dd], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int dd = c * 32 + lane;
    if (dd < dim) o[dd] = from_f32<T>(acc[c]);
  }
}

// Block x takes rows x * rows_per_block + r (r < rows_per_block); warp i of
// a row stages token i of q, k and v, and after the barrier computes query i.
template <typename T, bool kVec>
__global__ void __launch_bounds__(1024)
small_seq_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int rows,
                     int heads, int seq, int dim, int rows_per_block, Strides st,
                     float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp / seq;           // once a warp: this warp's row in the block
  const int i = warp - r * seq;       // and its query
  const int row = blockIdx.x * rows_per_block + r;
  const bool active = row < rows;     // warp-uniform; every warp reaches the barrier
  const int b = active ? row / heads : 0, h = active ? row - b * heads : 0;
  float* qs = smem + static_cast<size_t>(r) * row_floats(seq, dim);
  float* ks = qs + seq * q_ld(dim);
  float* vs = ks + seq * kv_ld(dim);

  if (active) {
    RowRegs<T, kVec> rq, rk, rv;  // all three loads in flight before the stores
    rq.load(q + b * st.q[0] + h * st.q[1] + i * st.q[2], st.q[3], dim, lane);
    rk.load(k + b * st.k[0] + h * st.k[1] + i * st.k[2], st.k[3], dim, lane);
    rv.load(v + b * st.v[0] + h * st.v[1] + i * st.v[2], st.v[3], dim, lane);
    rq.store(qs + i * q_ld(dim), dim, lane, true, round_to<T>(scale));  // D^-1/2 in q's dtype
    rk.store(ks + i * kv_ld(dim), dim, lane, false, 0.f);
    rv.store(vs + i * kv_ld(dim), dim, lane, false, 0.f);
  }
  __syncthreads();
  if (!active) return;
  attend<T>(qs, ks, vs, seq, dim, i, lane, causal,
            out + ((static_cast<long long>(b) * seq + i) * heads + h) * dim);
}

// Whether every row and channel of x starts on a 16-byte boundary and its
// channels are contiguous: the vector staging path.
template <typename T>
bool vector_ok(const void* x, const long long* s, int dim) {
  constexpr int V = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && s[3] == 1 && dim % V == 0 &&
         s[0] % V == 0 && s[1] % V == 0 && s[2] % V == 0;
}

template <typename T, bool kVec>
int launch_typed(const T* q, const T* k, const T* v, T* out, int rows, int H, int seq,
                 int dim, const Strides& st, float scale, int causal, cudaStream_t stream) {
  const auto kernel = small_seq_mha_kernel<T, kVec>;
  // raise the shared-memory cap once per instance and device, at the first
  // launch there (and so before any capture into a CUDA graph)
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev].store(true, std::memory_order_release);
  }
  const size_t per_row = static_cast<size_t>(row_floats(seq, dim)) * sizeof(float);
  int rpb = seq < kTargetWarps ? kTargetWarps / seq : 1;
  while (rpb > 1 && ((rows + rpb - 1) / rpb < kFillBlocks || rpb * per_row > kMaxSmem))
    --rpb;
  const int blocks = (rows + rpb - 1) / rpb;
  kernel<<<blocks, rpb * seq * 32, rpb * per_row, stream>>>(
      q, k, v, out, rows, H, seq, dim, rpb, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int seq,
           int dim, const Strides& st, float scale, int causal, cudaStream_t stream) {
  if (B < 1 || H < 1 || seq < 1 || seq > kMaxSeq || dim < 1 || dim > kMaxDim ||
      static_cast<long long>(B) * H > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v);
  const bool vec = vector_ok<T>(q, st.q, dim) && vector_ok<T>(k, st.k, dim) &&
                   vector_ok<T>(v, st.v, dim);
  return vec ? launch_typed<T, true>(qp, kp, vp, static_cast<T*>(out), B * H, H, seq, dim,
                                     st, scale, causal, stream)
             : launch_typed<T, false>(qp, kp, vp, static_cast<T*>(out), B * H, H, seq, dim,
                                      st, scale, causal, stream);
}

}  // namespace

extern "C" {

// Launches on `stream`. `params` holds 18 int64: B, H, T, D, the 12 element
// strides of q, k and v over (B, H, T, D), causal, is_bf16 (one argument,
// so that the host's call converts few). Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape outside the kernel's domain.
int mdt_small_seq_mha(const void* q, const void* k, const void* v, void* out,
                      const long long* params, float scale, void* stream) {
  const long long* p = params;
  const Strides st = {{p[4], p[5], p[6], p[7]}, {p[8], p[9], p[10], p[11]},
                      {p[12], p[13], p[14], p[15]}};
  for (int a = 0; a < 4; ++a)
    if (p[a] < 1 || p[a] > (1LL << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  const int B = static_cast<int>(p[0]), H = static_cast<int>(p[1]),
            seq = static_cast<int>(p[2]), dim = static_cast<int>(p[3]);
  const int causal = static_cast<int>(p[16]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p[17] ? launch<__nv_bfloat16>(q, k, v, out, B, H, seq, dim, st, scale, causal, s)
               : launch<float>(q, k, v, out, B, H, seq, dim, st, scale, causal, s);
}

}  // extern "C"
