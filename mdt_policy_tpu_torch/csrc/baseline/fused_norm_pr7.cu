// Row LayerNorm and RMSNorm in one pass over device memory, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels mdt_policy_tpu/ops/fused_norm.py
// (fused_layer_norm: _ln_kernel; fused_rms_norm: _rms_kernel). Contract,
// identical to them:
//   x (rows, D) row-major, float32 or bfloat16; weights (D,) in the dtype of
//   x (cast to f32 here); out (rows, D) in the dtype of x. A caller with an
//   f32 master weight and a bf16 input casts the weight first, as the JAX
//   modules do.
//   LayerNorm: mean and variance of the row in f32, y = (x - mean) *
//   rsqrt(var + eps) * w + b in f32, rounded once to the output dtype.
//   RMSNorm:   n = max(||x||_2 * D^-1/2, eps) in f32, y = x / n * g in f32,
//   rounded once.
//
// Design (correct and simple first): one warp per row, kWarps rows per
// block. Each lane loads its share of the row with 16-byte vector loads
// (8 bf16 or 4 f32 values) into registers, VPL vectors per lane, so the row
// is read from device memory once and written once. The row sums are reduced
// with warp shuffles; the weights are read per row and stay in L1/L2. D must
// be a multiple of 8 (every site: 192, 384, 512, 768) and at most
// 32 * VPL_MAX vectors; ragged row counts need no padding (a warp past the
// last row returns).
//
// What bounds it on the H100: bytes. It moves 2 * rows * D * itemsize bytes
// and does ~5 flops per element, far below the ~295 flop/byte ridge, so its
// floor is the traffic over 3.35 TB/s (23 us for 50,176 rows of 384 in bf16).
// The design's answer is the single read and single write of each row; no
// shared memory, no second pass. At the replans' few hundred rows the
// kernel takes ~2 us and a call's cost is the host's launch: the wrapper
// keeps it light, and inside the replan's CUDA graph it costs nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kVplMax = 8;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N contiguous values, so one access is a vector load/store: 16 bytes is
// one ld.global.v4, 32 bytes two of them, 8 bytes one v2. Alignment is
// capped at 16 bytes, the widest access on sm_90, which the wrapper checks.
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  const Vec<T, N> r = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(r.v[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store_from_f32(T* p, const float* in) {
  Vec<T, N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Vec<T, N>*>(p) = r;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Elements per 16-byte vector of the input type.
template <typename T> __host__ __device__ constexpr int vec_elems() {
  return static_cast<int>(16 / sizeof(T));
}

template <typename T, int VPL, bool kRms>
__global__ void __launch_bounds__(kWarps * 32)
fused_norm_pr7_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
            T* __restrict__ out, long long rows, int D, float inv_sqrt_d, float eps) {
  constexpr int V = vec_elems<T>();
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const T* xr = x + row * D;
  T* orow = out + row * D;
  const int n_vec = D / V;

  float vals[VPL][V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    if (v < n_vec) {
      load_f32<T, V>(xr + v * V, vals[i]);
#pragma unroll
      for (int e = 0; e < V; ++e) sum += kRms ? vals[i][e] * vals[i][e] : vals[i][e];
    }
  }
  sum = warp_sum(sum);

  float mean = 0.f, scale;
  if constexpr (kRms) {
    // x / max(||x|| * D^-1/2, eps): the clamp keeps an all-zero row at 0
    scale = fmaxf(sqrtf(sum) * inv_sqrt_d, eps);
  } else {
    mean = sum / static_cast<float>(D);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (lane + 32 * i < n_vec) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float c = vals[i][e] - mean;
          sq += c * c;
        }
      }
    }
    scale = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
  }

#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    if (v < n_vec) {
      float wv[V], y[V];
      load_f32<T, V>(w + v * V, wv);
      if constexpr (kRms) {
#pragma unroll
        for (int e = 0; e < V; ++e) y[e] = vals[i][e] / scale * wv[e];
      } else {
        float bv[V];
        load_f32<T, V>(b + v * V, bv);
#pragma unroll
        for (int e = 0; e < V; ++e) y[e] = (vals[i][e] - mean) * scale * wv[e] + bv[e];
      }
      store_from_f32<T, V>(orow + v * V, y);
    }
  }
}

template <typename T, bool kRms>
int launch_typed(const void* x, const void* w, const void* b, void* out, long long rows,
                 int D, float eps, cudaStream_t stream) {
  constexpr int V = vec_elems<T>();
  const int n_vec = D / V;
  const int vpl = (n_vec + 31) / 32;
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  // D^-1/2 rounded once from double, as the plain version's Python scalar
  const float inv_sqrt_d = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  if (vpl <= 1) {
    fused_norm_pr7_kernel<T, 1, kRms><<<grid, block, 0, stream>>>(xp, wp, bp, op, rows, D, inv_sqrt_d, eps);
  } else if (vpl <= 2) {
    fused_norm_pr7_kernel<T, 2, kRms><<<grid, block, 0, stream>>>(xp, wp, bp, op, rows, D, inv_sqrt_d, eps);
  } else if (vpl <= 4) {
    fused_norm_pr7_kernel<T, 4, kRms><<<grid, block, 0, stream>>>(xp, wp, bp, op, rows, D, inv_sqrt_d, eps);
  } else if (vpl <= kVplMax) {
    fused_norm_pr7_kernel<T, kVplMax, kRms><<<grid, block, 0, stream>>>(xp, wp, bp, op, rows, D, inv_sqrt_d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool kRms>
int launch(const void* x, const void* w, const void* b, void* out, long long rows, int D,
           float eps, int is_bf16, void* stream) {
  if (rows <= 0) return 0;
  // the grid's x limit, and the 16-byte vector accesses
  if ((rows + kWarps - 1) / kWarps >= (1LL << 31) || !aligned16(x) || !aligned16(w) ||
      (!kRms && !aligned16(b)) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_typed<__nv_bfloat16, kRms>(x, w, b, out, rows, D, eps, s)
                 : launch_typed<float, kRms>(x, w, b, out, rows, D, eps, s);
}

}  // namespace

extern "C" {

// Largest row width the kernel takes for an input of this itemsize.
int mdt_fused_norm_max_width(int is_bf16) {
  return 32 * kVplMax * (is_bf16 ? vec_elems<__nv_bfloat16>() : vec_elems<float>());
}

// Launch on `stream`; return cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for more rows than the grid holds or a pointer that
// is not 16-byte aligned.
int mdt_fused_layer_norm(const void* x, const void* w, const void* b, void* out,
                         long long rows, int D, float eps, int is_bf16, void* stream) {
  return launch<false>(x, w, b, out, rows, D, eps, is_bf16, stream);
}

int mdt_fused_rms_norm(const void* x, const void* g, void* out, long long rows, int D,
                       float eps, int is_bf16, void* stream) {
  return launch<true>(x, g, nullptr, out, rows, D, eps, is_bf16, stream);
}

}  // extern "C"
