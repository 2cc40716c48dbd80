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
//   RMSNorm:   n = max(||x||_2 * D^-1/2, eps) in f32, y = x / n * g in f32
//   (as x * (1/n) * g, within an f32 ulp of it), rounded once.
//
// Design. A row is held in registers as 16-byte vectors (8 bf16 or 4 f32
// values), read from device memory once and written once. A group of LANES
// lanes takes a row, VPL vectors a lane (kLayouts), so that no lane idles
// wherever an exact split exists: bf16 384 is 16 lanes x 3 (two rows a
// warp), bf16 192 is 8 x 3 (four rows), bf16 768 and f32 384 are 32 x 3. A
// row's sums are reduced with xor shuffles within its lane group. Each warp
// takes one step of rows; a lane group past the last row reads a copy of
// it and stores nothing, so that no load is predicated.
//
// Few rows (at most one step for every warp of the card at 8 a block: the
// replans) are bound by latency: blocks of as few warps as put a block on
// every SM, and each lane loads its share of the weights into registers
// beside its rows, so that a row waits on one round trip to memory, not
// two. Many rows (the train steps) are bound by bytes: blocks of 8 warps, as
// many as the rows need (the hardware starts each as one ends), and no
// thread holds the weights while its rows are in flight, so that more warps
// and more bytes are in flight on an SM: the block copies the weights into
// shared memory by cp.async beside its rows, or, in bf16 LayerNorm, each
// lane loads its share after its row's statistics (kLateWeights). RMSNorm
// multiplies by one reciprocal a row.
//
// What bounds it on the H100: bytes. It moves 2 * rows * D * itemsize bytes
// and does ~5 flops an element, far below the ~295 flop/byte ridge, so its
// floor is the traffic over 3.35 TB/s (23 us for 50,176 rows of 384 in
// bf16). chip_smoke.py times a copy of the same rows beside it, the floor in
// practice; PERF.md has both. At a replan's 392 rows the floor is 0.2 us, and
// what is left is a launch and a round trip to memory, which a CUDA graph
// does not remove (it removes the host's launch only).
//
// Measured on the card and not kept (PERF.md): a persistent grid whose warps
// stride over the rows with the next step's loads in flight (a register
// double buffer), and a ring of row tiles in shared memory fed by 1-D bulk
// copies (cp.async.bulk and mbarriers), both slower at the steps' shapes
// than blocks the hardware schedules; a division an element in RMSNorm,
// slower at every shape.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <utility>

namespace {

constexpr int kWarps = 8;  // warps a block: at most, for few rows; always, for many
constexpr int kMaxDevices = 64;

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

// Elements per 16-byte vector of the input type.
template <typename T> __host__ __device__ constexpr int vec_elems() {
  return static_cast<int>(16 / sizeof(T));
}

// Element e of a 16-byte vector (one ld/st.global.v4; the wrapper checks
// the alignment) as f32
template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int e) {
  return to_f32(reinterpret_cast<const T*>(&r)[e]);
}

// (lanes a row, vectors a lane) of the instantiated kernels
struct Layout {
  int lanes, vpl;
};
constexpr Layout kLayouts[] = {{1, 1}, {2, 1}, {4, 1},  {8, 1},  {16, 1}, {1, 3},
                               {2, 3}, {4, 3}, {8, 3},  {16, 3}, {32, 1}, {32, 2},
                               {32, 3}, {32, 4}, {32, 6}, {32, 8}};
constexpr int kNumLayouts = sizeof(kLayouts) / sizeof(kLayouts[0]);
constexpr int kMaxVectors = 32 * 8;  // the widest layout's vectors a row

// The layout for rows of n_vec vectors: the fewest idle vector slots, then
// the most lanes (an exact split idles none); -1 past the widest.
int choose_layout(int n_vec) {
  int best = -1;
  for (int i = 0; i < kNumLayouts; ++i) {
    const int slots = kLayouts[i].lanes * kLayouts[i].vpl;
    if (slots < n_vec) continue;
    if (best < 0) { best = i; continue; }
    const int best_slots = kLayouts[best].lanes * kLayouts[best].vpl;
    if (slots < best_slots || (slots == best_slots && kLayouts[i].lanes > kLayouts[best].lanes))
      best = i;
  }
  return best;
}

// Sum over the LANES lanes of an aligned group; the whole warp takes part
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The lane's vectors of `row`. Past the last row a lane group reads the
// last row instead, and past the row's end (a split that is not exact) a
// lane reads the row's first vector: no load is predicated and no value
// masked, and what those slots hold is never summed or stored.
template <typename T, int LANES, int VPL>
__device__ __forceinline__ void load_row(uint4* r, const T* __restrict__ x, long long row,
                                         long long rows, int D, int sub, int n_vec) {
  constexpr int V = vec_elems<T>();
  const T* xr = x + (row < rows ? row : rows - 1) * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = sub + LANES * i;
    r[i] = *reinterpret_cast<const uint4*>(xr + (v < n_vec ? v : 0) * V);
  }
}

// 16 bytes from device memory into shared memory, asynchronously (cp.async:
// no register holds them, and the copies of a loop are all in flight at
// once); cp.async.wait_all then waits for the thread's copies
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

// The statistics of a row from the lane's share (vals; slots past the
// row's end left out), reduced over the row's lane group (every lane of
// the warp calls it): y = (x - mean) * scale [* w + b]
template <bool kRms, typename T, int LANES, int VPL>
__device__ __forceinline__ void row_stats(const float (&vals)[VPL][vec_elems<T>()], int sub,
                                          int n_vec, int D, float inv_sqrt_d, float eps,
                                          float* mean, float* scale) {
  constexpr int V = vec_elems<T>();
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (sub + LANES * i < n_vec) {
#pragma unroll
      for (int e = 0; e < V; ++e) sum += kRms ? vals[i][e] * vals[i][e] : vals[i][e];
    }
  }
  sum = group_sum<LANES>(sum);
  if constexpr (kRms) {
    // 1 / max(||x|| * D^-1/2, eps): the clamp keeps an all-zero row at 0.
    // One division a row; x * (1/n) is within an f32 ulp of x / n.
    *mean = 0.f;
    *scale = 1.f / fmaxf(sqrtf(sum) * inv_sqrt_d, eps);
  } else {
    *mean = sum / static_cast<float>(D);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (sub + LANES * i < n_vec) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float c = vals[i][e] - *mean;
          sq += c * c;
        }
      }
    }
    *scale = rsqrtf(group_sum<LANES>(sq) / static_cast<float>(D) + eps);
  }
}

// The weights of the lane's vector i, vector v of the row, as f32: the
// lane's own vectors in registers (LaneWeights), or the block's copy of the
// whole row in shared memory, converted to f32 once a block (BlockWeights)
template <bool kRms, typename T, int LANES, int VPL>
struct LaneWeights {
  uint4 w[VPL], b[VPL];

  __device__ __forceinline__ void load(const T* __restrict__ wp, const T* __restrict__ bp,
                                       int sub, int n_vec) {
    constexpr int V = vec_elems<T>();
#pragma unroll
    for (int i = 0; i < VPL; ++i) {  // past the row's end, vector 0 (never used), as load_row
      const int v = sub + LANES * i < n_vec ? sub + LANES * i : 0;
      w[i] = *reinterpret_cast<const uint4*>(wp + v * V);
      if constexpr (!kRms) b[i] = *reinterpret_cast<const uint4*>(bp + v * V);
    }
  }
  __device__ __forceinline__ void get(int i, int, float* g, float* bias) const {
#pragma unroll
    for (int e = 0; e < vec_elems<T>(); ++e) {
      g[e] = elem<T>(w[i], e);
      if constexpr (!kRms) bias[e] = elem<T>(b[i], e);
    }
  }
};

template <bool kRms, typename T>
struct BlockWeights {
  const uint4* w;
  const uint4* b;

  __device__ __forceinline__ void get(int, int v, float* g, float* bias) const {
    const uint4 wv = w[v];
    uint4 bv{};
    if constexpr (!kRms) bv = b[v];
#pragma unroll
    for (int e = 0; e < vec_elems<T>(); ++e) {
      g[e] = elem<T>(wv, e);
      if constexpr (!kRms) bias[e] = elem<T>(bv, e);
    }
  }
};

// The lane's share of a row, normalized, rounded once and stored
template <bool kRms, typename T, int LANES, int VPL, typename Weights>
__device__ __forceinline__ void store_row(T* __restrict__ orow,
                                          const float (&vals)[VPL][vec_elems<T>()],
                                          const Weights& weights, float mean, float scale,
                                          int sub, int n_vec) {
  constexpr int V = vec_elems<T>();
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = sub + LANES * i;
    if (v < n_vec) {
      float g[V], bias[V];
      weights.get(i, v, g, bias);
      uint4 y;
      T* ye = reinterpret_cast<T*>(&y);
#pragma unroll
      for (int e = 0; e < V; ++e)
        ye[e] = from_f32<T>(kRms ? vals[i][e] * scale * g[e]
                                 : (vals[i][e] - mean) * scale * g[e] + bias[e]);
      *reinterpret_cast<uint4*>(orow + v * V) = y;
    }
  }
}

// The lane's vectors as f32
template <typename T, int VPL>
__device__ __forceinline__ void row_to_f32(const uint4 (&raw)[VPL],
                                           float (&vals)[VPL][vec_elems<T>()]) {
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
#pragma unroll
    for (int e = 0; e < vec_elems<T>(); ++e) vals[i][e] = elem<T>(raw[i], e);
  }
}

// Where many rows load the weights: LayerNorm in bf16 reads both rows of
// weights late, after the row's statistics, from L1 into registers; the
// others stage them in shared memory. Measured on the H100 at the steps'
// shapes: staging costs bf16 LayerNorm (two weight rows, the most work a
// byte) more than its registers save, and saves the others time.
template <bool kRms, typename T>
constexpr bool kLateWeights = !kRms && sizeof(T) == 2;

// One step of rows a warp: 32 / LANES rows, a row to each group of LANES
// lanes. Few rows (the replans; not kMany): each lane loads its share of
// the weights into registers beside its rows, so that no row waits on a
// second round trip. Many rows (the steps; kMany): no thread holds the
// weights while its rows are in flight (fewer registers, more warps an SM,
// more bytes in flight): the block's threads copy them into shared memory
// beside their rows, or (kLateWeights) each lane loads its share after its
// row's statistics.
template <bool kRms, typename T, int LANES, int VPL, bool kMany>
__global__ void __launch_bounds__(kWarps * 32)
fused_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                  T* __restrict__ out, long long rows, int D, float inv_sqrt_d, float eps) {
  constexpr int kRowsPerWarp = 32 / LANES;
  const int lane = threadIdx.x & 31, sub = lane % LANES, n_vec = D / vec_elems<T>();
  const long long first =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5)) * kRowsPerWarp;
  const long long row = first + lane / LANES;
  uint4 raw[VPL];
  if constexpr (!kMany || kLateWeights<kRms, T>) {
    if (first >= rows) return;  // warp-uniform: every lane left reaches every shuffle
    LaneWeights<kRms, T, LANES, VPL> weights;
    load_row<T, LANES, VPL>(raw, x, row, rows, D, sub, n_vec);
    if constexpr (!kMany) weights.load(w, b, sub, n_vec);
    float vals[VPL][vec_elems<T>()], mean, scale;
    row_to_f32<T>(raw, vals);
    row_stats<kRms, T, LANES, VPL>(vals, sub, n_vec, D, inv_sqrt_d, eps, &mean, &scale);
    if constexpr (kMany) weights.load(w, b, sub, n_vec);
    if (row < rows)
      store_row<kRms, T, LANES, VPL>(out + row * D, vals, weights, mean, scale, sub, n_vec);
  } else {
    __shared__ uint4 staged[(kRms ? 1 : 2) * LANES * VPL];  // w, then b
    load_row<T, LANES, VPL>(raw, x, row, rows, D, sub, n_vec);
    for (int j = threadIdx.x; j < (kRms ? 1 : 2) * n_vec; j += blockDim.x) {
      if (j < n_vec)
        copy16_async(&staged[j], w + j * vec_elems<T>());
      else
        copy16_async(&staged[LANES * VPL + j - n_vec], b + (j - n_vec) * vec_elems<T>());
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // every thread's copies of the weights have landed
    // a warp past the last row has taken part in the copy; it stores nothing
    float vals[VPL][vec_elems<T>()], mean, scale;
    row_to_f32<T>(raw, vals);
    row_stats<kRms, T, LANES, VPL>(vals, sub, n_vec, D, inv_sqrt_d, eps, &mean, &scale);
    if (row < rows)
      store_row<kRms, T, LANES, VPL>(out + row * D, vals,
                                     BlockWeights<kRms, T>{staged, staged + LANES * VPL}, mean,
                                     scale, sub, n_vec);
  }
}

// How a call runs: blocks of `warps` warps, one step a warp; the path of
// many rows or not
struct Plan {
  long long blocks;
  int warps;
  bool many;
};

// SMs of the current device, read once per device
cudaError_t sm_count(int* sms) {
  static std::atomic<int> cached[kMaxDevices];  // 0 until read
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if ((*sms = cached[dev].load(std::memory_order_acquire)) == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached[dev].store(*sms, std::memory_order_release);
  }
  return cudaSuccess;
}

// Rows that fill the card's warps at most once (the replans): blocks of as
// few warps as put a block on every SM. More (the steps): kMany, blocks
// of kWarps warps, as many as the rows need; the hardware starts each as
// one ends.
template <int LANES>
cudaError_t plan_of(long long rows, Plan* p) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long steps = (rows + 32 / LANES - 1) / (32 / LANES);  // warp-steps of rows
  p->many = steps > static_cast<long long>(kWarps) * sms;
  p->warps = p->many ? kWarps
                       : static_cast<int>(std::max<long long>(1, (steps + sms - 1) / sms));
  p->blocks = (steps + p->warps - 1) / p->warps;
  return p->blocks < (1LL << 31) ? cudaSuccess : cudaErrorInvalidValue;  // the grid's x limit
}

struct Args {
  const void *x, *w, *b;
  void* out;
  long long rows;
  int D;
  float eps;
  cudaStream_t stream;
};

template <bool kRms, typename T, int LANES, int VPL>
cudaError_t launch_layout(const Args& a) {
  Plan p;
  const cudaError_t err = plan_of<LANES>(a.rows, &p);
  if (err != cudaSuccess) return err;
  // D^-1/2 rounded once from double, as the plain version's Python scalar
  const float inv_sqrt_d = static_cast<float>(1.0 / std::sqrt(static_cast<double>(a.D)));
  const auto kernel = p.many ? fused_norm_kernel<kRms, T, LANES, VPL, true>
                               : fused_norm_kernel<kRms, T, LANES, VPL, false>;
  kernel<<<static_cast<unsigned>(p.blocks), p.warps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w), static_cast<const T*>(a.b),
      static_cast<T*>(a.out), a.rows, a.D, inv_sqrt_d, a.eps);
  return cudaGetLastError();
}

template <bool kRms, typename T, std::size_t... I>
cudaError_t launch_typed(int layout, const Args& a, std::index_sequence<I...>) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((layout == static_cast<int>(I) &&
          (err = launch_layout<kRms, T, kLayouts[I].lanes, kLayouts[I].vpl>(a), true)) || ...);
  return err;
}

template <std::size_t... I>
cudaError_t plan_typed(int layout, long long rows, Plan* p, std::index_sequence<I...>) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((layout == static_cast<int>(I) && (err = plan_of<kLayouts[I].lanes>(rows, p), true)) ||
         ...);
  return err;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

inline int n_vectors(int D, int is_bf16) {
  return D / (is_bf16 ? vec_elems<__nv_bfloat16>() : vec_elems<float>());
}

template <bool kRms>
int launch(const Args& a, int is_bf16) {
  if (a.rows <= 0) return 0;
  const int layout = choose_layout(n_vectors(a.D, is_bf16));
  // the 16-byte vector accesses, and the widest layout
  if (layout < 0 || !aligned16(a.x) || !aligned16(a.w) || (!kRms && !aligned16(a.b)) ||
      !aligned16(a.out))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto all = std::make_index_sequence<kNumLayouts>{};
  return static_cast<int>(is_bf16 ? launch_typed<kRms, __nv_bfloat16>(layout, a, all)
                                  : launch_typed<kRms, float>(layout, a, all));
}

}  // namespace

extern "C" {

// Largest row width the kernel takes for an input of this itemsize.
int mdt_fused_norm_max_width(int is_bf16) {
  return kMaxVectors * (is_bf16 ? vec_elems<__nv_bfloat16>() : vec_elems<float>());
}

// How a call at (rows, D) runs, LayerNorm or RMSNorm: plan = {lanes a row,
// vectors a lane, blocks, warps a block, 1 where the weights are staged in
// shared memory}. Returns 0, or a CUDA error (cudaErrorInvalidValue past
// the widest row or the grid).
int mdt_fused_norm_plan(long long rows, int D, int is_bf16, long long* plan) {
  const int layout = choose_layout(n_vectors(D, is_bf16));
  if (layout < 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan_typed(layout, rows, &p, std::make_index_sequence<kNumLayouts>{});
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = kLayouts[layout].lanes;
  plan[1] = kLayouts[layout].vpl;
  plan[2] = p.blocks;
  plan[3] = p.warps;
  plan[4] = p.many;
  return 0;
}

// Launch on `stream`; return cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a pointer that is not 16-byte aligned or a row
// past the widest layout.
int mdt_fused_layer_norm(const void* x, const void* w, const void* b, void* out,
                         long long rows, int D, float eps, int is_bf16, void* stream) {
  return launch<false>({x, w, b, out, rows, D, eps, static_cast<cudaStream_t>(stream)}, is_bf16);
}

int mdt_fused_rms_norm(const void* x, const void* g, void* out, long long rows, int D,
                       float eps, int is_bf16, void* stream) {
  return launch<true>({x, g, nullptr, out, rows, D, eps, static_cast<cudaStream_t>(stream)},
                      is_bf16);
}

}  // extern "C"
