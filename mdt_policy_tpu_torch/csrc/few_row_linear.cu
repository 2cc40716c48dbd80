// Few-row float32 linear layers with a fused prologue and epilogue, for
// Hopper (sm_90a): kernel B6.
//
// Replaces no TPU kernel: the JAX package leaves the denoiser's dense layers
// to XLA, which fuses each one with its neighbours. On the H100 the same
// layers ran as one cuBLAS GEMM each, between separate LayerNorm,
// modulation, GELU, gate and residual kernels: about 37 launches a
// denoiser block, at 10 rows (B = 1, 10 action tokens) or 4 (the encoder).
//
// Contract. One launch runs up to kMaxJobs jobs; a job is one weight W
// (N, K), row-major as nn.Linear stores it, applied to M <= 32 input rows:
//   out[r, n] = epilogue(sum_k prologue(x)[r, k] * W[n, k])
// (K <= 512 with a layernorm or attention prologue, 16 key rows and heads
// at most with the attention: kMaxWidth, kMaxKvRows, kMaxHeads)
// with the prologue one of
//   none       x as it is;
//   silu       x / (1 + exp(-x)) (the AdaLN input);
//   layernorm  per row: mean and biased variance over the K columns,
//              (x - mean) * rsqrt(var + eps) * ln_w (+ ln_b), then, with
//              shift and scale, shift[m] + y * scale[m] where m = r / per
//              (the rows that share one modulation row);
//   attention  the rows are multi-head attention outputs: query rows q
//              (M = B * tq, K = C channels, `heads` heads of C / heads),
//              keys and values kv (B * tk rows), scores q.k * att_scale
//              summed in f32, with `causal` key j kept for query t when
//              j <= t, an f32 softmax, P.V in f32 (the cross-attention of
//              the denoiser's decoder, 10 queries over 4 context tokens);
// and the epilogue, in this order: + bias[n]; exact-erf GELU; with res,
// res[r, n] + y, or res[r, n] + gate[m, n] * y with a gate.
// Everything is float32: operands, products and sums, no tensor cores and
// no TF32. Every job reads x, q, kv, ln_w, ln_b, shift, scale, res and gate
// as f32 rows with their own leading dimensions (in floats); those it stages
// in shared memory (x, q, kv, ln_w, ln_b, shift, scale) in 16-byte vectors,
// so their rows start on 16-byte boundaries; out rows likewise.
//
// What bounds it on the H100: at M <= 32 rows a weight of N x K floats is
// 2 N K M FLOPs over 4 N K bytes, M / 2 FLOPs a byte, far under the ridge of
// the f32 peak over HBM bandwidth (67e12 / 3.35e12 = 20): the least time is
// the weight's bytes over 3.35 TB/s, 0.18 us for a 384 x 384 weight. At
// those sizes a launch is latency: one round trip to device memory for the
// weights, the input rows' staging, the dependent sums.
//
// Design. A block of 8 warps stages the job's input rows (with the
// LayerNorm's parameters and modulation rows, or the attention's queries,
// keys and values) in shared memory in one round trip, every thread's loads
// in flight before its stores, and runs the prologue there. Each warp owns F
// output features and reads each of their weight rows exactly once, a
// 16-byte vector a lane (lane l takes columns 4l .. 4l + 3 of every 128); it
// issues the loads of its first two groups of columns before the staging, so
// that the weights' latency overlaps it, and each later group's two groups
// ahead of its multiply-adds. F is the fewest that keeps the launch within
// one wave of resident blocks (each block repeats the prologue). A lane keeps
// R x F partial sums in registers (R = 4, 8, 12, 16 or 32 rows, the rows
// past M staged as zeros, so that the multiply-adds of all R rows run with
// no branch between them; R x F <= 32), one fma chain each in a fixed order;
// one transposing butterfly over the warp, 31 shuffles for 32 sums, leaves
// each sum whole on one lane, which applies the epilogue (its operands
// loaded at the start) and stores it. No atomics: every run gives the same
// bits.

#include <cuda_runtime.h>
#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxJobs = 8;
constexpr int kMaxRows = 32;
// the limits of the prologues staged whole (layernorm, attention), within
// which every job fits kMaxSmem (the static_asserts below): their width K,
// and the attention's key rows over all its sequences, and its heads
constexpr int kMaxWidth = 512;
constexpr int kMaxKvRows = 16;
constexpr int kMaxHeads = 16;
// blocks a launch beyond which warps take more features each: two for each
// of the H100's 132 SMs, about what stays resident at once
constexpr int kFillBlocks = 2 * 132;
constexpr int kMaxSmem = 200 * 1024;   // opted in once per instance and device
constexpr int kTileSmem = 96 * 1024;   // an input tile of the prologues that tile
constexpr int kMaxDevices = 64;
constexpr int kBatch = 8;  // 16-byte loads in flight a thread while staging

enum Prologue : long long { kNone = 0, kSilu = 1, kLayerNorm = 2, kAttention = 3 };

// One job, as the wrapper packs it: 8-byte fields only, in this order
// (ops/few_row_linear.py::_JOB). block0, blocks and kt are the launch's.
struct Job {
  const float* x;  long long x_ld;
  const float* w;  const float* bias;
  float* out;      long long out_ld;
  const float* res;  long long res_ld;
  const float* gate; long long gate_ld;
  const float* ln_w; const float* ln_b;
  const float* shift; const float* scale; long long mod_ld;
  const float* q; const float* kv; long long q_ld; long long kv_ld; long long v_off;
  long long M, K, N, per, prologue, gelu, heads, tq, tk, causal;
  long long kt, block0, blocks;
  double eps, att_scale;
};

struct Params {
  Job jobs[kMaxJobs];
  int njobs;
};

__host__ __device__ constexpr long long round_up(long long a, long long b) {
  return (a + b - 1) / b * b;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Smem layouts, in floats, each region a multiple of 4; the input rows are
// R of them, rows M .. R - 1 zero (the multiply-adds run over all R rows,
// with no branch a row). The attention prologue: queries (then the attention
// output) R x ld, keys and values nkv x ld each, then the probabilities
// M x heads x tk. The layernorm prologue: the rows R x ld, then ln_w, ln_b
// and the shift and scale rows (one every `per` rows) at ld each.
__host__ __device__ constexpr long long attention_floats(long long R, long long M, long long C,
                                                         long long nkv, long long heads,
                                                         long long tk) {
  const long long ld = round_up(C, 4);
  return (R + 2 * nkv) * ld + round_up(M * heads * tk, 4);
}

__host__ __device__ constexpr long long mod_rows(long long M, long long per) {
  return (M + per - 1) / per;
}

__host__ __device__ constexpr long long layer_norm_floats(long long R, long long M, long long K,
                                                          long long per) {
  return (R + 2 + 2 * mod_rows(M, per)) * round_up(K, 4);
}

// the largest job within the limits fits: the wrapper's gate checks the
// limits only (ops/few_row_linear.py: MAX_ROWS, MAX_WIDTH, ...)
static_assert(4 * attention_floats(kMaxRows, kMaxRows, kMaxWidth, kMaxKvRows, kMaxHeads,
                                   kMaxKvRows) <= kMaxSmem, "attention past kMaxSmem");
static_assert(4 * layer_norm_floats(kMaxRows, kMaxRows, kMaxWidth, 1) <= kMaxSmem,
              "layernorm past kMaxSmem");

// Rows [0, rows) x 16-byte vectors [0, v4) into dst (leading dimension ld
// floats): row rr from src(rr), a pointer to its first vector (nullptr: a
// row of zeros), vectors from valid4 on as zeros, each value x as
// x / (1 + exp(-x)) with silu. The threads form G = kThreads / W groups of
// W = min(v4, kThreads); a group takes rows g, g + G, ..., a thread vectors
// c, c + W, ...; kBatch of a thread's loads are in flight before their
// stores, so a block stages up to kThreads x kBatch vectors in one round
// trip.
template <typename Src>
__device__ __forceinline__ void stage_rows(float* dst, long long ld, int rows, int v4,
                                           int valid4, bool silu, Src src) {
  const int W = v4 < kThreads ? v4 : kThreads, G = kThreads / W;
  const int g = threadIdx.x / W, c = threadIdx.x - g * W;
  if (g >= G) return;
  // this thread's (row, vector) items, rows fastest
  const int nr = (rows - g + G - 1) / G, n = nr * ((v4 - c + W - 1) / W);
  int ri = 0, ci = 0;
  for (int e0 = 0; e0 < n; e0 += kBatch) {
    float4 val[kBatch];
    int rr[kBatch], cc[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      rr[u] = g + ri * G;
      cc[u] = c + ci * W;
      val[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e0 + u < n) {
        if (cc[u] < valid4) {
          const float* row = src(rr[u]);
          if (row) val[u] = __ldg(reinterpret_cast<const float4*>(row) + cc[u]);
        }
        if (++ri == nr) {
          ri = 0;
          ++ci;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (e0 + u >= n) break;
      float4 v = val[u];
      if (silu) {
        v.x = v.x / (1.f + expf(-v.x));
        v.y = v.y / (1.f + expf(-v.y));
        v.z = v.z / (1.f + expf(-v.z));
        v.w = v.w / (1.f + expf(-v.w));
      }
      reinterpret_cast<float4*>(dst + rr[u] * ld)[cc[u]] = v;
    }
  }
}

// The input rows [0, R) x columns [c0, c0 + cols) of a job whose prologue
// needs no whole rows (none, silu); rows from M on zero
__device__ __forceinline__ void stage_input(float* xs, const Job& J, int R, long long c0,
                                            long long cols) {
  const long long valid = J.K - c0 < cols ? J.K - c0 : cols;
  const int M = static_cast<int>(J.M);
  stage_rows(xs, cols, R, static_cast<int>(cols / 4), static_cast<int>(valid / 4),
             J.prologue == kSilu,
             [&](int rr) { return rr < M ? J.x + rr * J.x_ld + c0 : nullptr; });
}

// The layernorm prologue: the rows, ln_w, ln_b and the modulation rows
// staged in one pass, then a warp takes rows warp, warp + 8, ..., all of
// them at once (RW independent sums a lane), in 16-byte vectors
template <int R>
__device__ void layer_norm_rows(float* xs, long long ld, const Job& J) {
  constexpr int RW = (R + kWarps - 1) / kWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int M = static_cast<int>(J.M), K = static_cast<int>(J.K), K4 = K / 4;
  const int mods = static_cast<int>(mod_rows(M, J.per));
  stage_rows(xs, ld, R + 2 + (J.shift ? 2 * mods : 0), K4, K4, false,
             [&](int rr) -> const float* {
    if (rr < R) return rr < M ? J.x + rr * J.x_ld : nullptr;
    rr -= R;
    if (rr < 2) return rr == 0 ? J.ln_w : J.ln_b;
    rr -= 2;
    return rr < mods ? J.shift + rr * J.mod_ld : J.scale + (rr - mods) * J.mod_ld;
  });
  __syncthreads();
  const long long ld4 = ld / 4;
  float4* x4 = reinterpret_cast<float4*>(xs);
  const float4* lnw = x4 + R * ld4;
  const float4* lnb = lnw + ld4;
  const float4* shift = lnb + ld4;
  const float4* scale = shift + mods * ld4;
  float mean[RW], rstd[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) mean[i] = rstd[i] = 0.f;
  for (int c = lane; c < K4; c += 32) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + i * kWarps;
      if (r < M) {
        const float4 v = x4[r * ld4 + c];
        mean[i] += (v.x + v.y) + (v.z + v.w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) mean[i] = warp_sum(mean[i]) / K;
  for (int c = lane; c < K4; c += 32) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + i * kWarps;
      if (r < M) {
        const float4 v = x4[r * ld4 + c];
        const float a = v.x - mean[i], b = v.y - mean[i], d = v.z - mean[i], e = v.w - mean[i];
        rstd[i] += fmaf(a, a, b * b) + fmaf(d, d, e * e);
      }
    }
  }
  const float eps = static_cast<float>(J.eps);
#pragma unroll
  for (int i = 0; i < RW; ++i) rstd[i] = rsqrtf(warp_sum(rstd[i]) / K + eps);
  for (int c = lane; c < K4; c += 32) {
    const float4 w = lnw[c];
    const float4 b = J.ln_b ? lnb[c] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + i * kWarps;
      if (r < M) {
        float4 v = x4[r * ld4 + c];
        v.x = (v.x - mean[i]) * rstd[i] * w.x + b.x;
        v.y = (v.y - mean[i]) * rstd[i] * w.y + b.y;
        v.z = (v.z - mean[i]) * rstd[i] * w.z + b.z;
        v.w = (v.w - mean[i]) * rstd[i] * w.w + b.w;
        if (J.shift) {
          const long long m = (r / J.per) * ld4 + c;
          const float4 sh = shift[m], sc = scale[m];
          v.x = sh.x + v.x * sc.x;
          v.y = sh.y + v.y * sc.y;
          v.z = sh.z + v.z * sc.z;
          v.w = sh.w + v.w * sc.w;
        }
        x4[r * ld4 + c] = v;
      }
    }
  }
}

// The attention prologue: the attention output of the M query rows in xs
// (leading dimension round_up(C, 4)), keys, values and probabilities after
// it. A thread takes a (query, head) pair's scores, four keys at a time in
// 16-byte vectors, and its softmax; then a thread a 16-byte column of the
// output over a group's rows.
__device__ void attention_rows(float* xs, const Job& J, int R) {
  const int M = static_cast<int>(J.M), C = static_cast<int>(J.K);
  const int H = static_cast<int>(J.heads), D = C / H, D4 = D / 4, C4 = C / 4;
  const int tq = static_cast<int>(J.tq), tk = static_cast<int>(J.tk);
  const int nkv = M / tq * tk;
  const long long ld = round_up(C, 4), ld4 = ld / 4;
  float* ks = xs + R * ld;
  float* vs = ks + nkv * ld;
  float* ps = vs + nkv * ld;
  stage_rows(xs, ld, R + 2 * nkv, C4, C4, false, [&](int rr) -> const float* {
    if (rr < R) return rr < M ? J.q + rr * J.q_ld : nullptr;
    rr -= R;
    return rr < nkv ? J.kv + rr * J.kv_ld : J.kv + J.v_off + (rr - nkv) * J.kv_ld;
  });
  __syncthreads();
  const float scale = static_cast<float>(J.att_scale);
  for (int pair = threadIdx.x; pair < M * H; pair += kThreads) {
    const int r = pair / H, h = pair - r * H;
    const int b = r / tq, t = r - b * tq;
    const float4* q4 = reinterpret_cast<const float4*>(xs + r * ld + h * D);
    const float4* k4 = reinterpret_cast<const float4*>(ks + b * tk * ld + h * D);
    float* p = ps + pair * tk;
    for (int j0 = 0; j0 < tk; j0 += 4) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < D4; ++d) {
        const float4 q = q4[d];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j0 + u < tk) {
            const float4 k = k4[(j0 + u) * ld4 + d];
            s[u] = fmaf(q.x, k.x, fmaf(q.y, k.y, fmaf(q.z, k.z, fmaf(q.w, k.w, s[u]))));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + u < tk) p[j0 + u] = (J.causal && j0 + u > t) ? -FLT_MAX : s[u] * scale;
    }
    float m = -FLT_MAX;
    for (int j = 0; j < tk; ++j) m = fmaxf(m, p[j]);
    float sum = 0.f;
    for (int j = 0; j < tk; ++j) {
      p[j] = expf(p[j] - m);
      sum += p[j];
    }
    for (int j = 0; j < tk; ++j) p[j] = p[j] / sum;
  }
  __syncthreads();
  // P.V over the queries, which no thread reads any more
  const int W = C4 < kThreads ? C4 : kThreads, G = kThreads / W;
  const int g = threadIdx.x / W, c = threadIdx.x - g * W;
  if (g >= G) return;
  for (int c4 = c; c4 < C4; c4 += W) {
    const int h = c4 / D4;
    for (int r = g; r < M; r += G) {
      const int b = r / tq;
      const float* p = ps + (r * H + h) * tk;
      const float4* v4 = reinterpret_cast<const float4*>(vs + b * tk * ld) + c4;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < tk; ++j) {
        const float pj = p[j];
        const float4 v = v4[j * ld4];
        o.x = fmaf(pj, v.x, o.x);
        o.y = fmaf(pj, v.y, o.y);
        o.z = fmaf(pj, v.z, o.z);
        o.w = fmaf(pj, v.w, o.w);
      }
      reinterpret_cast<float4*>(xs + r * ld)[c4] = o;
    }
  }
}

// Weight vectors of steps [s0, s0 + U) of this warp's F features; zero past
// N or K (no load)
template <int F, int U>
__device__ __forceinline__ void load_w(float4 (&w)[U][F], const Job& J, long long n0,
                                       int s0, int lane) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long k = (s0 + u) * 128LL + 4 * lane;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      w[u][f] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n0 + f < J.N && k < J.K)
        w[u][f] = __ldg(reinterpret_cast<const float4*>(J.w + (n0 + f) * J.K + k));
    }
  }
}

// The partial sums of V values on each lane, summed over the warp by a
// transposing butterfly: each step hands half of a lane's values to the lane
// `Off` away and adds the other half's from it (the upper lane keeps the
// upper half), so after log2(V) steps a lane holds one value's sum over the
// lanes that differ in those bits, value lane / (32 / V); plain butterfly
// steps over the remaining bits finish it (lanes that hold the same value
// hold the same bits)
template <int Half, int Off>
struct Fold {
  static __device__ __forceinline__ void run(float* a, int lane) {
    const bool upper = lane & Off;
#pragma unroll
    for (int i = 0; i < Half; ++i) {
      const float send = upper ? a[i] : a[i + Half];
      const float keep = upper ? a[i + Half] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, Off);
    }
    Fold<Half / 2, Off / 2>::run(a, lane);
  }
};

template <int Off>
struct Fold<0, Off> {
  static __device__ __forceinline__ void run(float*, int) {}
};

template <int V>
__device__ __forceinline__ float lane_sums(float (&a)[V], int lane) {
  Fold<V / 2, 16>::run(a, lane);
  float s = a[0];
#pragma unroll
  for (int off = 16 / V; off >= 1; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <int R, int F>
__global__ void __launch_bounds__(kThreads, 2)
few_row_linear_kernel(const __grid_constant__ Params p) {
  constexpr int U = 4 / F;  // steps of 128 columns a group: U x F vectors a buffer
  constexpr int V = R * F;  // sums a lane,
  constexpr int VP = V <= 4 ? 4 : V <= 8 ? 8 : V <= 16 ? 16 : 32;  // padded to a power of 2
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  int j = 0;
  while (j + 1 < p.njobs && blockIdx.x >= p.jobs[j + 1].block0) ++j;
  const Job& J = p.jobs[j];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int M = static_cast<int>(J.M);
  const long long K = J.K, kt = J.kt;
  const long long n0 = (blockIdx.x - J.block0) * (kWarps * F) + warp * F;
  const int groups = static_cast<int>((K + 128 * U - 1) / (128 * U));
  const bool tiled = kt < K;

  // this lane's output after lane_sums, and its epilogue operands, first
  const int idx = lane / (32 / VP), r_out = idx / F;
  const long long n_out = n0 + (idx - r_out * F);
  const bool writes = lane % (32 / VP) == 0 && r_out < M && n_out < J.N;
  float bias = 0.f, res = 0.f, gate = 1.f;
  if (writes) {
    if (J.bias) bias = __ldg(J.bias + n_out);
    if (J.res) res = __ldg(J.res + r_out * J.res_ld + n_out);
    if (J.gate) gate = __ldg(J.gate + (r_out / J.per) * J.gate_ld + n_out);
  }
  // the first two groups' weights in flight before the prologue
  float4 wa[U][F], wb[U][F];
  load_w<F, U>(wa, J, n0, 0, lane);
  load_w<F, U>(wb, J, n0, U, lane);
  if (J.prologue == kAttention) {
    attention_rows(xs, J, R);
  } else if (J.prologue == kLayerNorm) {
    layer_norm_rows<R>(xs, kt, J);
  } else {
    stage_input(xs, J, R, 0, tiled ? kt : round_up(K, 4));
  }
  __syncthreads();

  float acc[VP];
#pragma unroll
  for (int i = 0; i < VP; ++i) acc[i] = 0.f;
  long long c0 = 0;  // the staged tile's first column
  for (int g = 0; g < groups; ++g) {
    const long long k0 = g * 128LL * U;
    if (tiled && k0 > 0 && k0 % kt == 0) {
      __syncthreads();
      c0 = k0;
      stage_input(xs, J, R, c0, kt);
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long k = k0 + 128 * u + 4 * lane;
      if (k < K) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + r * kt + (k - c0));
#pragma unroll
          for (int f = 0; f < F; ++f) {
            float a = acc[r * F + f];
            a = fmaf(xv.x, wa[u][f].x, a);
            a = fmaf(xv.y, wa[u][f].y, a);
            a = fmaf(xv.z, wa[u][f].z, a);
            a = fmaf(xv.w, wa[u][f].w, a);
            acc[r * F + f] = a;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int f = 0; f < F; ++f) wa[u][f] = wb[u][f];
    load_w<F, U>(wb, J, n0, (g + 2) * U, lane);
  }

  float y = lane_sums<VP>(acc, lane) + bias;
  if (!writes) return;
  if (J.gelu) y = 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
  if (J.res) y = J.gate ? res + gate * y : res + y;
  J.out[r_out * J.out_ld + n_out] = y;
}

using KernelFn = void (*)(Params);

template <int R>
KernelFn pick(int F) {
  if constexpr (R <= 8) if (F == 4) return few_row_linear_kernel<R, 4>;
  if constexpr (R <= 16) if (F == 2) return few_row_linear_kernel<R, 2>;
  return few_row_linear_kernel<R, 1>;
}

KernelFn kernel_for(int R, int F) {
  switch (R) {
    case 4: return pick<4>(F);
    case 8: return pick<8>(F);
    case 12: return pick<12>(F);
    case 16: return pick<16>(F);
    default: return pick<32>(F);
  }
}

bool aligned(const void* p) { return p && reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The launch plan: R, F, each job's blocks, first block and tile, and the
// shared memory; false for a job outside the kernel's domain
bool plan(Params& p, int& R, int& F, long long& smem) {
  int max_m = 1;
  for (int i = 0; i < p.njobs; ++i) {
    const Job& J = p.jobs[i];
    if (J.M < 1 || J.M > kMaxRows || J.K < 4 || J.K % 4 || J.N < 1 || J.K > (1 << 24) ||
        J.N > (1 << 24) || J.per < 1 || J.prologue < kNone || J.prologue > kAttention ||
        !J.w || !J.out || !aligned(J.w))
      return false;
    if (J.prologue == kAttention) {
      if (J.heads < 1 || J.heads > kMaxHeads || J.K > kMaxWidth || J.K % (4 * J.heads) ||
          J.tq < 1 || J.M % J.tq || J.tk < 1 || J.M / J.tq * J.tk > kMaxKvRows ||
          !aligned(J.q) || !aligned(J.kv) ||
          !aligned(J.kv + J.v_off) ||
          J.q_ld % 4 || J.kv_ld % 4)
        return false;
    } else if (!J.x || !aligned(J.x) || J.x_ld % 4) {
      return false;
    }
    if (J.prologue == kLayerNorm &&
        (J.K > kMaxWidth || !aligned(J.ln_w) || (J.ln_b && !aligned(J.ln_b)) ||
         (!J.shift) != (!J.scale) ||
         (J.shift && (!aligned(J.shift) || !aligned(J.scale) || J.mod_ld % 4))))
      return false;
    if (J.gate && !J.res) return false;
    if (J.M > max_m) max_m = static_cast<int>(J.M);
  }
  R = max_m <= 4 ? 4 : max_m <= 8 ? 8 : max_m <= 12 ? 12 : max_m <= 16 ? 16 : 32;
  auto blocks_at = [&](int f) {
    long long b = 0;
    for (int i = 0; i < p.njobs; ++i) b += (p.jobs[i].N + kWarps * f - 1) / (kWarps * f);
    return b;
  };
  // the fewest features a warp that keep the launch within one wave of
  // resident blocks: each block repeats the prologue
  F = 1;
  while (2 * R * F <= 32 && F < 4 && blocks_at(F) > kFillBlocks) F *= 2;
  const long long step = 128LL * (4 / F);
  smem = 0;
  long long block0 = 0;
  for (int i = 0; i < p.njobs; ++i) {
    Job& J = p.jobs[i];
    const long long whole = round_up(J.K, 4);
    long long floats;
    if (J.prologue == kAttention) {
      J.kt = whole;
      floats = attention_floats(R, J.M, J.K, J.M / J.tq * J.tk, J.heads, J.tk);
    } else if (J.prologue == kLayerNorm) {
      J.kt = whole;
      floats = layer_norm_floats(R, J.M, J.K, J.per);
    } else {
      J.kt = whole;
      if (R * whole * 4 > kTileSmem)
        J.kt = std::max(step, kTileSmem / 4 / R / step * step);
      floats = R * J.kt;
    }
    if (floats * 4 > kMaxSmem) return false;
    smem = std::max(smem, floats * 4);
    J.blocks = (J.N + kWarps * F - 1) / (kWarps * F);
    J.block0 = block0;
    block0 += J.blocks;
  }
  return block0 <= (1LL << 31) - 1;
}

}  // namespace

extern "C" {

// Launches `njobs` jobs (1..8, packed as `Job`) in one kernel on `stream`.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// job outside the kernel's domain.
int mdt_few_row_linear(const void* jobs, int njobs, void* stream) {
  if (njobs < 1 || njobs > kMaxJobs) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int i = 0; i < njobs; ++i) p.jobs[i] = static_cast<const Job*>(jobs)[i];
  p.njobs = njobs;
  int R = 0, F = 0;
  long long smem = 0;
  if (!plan(p, R, F, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kernel = kernel_for(R, F);
  // raise the shared-memory cap once per instance and device, at the first
  // launch there (and so before any capture into a CUDA graph)
  static std::atomic<bool> raised[5][3][kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const int r_index = R == 4 ? 0 : R == 8 ? 1 : R == 12 ? 2 : R == 16 ? 3 : 4;
  std::atomic<bool>& flag = raised[r_index][F == 4 ? 2 : F - 1][dev];
  if (!flag.load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flag.store(true, std::memory_order_release);
  }
  const long long blocks = p.jobs[njobs - 1].block0 + p.jobs[njobs - 1].blocks;
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
