// Fused multi-head attention over the packed qkv projection, for Hopper (sm_90a):
// kernel B1.
//
// Replaces the Pallas TPU kernel mdt_policy_tpu/ops/fused_qkv_attention.py
// (fused_qkv_attention: _kernel / _kernel_pair). Two bodies, one contract:
// bf16 calls with 64-wide heads and T <= 208 (every tower call) run the
// tensor-core body of attention_sm90.cuh; every other call (f32, other head
// widths) runs mha_core.cuh. The wrapper (ops/fused_qkv_attention.py) picks
// the body; each file's header holds its design and what bounds it. The
// attention half-block (attention_halfblock.cu) runs the same bodies between
// its projections.

#include "attention_sm90.cuh"
#include "mha_core.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(mha::kWarps * 32)
fused_qkv_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                           int seq, int C, int dh, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  mha::mha_block<T>(qkv, out, seq, C, dh, scale, causal, smem);
}

template <int NS>
__global__ void __launch_bounds__(attn90::kThreads, 1)
fused_qkv_attention_kernel_sm90(const __grid_constant__ CUtensorMap map_kv,
                                const __grid_constant__ CUtensorMap map_q,
                                attn90::bf16* __restrict__ out, int B, int seq, int C, int H,
                                int causal) {
  extern __shared__ __align__(128) unsigned char smem_sm90[];
  attn90::attention_block<NS>(&map_kv, &map_q, out, B, seq, C, H, causal, smem_sm90);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper checks it against the
// card's per-block limit before launching.
size_t mdt_fused_qkv_attention_smem_bytes(int seq, int C, int H, int is_bf16) {
  const int dh = C / H;
  return is_bf16 ? mha::smem_bytes<__nv_bfloat16>(seq, dh) : mha::smem_bytes<float>(seq, dh);
}

// Launches the mha_core body on `stream`; returns cudaGetLastError() (0 on success).
int mdt_fused_qkv_attention(const void* qkv, void* out, int B, int seq, int C, int H,
                            int causal, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? mha::launch_mha<__nv_bfloat16>(fused_qkv_attention_kernel<__nv_bfloat16>,
                                                  qkv, out, B, seq, C, H, causal, s)
                 : mha::launch_mha<float>(fused_qkv_attention_kernel<float>,
                                          qkv, out, B, seq, C, H, causal, s);
}

// Launches the tensor-core body (bf16, C = 64 H, 1 <= T <= 208, 16-byte
// aligned qkv) on `stream`; returns the first error (0 on success).
int mdt_fused_qkv_attention_sm90(const void* qkv, void* out, int B, int seq, int C, int H,
                                 int causal, void* stream) {
  return attn90::launch(fused_qkv_attention_kernel_sm90<attn90::kShortSteps>,
                        fused_qkv_attention_kernel_sm90<attn90::kMaxSteps>, qkv, out, B, seq, C,
                        H, static_cast<cudaStream_t>(stream), causal);
}

}  // extern "C"
