// Fused multi-head attention over the packed qkv projection, for Hopper (sm_90a):
// kernel B1.
//
// Replaces the Pallas TPU kernel mdt_policy_tpu/ops/fused_qkv_attention.py
// (fused_qkv_attention: _kernel / _kernel_pair). The contract, the design and
// what bounds it on the H100 are written at the top of mha_core.cuh, which
// holds the kernel's body; the attention half-block (attention_halfblock.cu)
// runs the same body between its projections.

#include "mha_core.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(mha::kWarps * 32)
fused_qkv_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                           int seq, int C, int dh, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  mha::mha_block<T>(qkv, out, seq, C, dh, scale, causal, smem);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper checks it against the
// card's per-block limit before launching.
size_t mdt_fused_qkv_attention_smem_bytes(int seq, int C, int H, int is_bf16) {
  const int dh = C / H;
  return is_bf16 ? mha::smem_bytes<__nv_bfloat16>(seq, dh) : mha::smem_bytes<float>(seq, dh);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int mdt_fused_qkv_attention(const void* qkv, void* out, int B, int seq, int C, int H,
                            int causal, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? mha::launch_mha<__nv_bfloat16>(fused_qkv_attention_kernel<__nv_bfloat16>,
                                                  qkv, out, B, seq, C, H, causal, s)
                 : mha::launch_mha<float>(fused_qkv_attention_kernel<float>,
                                          qkv, out, B, seq, C, H, causal, s);
}

}  // extern "C"
