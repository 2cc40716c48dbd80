// The attention core of kernel B4, the attention half-block of a frozen
// tower block, for Hopper (sm_90a):
//
//     out = x + [gamma *] proj(attention(qkv(norm(x))))
//
// Replaces, with halfblock_gemm.cu, the Pallas TPU kernel
// mdt_policy_tpu/ops/attention_halfblock.py (attention_halfblock, _kernel).
// The wrapper (ops/attention_halfblock.py) launches four kernels on one
// stream, with nothing between them:
//   1. halfblock_norm (halfblock_gemm.cu)                x -> xn (B*T, C)
//   2. halfblock_gemm, bias epilogue                     xn -> qkv (B*T, 3C)
//   3. this file: the attention core, B1's body: halfblock_attention_sm90_kernel
//      (attention_sm90.cuh) where the wrapper's `sm90` flag says the call lies
//      in its domain (64-wide heads, T <= 208: every tower), else
//      halfblock_attention_kernel (mha_core.cuh)       qkv -> att (B*T, C)
//   4. halfblock_gemm, residual epilogue (+ b_proj, * gamma, + x)  att -> out
// xn, qkv and att are scratch that the wrapper allocates. One CLIP image's
// normalized rows (197 x 768 bf16, 303 KB) do not fit in a block's shared
// memory, so the chain goes through device memory (and mostly L2) instead of
// one fused kernel. The Pallas kernel rounds each head's attention output to
// bf16 before its partial projection and sums the heads in f32; rounding the
// whole attention output and running one f32-accumulated projection is the
// same arithmetic in another summation order.
//
// What bounds it on the H100: 8*T*C^2 + 4*T^2*C FLOP per image against
// ~4*T*C bytes of input and output: the tensor cores (see halfblock_gemm.cu
// and, for the attention core, attention_sm90.cuh).

#include "attention_sm90.cuh"
#include "mha_core.cuh"

namespace {

__global__ void __launch_bounds__(mha::kWarps * 32)
halfblock_attention_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                           int seq, int C, int dh, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  mha::mha_block<__nv_bfloat16>(qkv, out, seq, C, dh, scale, causal, smem);
}

template <int NS>
__global__ void __launch_bounds__(attn90::kThreads, 1)
halfblock_attention_sm90_kernel(const __grid_constant__ CUtensorMap map_kv,
                                const __grid_constant__ CUtensorMap map_q,
                                attn90::bf16* __restrict__ out, int B, int seq, int C, int H,
                                int causal) {
  extern __shared__ __align__(128) unsigned char smem_sm90[];
  attn90::attention_block<NS>(&map_kv, &map_q, out, B, seq, C, H, causal, smem_sm90);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the attention core.
size_t mdt_halfblock_attention_smem_bytes(int seq, int C, int H, int sm90) {
  return sm90 ? attn90::smem_bytes(seq) : mha::smem_bytes<__nv_bfloat16>(seq, C / H);
}

// qkv (B, T, 3C) -> att (B, T, C) on `stream`; returns cudaGetLastError()
// (0 on success), or kTensorMapError (-1) for a refused tensor map.
int mdt_halfblock_attention(const void* qkv, void* att, int B, int T, int C, int H, int causal,
                            int sm90, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sm90 ? attn90::launch(halfblock_attention_sm90_kernel<attn90::kShortSteps>,
                               halfblock_attention_sm90_kernel<attn90::kMaxSteps>, qkv, att, B,
                               T, C, H, s, causal)
              : mha::launch_mha<__nv_bfloat16>(halfblock_attention_kernel, qkv, att, B, T, C,
                                               H, causal, s);
}

}  // extern "C"
