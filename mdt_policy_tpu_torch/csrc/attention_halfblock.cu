// Attention half-block of a frozen tower block, for Hopper (sm_90a): kernel B4.
//
//     out = x + [gamma *] proj(attention(qkv(norm(x))))
//
// Replaces the Pallas TPU kernel mdt_policy_tpu/ops/attention_halfblock.py
// (attention_halfblock, _kernel). x (B, T, C) bf16; norm RMS (Voltron) or
// LayerNorm (CLIP) with its gain and optional bias; w_qkv (3C, C) and
// w_proj (C, C) are torch Linear weights, as the towers hold them; gamma is
// the LayerScale vector or null.
//
// Three launches on one stream, with nothing between them:
//   1. halfblock_gemm (norm prologue, bias epilogue)    x -> qkv (B*T, 3C)
//   2. the attention core, B1's body: halfblock_attention_sm90_kernel
//      (attention_sm90.cuh) where the wrapper's `sm90` flag says the call lies
//      in its domain (64-wide heads, T <= 208: every tower), else
//      halfblock_attention_kernel (mha_core.cuh)       qkv -> att (B*T, C)
//   3. halfblock_gemm (residual epilogue: + b_proj, * gamma, + x)  att -> out
// qkv and att are scratch that the wrapper allocates. One CLIP image's
// normalized rows (197 x 768 bf16, 303 KB) do not fit in a block's shared
// memory, so the chain goes through device memory (and mostly L2) instead of
// one fused kernel. The Pallas kernel rounds each head's attention output to
// bf16 before its partial projection and sums the heads in f32; rounding the
// whole attention output and running one f32-accumulated projection is the
// same arithmetic in another summation order.
//
// What bounds it on the H100: 8*T*C^2 + 4*T^2*C FLOP per image against
// ~4*T*C bytes of input and output: the tensor cores (see halfblock_gemm.cuh
// and, for the attention core, attention_sm90.cuh).

#include "attention_sm90.cuh"
#include "halfblock_gemm.cuh"
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

// Dynamic shared memory of the attention launch (the largest of the three).
size_t mdt_attention_halfblock_smem_bytes(int seq, int C, int H, int sm90) {
  const size_t att = sm90 ? attn90::smem_bytes(seq) : mha::smem_bytes<__nv_bfloat16>(seq, C / H);
  const size_t gemm = hbgemm::smem_bytes();
  return att > gemm ? att : gemm;
}

// Launches the three kernels on `stream`; returns the first non-zero
// cudaGetLastError(), or 0.
int mdt_attention_halfblock(const void* x, const void* g, const void* b, const void* w_qkv,
                            const void* b_qkv, const void* w_proj, const void* b_proj,
                            const void* gamma, void* qkv, void* att, void* out, int B, int T,
                            int C, int H, int norm_is_ln, float eps, int causal, int sm90,
                            void* stream) {
  using hbgemm::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  hbgemm::Args in{};
  in.a = static_cast<const bf16*>(x);
  in.w = static_cast<const bf16*>(w_qkv);
  in.bias = static_cast<const bf16*>(b_qkv);
  in.g = static_cast<const bf16*>(g);
  in.b = static_cast<const bf16*>(b);
  in.out = static_cast<bf16*>(qkv);
  in.M = M;
  in.K = C;
  in.n_out = 3 * C;
  in.eps = eps;
  in.norm_scale = hbgemm::inv_sqrt(C);
  int rc = hbgemm::launch_norm_gemm<hbgemm::kBias>(in, norm_is_ln, s);
  if (rc != 0) return rc;

  rc = sm90 ? attn90::launch(halfblock_attention_sm90_kernel<attn90::kShortSteps>,
                             halfblock_attention_sm90_kernel<attn90::kMaxSteps>, qkv, att, B,
                             T, C, H, causal, s)
            : mha::launch_mha<__nv_bfloat16>(halfblock_attention_kernel, qkv, att, B, T, C,
                                             H, causal, s);
  if (rc != 0) return rc;

  hbgemm::Args pr{};
  pr.a = static_cast<const bf16*>(att);
  pr.w = static_cast<const bf16*>(w_proj);
  pr.bias = static_cast<const bf16*>(b_proj);
  pr.res = static_cast<const bf16*>(x);
  pr.gamma = static_cast<const bf16*>(gamma);
  pr.out = static_cast<bf16*>(out);
  pr.M = M;
  pr.K = C;
  pr.n_out = C;
  return hbgemm::launch_gemm<hbgemm::kPlain, hbgemm::kResidual>(pr, s);
}

}  // extern "C"
