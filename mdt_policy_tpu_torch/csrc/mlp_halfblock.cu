// MLP half-block of a frozen tower block, for Hopper (sm_90a): kernel B5.
//
//     out = x + [gamma *] W2(act(W1(norm(x))))
//
// Replaces the Pallas TPU kernel mdt_policy_tpu/ops/mlp_halfblock.py
// (mlp_halfblock, _kernel). x (M, C) bf16 rows; norm RMS (Voltron) or
// LayerNorm (CLIP); act "swishglu" (Voltron: W1 packs [proj | gate], 2H rows,
// act = proj * silu(gate)) or "quickgelu" (CLIP: act = h * sigmoid(1.702 h));
// w1 (2H or H, C) and w2 (C, H) are torch Linear weights; gamma the
// LayerScale vector or null.
//
// Two launches on one stream, with nothing between them:
//   1. halfblock_gemm (norm prologue, bias + activation epilogue)  x -> h (M, H)
//   2. halfblock_gemm (residual epilogue: + b2, * gamma, + x)      h -> out
// h is scratch that the wrapper allocates. The Pallas kernel walks the hidden
// axis in tiles and sums act(tile) @ W2[tile] in f32; here the hidden
// activations are rounded to bf16 whole and W2 runs as one f32-accumulated
// product: the same arithmetic in another summation order. For SwishGLU a
// block's W tile holds 64 proj rows and the 64 gate rows of the same hidden
// columns, so both halves of a column meet in one thread's epilogue.
//
// What bounds it on the H100: 2*T*C*(rows of W1 + H) FLOP per image, 6*T*C*H
// for SwishGLU and 4*T*C*H for QuickGELU, against ~4*T*C bytes of input and
// output: the tensor cores (see halfblock_gemm.cuh).

#include "halfblock_gemm.cuh"

extern "C" {

size_t mdt_mlp_halfblock_smem_bytes() { return hbgemm::smem_bytes(); }

// Launches the two kernels on `stream`; returns the first non-zero
// cudaGetLastError(), or 0.
int mdt_mlp_halfblock(const void* x, const void* g, const void* b, const void* w1,
                      const void* b1, const void* w2, const void* b2, const void* gamma,
                      void* h, void* out, int M, int C, int H, int norm_is_ln,
                      int act_is_swishglu, float eps, void* stream) {
  using hbgemm::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hbgemm::Args up{};
  up.a = static_cast<const bf16*>(x);
  up.w = static_cast<const bf16*>(w1);
  up.bias = static_cast<const bf16*>(b1);
  up.g = static_cast<const bf16*>(g);
  up.b = static_cast<const bf16*>(b);
  up.out = static_cast<bf16*>(h);
  up.M = M;
  up.K = C;
  up.n_out = H;
  up.eps = eps;
  up.norm_scale = hbgemm::inv_sqrt(C);
  const int rc = act_is_swishglu
                     ? hbgemm::launch_norm_gemm<hbgemm::kSwiGlu>(up, norm_is_ln, s)
                     : hbgemm::launch_norm_gemm<hbgemm::kQuickGelu>(up, norm_is_ln, s);
  if (rc != 0) return rc;

  hbgemm::Args down{};
  down.a = static_cast<const bf16*>(h);
  down.w = static_cast<const bf16*>(w2);
  down.bias = static_cast<const bf16*>(b2);
  down.res = static_cast<const bf16*>(x);
  down.gamma = static_cast<const bf16*>(gamma);
  down.out = static_cast<bf16*>(out);
  down.M = M;
  down.K = H;
  down.n_out = C;
  return hbgemm::launch_gemm<hbgemm::kPlain, hbgemm::kResidual>(down, s);
}

}  // extern "C"
