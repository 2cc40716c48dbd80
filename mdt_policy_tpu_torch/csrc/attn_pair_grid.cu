// Head-pair attention over the packed qkv projection, for Hopper (sm_90a):
// kernel V1, a variant of B1 for measurement.
//
// Replaces the Pallas TPU kernel tools/attn_kernel_experiment.py
// (make_pair_grid) of the JAX repository: B1's non-causal math on an (image
// block, head pair) grid. The contract, the design and what bounds it on the
// H100 are written at the top of pair_attention.cuh, which holds the body
// shared with V3 (attn_pair_v3.cu); this entry runs it without options.

#include "pair_attention.cuh"

namespace {

__global__ void __launch_bounds__(pair::kThreads, 2)
attn_pair_grid_kernel(const pair::bf16* __restrict__ qkv, pair::bf16* __restrict__ out,
                      int B, int seq, int C, int block_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  pair::pair_block<0>(qkv, out, B, seq, C, block_b, smem);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper checks it against the
// launch's budget before launching.
size_t mdt_attn_pair_smem_bytes(int seq) { return pair::smem_bytes(seq); }

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int mdt_attn_pair_grid(const void* qkv, void* out, int B, int seq, int C, int block_b,
                       void* stream) {
  return pair::launch_pair(attn_pair_grid_kernel, qkv, out, B, seq, C, block_b,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
