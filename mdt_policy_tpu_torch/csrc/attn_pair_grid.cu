// Head-pair attention over the packed qkv projection, for Hopper (sm_90a):
// kernel V1, a variant of B1 for measurement.
//
// Replaces the Pallas TPU kernel tools/attn_kernel_experiment.py
// (make_pair_grid) of the JAX repository: B1's non-causal bf16 math on an
// (image block, head pair) grid. It runs B1's tensor-core body,
// attention_sm90.cuh (contract, design and what bounds it in its header),
// without options (FLAGS = 0) and with the items in the pair grid's order
// (attn90::PairGrid): block_b changes only which (image, head) items run
// side by side, not the shared memory. V3 (attn_pair_v3.cu) is the same
// body with its options.

#include "attention_sm90.cuh"

namespace {

template <int NS>
__global__ void __launch_bounds__(attn90::kThreads, 1)
attn_pair_grid_kernel(const __grid_constant__ CUtensorMap map_kv,
                      const __grid_constant__ CUtensorMap map_q, attn90::bf16* __restrict__ out,
                      int B, int seq, int C, int H, int block_b) {
  extern __shared__ __align__(128) unsigned char smem_sm90[];
  attn90::attention_block<NS, 0>(&map_kv, &map_q, out, B, seq, C, H, attn90::opaque(0),
                                 smem_sm90, attn90::PairGrid{block_b});
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper checks it against the
// launch's budget before launching.
size_t mdt_attn_pair_smem_bytes(int seq) { return attn90::smem_bytes(seq); }

// Launches on `stream` (bf16, C = 64 H, H even, 1 <= T <= 208, 16-byte
// aligned qkv); returns the first error (0 on success).
int mdt_attn_pair_grid(const void* qkv, void* out, int B, int seq, int C, int H, int block_b,
                       void* stream) {
  return attn90::launch(attn_pair_grid_kernel<attn90::kShortSteps>,
                        attn_pair_grid_kernel<attn90::kMaxSteps>, qkv, out, B, seq, C, H,
                        static_cast<cudaStream_t>(stream), block_b);
}

// Registers and local-memory bytes a thread of the kernel a call with `seq`
// rows runs.
int mdt_attn_pair_grid_attributes(int seq, int* regs, int* local_bytes) {
  return attn90::kernel_attributes(attn_pair_grid_kernel<attn90::kShortSteps>,
                                   attn_pair_grid_kernel<attn90::kMaxSteps>, seq, regs,
                                   local_bytes);
}

}  // extern "C"
