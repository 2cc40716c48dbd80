// Head-pair attention over the packed qkv projection with the round-3
// options, for Hopper (sm_90a): kernel V3, a variant of B1 for measurement.
//
// Replaces the Pallas TPU kernel tools/attn_kernel_round3.py (make_pair_v3)
// of the JAX repository. The contract, the options, the design and what
// bounds it on the H100 are written at the top of pair_attention.cuh, which
// holds the body shared with V1 (attn_pair_grid.cu). The options are template
// parameters: one instantiation for each combination the TPU kernel's
// branches tell apart (no_max only under mxu_sum, bf16_softmax only without).

#include "pair_attention.cuh"

namespace {

template <int FLAGS>
__global__ void __launch_bounds__(pair::kThreads, 2)
attn_pair_v3_kernel(const pair::bf16* __restrict__ qkv, pair::bf16* __restrict__ out,
                    int B, int seq, int C, int block_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  pair::pair_block<FLAGS>(qkv, out, B, seq, C, block_b, smem);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper checks it against the
// launch's budget before launching.
size_t mdt_attn_pair_smem_bytes(int seq) { return pair::smem_bytes(seq); }

// Launches on `stream` with the option bits `flags` (pair::Flags); returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a
// combination the wrapper never passes.
int mdt_attn_pair_v3(const void* qkv, void* out, int B, int seq, int C, int block_b,
                     int flags, void* stream) {
  using namespace pair;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](void (*kernel)(const bf16*, bf16*, int, int, int, int)) {
    return launch_pair(kernel, qkv, out, B, seq, C, block_b, s);
  };
  switch (flags) {
    case 0: return go(attn_pair_v3_kernel<0>);
    case kExp2: return go(attn_pair_v3_kernel<kExp2>);
    case kBf16Softmax: return go(attn_pair_v3_kernel<kBf16Softmax>);
    case kExp2 | kBf16Softmax: return go(attn_pair_v3_kernel<kExp2 | kBf16Softmax>);
    case kMxuSum: return go(attn_pair_v3_kernel<kMxuSum>);
    case kMxuSum | kExp2: return go(attn_pair_v3_kernel<kMxuSum | kExp2>);
    case kMxuSum | kNoMax: return go(attn_pair_v3_kernel<kMxuSum | kNoMax>);
    case kMxuSum | kExp2 | kNoMax: return go(attn_pair_v3_kernel<kMxuSum | kExp2 | kNoMax>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
