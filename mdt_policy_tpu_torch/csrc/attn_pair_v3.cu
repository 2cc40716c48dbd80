// Head-pair attention over the packed qkv projection with the round-3
// options, for Hopper (sm_90a): kernel V3, a variant of B1 for measurement.
//
// Replaces the Pallas TPU kernel tools/attn_kernel_round3.py (make_pair_v3)
// of the JAX repository. It runs B1's tensor-core body, attention_sm90.cuh
// (contract, options, design and what bounds it in its header), with the
// items in the pair grid's order (attn90::PairGrid), as V1
// (attn_pair_grid.cu) does. The options are its template parameter FLAGS:
// one instantiation, at each of the two key-step counts, for each
// combination that the TPU kernel's branches tell apart (no_max only under
// mxu_sum, bf16_softmax only without it).

#include "attention_sm90.cuh"

namespace {

using attn90::bf16;

template <int NS, int FLAGS>
__global__ void __launch_bounds__(attn90::kThreads, 1)
attn_pair_v3_kernel(const __grid_constant__ CUtensorMap map_kv,
                    const __grid_constant__ CUtensorMap map_q, bf16* __restrict__ out, int B,
                    int seq, int C, int H, int block_b) {
  extern __shared__ __align__(128) unsigned char smem_sm90[];
  attn90::attention_block<NS, FLAGS>(&map_kv, &map_q, out, B, seq, C, H, attn90::opaque(0),
                                     smem_sm90, attn90::PairGrid{block_b});
}

using Kernel = decltype(&attn_pair_v3_kernel<attn90::kShortSteps, 0>);

struct Kernels {
  Kernel short_kernel, long_kernel;
};

template <int FLAGS>
Kernels kernels() {
  return {attn_pair_v3_kernel<attn90::kShortSteps, FLAGS>,
          attn_pair_v3_kernel<attn90::kMaxSteps, FLAGS>};
}

// The instantiations of option bits `flags`; false for a combination the
// wrapper never passes.
bool pick(int flags, Kernels* k) {
  using namespace attn90;
  switch (flags) {
    case 0: *k = kernels<0>(); return true;
    case kExp2: *k = kernels<kExp2>(); return true;
    case kBf16Softmax: *k = kernels<kBf16Softmax>(); return true;
    case kExp2 | kBf16Softmax: *k = kernels<kExp2 | kBf16Softmax>(); return true;
    case kMxuSum: *k = kernels<kMxuSum>(); return true;
    case kMxuSum | kExp2: *k = kernels<kMxuSum | kExp2>(); return true;
    case kMxuSum | kNoMax: *k = kernels<kMxuSum | kNoMax>(); return true;
    case kMxuSum | kExp2 | kNoMax: *k = kernels<kMxuSum | kExp2 | kNoMax>(); return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper checks it against the
// launch's budget before launching.
size_t mdt_attn_pair_smem_bytes(int seq) { return attn90::smem_bytes(seq); }

// Launches on `stream` with the option bits `flags` (attn90::Flags) (bf16,
// C = 64 H, H even, 1 <= T <= 208, 16-byte aligned qkv); returns the first
// error (0 on success), cudaErrorInvalidValue for a combination the wrapper
// never passes.
int mdt_attn_pair_v3(const void* qkv, void* out, int B, int seq, int C, int H, int block_b,
                     int flags, void* stream) {
  Kernels k;
  if (!pick(flags, &k)) return static_cast<int>(cudaErrorInvalidValue);
  return attn90::launch(k.short_kernel, k.long_kernel, qkv, out, B, seq, C, H,
                        static_cast<cudaStream_t>(stream), block_b);
}

// Registers and local-memory bytes a thread of the kernel a call with `seq`
// rows and option bits `flags` runs.
int mdt_attn_pair_v3_attributes(int seq, int flags, int* regs, int* local_bytes) {
  Kernels k;
  if (!pick(flags, &k)) return static_cast<int>(cudaErrorInvalidValue);
  return attn90::kernel_attributes(k.short_kernel, k.long_kernel, seq, regs, local_bytes);
}

}  // extern "C"
