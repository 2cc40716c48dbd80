"""The port's microbenches: `perf_probe.chain_bench` and the two
attention-variant microbenches (`attn_kernel_experiment`, V1;
`attn_kernel_round3`, V3), copies of the JAX repository's `tools/` for
PyTorch on the H100."""
