"""The harness: loading the benchmark by name, weights, traces, FLOPs."""
