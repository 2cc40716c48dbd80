"""Kernel B1's share of its roofline in the train step (%): the least time
of the traced window's B1 calls (bytes over HBM bandwidth or FLOPs over
the bf16 peak, from the call shapes) over their device time by kernel
name."""
from port_bench.harness import flops as Fl
from port_bench.harness.readers import roofline


def read(obs):
    calls = obs["runner"].b1_calls()
    return roofline(obs, lambda n: "fused_qkv_attention_kernel" in n,
                    sum(Fl.b1_least_s(*c) for c in calls), len(calls), obs.get("steps", 0))
