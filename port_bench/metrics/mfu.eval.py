"""The whole evaluator tick's share of the card's peak (%): the FLOPs by
dtype of the tick's replan and of its text-tower encodes (the measured
encodes a tick), each over its dtype's peak, over the untraced window's
mean tick time."""
from port_bench.harness import flops as Fl
from port_bench.harness.readers import unit_s


def read(obs):
    f, per, ticks = getattr(obs["runner"], "tick_flops", None), unit_s(obs), obs.get("ticks")
    if not f or not per or not ticks:
        return None
    encodes = obs["b1_launches"] / obs["text_layers"] / ticks
    return 100.0 * (Fl.least_time_s(f["replan"]) + encodes * Fl.least_time_s(f["text"])) / per
