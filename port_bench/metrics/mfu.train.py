"""The whole train step's share of the card's peak (%): its FLOPs by dtype
(counted by the harness over one step, B1's from its shapes), each over
its dtype's peak, over the untraced window's mean step time."""
from port_bench.harness import flops as Fl
from port_bench.harness.readers import unit_s


def read(obs):
    f, per = getattr(obs["runner"], "step_flops", None), unit_s(obs)
    if not f or not per:
        return None
    return 100.0 * Fl.least_time_s(f) / per
