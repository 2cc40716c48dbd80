"""Share of the text tower's rows that carried a changed goal (%): 100 x
the program's counter `policy.goal_rows_changed` over
`policy.goal_rows_encoded`, summed over the traced window's ticks. The
batched evaluator encodes every env's goal when any one changes, so the
rest is work a per-env goal cache would not do. Counted in the traced
window, which the device profile slows by 4-10 %; the counts do not
depend on the speed."""
from port_bench.harness.program_spans import units


def read(obs):
    ticks = units(obs, "pb.tick")
    encoded = sum(u.counts.get("policy.goal_rows_encoded", 0) for u in ticks)
    changed = sum(u.counts.get("policy.goal_rows_changed", 0) for u in ticks)
    return 100.0 * changed / encoded if encoded else None
