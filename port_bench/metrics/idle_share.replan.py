"""Device idle share (%): 100 - the device's busy time of a replan cycle
(the replan and its env steps) in the traced window over its untraced time
(`readers.idle_share`)."""
from port_bench.harness.readers import idle_share as read  # noqa: F401
