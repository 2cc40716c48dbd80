"""Device idle share (%): 100 - the device's busy time of an evaluator tick in
the traced window over its untraced time (`readers.idle_share`)."""
from port_bench.harness.readers import idle_share as read  # noqa: F401
