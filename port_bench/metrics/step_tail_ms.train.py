"""Host ms a train step spends in the program's `train.tail` span, after
the backward pass: the gradients' zero fill, their norm, AdamW, the
parameters' norm and the EMA, each a loop over the trainable tensors; as
a mean over the traced window's steps. Issue time, not device time. A
traced-window reading: the device profile slows a step by 1-20 %."""
from port_bench.harness.program_spans import step_ms


def read(obs):
    return step_ms(obs, "train.tail")
