"""Host ms a train step spends in the program's `train.forward` spans (one
a scope: the towers, the denoiser, the foresight decoder and the InfoNCE
issued), as a mean over the traced window's steps. The card runs behind
the host, so this is issue time, not device time. A traced-window
reading: the device profile slows a step by 1-20 %."""
from port_bench.harness.program_spans import step_ms


def read(obs):
    return step_ms(obs, "train.forward")
