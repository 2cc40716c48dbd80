"""A kernel's forward with the backward of its plain version, for every
kernel of the port, as the TPU kernels' custom VJPs differentiate their XLA
references."""

from __future__ import annotations

import torch


class PlainBackward(torch.autograd.Function):
    """apply(launch, reference, kwargs, *tensors): the forward is
    `launch(*tensors, **kwargs)`; the backward is autograd through
    `reference(*tensors, **kwargs)`. A tensor may be None."""

    @staticmethod
    def forward(ctx, launch, reference, kwargs, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.reference, ctx.kwargs = reference, kwargs
        return launch(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            y = ctx.reference(*inputs, **ctx.kwargs)
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, grad) if wanted else ())
        return (None, None, None, *(next(grads) if t is not None and t.requires_grad
                                    else None for t in inputs))


def launch_with_plain_backward(launch, reference, kwargs, *tensors):
    """`launch(*tensors, **kwargs)`, through `PlainBackward` only where
    autograd records the call (grad mode on and an input that requires a
    gradient): a call under `no_grad`, or on frozen inputs, pays for no
    autograd Function."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return PlainBackward.apply(launch, reference, kwargs, *tensors)
    return launch(*tensors, **kwargs)
