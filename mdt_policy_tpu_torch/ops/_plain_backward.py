"""A kernel's forward with the derivatives of its plain version, for every
kernel of the port, as the TPU kernels' custom VJPs differentiate their XLA
references: the backward (reverse mode) and the forward-mode product of
`torch.func.jvp` both go through the plain version."""

from __future__ import annotations

import torch
from torch._C._functorch import is_functorch_wrapped_tensor


class PlainBackward(torch.autograd.Function):
    """apply(launch, reference, kwargs, *tensors): the forward is
    `launch(*tensors, **kwargs)`; the backward is autograd through
    `reference(*tensors, **kwargs)`, and so is the forward-mode product. A
    tensor may be None."""

    @staticmethod
    def forward(launch, reference, kwargs, *tensors):
        return launch(*tensors, **kwargs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, reference, kwargs, *tensors = inputs
        ctx.save_for_backward(*tensors)
        ctx.save_for_forward(*tensors)
        ctx.reference, ctx.kwargs = reference, kwargs

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

    @staticmethod
    def jvp(ctx, _launch, _reference, _kwargs, *tangents):
        primals = ctx.saved_tensors
        live = [i for i, t in enumerate(primals) if t is not None and
                tangents[i] is not None]

        def plain(*xs):
            full = list(primals)
            for i, x in zip(live, xs):
                full[i] = x
            return ctx.reference(*full, **ctx.kwargs)
        return torch.func.jvp(plain, tuple(primals[i] for i in live),
                              tuple(tangents[i] for i in live))[1]


def launch_with_plain_backward(launch, reference, kwargs, *tensors):
    """`launch(*tensors, **kwargs)`, through `PlainBackward` only where
    autograd records the call (grad mode on and an input that requires a
    gradient) or an input is a `torch.func` transform's wrapper (a
    forward-mode tangent of `torch.func.jvp`): a call under `no_grad`, or on
    frozen inputs, pays for no autograd Function. `torch.autograd.forward_ad`
    dual tensors are not supported."""
    live = [t for t in tensors if t is not None]
    if (torch.is_grad_enabled() and any(t.requires_grad for t in live)) \
            or any(is_functorch_wrapped_tensor(t) for t in live):
        return PlainBackward.apply(launch, reference, kwargs, *tensors)
    return launch(*tensors, **kwargs)
