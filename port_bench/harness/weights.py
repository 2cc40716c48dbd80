"""Seeded weights, made on the device in one draw and handed to both the
program and the reference.

`make_weights` draws one N(0, 1) vector for every parameter of the net
(in `named_parameters` order) from a generator seeded by `seed`, and
scales each slice by the parameter's rule: biases 0, norm gains 1,
LayerScale 0.1, `logit_scale` log(1/0.07), latents and learned frame
embeddings N(0, 1), convolutions N(0, 1/fan_in), the CLIP projections
N(0, 1/width), position tables N(0, 0.01), everything else N(0, 0.02).
The result is float32; a net that holds a tower in bfloat16 rounds it
when the weights are loaded, and the reference rounds its copy the same
way (`stored_dtype`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

NORMS = ("LayerNorm", "TowerLayerNorm", "GroupNorm", "RMSNorm", "FrozenBatchNorm2d")


def rule(name: str, owner_cls: str, shape) -> Tuple[str, float]:
    """("const", value) or ("normal", std) for one parameter."""
    leaf = name.rpartition(".")[2]
    if leaf == "bias":
        return "const", 0.0
    if owner_cls in NORMS:
        return "const", 1.0
    if owner_cls == "LayerScale":
        return "const", 0.1
    if leaf == "logit_scale":
        return "const", math.log(1 / 0.07)
    if leaf in ("latents", "time_pos_emb", "ctx_dec_pe"):
        return "normal", 1.0
    if owner_cls == "Conv2d":
        return "normal", math.prod(shape[1:]) ** -0.5
    if leaf in ("text_projection", "proj") and len(shape) == 2 and owner_cls.startswith("CLIP"):
        return "normal", shape[0] ** -0.5
    if leaf == "positional_embedding":
        return "normal", 0.01
    return "normal", 0.02


def layout(net) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, value) of every parameter, in order."""
    modules = dict(net.named_modules())
    out = []
    for name, p in net.named_parameters():
        owner = modules[name.rpartition(".")[0]] if "." in name else net
        kind, v = rule(name, type(owner).__name__, tuple(p.shape))
        out.append((name, tuple(p.shape), kind, v))
    return out


def draw(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The float32 weights of `layout(net)` for `seed`, on `device`."""
    gen = torch.Generator(device).manual_seed(seed)
    total = sum(math.prod(s) for _, s, _, _ in spec)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, v in spec:
        n = math.prod(shape)
        piece = flat[at:at + n].view(shape)
        out[name] = piece.mul(v) if kind == "normal" else torch.full(shape, v, device=device)
        at += n
    return out


@torch.no_grad()
def load(net, weights: Dict[str, torch.Tensor]) -> None:
    for name, p in net.named_parameters():
        p.copy_(weights[name])


def stored_dtype(weights: Dict[str, torch.Tensor], bf16_prefixes) -> Dict[str, torch.Tensor]:
    """The weights as the configuration stores them: those under
    `bf16_prefixes` rounded to bfloat16, as float32 tensors."""
    return {k: v.to(torch.bfloat16).float() if k.split(".", 1)[0] in bf16_prefixes else v
            for k, v in weights.items()}
