"""FLOPs inside the hand attention kernel B1, which an op counter cannot see
(port of `mdt_policy_tpu/utils/flops.py`).

`torch.utils.flop_counter.FlopCounterMode` counts the matmuls of the aten
ops a step dispatches; a ctypes launch of `csrc/fused_qkv_attention.cu`
dispatches none. On the card, then, a step's FLOPs are the counter's plus
these. B1 computes Q.K^T and P.V: 2 T^2 C multiply-adds, 4 T^2 C FLOPs, an
image a layer (the softmax's exponentials are not matmul work, and the
counter does not count them on the plain route either). The towers are
frozen, so each runs forward only, once a step.

The JAX package returns 0 where its Pallas kernel is not routed, because
XLA then counts the einsum itself. The port's B1 runs whenever the
tensors are on CUDA and its plain version, which the counter does see, on
the CPU; so these functions take the step's `device` and return 0 off
CUDA.
"""

from __future__ import annotations

import torch

__all__ = ["attention_matmul_flops", "tower_custom_call_flops",
           "mdt_tower_custom_call_flops"]


def attention_matmul_flops(batch: int, seq: int, channels: int, layers: int = 1) -> float:
    """FLOPs of Q.K^T and P.V for `layers` attention layers over `batch`
    sequences of `seq` tokens, model width `channels` (heads x head width)."""
    return 4.0 * batch * seq * seq * channels * layers


def _routed(device) -> bool:
    return torch.device(device).type == "cuda"


def tower_custom_call_flops(cfg, B: int, device="cuda") -> float:
    """FLOPs inside B1 in one MDT-V train step at B samples a stream:
    the Voltron ViT over 2 cameras x 2 streams x B images ((img/patch)^2
    tokens, `perceiver_dim` wide, `vit_depth` layers), and the CLIP goal
    towers (`_clip_goal_tower_flops`). 0 off CUDA."""
    if not _routed(device):
        return 0.0
    n_vit = (cfg.img_size // cfg.vit_patch) ** 2
    return (attention_matmul_flops(4 * B, n_vit, cfg.perceiver_dim, cfg.vit_depth)
            + _clip_goal_tower_flops(cfg, B))


def _clip_goal_tower_flops(cfg, B: int) -> float:
    """B1's FLOPs in the frozen CLIP goal towers of either family: the ViT
    over 2 streams x B goal frames ((img/patch)^2 + 1 tokens) and the text
    tower over the language stream's B sentences. The RN50 family's goal
    tower runs convolutions and `sdpa`, not B1."""
    vision = 0.0
    if getattr(cfg, "clip_vision_family", "vit") != "resnet":
        n_clip = (cfg.img_size // cfg.clip_vision_patch) ** 2 + 1
        vision = attention_matmul_flops(2 * B, n_clip, cfg.clip_vision_width,
                                        cfg.clip_vision_layers)
    return vision + attention_matmul_flops(B, cfg.clip_context_length, cfg.clip_text_width,
                                           cfg.clip_text_layers)


def mdt_tower_custom_call_flops(cfg, B: int, device="cuda") -> float:
    """FLOPs inside B1 in one MDT train step at B samples a stream: its
    CLIP goal towers only (the trainable ResNets are cuDNN convolutions,
    which the counter sees). 0 off CUDA."""
    if not _routed(device):
        return 0.0
    return _clip_goal_tower_flops(cfg, B)
