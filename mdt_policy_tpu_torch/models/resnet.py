"""ResNet-18 with GroupNorm, the MDT per-camera encoder (port of
`mdt_policy_tpu/models/resnet.py`), with the reference's `state_dict` key
layout (the one `port_resnet18_gn` of `mdt_policy_tpu/utils/torch_port.py`
reads): the torchvision trunk as an `nn.Sequential` (0 conv1, 1 norm, 2 relu,
3 max-pool, 4-7 layer1-4, 8 average pool) and the head `fc_layers.0`.

Every BatchNorm of torchvision's resnet18 is a GroupNorm of C/16 groups,
eps 1e-5, statistics in float32. torch groups consecutive channels of the
channel axis, as flax does on the last axis of NHWC, so the groups match.
The public functions take NHWC images, as in JAX; inside, the convolutions
run on NCHW in the `channels_last` memory format (NHWC in memory).
A float32 convolution on the card runs in TF32 unless
`torch.backends.cudnn.allow_tf32` is False; the comparisons in
`chip_smoke.py` set it so.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["BasicBlock", "ResNet18GN", "BesoResNetEncoder", "SpatialSoftmax"]


class GroupNorm(nn.GroupNorm):
    """GroupNorm(C/16 groups, eps 1e-5) with float32 statistics and affine."""

    def __init__(self, channels: int):
        super().__init__(channels // 16, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


class BasicBlock(nn.Module):
    """conv3x3-GN-relu-conv3x3-GN plus the (1x1 conv, GN) shortcut when the
    stride or the width changes, then relu."""

    def __init__(self, cin: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, channels, 3, stride)
        self.bn1 = GroupNorm(channels)
        self.conv2 = _conv(channels, channels, 3)
        self.bn2 = GroupNorm(channels)
        self.downsample = nn.Sequential(_conv(cin, channels, 1, stride), GroupNorm(channels)) \
            if stride != 1 or cin != channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet18GN(nn.Sequential):
    """Headless resnet18 trunk with GroupNorm: NHWC (B, H, W, 3) -> (B, 512)."""

    def __init__(self, stage_sizes=(2, 2, 2, 2), channels=(64, 128, 256, 512)):
        stages, cin = [], 64
        for stage, (blocks, ch) in enumerate(zip(stage_sizes, channels)):
            layer = []
            for b in range(blocks):
                layer.append(BasicBlock(cin, ch, 2 if (b == 0 and stage > 0) else 1))
                cin = ch
            stages.append(nn.Sequential(*layer))
        super().__init__(_conv(3, 64, 7, 2), GroupNorm(64), nn.ReLU(),
                         nn.MaxPool2d(3, stride=2, padding=1), *stages,
                         nn.AdaptiveAvgPool2d(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return super().forward(x).flatten(1)


class BesoResNetEncoder(nn.Module):
    """ResNet18-GN trunk and a linear head to `latent_dim` (ref
    resnets.py:100-155): (B, H, W, 3) -> (B, latent) or (B, T, H, W, 3) ->
    (B, T, latent)."""

    def __init__(self, latent_dim: int = 512):
        super().__init__()
        self.backbone = ResNet18GN()
        self.fc_layers = nn.Sequential(nn.Linear(512, latent_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        feats = self.fc_layers(self.backbone(x.reshape((-1,) + tuple(x.shape[-3:]))))
        return feats.reshape(tuple(lead) + (feats.shape[-1],))


class SpatialSoftmax(nn.Module):
    """Spatial-softmax keypoints (ref resnets.py:62-96): per channel a
    softmax over H*W and the expected (x, y) in [-1, 1]:
    (B, H, W, C) -> (B, 2C), x and y interleaved per channel."""

    def __init__(self, temperature: float = 1.0):
        super().__init__()
        self.temperature = temperature

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        pos_x, pos_y = torch.meshgrid(torch.linspace(-1.0, 1.0, W, device=x.device),
                                      torch.linspace(-1.0, 1.0, H, device=x.device),
                                      indexing="xy")
        attn = torch.softmax(x.permute(0, 3, 1, 2).reshape(B * C, H * W) / self.temperature,
                             dim=1)
        ex = (pos_x.reshape(-1) * attn).sum(1)
        ey = (pos_y.reshape(-1) * attn).sum(1)
        return torch.stack([ex, ey], dim=1).reshape(B, C * 2)
