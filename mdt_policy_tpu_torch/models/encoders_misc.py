"""Small perceptual encoders and time embeddings (port of
`mdt_policy_tpu/models/encoders_misc.py`):

* `NoEncoder`: identity; an agent reads it as "this head is off".
* `VisionClipHead`: a frozen CLIP image tower (ViT through kernels B1 and
  B3, or the RN50 family's `CLIPResNetTower`) and a trainable ReLU head
  (ref vision_clip.py:8-31).
* `CLIPVisionTokens`: the CLIP ViT's token grid without pooling (ref
  vision_clip.py:50-64); its `ln_pre` is a flax default LayerNorm (eps
  1e-6), through B3 as the towers' other norms.
* `VoltronMAPEncoder`: the frozen Voltron ViT (`vcond`) and a trainable
  MAP pooling head (`vector_extractor`, ref voltron_encoder.py:21-70).
* `GaussianFourierEmbedding`, `FourierFeatures`, `SinusoidalTimeEmbedding`:
  the EDM utils' time embeddings (ref edm_diffusion/utils.py:22-115). The
  random features are parameters, as in JAX (so `from_jax` carries them),
  and are detached in the forward pass.

The frozen towers' outputs are detached; a head takes them in its own
weights' dtype, so a bf16 tower feeds a float32 head as flax's promotion
does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import MAPBlock, SinusoidalPosEmb, TowerLayerNorm, mish
from .clip import CLIPResNetTower, CLIPVisionTower, _Transformer
from .voltron_vit import VoltronViT

__all__ = ["NoEncoder", "VisionClipHead", "CLIPVisionTokens", "VoltronMAPEncoder",
           "GaussianFourierEmbedding", "FourierFeatures", "SinusoidalTimeEmbedding"]


class NoEncoder(nn.Module):
    """Identity passthrough; `isinstance(x, NoEncoder)` turns the matching
    auxiliary loss off."""

    def forward(self, x=None, *args, **kwargs):
        return x


class VisionClipHead(nn.Module):
    """Frozen CLIP image tower + Linear-ReLU-Linear head. `family` "vit"
    (ViT-B/32 widths in the reference: fc1 256 wide) or "resnet" (the
    reference's RN50 default: fc1 512 wide); `tower_kwargs` go to the
    tower. Images NHWC, CLIP-normalized, in the tower's dtype."""

    def __init__(self, visual_features: int = 64, clip_embed_dim: int = 512,
                 family: str = "vit", tower_kwargs: Optional[dict] = None):
        super().__init__()
        if family == "resnet":
            self.clip = CLIPResNetTower(embed_dim=clip_embed_dim, **(tower_kwargs or {}))
            fc1_width = 512
        elif family == "vit":
            self.clip = CLIPVisionTower(embed_dim=clip_embed_dim, **(tower_kwargs or {}))
            fc1_width = 256
        else:
            raise ValueError(f"unknown CLIP family {family!r}; expected 'vit' or 'resnet'")
        self.fc1 = nn.Linear(clip_embed_dim, fc1_width)
        self.fc2 = nn.Linear(fc1_width, visual_features)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.clip(images).detach().to(self.fc1.weight.dtype)
        return self.fc2(F.relu(self.fc1(x)))


class CLIPVisionTokens(nn.Module):
    """images (B, H, W, 3), CLIP-normalized -> the token grid
    (B, 1 + n_patches, width) in the weights' dtype: the CLIP ViT without
    `ln_post` and the projection. Heads: width // 64. Keys as
    `CLIPVisionTower`'s."""

    def __init__(self, width: int = 768, layers: int = 12, patch_size: int = 16,
                 image_resolution: int = 224):
        super().__init__()
        n_pos = (image_resolution // patch_size) ** 2 + 1
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(n_pos, width))
        self.ln_pre = TowerLayerNorm(width, eps=1e-6)
        self.transformer = _Transformer(width, layers, max(width // 64, 1), causal=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.conv1(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding[None]
        return self.transformer(self.ln_pre(x))


class VoltronMAPEncoder(nn.Module):
    """Frozen Voltron tokens (`vcond`, a `VoltronViT` of `vit_kwargs`) pooled
    by a trainable MAPBlock with 8 heads to `latent_dim`."""

    def __init__(self, latent_dim: int = 512, n_latents: int = 1,
                 vit_kwargs: Optional[dict] = None):
        super().__init__()
        self.vcond = VoltronViT(**(vit_kwargs or {}))
        embed_dim = self.vcond.encoder_norm.normalized_shape[0]
        self.vector_extractor = MAPBlock(n_latents, embed_dim, 8, output_dim=latent_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        tokens = self.vcond(images).detach()
        return self.vector_extractor(tokens.to(self.vector_extractor.latents.dtype))


class GaussianFourierEmbedding(nn.Module):
    """Fixed Gaussian random features (`W`, N(0, scale)) -> sin, cos ->
    Linear-Mish-Linear."""

    def __init__(self, time_embed_dim: int, scale: float = 30.0):
        super().__init__()
        self.W = nn.Parameter(torch.randn(time_embed_dim // 2) * scale)
        self.fc1 = nn.Linear(time_embed_dim, 2 * time_embed_dim)
        self.fc2 = nn.Linear(2 * time_embed_dim, time_embed_dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        proj = t[..., None] * self.W.detach() * 2 * math.pi
        h = torch.cat([proj.sin(), proj.cos()], dim=-1)
        return self.fc2(mish(self.fc1(h)))


class FourierFeatures(nn.Module):
    """Unit-normal Fourier features: [cos, sin](2 pi t W^T), `weight`
    (time_embed_dim // 2, in_features). flax infers `in_features` from the
    input; here it is given."""

    def __init__(self, time_embed_dim: int, in_features: int = 1, std: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(time_embed_dim // 2, in_features) * std)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        if t.ndim == 1:
            t = t[:, None]
        f = 2 * math.pi * t @ self.weight.detach().T
        return torch.cat([f.cos(), f.sin()], dim=-1)


class SinusoidalTimeEmbedding(nn.Module):
    """Sinusoidal embedding -> Linear-Mish-Linear."""

    def __init__(self, time_embed_dim: int):
        super().__init__()
        self.sin = SinusoidalPosEmb(time_embed_dim)
        self.fc1 = nn.Linear(time_embed_dim, 2 * time_embed_dim)
        self.fc2 = nn.Linear(2 * time_embed_dim, time_embed_dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.fc2(mish(self.fc1(self.sin(t))))
