"""CLIP towers (port of `mdt_policy_tpu/models/clip.py`): pre-LN
transformers with QuickGELU and packed-qkv attention through kernel B1, every
LayerNorm (eps 1e-5) through kernel B3. With `halfblocks=True` every residual
block runs as the attention half-block B4 and the MLP half-block B5
(`ops/attention_halfblock.py`, `ops/mlp_halfblock.py`); `ln_pre`, `ln_post`
and `ln_final` stay on B3.

* `CLIPTextTower`: causal, pooled at the EOT token (the largest token id).
* `CLIPVisionTower`: ViT over NHWC images, a bias-free conv patchifier, a
  class token, `ln_post` on the class token and `@ proj`.
* `CLIPResNetTower`: CLIP's ModifiedResNet (RN50 family), the goal tower of
  `clip_vision_family="resnet"`: a three-conv stem, anti-aliased
  Bottlenecks with frozen BatchNorm, and attention pooling whose query is
  the mean token alone. The JAX package leaves its convolutions to XLA and
  its pooling attention to the `sdpa` einsum, so here they are cuDNN
  convolutions and the plain `ops/attention.py::sdpa`, in the weights'
  dtype.

`clip_config_from_state_dict` reads a tower's hyperparameters off an
OpenAI checkpoint's shapes; `clip_normalize` takes [0, 1] NHWC images to
CLIP's statistics.

OpenAI's `state_dict` layout (`transformer.resblocks.{i}.attn.in_proj_weight`,
`conv1.weight`, `class_embedding`, `layer1.0.downsample.0.weight`,
`attnpool.q_proj.weight`, ...), the one `port_clip_text`, `port_clip_vision`
and `port_clip_resnet` (without the `visual.` prefix) of the JAX package
read.
"""

from __future__ import annotations

import collections
import re

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sdpa
from ..ops.attention_halfblock import attention_halfblock
from ..ops.fused_qkv_attention import fused_qkv_attention
from ..ops.mlp_halfblock import mlp_halfblock
from .blocks import TowerLayerNorm

__all__ = ["clip_config_from_state_dict", "clip_normalize", "quick_gelu", "ResidualAttentionBlock", "CLIPTextTower",
           "CLIPVisionTower", "FrozenBatchNorm2d", "Bottleneck", "AttentionPool2d",
           "CLIPResNetTower"]


# CLIP's image statistics (also `data/transforms.py`'s, which imports the agents)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_config_from_state_dict(sd) -> dict:
    """The tower hyperparameters of an OpenAI CLIP checkpoint, from its
    tensors' shapes (the reference's `build_model`, clip.py:467-495, with no
    module built). `visual.proj` marks a ViT; otherwise the RN family's
    Bottleneck counts come from the `visual.layerN.*` key numbering and the
    stem width from `visual.layer1.0.conv1`. Grid sides are rounded, as the
    reference does, not truncated."""
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len([k for k in sd if re.fullmatch(
            r"visual\.transformer\.resblocks\.\d+\.attn\.in_proj_weight", k)])
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid
        embed_dim = sd["visual.proj"].shape[1]
    else:
        vision_layers = tuple(
            len(set(re.findall(rf"visual\.layer{b}\.(\d+)", " ".join(sd))))
            for b in (1, 2, 3, 4))
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        vision_patch_size = None
        output_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = output_width * 32
        embed_dim = sd["visual.attnpool.c_proj.weight"].shape[0]
    return dict(
        embed_dim=embed_dim, image_resolution=image_resolution,
        vision_layers=vision_layers, vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=len([k for k in sd if re.fullmatch(
            r"transformer\.resblocks\.\d+\.attn\.in_proj_weight", k)]),
    )


def clip_normalize(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC images -> CLIP-normalized, in the images' dtype."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class _PackedAttention(nn.Module):
    """Parameters of OpenAI's attention (packed in-projection) and its
    application through kernel B1."""

    def __init__(self, width: int, heads: int, causal: bool):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        return self.out_proj(fused_qkv_attention(qkv, self.heads, self.causal))


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.ln_1 = TowerLayerNorm(width, eps=1e-5)
        self.attn = _PackedAttention(width, heads, causal)
        self.ln_2 = TowerLayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x: torch.Tensor, halfblocks: bool = False) -> torch.Tensor:
        if halfblocks:  # B4 then B5, from the block's own weights
            attn, mlp = self.attn, self.mlp
            x = attention_halfblock(x, self.ln_1.weight, self.ln_1.bias,
                                    attn.in_proj_weight, attn.in_proj_bias,
                                    attn.out_proj.weight, attn.out_proj.bias, None,
                                    attn.heads, "ln", self.ln_1.eps, attn.causal)
            return mlp_halfblock(x, self.ln_2.weight, self.ln_2.bias, mlp.c_fc.weight,
                                 mlp.c_fc.bias, mlp.c_proj.weight, mlp.c_proj.bias, None,
                                 "quickgelu", "ln", self.ln_2.eps)
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, causal: bool):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal) for _ in range(layers))

    def forward(self, x: torch.Tensor, halfblocks: bool = False) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, halfblocks)
        return x


class CLIPTextTower(nn.Module):
    """tokens (B, context_length) int -> (B, embed_dim), in the weights' dtype;
    `halfblocks` runs every block as B4 + B5."""

    def __init__(self, embed_dim: int = 512, context_length: int = 77,
                 vocab_size: int = 49408, width: int = 512, heads: int = 8,
                 layers: int = 12):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.transformer = _Transformer(width, layers, heads, causal=True)
        self.ln_final = TowerLayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, tokens: torch.Tensor, halfblocks: bool = False) -> torch.Tensor:
        x = self.token_embedding(tokens) + self.positional_embedding[None]
        x = self.ln_final(self.transformer(x, halfblocks))
        eot = tokens.argmax(dim=-1)  # first occurrence of the largest id
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection


class CLIPVisionTower(nn.Module):
    """images (B, H, W, 3), CLIP-normalized -> (B, embed_dim), in the
    weights' dtype (JAX clip.py:188-223). Heads: width // 64. `halfblocks`
    runs every block as B4 + B5."""

    def __init__(self, embed_dim: int = 512, image_resolution: int = 224,
                 layers: int = 12, width: int = 768, patch_size: int = 16):
        super().__init__()
        n_pos = (image_resolution // patch_size) ** 2 + 1
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(n_pos, width))
        self.ln_pre = TowerLayerNorm(width, eps=1e-5)
        self.transformer = _Transformer(width, layers, max(width // 64, 1),
                                        causal=False)
        self.ln_post = TowerLayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, images: torch.Tensor, halfblocks: bool = False) -> torch.Tensor:
        x = self.conv1(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding[None]
        x = self.transformer(self.ln_pre(x), halfblocks)
        return self.ln_post(x[:, 0]) @ self.proj


class FrozenBatchNorm2d(nn.Module):
    """Inference BatchNorm over NCHW with fixed statistics (JAX
    `_FrozenBatchNorm`, clip.py:262-284): the scale and shift are formed in
    the parameters' dtype, then cast to the input's. `weight`, `bias`,
    `running_mean` and `running_var` as torch's BatchNorm2d names them."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        root = torch.sqrt(self.running_var + self.eps)
        inv = (self.weight / root).to(x.dtype)
        shift = (self.bias - self.running_mean * self.weight / root).to(x.dtype)
        return x * inv[:, None, None] + shift[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """CLIP's anti-aliased Bottleneck (reference clip.py:43-91; JAX
    `_Bottleneck`, :287-315): every conv at stride 1; with stride > 1 an
    average pool after conv2 and at the head of the downsample branch."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), FrozenBatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), FrozenBatchNorm2d(planes)
        self.conv3, self.bn3 = _conv(planes, out, 1), FrozenBatchNorm2d(out)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(collections.OrderedDict([
                ("-1", nn.AvgPool2d(stride)), ("0", _conv(inplanes, out, 1)),
                ("1", FrozenBatchNorm2d(out))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class AttentionPool2d(nn.Module):
    """CLIP's QKV attention pool (reference clip.py:93-130; JAX :318-350):
    tokens [mean; grid] plus learned positions, multi-head attention, the
    attended mean token out through `c_proj`. As in JAX, only the mean
    token's query is formed: the other rows are never read."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # (B, HW, C), row-major over (H, W)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding[None].to(tokens.dtype)
        heads = lambda t: t.reshape(B, -1, self.num_heads, C // self.num_heads)
        out = sdpa(heads(self.q_proj(tokens[:, :1])), heads(self.k_proj(tokens)),
                   heads(self.v_proj(tokens)), layout="bthd")
        return self.c_proj(out.reshape(B, C))


class CLIPResNetTower(nn.Module):
    """images (B, H, W, 3), CLIP-normalized -> (B, embed_dim), in the
    weights' dtype (JAX `CLIPResNetTower`, clip.py:353-381): CLIP's
    ModifiedResNet, NCHW inside. Heads: width * 32 // 64. The towers'
    `halfblocks` flag does not apply to a conv net and is ignored."""

    def __init__(self, embed_dim: int = 1024, layers=(3, 4, 6, 3), width: int = 64,
                 image_resolution: int = 224):
        super().__init__()
        half = width // 2
        self.conv1, self.bn1 = _conv(3, half, 3, stride=2), FrozenBatchNorm2d(half)
        self.conv2, self.bn2 = _conv(half, half, 3), FrozenBatchNorm2d(half)
        self.conv3, self.bn3 = _conv(half, width, 3), FrozenBatchNorm2d(width)
        inplanes = width
        for stage, blocks in enumerate(layers):
            planes = width * 2 ** stage
            stack = []
            for b in range(blocks):
                stack.append(Bottleneck(inplanes, planes, 2 if (b == 0 and stage > 0) else 1))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*stack))
        self.n_stages = len(layers)
        self.attnpool = AttentionPool2d(image_resolution // 32, width * 32,
                                        width * 32 // 64, embed_dim)

    def forward(self, images: torch.Tensor, halfblocks: bool = False) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = F.relu(bn(conv(x)))
        x = F.avg_pool2d(x, 2)
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return self.attnpool(x)
