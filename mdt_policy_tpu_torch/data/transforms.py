"""Batch preprocessing on the frames' device (port of
`mdt_policy_tpu/data/transforms.py`): resize, the DrQ-v2 random shift,
/255 and CLIP normalization, the train and eval camera pipelines built from
them, and the train-time noise and action transforms (Gaussian noise, the
gamma noise of depth frames, vector normalization, relative actions).

  rgb_static : resize 224 -> random shift (pad 10) -> /255 -> CLIP-normalize
  rgb_gripper: resize 84  -> random shift (pad 4)  -> /255 -> CLIP-normalize
  (eval: the same without the shift)

Frames are NHWC, (B, H, W, 3) or (B, T, H, W, 3), uint8 or float. The random
shift draws its integer offsets from an explicit `torch.Generator`, or takes
them as an `offsets` tensor (B, 2), which the tests fill from numpy; the
noise transforms take a generator or their draws the same way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import math

import torch
import torch.nn.functional as F

from ..agents.mdtv_agent import resize_nhwc

__all__ = ["CLIP_IMAGE_MEAN", "CLIP_IMAGE_STD", "resize_batch", "random_shift_aug",
           "scale_and_normalize", "add_gaussian_noise", "normalize_vector",
           "add_depth_noise", "relative_actions", "preprocess_rgb_train",
           "preprocess_rgb_eval"]

# OpenAI CLIP's channel statistics (mdt_policy_tpu/models/clip.py:387-388)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_batch(images: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear antialiased resize of (..., H, W, C) to (..., size, size, C),
    float32 out (the JAX `resize_batch`, :43-52)."""
    *lead, H, W, C = images.shape
    flat = images.reshape((-1, H, W, C)).float()
    return resize_nhwc(flat, size).reshape((*lead, size, size, C))


def random_shift_aug(images: torch.Tensor, pad: int, *,
                     generator: Optional[torch.Generator] = None,
                     offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DrQ-v2 random shift (the JAX `random_shift_aug`, :55-72): replicate-pad
    (B, H, W, C) square images by `pad` and crop each back to (H, W) at an
    integer offset (row, column) in [0, 2*pad], drawn from `generator` (on
    the images' device) or given as `offsets` (B, 2). Float32 out."""
    B, H, W, C = images.shape
    if H != W:
        raise ValueError("random_shift_aug expects square images")
    if offsets is None:
        if generator is None:
            raise ValueError("random_shift_aug needs a generator or the offsets")
        offsets = torch.randint(0, 2 * pad + 1, (B, 2), generator=generator,
                                device=generator.device)
    offsets = offsets.to(device=images.device, dtype=torch.long)
    x = F.pad(images.float().permute(0, 3, 1, 2), (pad,) * 4, mode="replicate")
    x = x.permute(0, 2, 3, 1)  # (B, H + 2 pad, W + 2 pad, C)
    ar = torch.arange(H, device=images.device)
    rows = (offsets[:, 0, None] + ar)[:, :, None]  # (B, H, 1)
    cols = (offsets[:, 1, None] + ar)[:, None, :]  # (B, 1, W)
    return x[torch.arange(B, device=images.device)[:, None, None], rows, cols]


def scale_and_normalize(images: torch.Tensor,
                        mean: Tuple[float, ...] = CLIP_IMAGE_MEAN,
                        std: Tuple[float, ...] = CLIP_IMAGE_STD) -> torch.Tensor:
    """uint8 range -> [0, 1] -> channel-normalized, float32."""
    x = images.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def add_gaussian_noise(x: torch.Tensor, std: float = 0.01, mean: float = 0.0, *,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x + N(0, 1) * std + mean (the JAX `add_gaussian_noise`, :84-87), the
    N(0, 1) draw of x's shape from `generator` or given as `noise`."""
    if noise is None:
        if generator is None:
            raise ValueError("add_gaussian_noise needs a generator or the noise")
        noise = torch.randn(x.shape, generator=generator, device=generator.device)
    return x + noise.to(device=x.device, dtype=x.dtype) * std + mean


def normalize_vector(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std with zero stds treated as 1 (the JAX
    `normalize_vector`, :90-93)."""
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    return (x - torch.as_tensor(mean, dtype=x.dtype, device=x.device)) / std


def add_depth_noise(depth: torch.Tensor, shape: float = 1000.0, rate: float = 1000.0,
                    sample_shape: Tuple[int, ...] = (), *,
                    generator: Optional[torch.Generator] = None,
                    gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multiplicative gamma noise on depth frames (the JAX `add_depth_noise`,
    :96-107): one Gamma(shape) draw of `sample_shape` ((B,) for one draw a
    sample), divided by `rate` and broadcast over the frame, drawn from
    `generator` or given as `gamma` (the undivided draw)."""
    if gamma is None:
        if generator is None:
            raise ValueError("add_depth_noise needs a generator or the gamma draw")
        gamma = torch._standard_gamma(torch.full(sample_shape, shape, device=generator.device),
                                      generator=generator)
    noise = gamma.to(device=depth.device, dtype=torch.float32) / rate
    noise = noise.reshape(tuple(sample_shape) + (1,) * (depth.ndim - len(sample_shape)))
    return depth * noise.to(depth.dtype)


def relative_actions(actions: torch.Tensor, robot_obs: torch.Tensor,
                     max_pos: float, max_orn: float) -> torch.Tensor:
    """Absolute -> relative actions (the JAX `relative_actions`, :110-116):
    the position and the wrapped orientation deltas clipped and scaled to
    [-1, 1], the gripper action kept."""
    rel_pos = torch.clamp(actions[..., :3] - robot_obs[..., :3], -max_pos, max_pos) / max_pos
    diff = actions[..., 3:6] - robot_obs[..., 3:6]
    rel_orn = torch.remainder(diff + math.pi, 2 * math.pi) - math.pi
    rel_orn = torch.clamp(rel_orn, -max_orn, max_orn) / max_orn
    return torch.cat([rel_pos, rel_orn, actions[..., -1:]], dim=-1)


def _flatten_time(x: torch.Tensor):
    if x.ndim == 5:
        B, T = x.shape[:2]
        return x.reshape((B * T,) + tuple(x.shape[2:])), (B, T)
    return x, None


def _unflatten_time(x: torch.Tensor, bt):
    return x if bt is None else x.reshape(bt + tuple(x.shape[1:]))


def preprocess_rgb_train(images: torch.Tensor, *, size: int, shift_pad: Optional[int],
                         generator: Optional[torch.Generator] = None,
                         offsets: Optional[torch.Tensor] = None,
                         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Train-time camera pipeline: resize -> random shift -> scale and
    normalize, cast to `out_dtype` (bf16: the frames feed the bf16 towers)."""
    flat, bt = _flatten_time(images)
    x = resize_batch(flat, size)
    if shift_pad:
        x = random_shift_aug(x, shift_pad, generator=generator, offsets=offsets)
    return _unflatten_time(scale_and_normalize(x).to(out_dtype), bt)


def preprocess_rgb_eval(images: torch.Tensor, *, size: int) -> torch.Tensor:
    """Eval-time camera pipeline: resize -> scale and normalize, float32."""
    flat, bt = _flatten_time(images)
    return _unflatten_time(scale_and_normalize(resize_batch(flat, size)), bt)
