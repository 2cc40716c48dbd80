"""Plain PyTorch operations of the benchmark's reference: every function
takes the parameters as a flat dict `P` of tensors under the agent's
`state_dict` keys and computes in float32.

`Prec` sets the precision of a computation. The reference (`control=False`)
runs float32 with TF32 off. The control (`control=True`) computes one step
below what the configuration states: the matmuls and convolutions of the
modules that the configuration runs in bfloat16 (the frozen towers, the
perceiver, the foresight decoder) take operands rounded to fp8 (e4m3, one
scale a tensor; the backward sees the rounding as the identity, as fp8
training with float32 master weights does), and every float32 matmul and
convolution runs in TF32.
Nothing here imports the measured program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
FP8_MAX = 448.0


class Prec:
    """Precision of one reference computation (see the module docstring)."""

    def __init__(self, control: bool = False):
        self.control = control

    def q(self, t: torch.Tensor, lowp: bool) -> torch.Tensor:
        """An operand of a matmul: fp8-rounded in a low-precision module of
        the control, else as it is."""
        if not (self.control and lowp):
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        rounded = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
        return t + (rounded - t.detach())  # the gradient passes as through the float32 value

    @contextlib.contextmanager
    def scope(self):
        """TF32 on for the control, off for the reference; restored after."""
        m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.control
        torch.backends.cudnn.allow_tf32 = self.control
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def linear(pr: Prec, x, w, b=None, lowp: bool = False):
    return F.linear(pr.q(x, lowp), pr.q(w, lowp), b)


def lin(pr: Prec, P, name: str, x, lowp: bool = False, bias: bool = True):
    return linear(pr, x, P[name + ".weight"], P.get(name + ".bias") if bias else None, lowp)


def layer_norm(x, w=None, b=None, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def ln(P, name: str, x, eps: float):
    return layer_norm(x, P[name + ".weight"], P.get(name + ".bias"), eps)


def rms_norm(x, g, eps: float = 1e-8):
    """x / max(||x||_2 * D^-1/2, eps) * g."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * x.shape[-1] ** -0.5
    return x / norm.clamp_min(eps) * g


def gelu(x):
    return F.gelu(x)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def dropout(x, p: float, gen: Optional[torch.Generator]):
    """Inverted dropout, kept where a uniform draw of x's shape from `gen`
    is under 1 - p. Off without a generator."""
    if gen is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def attention(pr: Prec, q, k, v, *, causal: bool = False, lowp: bool = False,
              drop: float = 0.0, gen: Optional[torch.Generator] = None):
    """Softmax attention over (B, H, T, D) tensors in float32; `causal`
    keeps key j for query i when j <= i (also for Tq != Tk). Dropout on the
    probabilities with a generator."""
    scores = torch.matmul(pr.q(q, lowp), pr.q(k, lowp).transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones(q.shape[-2], k.shape[-2], dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
    probs = dropout(torch.softmax(scores, dim=-1), drop, gen)
    return torch.matmul(pr.q(probs, lowp), pr.q(v, lowp))


def heads(x, n: int):
    """(B, T, C) -> (B, n, T, C / n)."""
    B, T, C = x.shape
    return x.reshape(B, T, n, C // n).transpose(1, 2)


def merge(x):
    """(B, n, T, d) -> (B, T, n d)."""
    B, n, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, n * d)


def sincos_2d(embed_dim: int, grid: int) -> np.ndarray:
    """MAE's 2-D sin-cos position table, (grid**2, embed_dim), with the
    meshgrid taken (w, h)."""
    def one_d(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float32) / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)
    g = np.arange(grid, dtype=np.float32)
    mesh = np.stack(np.meshgrid(g, g), axis=0).reshape(2, 1, grid, grid)
    return np.concatenate([one_d(embed_dim // 2, mesh[0]), one_d(embed_dim // 2, mesh[1])],
                          axis=1).astype(np.float32)


def resize(x, size: int):
    """(B, H, W, C) float -> (B, size, size, C): bilinear, antialiased,
    half-pixel centres."""
    if x.shape[1] == size and x.shape[2] == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def normalize(x):
    """uint8-range values -> /255 -> CLIP's channel statistics."""
    m = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    s = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x / 255.0 - m) / s


def eval_frames(raw, size: int):
    """Raw uint8 (..., H, W, 3) -> resized, normalized float32."""
    *lead, H, W, C = raw.shape
    x = resize(raw.reshape(-1, H, W, C).float(), size)
    return normalize(x).reshape(*lead, size, size, C)


def shift(x, pad: int, offsets):
    """DrQ shift: replicate-pad (B, H, W, C) by `pad` and crop back at the
    integer (row, column) `offsets` (B, 2)."""
    B, H, W, C = x.shape
    xp = F.pad(x.permute(0, 3, 1, 2), (pad,) * 4, mode="replicate").permute(0, 2, 3, 1)
    out = torch.empty_like(x)
    for i in range(B):
        r, c = int(offsets[i, 0]), int(offsets[i, 1])
        out[i] = xp[i, r:r + H, c:c + W]
    return out


def train_frames(raw, size: int, pad: int, offsets):
    """Raw uint8 (B, T, H, W, 3) -> resized, shifted, normalized float32."""
    B, T, H, W, C = raw.shape
    x = resize(raw.reshape(B * T, H, W, C).float(), size)
    return normalize(shift(x, pad, offsets)).reshape(B, T, size, size, C)


def sigmas_exponential(n: int, sigma_min: float, sigma_max: float) -> np.ndarray:
    s = np.exp(np.linspace(math.log(sigma_max), math.log(sigma_min), n, dtype=np.float64))
    return np.concatenate([s.astype(np.float32), np.zeros(1, np.float32)])


def scalings(sigma, sigma_data: float):
    var = sigma ** 2 + sigma_data ** 2
    return sigma_data ** 2 / var, sigma * sigma_data * torch.rsqrt(var), torch.rsqrt(var)


def log_logistic(u, loc: float, scale: float, lo: float, hi: float):
    """Sigmas by the inverse CDF of the log-logistic truncated to [lo, hi]."""
    sig = lambda z: 1.0 / (1.0 + math.exp(-z / scale))
    u = u * (sig(math.log(hi) - loc) - sig(math.log(lo) - loc)) + sig(math.log(lo) - loc)
    return torch.exp(torch.log(u / (1 - u)) * scale + loc)


def tri_stage_lr(step: int, peak: float, init_scale: float, final_scale: float,
                 total: int, ratios) -> float:
    """The tri-stage learning rate at `step`, in float32."""
    f32 = np.float32
    warm, hold, decay = (int(total * r) for r in ratios)
    init, final = init_scale * peak, final_scale * peak
    s = f32(step)
    if s < warm:
        return float(f32(init) + f32((peak - init) / warm) * s)
    if s < warm + hold:
        return float(f32(peak))
    if s <= warm + hold + decay:
        cos = np.cos((s - f32(warm + hold)) / f32(decay) * f32(math.pi))
        return float(f32(final) + f32(0.5 * (peak - final)) * (f32(1) + cos))
    return float(f32(final))


def ema_decay(step: int, power: float = 2.0 / 3.0, max_value: float = 0.9999) -> float:
    f32 = np.float32
    eff = f32(max(0, step - 1))
    return float(np.clip(f32(1) - (f32(1) + eff) ** f32(-power), f32(0), f32(max_value)))
