"""MDT-V agent, inference path (port of the inference half of
`mdt_policy_tpu/agents/mdtv_agent.py`).

`MDTVAgentNet` holds the four networks a closed-loop replan runs: the frozen
Voltron ViT (`img_encoder`), the perceiver resampler (`perceiver`), the
frozen CLIP text tower (`language_goal`) and the denoiser (`inner`). The
goal-image tower, the foresight decoder and the contrastive head come with
the train-step slice.

Dtypes follow the JAX defaults: frozen towers hold bf16 weights and compute
in bf16 (`compute_dtype`), the perceiver keeps f32 weights and computes in
bf16 with an f32 final LayerNorm, the denoiser is f32. Public layouts are
the JAX package's: images NHWC (B, T, H, W, 3), tokens (B, 77) int, actions
(B, 10, 7).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..diffusion import get_noise_schedule, precond_denoise, sample_loop
from ..models.blocks import RMSNorm
from ..models.clip import CLIPTextTower
from ..models.mdtv_transformer import MDTVTransformer
from ..models.perceiver import PerceiverResampler
from ..models.voltron_vit import LayerScale, VoltronViT
from .config import MDTVConfig

__all__ = ["MDTVAgentNet", "MDTVPolicy", "denoise_actions", "init_random_",
           "resize_nhwc"]


def resize_nhwc(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, size, size, C), bilinear with antialiasing, as
    `jax.image.resize(..., "linear", antialias=True)`; the two agree to
    float32 rounding when upsampling (tests/test_torch_modules.py)."""
    if x.shape[1] == size and x.shape[2] == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


# config values slice 1 ports; any other value is rejected, not ignored
_PORTED = {"sampler_type": "ddim", "use_ada_conditioning": True,
           "use_noise_encoder": False, "use_modality_encoder": True,
           "use_mlp_goal": True, "denoiser_compute_dtype": "float32"}


class MDTVAgentNet(nn.Module):
    """The MDT-V networks of the replan, built on `device`."""

    def __init__(self, cfg: MDTVConfig, device=None):
        super().__init__()
        unported = {k: getattr(cfg, k) for k, v in _PORTED.items()
                    if getattr(cfg, k) != v}
        if unported:
            raise NotImplementedError(
                f"config values not ported yet: {unported} (ported: the "
                f"production values {_PORTED}; ROADMAP queue A item 18)")
        c = self.cfg = cfg
        tower_dt = getattr(torch, c.compute_dtype)
        self.img_encoder = VoltronViT(
            c.vit_patch, c.perceiver_dim, c.vit_depth, c.vit_heads,
            img_size=c.img_size).to(dtype=tower_dt)
        self.perceiver = PerceiverResampler(
            c.perceiver_dim, c.perceiver_depth, c.perceiver_dim_head,
            c.perceiver_heads, c.num_latents, c.perceiver_num_time_embeds,
            dtype=tower_dt, factored=c.perceiver_factored_kv)
        self.language_goal = CLIPTextTower(
            c.clip_embed_dim, c.clip_context_length, c.clip_vocab_size,
            c.clip_text_width, c.clip_text_heads,
            c.clip_text_layers).to(dtype=tower_dt)
        self.inner = MDTVTransformer(
            obs_dim=c.obs_dim, goal_dim=c.goal_dim, action_dim=c.action_dim,
            proprio_dim=c.proprio_dim, embed_dim=c.embed_dim,
            n_enc_layers=c.n_enc_layers, n_dec_layers=c.n_dec_layers,
            n_heads=c.n_heads, goal_seq_len=c.goal_seq_len,
            obs_seq_len=c.obs_seq_len, n_obs_token=c.num_latents,
            action_seq_len=c.act_window_size, use_proprio=c.use_proprio)
        self.to(device=device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.inner.tok_emb.weight.device

    # ---- encoders ------------------------------------------------------------

    def _to_vit_size(self, x: torch.Tensor) -> torch.Tensor:
        """Resize NHWC frames to the ViT input size (gripper frames arrive
        at 84 px)."""
        return resize_nhwc(x, self.cfg.img_size)

    def voltron_camera_tokens(self, rgb_static, rgb_gripper) -> torch.Tensor:
        """Frozen Voltron tokens of a 2-camera frame pair: (B*, 2N, D) in the
        towers' dtype. Inputs (B*, H, W, 3), CLIP-normalized. Both cameras
        run as one batch (`fuse_camera_batch`, always on in the port: the
        same weights apply per image)."""
        cdt = getattr(torch, self.cfg.compute_dtype)
        both = torch.cat([self._to_vit_size(rgb_static),
                          self._to_vit_size(rgb_gripper)])
        static_tokens, gripper_tokens = self.img_encoder(both.to(cdt)).chunk(2)
        return torch.cat([static_tokens, gripper_tokens], dim=1)

    def compute_voltron_embeddings(self, rgb_static, rgb_gripper
                                   ) -> Dict[str, torch.Tensor]:
        """(B, T, H, W, 3) camera frames -> {"state_images": perceiver latents}."""
        B, T = rgb_static.shape[:2]
        tokens = self.voltron_camera_tokens(
            rgb_static.reshape((B * T,) + tuple(rgb_static.shape[2:])),
            rgb_gripper.reshape((B * T,) + tuple(rgb_gripper.shape[2:])))
        return {"state_images": self.perceiver(tokens[:, None])}

    perceive = compute_voltron_embeddings

    def encode_language_goal(self, lang_tokens: torch.Tensor) -> torch.Tensor:
        """Frozen CLIP text embedding, float32."""
        return self.language_goal(lang_tokens).float()

    # ---- score model -----------------------------------------------------------

    def encode_context(self, perceptual_emb, latent_goal, *, modality: str):
        return self.inner.encode(perceptual_emb, latent_goal, modality=modality)

    def decode_actions(self, context, actions, sigma):
        return self.inner.decode(context, actions, sigma)


@torch.no_grad()
def init_random_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from `generator`, in `named_parameters` order:
    biases 0, norm weights 1, LayerScale 0.1, perceiver latents N(0, 1),
    convolutions N(0, 1/fan_in), the CLIP text projection N(0, 1/width),
    positional tables N(0, 0.01), everything else N(0, 0.02)."""
    for name, p in net.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = net.get_submodule(owner_name) if owner_name else net
        if leaf == "bias":
            p.zero_()
            continue
        if isinstance(owner, (nn.LayerNorm, RMSNorm)):
            p.fill_(1.0)
            continue
        if isinstance(owner, LayerScale):
            p.fill_(0.1)
            continue
        if leaf in ("latents", "time_pos_emb"):
            std = 1.0
        elif isinstance(owner, nn.Conv2d):
            std = (p[0].numel()) ** -0.5
        elif leaf == "text_projection":
            std = p.shape[0] ** -0.5
        elif leaf == "positional_embedding":
            std = 0.01
        else:
            std = 0.02
        draw = torch.randn(p.shape, generator=generator, device=generator.device)
        p.copy_(draw * std)
    return net


@torch.no_grad()
def denoise_actions(net: MDTVAgentNet, perceptual_emb: Dict[str, torch.Tensor],
                    latent_goal: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None,
                    modality: str = "lang") -> torch.Tensor:
    """Sample a (B, act_window_size, action_dim) action chunk with the
    config's sampler, schedule and number of steps.

    The encoder runs once: under AdaLN conditioning it never sees sigma, so
    the context is computed before the sampling loop. The initial state is
    x = N(0, 1) * sigma_max, with the N(0, 1) draw taken from `generator`
    (on the goal's device) or passed in as `noise`."""
    cfg = net.cfg
    sigmas = get_noise_schedule(cfg.num_sampling_steps, cfg.noise_scheduler,
                                cfg.sigma_min, cfg.sigma_max)
    if latent_goal.ndim == 2:
        latent_goal = latent_goal[:, None, :]
    B = latent_goal.shape[0]
    context = net.encode_context(perceptual_emb, latent_goal, modality=modality)

    def denoise_fn(x, sigma):
        sigma_b = torch.full((B,), float(sigma), dtype=x.dtype, device=x.device)
        return precond_denoise(lambda xin, s: net.decode_actions(context, xin, s),
                               x, sigma_b, cfg.sigma_data)

    shape = (B, cfg.act_window_size, cfg.action_dim)
    if noise is None:
        if generator is None:
            raise ValueError("denoise_actions needs a generator or the noise")
        noise = torch.randn(shape, generator=generator, device=latent_goal.device)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"noise must be {shape}, got {tuple(noise.shape)}")
    x = noise.to(device=latent_goal.device, dtype=torch.float32) * cfg.sigma_max
    return sample_loop(cfg.sampler_type, denoise_fn, x, sigmas)


class MDTVPolicy:
    """Closed-loop `reset() / step(obs, goal)` with action chunking: a replan
    every `multistep` env steps, the cached chunk replayed in between. The
    CLIP text tower runs once per goal: its embedding is cached for as long
    as the goal tokens do not change."""

    def __init__(self, net: MDTVAgentNet,
                 generator: Optional[torch.Generator] = None):
        self.net, self.cfg = net, net.cfg
        if self.cfg.multistep > self.cfg.act_window_size:
            raise ValueError(f"multistep={self.cfg.multistep} exceeds "
                             f"act_window_size={self.cfg.act_window_size}")
        self.device = net.device
        self.generator = generator if generator is not None \
            else torch.Generator(self.device).manual_seed(0)
        self.reset()

    def reset(self):
        self.rollout_step_counter = 0
        self.pred_action_seq = None
        self._goal_tokens = None
        self._goal_emb = None

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    @torch.no_grad()
    def step(self, obs: Dict, goal: Dict) -> torch.Tensor:
        """obs: {'rgb_static': (B,T,H,W,3), 'rgb_gripper': ...};
        goal: {'lang_tokens': (B,77)} or {'lang': (B,512) embedding}.
        Returns the current (B, action_dim) action."""
        if self.rollout_step_counter % self.cfg.multistep == 0:
            if "lang_tokens" in goal:
                toks = goal["lang_tokens"]
                toks = toks.cpu().numpy() if torch.is_tensor(toks) else np.asarray(toks)
                if self._goal_tokens is None or \
                        not np.array_equal(toks, self._goal_tokens):
                    self._goal_tokens = toks
                    self._goal_emb = self.net.encode_language_goal(self._tensor(toks))
                goal_emb = self._goal_emb
            elif "rgb_static_goal" in goal:
                raise NotImplementedError(
                    "goal-image conditioning needs the CLIP vision tower, "
                    "which is not ported yet (ROADMAP queue A item 9)")
            else:
                goal_emb = torch.atleast_2d(self._tensor(goal["lang"], torch.float32))
            emb = self.net.perceive(self._tensor(obs["rgb_static"], torch.float32),
                                    self._tensor(obs["rgb_gripper"], torch.float32))
            self.pred_action_seq = denoise_actions(
                self.net, emb, goal_emb, generator=self.generator,
                modality="lang")
        action = self.pred_action_seq[:, self.rollout_step_counter % self.cfg.multistep]
        self.rollout_step_counter += 1
        if self.rollout_step_counter == self.cfg.multistep:
            self.rollout_step_counter = 0
        return action
