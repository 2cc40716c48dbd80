"""MDT agent, the ResNet variant (port of `mdt_policy_tpu/agents/mdt_agent.py`):
the network bundle and its serving methods.

`MDTAgentNet` holds every network of the JAX agent under the same names:
the trainable per-camera ResNet-18-GroupNorm encoders (`static_resnet`,
`gripper_resnet`, one 512-d token per camera), the frozen CLIP vision and
text goal towers (`visual_goal`, `language_goal`), the denoiser (`inner`, an
`MDTTransformer`, 512 wide, 4 encoder and 6 decoder layers), the masked
foresight decoder (`gen_img`), the contrastive head (`clip_proj`, the
parameter-free single-token style: context token 1) and its temperature
(`logit_scale`). It builds on the CUDA device unless the caller names
another one (`device="cpu"`).

The serving methods are those of `MDTVAgentNet` (`perceive`,
`encode_visual_goal`, `encode_language_goal`, `encode_context`,
`decode_actions`), so `denoise_actions` and `MDTVPolicy` (alias
`MDTPolicy`) serve either net. So is `forward`, the per-scope losses of
the JAX `MDTAgentNet.__call__`, with MDT's `contrastive_context`; the MDT-V
module's `init_train_state`, `train_step` and `validation_step` train and
validate either net: the trainables are the parameters outside
`frozen_prefixes`, here both ResNets among them. MDT has no cache mode: a
batch of cached tower outputs raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn as nn

from ..diffusion import make_sample_density
from ..models.blocks import ClipStyleProjection
from ..models.clip import CLIPTextTower
from ..models.masked_decoder import MaskedTransformerImgDecoder
from ..models.mdt_transformer import MDTTransformer
from ..models.resnet import BesoResNetEncoder
from .config import MDTVConfig
from .mdtv_agent import (Batch, MDTVAgentNet, default_device, denoiser_dtype,
                         make_visual_goal_tower)

__all__ = ["MDT_FROZEN_PREFIXES", "MDTAgentNet", "MDTConfig", "make_agent_net"]

# MDT freezes only the CLIP goal towers; both ResNets train (JAX mdt_agent.py:61)
MDT_FROZEN_PREFIXES = ("visual_goal", "language_goal")


@dataclasses.dataclass(frozen=True)
class MDTConfig(MDTVConfig):
    """MDT production hyperparameters (conf/model/mdt_agent.yaml and
    conf/model/model/mdt_transformer.yaml): 512-d latent, 4/6 layers. The
    Voltron and perceiver fields it inherits are not read."""
    latent_dim: int = 512
    obs_dim: int = 512
    embed_dim: int = 512
    n_enc_layers: int = 4
    n_dec_layers: int = 6


class MDTAgentNet(nn.Module):
    """The MDT networks, built on `device` (default: CUDA)."""

    frozen_prefixes = MDT_FROZEN_PREFIXES

    def __init__(self, cfg: MDTConfig, device=None):
        super().__init__()
        device = default_device(device)
        c = self.cfg = cfg
        tower_dt = getattr(torch, c.compute_dtype)
        gen_dt = getattr(torch, c.gen_compute_dtype)
        self.static_resnet = BesoResNetEncoder(c.latent_dim)
        self.gripper_resnet = BesoResNetEncoder(c.latent_dim)
        self.visual_goal = make_visual_goal_tower(c).to(dtype=tower_dt)
        self.language_goal = CLIPTextTower(
            c.clip_embed_dim, c.clip_context_length, c.clip_vocab_size,
            c.clip_text_width, c.clip_text_heads, c.clip_text_layers).to(dtype=tower_dt)
        self.inner = MDTTransformer(
            obs_dim=c.obs_dim, goal_dim=c.goal_dim, action_dim=c.action_dim,
            embed_dim=c.embed_dim, n_enc_layers=c.n_enc_layers,
            n_dec_layers=c.n_dec_layers, n_heads=c.n_heads,
            goal_seq_len=c.goal_seq_len, action_seq_len=c.act_window_size,
            attn_pdrop=c.attn_pdrop, resid_pdrop=c.resid_pdrop, mlp_pdrop=c.mlp_pdrop,
            embed_pdrob=c.embed_pdrob, use_ada_conditioning=c.use_ada_conditioning,
            use_noise_encoder=c.use_noise_encoder,
            use_modality_encoder=c.use_modality_encoder, use_mlp_goal=c.use_mlp_goal,
            compute_dtype=denoiser_dtype(c))
        self.gen_img = MaskedTransformerImgDecoder(
            c.gen_img_res, c.gen_patch_size, c.gen_decoder_depth,
            c.gen_decoder_dim, c.gen_decoder_heads, context_dim=c.latent_dim,
            mask_ratio=c.gen_mask_ratio,
            dtype=None if gen_dt == torch.float32 else gen_dt)
        # ref mdt_agent.py:112-117: token 1 of the 3 context tokens
        self.clip_proj = ClipStyleProjection("single_token", clip_token_index=1)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        for name in self.frozen_prefixes:
            getattr(self, name).requires_grad_(False)
        self.sample_density = make_sample_density(
            c.sigma_sample_density_type, c.sigma_data, c.sigma_min, c.sigma_max)
        self.to(device=device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.inner.tok_emb.weight.device

    # ---- encoders ------------------------------------------------------------

    def embed_visual_obs(self, rgb_static: torch.Tensor,
                         rgb_gripper: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One ResNet token per camera and frame (ref embed_visual_obs,
        mdt_agent.py:368-382): (B, T, H, W, 3) preprocessed frames ->
        {"static": (B, T, latent), "gripper": (B, T, latent)}."""
        return {"static": self.static_resnet(rgb_static.float()),
                "gripper": self.gripper_resnet(rgb_gripper.float())}

    perceive = embed_visual_obs

    # the goal towers' entry points, the score model's, the contrastive
    # loss and the trainables are the MDT-V agent's: the same attribute
    # names, the same calls
    trainable_parameters = MDTVAgentNet.trainable_parameters
    _to_vit_size = MDTVAgentNet._to_vit_size
    encode_visual_goal = MDTVAgentNet.encode_visual_goal
    encode_language_goal = MDTVAgentNet.encode_language_goal
    encode_context = MDTVAgentNet.encode_context
    decode_actions = MDTVAgentNet.decode_actions
    clip_auxiliary_loss = MDTVAgentNet.clip_auxiliary_loss  # JAX :211-220

    def encode_towers(self, batch: Batch, modality: str):
        """(perceptual_emb, image_latent_goal, latent_goal) of one scope
        from its frames (JAX __call__, :161-175): the ResNet tokens of the
        observation frames, the CLIP vision embedding of the goal frame,
        and in the lang scope the CLIP text embedding of the goal tokens.
        MDT trains its ResNets, so their outputs cannot be cached: a batch
        of cached tower outputs raises."""
        cached = sorted({"voltron_tokens", "image_latent_goal", "lang_latent_goal"} & set(batch))
        if cached:
            raise ValueError(f"the MDT agent has no cache mode; the batch carries {cached}")
        perceptual_emb = self.embed_visual_obs(batch["rgb_static"][:, :-1],
                                               batch["rgb_gripper"][:, :-1])
        image_latent_goal = self.encode_visual_goal(batch["rgb_static"][:, -1])
        latent_goal = self.encode_language_goal(batch["lang_tokens"]) \
            if modality == "lang" else image_latent_goal
        return perceptual_emb, image_latent_goal, latent_goal

    # ---- losses (one modality scope): MDT-V's, with MDT's contrastive encode

    forward = MDTVAgentNet.forward  # JAX `MDTAgentNet.__call__`, mdt_agent.py:156-209

    def contrastive_context(self, perceptual_emb, image_latent_goal, sigmas=None,
                            generator=None, goal_mask=None):
        """The image goal's context for the contrastive loss (JAX :195-203):
        a second encode in the lang modality with `modality_embed=True`,
        which takes `lang_emb`; the main path embeds every goal with
        `goal_emb`."""
        return self.inner.encode(perceptual_emb, image_latent_goal, sigmas, modality="lang",
                                 modality_embed=True, generator=generator,
                                 goal_mask=goal_mask)


def make_agent_net(cfg: MDTVConfig, device=None) -> nn.Module:
    """The net of `cfg`'s family on `device` (default: CUDA): an
    `MDTAgentNet` for an `MDTConfig`, else an `MDTVAgentNet`."""
    return (MDTAgentNet if isinstance(cfg, MDTConfig) else MDTVAgentNet)(cfg, device=device)
