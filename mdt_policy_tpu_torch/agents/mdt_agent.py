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
`MDTPolicy`) serve either net. The losses and the train step are not ported
yet (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn as nn

from ..models.blocks import SingleTokenProjection
from ..models.clip import CLIPTextTower, CLIPVisionTower
from ..models.masked_decoder import MaskedTransformerImgDecoder
from ..models.mdt_transformer import MDTTransformer
from ..models.resnet import BesoResNetEncoder
from .config import MDTVConfig
from .mdtv_agent import MDTVAgentNet, check_ported, default_device

__all__ = ["MDT_FROZEN_PREFIXES", "MDTAgentNet", "MDTConfig"]

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

    def __init__(self, cfg: MDTConfig, device=None):
        super().__init__()
        check_ported(cfg)
        device = default_device(device)
        c = self.cfg = cfg
        tower_dt = getattr(torch, c.compute_dtype)
        gen_dt = getattr(torch, c.gen_compute_dtype)
        self.static_resnet = BesoResNetEncoder(c.latent_dim)
        self.gripper_resnet = BesoResNetEncoder(c.latent_dim)
        self.visual_goal = CLIPVisionTower(
            c.clip_embed_dim, c.img_size, c.clip_vision_layers,
            c.clip_vision_width, c.clip_vision_patch).to(dtype=tower_dt)
        self.language_goal = CLIPTextTower(
            c.clip_embed_dim, c.clip_context_length, c.clip_vocab_size,
            c.clip_text_width, c.clip_text_heads, c.clip_text_layers).to(dtype=tower_dt)
        self.inner = MDTTransformer(
            obs_dim=c.obs_dim, goal_dim=c.goal_dim, action_dim=c.action_dim,
            embed_dim=c.embed_dim, n_enc_layers=c.n_enc_layers,
            n_dec_layers=c.n_dec_layers, n_heads=c.n_heads,
            goal_seq_len=c.goal_seq_len, action_seq_len=c.act_window_size,
            attn_pdrop=c.attn_pdrop, resid_pdrop=c.resid_pdrop, mlp_pdrop=c.mlp_pdrop)
        self.gen_img = MaskedTransformerImgDecoder(
            c.gen_img_res, c.gen_patch_size, c.gen_decoder_depth,
            c.gen_decoder_dim, c.gen_decoder_heads, context_dim=c.latent_dim,
            mask_ratio=c.gen_mask_ratio,
            dtype=None if gen_dt == torch.float32 else gen_dt)
        # ref mdt_agent.py:112-117: token 1 of the 3 context tokens
        self.clip_proj = SingleTokenProjection(1)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        for name in MDT_FROZEN_PREFIXES:
            getattr(self, name).requires_grad_(False)
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

    # the goal towers' entry points and the score model's are the MDT-V
    # agent's: the same attribute names, the same calls
    _to_vit_size = MDTVAgentNet._to_vit_size
    encode_visual_goal = MDTVAgentNet.encode_visual_goal
    encode_language_goal = MDTVAgentNet.encode_language_goal
    encode_context = MDTVAgentNet.encode_context
    decode_actions = MDTVAgentNet.decode_actions
