"""MDT-V denoiser: encoder-decoder score transformer (port of
`mdt_policy_tpu/models/mdtv_transformer.py`), with the reference's
`state_dict` layout.

  encoder input = [goal token (1), perceiver obs tokens (3)]   (AdaLN mode)
                  [sigma token (1), goal token (1), obs tokens (3)]
                                                    (use_ada_conditioning=False)
  decoder input = noised-action tokens, causal self-attention with AdaLN
                  sigma conditioning (or the sigma token added to the
                  normed inputs, `use_noise_encoder`; or none, a plain
                  causal decoder, without AdaLN) and cross-attention to the
                  context.

`encode` and `decode` are separate, so a sampler whose encoder does not see
sigma computes the context once per replan. The goal projections are MLPs
(`use_mlp_goal`) or linear; `lang_emb` projects language goals unless
`use_modality_encoder` is off, when `goal_emb` serves both modalities.
Dropout (`attn_pdrop`, `resid_pdrop`, `mlp_pdrop`, and `embed_pdrob` on the
action embedding) runs when `encode`/`decode` get a generator; `goal_drop`
zeroes the goal where the caller's Bernoulli `goal_mask` is set. The block
stacks compute in `compute_dtype` (None: float32).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..ops.attention import dropout
from .blocks import (SigmaEmbedding, TransformerDecoder, TransformerEncoder,
                     TransformerFiLMDecoder)


def GoalEmbed(in_dim: int, embed_dim: int, use_mlp: bool = True) -> nn.Module:
    """Linear-GELU-Linear, or one Linear (ref mdtv_transformer.py:83-101)."""
    if not use_mlp:
        return nn.Linear(in_dim, embed_dim)
    return nn.Sequential(nn.Linear(in_dim, 2 * embed_dim), nn.GELU(),
                         nn.Linear(2 * embed_dim, embed_dim))


def ProprioEmbed(in_dim: int, embed_dim: int) -> nn.Module:
    """Linear-Mish-Linear (ref mdtv_transformer.py:159-163)."""
    return nn.Sequential(nn.Linear(in_dim, 2 * embed_dim), nn.Mish(),
                         nn.Linear(2 * embed_dim, embed_dim))


def make_decoder(embed_dim: int, n_heads: int, n_layers: int, drops, *,
                 use_ada_conditioning: bool, use_noise_encoder: bool,
                 dtype: Optional[torch.dtype]) -> nn.Module:
    """The sigma-conditioned decoder (AdaLN or noise blocks), or the plain
    causal decoder of the sigma-token encoder."""
    if use_ada_conditioning:
        return TransformerFiLMDecoder(embed_dim, n_heads, n_layers, *drops,
                                      use_noise_encoder=use_noise_encoder, dtype=dtype)
    return TransformerDecoder(embed_dim, n_heads, n_layers, *drops, dtype=dtype)


def mask_goals(goals: torch.Tensor, goal_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """goals * (1 - mask) where a Bernoulli(goal_drop) mask is given (the
    JAX `_preprocess_goals` in train mode)."""
    if goal_mask is None:
        return goals
    mask = goal_mask[:, :goals.shape[1], :goals.shape[2]]
    return goals * (1.0 - mask.to(goals.dtype))


class MDTVTransformer(nn.Module):

    def __init__(self, obs_dim: int = 384, goal_dim: int = 512,
                 action_dim: int = 7, proprio_dim: int = 8,
                 embed_dim: int = 384, n_enc_layers: int = 4,
                 n_dec_layers: int = 4, n_heads: int = 8,
                 goal_seq_len: int = 1, obs_seq_len: int = 1,
                 n_obs_token: int = 3, action_seq_len: int = 10,
                 use_proprio: bool = False, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, mlp_pdrop: float = 0.0,
                 embed_pdrob: float = 0.0, use_ada_conditioning: bool = True,
                 use_noise_encoder: bool = False, use_modality_encoder: bool = True,
                 use_mlp_goal: bool = True, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.obs_dim, self.goal_seq_len = obs_dim, goal_seq_len
        self.embed_pdrob, self.use_ada_conditioning = embed_pdrob, use_ada_conditioning
        self.tok_emb = nn.Linear(obs_dim, embed_dim)
        self.goal_emb = GoalEmbed(goal_dim, embed_dim, use_mlp_goal)
        self.lang_emb = GoalEmbed(goal_dim, embed_dim, use_mlp_goal) \
            if use_modality_encoder else None
        seq_size = goal_seq_len + obs_seq_len * n_obs_token + action_seq_len
        # unused by the MDT-V forward; kept for checkpoint-layout parity
        self.pos_emb = nn.Parameter(torch.zeros(1, seq_size, embed_dim))
        # the JAX package creates this head only when proprio is fed
        self.proprio_emb = ProprioEmbed(proprio_dim, embed_dim) \
            if use_proprio else None
        self.sigma_emb = SigmaEmbedding(embed_dim)
        self.action_emb = nn.Linear(action_dim, embed_dim)
        drops = (attn_pdrop, resid_pdrop, mlp_pdrop)
        self.encoder = TransformerEncoder(embed_dim, n_heads, n_enc_layers, *drops,
                                          dtype=compute_dtype)
        self.decoder = make_decoder(embed_dim, n_heads, n_dec_layers, drops,
                                    use_ada_conditioning=use_ada_conditioning,
                                    use_noise_encoder=use_noise_encoder,
                                    dtype=compute_dtype)
        self.action_pred = nn.Linear(embed_dim, action_dim)

    def _sigma_token(self, sigma: torch.Tensor, batch: int) -> torch.Tensor:
        """sigma -> (B, 1, embed) via log(max(sigma, 1e-20)) / 4."""
        sigma = sigma.float()
        if sigma.ndim == 0:
            sigma = sigma.expand(batch)
        log_sigma = torch.log(sigma.clamp_min(1e-20)) / 4.0
        return self.sigma_emb(log_sigma.reshape(batch, 1))

    def _preprocess_goals(self, goals: torch.Tensor, states_length: int,
                          goal_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if goals.ndim == 2:
            goals = goals[:, None, :]
        if goals.shape[1] == states_length and self.goal_seq_len == 1:
            goals = goals[:, :1, :]
        if goals.shape[-1] == 2 * self.obs_dim:
            goals = goals[:, :, :self.obs_dim]
        return mask_goals(goals, goal_mask)

    def encode(self, states: Dict[str, torch.Tensor], goals: torch.Tensor,
               sigma: Optional[torch.Tensor] = None, *, modality: str = "vis",
               generator: Optional[torch.Generator] = None,
               goal_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder context (ref forward_enc_only). Under AdaLN the encoder
        does not see sigma; without it (`use_ada_conditioning=False`) the
        sigma token leads the sequence."""
        state_images = states["state_images"]
        goals = self._preprocess_goals(goals, state_images.shape[1], goal_mask)
        if modality == "lang" and self.lang_emb is not None:
            goal_embed = self.lang_emb(goals)
        else:
            goal_embed = self.goal_emb(goals)
        parts = [goal_embed, self.tok_emb(state_images)]
        if "state_obs" in states:
            parts.append(self.proprio_emb(states["state_obs"]))
        if not self.use_ada_conditioning:
            parts.insert(0, self._sigma_token(sigma, state_images.shape[0]))
        return self.encoder(torch.cat(parts, dim=1), generator)

    def decode(self, context: torch.Tensor, actions: torch.Tensor,
               sigma: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Decoder pass over (scaled) noised action tokens (ref
        forward_dec_only)."""
        x = dropout(self.action_emb(actions), self.embed_pdrob, generator)
        if self.use_ada_conditioning:
            x = self.decoder(x, self._sigma_token(sigma, actions.shape[0]), context,
                             generator)
        else:
            x = self.decoder(x, context, generator)
        return self.action_pred(x)
