"""MDT-V denoiser: encoder-decoder score transformer (port of
`mdt_policy_tpu/models/mdtv_transformer.py`), with the reference's
`state_dict` layout.

  encoder input = [goal token (1), perceiver obs tokens (3)]   (AdaLN mode)
  decoder input = noised-action tokens, causal self-attention with AdaLN
                  sigma conditioning and cross-attention to the context.

`encode` and `decode` are separate so the sampler computes the context once
per replan. Only the production layout is ported: AdaLN decoder, MLP goal
projections and a separate language-goal projection (`lang_emb`); the agent
rejects other configs (ROADMAP queue A, "The rest, behind the production
defaults"). Dropout (`attn_pdrop`, `resid_pdrop`, `mlp_pdrop`) runs when
`encode`/`decode` get a generator.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from .blocks import SigmaEmbedding, TransformerEncoder, TransformerFiLMDecoder


def GoalEmbed(in_dim: int, embed_dim: int) -> nn.Module:
    """Linear-GELU-Linear (ref mdtv_transformer.py:83-101)."""
    return nn.Sequential(nn.Linear(in_dim, 2 * embed_dim), nn.GELU(),
                         nn.Linear(2 * embed_dim, embed_dim))


def ProprioEmbed(in_dim: int, embed_dim: int) -> nn.Module:
    """Linear-Mish-Linear (ref mdtv_transformer.py:159-163)."""
    return nn.Sequential(nn.Linear(in_dim, 2 * embed_dim), nn.Mish(),
                         nn.Linear(2 * embed_dim, embed_dim))


class MDTVTransformer(nn.Module):

    def __init__(self, obs_dim: int = 384, goal_dim: int = 512,
                 action_dim: int = 7, proprio_dim: int = 8,
                 embed_dim: int = 384, n_enc_layers: int = 4,
                 n_dec_layers: int = 4, n_heads: int = 8,
                 goal_seq_len: int = 1, obs_seq_len: int = 1,
                 n_obs_token: int = 3, action_seq_len: int = 10,
                 use_proprio: bool = False, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, mlp_pdrop: float = 0.0):
        super().__init__()
        self.obs_dim, self.goal_seq_len = obs_dim, goal_seq_len
        self.tok_emb = nn.Linear(obs_dim, embed_dim)
        self.goal_emb = GoalEmbed(goal_dim, embed_dim)
        self.lang_emb = GoalEmbed(goal_dim, embed_dim)
        seq_size = goal_seq_len + obs_seq_len * n_obs_token + action_seq_len
        # unused by the MDT-V forward; kept for checkpoint-layout parity
        self.pos_emb = nn.Parameter(torch.zeros(1, seq_size, embed_dim))
        # the JAX package creates this head only when proprio is fed
        self.proprio_emb = ProprioEmbed(proprio_dim, embed_dim) \
            if use_proprio else None
        self.sigma_emb = SigmaEmbedding(embed_dim)
        self.action_emb = nn.Linear(action_dim, embed_dim)
        drops = (attn_pdrop, resid_pdrop, mlp_pdrop)
        self.encoder = TransformerEncoder(embed_dim, n_heads, n_enc_layers, *drops)
        self.decoder = TransformerFiLMDecoder(embed_dim, n_heads, n_dec_layers, *drops)
        self.action_pred = nn.Linear(embed_dim, action_dim)

    def _sigma_token(self, sigma: torch.Tensor, batch: int) -> torch.Tensor:
        """sigma -> (B, 1, embed) via log(max(sigma, 1e-20)) / 4."""
        sigma = sigma.float()
        if sigma.ndim == 0:
            sigma = sigma.expand(batch)
        log_sigma = torch.log(sigma.clamp_min(1e-20)) / 4.0
        return self.sigma_emb(log_sigma.reshape(batch, 1))

    def _preprocess_goals(self, goals: torch.Tensor,
                          states_length: int) -> torch.Tensor:
        if goals.ndim == 2:
            goals = goals[:, None, :]
        if goals.shape[1] == states_length and self.goal_seq_len == 1:
            goals = goals[:, :1, :]
        if goals.shape[-1] == 2 * self.obs_dim:
            goals = goals[:, :, :self.obs_dim]
        return goals

    def encode(self, states: Dict[str, torch.Tensor], goals: torch.Tensor,
               *, modality: str = "vis",
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Encoder context (ref forward_enc_only). Under AdaLN the encoder
        does not see sigma."""
        state_images = states["state_images"]
        goals = self._preprocess_goals(goals, state_images.shape[1])
        if modality == "lang":
            goal_embed = self.lang_emb(goals)
        else:
            goal_embed = self.goal_emb(goals)
        parts = [goal_embed, self.tok_emb(state_images)]
        if "state_obs" in states:
            parts.append(self.proprio_emb(states["state_obs"]))
        return self.encoder(torch.cat(parts, dim=1), generator)

    def decode(self, context: torch.Tensor, actions: torch.Tensor,
               sigma: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Decoder pass over (scaled) noised action tokens (ref
        forward_dec_only)."""
        emb_t = self._sigma_token(sigma, actions.shape[0])
        x = self.decoder(self.action_emb(actions), emb_t, context, generator)
        return self.action_pred(x)
