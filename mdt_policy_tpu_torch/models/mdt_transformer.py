"""MDT denoiser: the encoder-decoder score transformer of the ResNet variant
(port of `mdt_policy_tpu/models/mdt_transformer.py`), with the reference's
`state_dict` layout (the one `port_mdt_transformer` reads).

  encoder input = [goal token (1), static/gripper camera tokens
                   interleaved (2T)]                        (AdaLN mode)
  decoder input = noised-action tokens, causal self-attention with AdaLN
                  sigma conditioning and cross-attention to the context.

Kept from the reference, quirks included: the absolute position table has
goal_seq_len + action_seq_len rows; the goal takes rows [:goal_seq_len], the
state tokens share rows [goal_seq_len : goal_seq_len + T], and the decoder's
action tokens take none. The main path embeds the goal with `goal_emb`
whatever the modality; `modality_embed=True` (the contrastive head's path)
takes `lang_emb` for the "lang" modality, when there is one
(`use_modality_encoder`). The config switches are MDT-V's
(`models/mdtv_transformer.py`): the sigma token leading the encoder without
AdaLN, the noise-encoder decoder, linear goal projections, `embed_pdrob`
dropout (here on the goal and state tokens and on the action embedding),
`goal_drop`'s mask and the blocks' `compute_dtype`. No proprio, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..ops.attention import dropout
from .blocks import SigmaEmbedding, TransformerEncoder
from .mdtv_transformer import GoalEmbed, make_decoder, mask_goals

__all__ = ["MDTTransformer"]


class MDTTransformer(nn.Module):

    def __init__(self, obs_dim: int = 512, goal_dim: int = 512,
                 action_dim: int = 7, embed_dim: int = 512, n_enc_layers: int = 4,
                 n_dec_layers: int = 6, n_heads: int = 8, goal_seq_len: int = 1,
                 action_seq_len: int = 10, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, mlp_pdrop: float = 0.0,
                 embed_pdrob: float = 0.0, use_ada_conditioning: bool = True,
                 use_noise_encoder: bool = False, use_modality_encoder: bool = True,
                 use_mlp_goal: bool = True, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.obs_dim, self.goal_seq_len = obs_dim, goal_seq_len
        self.embed_pdrob, self.use_ada_conditioning = embed_pdrob, use_ada_conditioning
        self.tok_emb = nn.Linear(obs_dim, embed_dim)
        self.incam_embed = nn.Linear(obs_dim, embed_dim)
        self.pos_emb = nn.Parameter(torch.zeros(1, goal_seq_len + action_seq_len, embed_dim))
        self.goal_emb = GoalEmbed(goal_dim, embed_dim, use_mlp_goal)
        self.lang_emb = GoalEmbed(goal_dim, embed_dim, use_mlp_goal) \
            if use_modality_encoder else None
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

    def _state_tokens(self, states: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Static and gripper camera tokens interleaved: (B, 2T, embed)."""
        static = self.tok_emb(states["static"].float())
        gripper = self.incam_embed(states["gripper"].float())
        B, T = static.shape[:2]
        return torch.stack([static, gripper], dim=2).reshape(B, 2 * T, -1)

    def encode(self, states: Dict[str, torch.Tensor], goals: torch.Tensor,
               sigma: Optional[torch.Tensor] = None, *, modality: str = "vis",
               modality_embed: bool = False,
               generator: Optional[torch.Generator] = None,
               goal_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder context (ref enc_only_forward). Under AdaLN the encoder
        does not see sigma; without it the sigma token leads the sequence."""
        T = states["static"].shape[1]
        goals = self._preprocess_goals(goals, T, goal_mask)
        lang = modality_embed and modality == "lang" and self.lang_emb is not None
        emb = self.lang_emb if lang else self.goal_emb
        g = self.goal_seq_len
        goal_x = dropout(emb(goals) + self.pos_emb[:, :g], self.embed_pdrob, generator)
        state_x = dropout(self._state_tokens(states) + self.pos_emb[:, g:g + T],
                          self.embed_pdrob, generator)
        parts = [goal_x, state_x]
        if not self.use_ada_conditioning:
            parts.insert(0, self._sigma_token(sigma, goal_x.shape[0]))
        return self.encoder(torch.cat(parts, dim=1), generator)

    def decode(self, context: torch.Tensor, actions: torch.Tensor, sigma: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Decoder pass over (scaled) noised action tokens (ref
        dec_only_forward); no position table on the action tokens."""
        x = dropout(self.action_emb(actions), self.embed_pdrob, generator)
        if self.use_ada_conditioning:
            x = self.decoder(x, self._sigma_token(sigma, actions.shape[0]), context,
                             generator)
        else:
            x = self.decoder(x, context, generator)
        return self.action_pred(x)
