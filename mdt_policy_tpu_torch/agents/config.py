"""Agent configuration: the MDT-V hyperparameters of the JAX package
(`mdt_policy_tpu/agents/config.py`), copied field for field so a config
round-trips between the two packages.

Fields that only the TPU build reads (`scan_tower_layers`,
`voltron_blocks_2d`, `remat_perceiver`, `fused_tower_attention`) and
`fuse_camera_batch` (always on in the port) are kept as inert fields: the
port accepts them and ignores them; every other field's values are the
JAX package's (sampler, density, denoiser and goal-tower options
included). `filter_retired_overrides` drops the keys of the JAX package's
retired experiments from a run snapshot.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.9)
    transformer_weight_decay: float = 0.05
    obs_encoder_weight_decay: float = 0.05

    def __post_init__(self):
        object.__setattr__(self, "betas", tuple(self.betas))


@dataclasses.dataclass(frozen=True)
class LRSchedulerConfig:
    init_lr: float = 1e-4
    init_lr_scale: float = 0.1
    final_lr_scale: float = 1e-6
    total_steps: int = 50_000
    phase_ratio: Tuple[float, float, float] = (0.02, 0.08, 0.9)

    def __post_init__(self):
        object.__setattr__(self, "phase_ratio", tuple(self.phase_ratio))


@dataclasses.dataclass(frozen=True)
class MDTVConfig:
    """MDT-V agent hyperparameters (production defaults)."""
    # diffusion
    latent_dim: int = 384
    multistep: int = 10
    sampler_type: str = "ddim"
    num_sampling_steps: int = 10
    sigma_data: float = 0.5
    sigma_min: float = 0.001
    sigma_max: float = 80.0
    noise_scheduler: str = "exponential"
    sigma_sample_density_type: str = "loglogistic"
    act_window_size: int = 10
    action_dim: int = 7
    # aux losses
    cont_alpha: float = 1.0
    masked_beta: float = 1.0
    use_distributed_clip: bool = True
    use_text_not_embedding: bool = True
    # denoiser transformer
    obs_dim: int = 384
    goal_dim: int = 512
    proprio_dim: int = 8
    embed_dim: int = 384
    n_enc_layers: int = 4
    n_dec_layers: int = 4
    n_heads: int = 8
    n_obs_token: int = 3
    goal_seq_len: int = 1
    obs_seq_len: int = 1
    attn_pdrop: float = 0.3
    resid_pdrop: float = 0.1
    mlp_pdrop: float = 0.05
    embed_pdrob: float = 0.0
    goal_drop: float = 0.0
    use_ada_conditioning: bool = True
    use_noise_encoder: bool = False
    use_modality_encoder: bool = True
    use_mlp_goal: bool = True
    use_proprio: bool = False
    # perceiver
    perceiver_depth: int = 6
    perceiver_heads: int = 8
    perceiver_dim_head: int = 64
    perceiver_num_time_embeds: int = 1
    perceiver_dim: int = 384
    num_latents: int = 3
    # image encoder (Voltron v-cond ViT-S/16 @224)
    img_size: int = 224
    vit_patch: int = 16
    vit_depth: int = 12
    vit_heads: int = 6
    freeze_img_encoder: bool = True
    # goal towers (ViT-B/16 vision, ViT-B/32 text)
    clip_embed_dim: int = 512
    clip_vision_width: int = 768
    clip_vision_layers: int = 12
    clip_vision_patch: int = 16
    clip_vision_family: str = "vit"
    clip_rn_layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    clip_rn_width: int = 64
    clip_text_width: int = 512
    clip_text_layers: int = 12
    clip_text_heads: int = 8
    clip_context_length: int = 77
    clip_vocab_size: int = 49408
    # masked foresight decoder
    gen_img_res: int = 112
    gen_patch_size: int = 16
    gen_decoder_depth: int = 6
    gen_decoder_dim: int = 192
    gen_decoder_heads: int = 8
    gen_mask_ratio: float = 0.75
    img_gen_frame_diff: int = 3
    gen_compute_dtype: str = "bfloat16"
    # compute dtype of the denoiser's block stacks (parameters stay float32)
    denoiser_compute_dtype: str = "float32"
    # factored (folded) perceiver cross-attention; False is the plain path
    perceiver_factored_kv: bool = True
    # training
    optimizer: OptimizerConfig = OptimizerConfig()
    lr_scheduler: LRSchedulerConfig = LRSchedulerConfig()

    def __post_init__(self):
        if isinstance(self.optimizer, dict):
            object.__setattr__(self, "optimizer",
                               OptimizerConfig(**self.optimizer))
        if isinstance(self.lr_scheduler, dict):
            object.__setattr__(self, "lr_scheduler",
                               LRSchedulerConfig(**self.lr_scheduler))
        object.__setattr__(self, "clip_rn_layers", tuple(self.clip_rn_layers))

    # dtype of the FROZEN encoder towers (weights and activations)
    compute_dtype: str = "bfloat16"
    # inert in the port (TPU-only levers of the JAX package)
    remat_perceiver: bool = False
    # run both cameras through the frozen ViT as one batched call (the port
    # always does; inert)
    fuse_camera_batch: bool = True
    fused_tower_attention: str = "auto"
    scan_tower_layers: bool = False
    voltron_blocks_2d: bool = False


# Config fields of the JAX package's measured-and-rejected experiments
# (`mdt_policy_tpu/agents/config.py:200-224`). The fields themselves are not
# ported (ROADMAP, "Do not port these"); run snapshots that carry them still
# load, with the keys dropped.
RETIRED_OVERRIDES = ("mxu_tower_norm", "perceiver_head_slice",
                     "fuse_scope_towers")


def filter_retired_overrides(overrides: dict) -> dict:
    """Drop retired experiment keys from a run snapshot's agent_overrides
    (with a log) so historical run dirs keep re-hydrating."""
    import logging
    retired = {k: v for k, v in overrides.items() if k in RETIRED_OVERRIDES}
    if retired:
        logging.getLogger(__name__).warning(
            "dropping retired agent overrides %s (rejected experiments; "
            "see agents/config.py RETIRED_OVERRIDES)", retired)
    return {k: v for k, v in overrides.items() if k not in RETIRED_OVERRIDES}
