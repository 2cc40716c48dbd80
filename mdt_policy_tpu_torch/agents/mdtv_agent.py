"""MDT-V agent (port of `mdt_policy_tpu/agents/mdtv_agent.py`): the network
bundle, its per-scope losses, the train and validation steps, and the
closed-loop replan.

`MDTVAgentNet` holds every network of the agent under the JAX package's
names: the frozen Voltron ViT (`img_encoder`), the perceiver resampler
(`perceiver`), the frozen CLIP vision and text towers (`visual_goal`, a
ViT or, with `clip_vision_family="resnet"`, CLIP's ModifiedResNet;
`language_goal`), the denoiser (`inner`, in any of the JAX package's
configurations), the masked foresight decoder
(`gen_img`), the contrastive head (`clip_proj`) and its temperature
(`logit_scale`). It builds on the CUDA device unless the caller names
another one (`device="cpu"`).

Dtypes follow the JAX defaults: frozen towers hold bf16 weights and compute
in bf16 (`compute_dtype`) under `torch.no_grad()`, the perceiver keeps f32
weights and computes in bf16 with an f32 final LayerNorm, the denoiser is
f32, the foresight decoder keeps f32 master weights and computes in
`gen_compute_dtype`. Public layouts are the JAX package's: images NHWC
(B, T, H, W, 3), tokens (B, 77) int, actions (B, 10, 7).

Every random number of a step (the sigma density's draw, the action noise,
the foresight mask's uniform draw, `goal_drop`'s masks, the denoiser's
dropout) comes from a `draws` dict per scope, made by `make_draws` from an
explicit `torch.Generator` or handed in by the caller; so do a replan's
initial noise and a stochastic sampler's per-step draws.

A batch that carries `voltron_tokens` and `image_latent_goal` (the frozen
towers' outputs, cached by `data/extract_embeddings.py`) is a cache batch:
the camera towers do not run, and in the lang scope `lang_latent_goal`, when
present, stands in for the text tower. The tower entry points take
`halfblocks=True` to run every tower block as kernels B4 + B5 (what
extraction does); by default they run B1 + B3.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import parallel
from ..diffusion import (append_dims, get_noise_schedule, get_scalings,
                         make_sample_density, precond_denoise, sample_loop)
from ..diffusion.densities import draw_sigma
from ..diffusion.samplers import n_step_draws
from ..models.blocks import ClipStyleProjection, RMSNorm
from ..models.clip import (CLIPResNetTower, CLIPTextTower, CLIPVisionTower,
                           FrozenBatchNorm2d)
from ..models.masked_decoder import MaskedTransformerImgDecoder
from ..models.mdtv_transformer import MDTVTransformer
from ..models.perceiver import PerceiverResampler
from ..models.voltron_vit import LayerScale, VoltronViT
from ..ops._build import count_replay, recording_launches
from ..utils.ema import ema_decay, ema_update
from ..utils.profiling import count, recording, span
from ..utils.schedulers import lr_schedule_from_cfg
from .config import MDTVConfig

__all__ = ["FROZEN_PREFIXES", "MDTVAgentNet", "MDTVPolicy", "TrainState",
           "denoise_actions", "init_random_", "init_train_state", "make_draws",
           "make_optimizer", "make_visual_goal_tower", "rank_draws",
           "reconstruction_forward", "resize_nhwc", "sampling_schedule", "train_step",
           "validation_step"]

# top-level networks that stay frozen: no gradient, no optimizer state, no
# EMA copy (JAX mdtv_agent.py:57). The Voltron tower stays here whatever
# `freeze_img_encoder` says, as in the JAX package, whose `split_params`
# never takes its gradient: the flag there only drops a stop_gradient.
FROZEN_PREFIXES = ("visual_goal", "language_goal", "img_encoder")

Batch = Mapping[str, torch.Tensor]


def resize_nhwc(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, size, size, C), bilinear with antialiasing, as
    `jax.image.resize(..., "linear", antialias=True)`; the two agree to
    float32 rounding (tests/test_torch_modules.py, tests/test_torch_extract.py).
    Computed in at least float32 and returned in the dtype of `x`."""
    if x.shape[1] == size and x.shape[2] == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).to(torch.promote_types(x.dtype, torch.float32)),
                      size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def make_visual_goal_tower(c: MDTVConfig) -> nn.Module:
    """The goal image tower of `c.clip_vision_family` (JAX
    make_visual_goal_tower, mdtv_agent.py:73-88): CLIP's ModifiedResNet for
    "resnet" (RN50: `clip_rn_layers` (3, 4, 6, 3), width 64, 1024-d
    embeddings), else the ViT (ViT-B/16 in production)."""
    if c.clip_vision_family == "resnet":
        return CLIPResNetTower(c.clip_embed_dim, tuple(c.clip_rn_layers), c.clip_rn_width,
                               c.img_size)
    return CLIPVisionTower(c.clip_embed_dim, c.img_size, c.clip_vision_layers,
                           c.clip_vision_width, c.clip_vision_patch)


def denoiser_dtype(c: MDTVConfig) -> Optional[torch.dtype]:
    """The denoiser blocks' compute dtype, None for float32."""
    dt = getattr(torch, c.denoiser_compute_dtype)
    return None if dt == torch.float32 else dt


def default_device(device) -> torch.device:
    """The CUDA device unless the caller names one; never a silent CPU: a
    CUDA device, named or not, raises when there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the agent nets build on the CUDA device by default "
                           "and no CUDA device is available; pass device='cpu' "
                           "to build on the CPU")
    return device


class MDTVAgentNet(nn.Module):
    """The MDT-V networks, built on `device` (default: CUDA)."""

    frozen_prefixes = FROZEN_PREFIXES

    def __init__(self, cfg: MDTVConfig, device=None):
        super().__init__()
        device = default_device(device)
        c = self.cfg = cfg
        tower_dt = getattr(torch, c.compute_dtype)
        gen_dt = getattr(torch, c.gen_compute_dtype)
        self.img_encoder = VoltronViT(
            c.vit_patch, c.perceiver_dim, c.vit_depth, c.vit_heads,
            img_size=c.img_size).to(dtype=tower_dt)
        self.perceiver = PerceiverResampler(
            c.perceiver_dim, c.perceiver_depth, c.perceiver_dim_head,
            c.perceiver_heads, c.num_latents, c.perceiver_num_time_embeds,
            dtype=tower_dt, factored=c.perceiver_factored_kv)
        self.visual_goal = make_visual_goal_tower(c).to(dtype=tower_dt)
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
            action_seq_len=c.act_window_size, use_proprio=c.use_proprio,
            attn_pdrop=c.attn_pdrop, resid_pdrop=c.resid_pdrop,
            mlp_pdrop=c.mlp_pdrop, embed_pdrob=c.embed_pdrob,
            use_ada_conditioning=c.use_ada_conditioning,
            use_noise_encoder=c.use_noise_encoder,
            use_modality_encoder=c.use_modality_encoder, use_mlp_goal=c.use_mlp_goal,
            compute_dtype=denoiser_dtype(c))
        self.gen_img = MaskedTransformerImgDecoder(
            c.gen_img_res, c.gen_patch_size, c.gen_decoder_depth,
            c.gen_decoder_dim, c.gen_decoder_heads, context_dim=c.latent_dim,
            mask_ratio=c.gen_mask_ratio,
            dtype=None if gen_dt == torch.float32 else gen_dt)
        # style 'map' over the whole context, token_dim=latent_dim (JAX :159-163)
        self.clip_proj = ClipStyleProjection(token_dim=c.latent_dim)
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

    def trainable_parameters(self) -> List[Tuple[str, nn.Parameter]]:
        """(name, parameter) of every network outside the net's
        `frozen_prefixes` (JAX `split_params(params, net.frozen_prefixes)`)."""
        return [(n, p) for n, p in self.named_parameters()
                if n.split(".", 1)[0] not in self.frozen_prefixes]

    # ---- encoders ------------------------------------------------------------

    def _to_vit_size(self, x: torch.Tensor) -> torch.Tensor:
        """Resize NHWC frames to the ViT input size (gripper frames arrive
        at 84 px)."""
        return resize_nhwc(x, self.cfg.img_size)

    @torch.no_grad()
    def voltron_camera_tokens(self, rgb_static, rgb_gripper, *,
                              halfblocks: bool = False) -> torch.Tensor:
        """Frozen Voltron tokens of a 2-camera frame pair: (B*, 2N, D) in the
        towers' dtype. Inputs (B*, H, W, 3), CLIP-normalized. Both cameras
        run as one batch (`fuse_camera_batch`, always on in the port: the
        same weights apply per image)."""
        cdt = getattr(torch, self.cfg.compute_dtype)
        both = torch.cat([self._to_vit_size(rgb_static),
                          self._to_vit_size(rgb_gripper)])
        static_tokens, gripper_tokens = self.img_encoder(both.to(cdt), halfblocks).chunk(2)
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

    def perceive_tokens(self, voltron_tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Perceiver latents from cached frozen Voltron tokens (JAX
        perceive_tokens, :220-227): (B, 2N, D) rows or the (B, 1, 2N, D)
        perceiver layout, cast to the towers' dtype."""
        vt = voltron_tokens[:, None] if voltron_tokens.ndim == 3 else voltron_tokens
        cdt = getattr(torch, self.cfg.compute_dtype)
        return {"state_images": self.perceiver(vt.to(device=self.device, dtype=cdt))}

    @torch.no_grad()
    def encode_visual_goal(self, goal_image: torch.Tensor, *,
                           halfblocks: bool = False) -> torch.Tensor:
        """Frozen CLIP vision embedding of a (B, H, W, 3) CLIP-normalized
        goal frame (the ViT's or the ResNet's), float32."""
        cdt = getattr(torch, self.cfg.compute_dtype)
        return self.visual_goal(self._to_vit_size(goal_image).to(cdt), halfblocks).float()

    @torch.no_grad()
    def encode_language_goal(self, lang_tokens: torch.Tensor, *,
                             halfblocks: bool = False) -> torch.Tensor:
        """Frozen CLIP text embedding, float32."""
        return self.language_goal(lang_tokens, halfblocks).float()

    def encode_towers(self, batch: Batch, modality: str):
        """(perceptual_emb, image_latent_goal, latent_goal) of one scope
        (JAX __call__, :273-306): from the cache when the batch carries
        `voltron_tokens` and `image_latent_goal`, else through the frozen
        towers; in the lang scope the batch's `lang_latent_goal` if it
        carries one (as the JAX validation step reads it), else the text
        tower."""
        if "voltron_tokens" in batch and "image_latent_goal" in batch:
            perceptual_emb = self.perceive_tokens(batch["voltron_tokens"])
            image_latent_goal = batch["image_latent_goal"].float()
        else:
            perceptual_emb = self.compute_voltron_embeddings(
                batch["rgb_static"][:, :-1], batch["rgb_gripper"][:, :-1])
            image_latent_goal = self.encode_visual_goal(batch["rgb_static"][:, -1])
        if modality != "lang":
            return perceptual_emb, image_latent_goal, image_latent_goal
        latent_goal = batch["lang_latent_goal"].float() if "lang_latent_goal" in batch \
            else self.encode_language_goal(batch["lang_tokens"])
        return perceptual_emb, image_latent_goal, latent_goal

    # ---- score model -----------------------------------------------------------

    def encode_context(self, perceptual_emb, latent_goal, sigma=None, *, modality: str,
                       generator: Optional[torch.Generator] = None, goal_mask=None):
        """The encoder's context; `sigma` (B,) is read by the sigma-token
        encoder (`use_ada_conditioning=False`) alone."""
        return self.inner.encode(perceptual_emb, latent_goal, sigma, modality=modality,
                                 generator=generator, goal_mask=goal_mask)

    def decode_actions(self, context, actions, sigma,
                       generator: Optional[torch.Generator] = None):
        return self.inner.decode(context, actions, sigma, generator)

    # ---- losses (one modality scope) ------------------------------------------

    def forward(self, batch: Batch, modality: str, *, train: bool = True,
                draws: Mapping) -> Dict[str, torch.Tensor]:
        """Per-scope losses (JAX `__call__`, mdtv_agent.py:259-348; the MDT
        net's too, through its own `encode_towers` and `contrastive_context`).

        batch: rgb_static / rgb_gripper (B, T+1, H, W, 3), the last frame
        the goal frame, or the cache's voltron_tokens (B, 2N, D) and
        image_latent_goal (B, E); gen_static / gen_gripper (B, h, w, 3);
        actions (B, W, A); lang_tokens (B, 77) or lang_latent_goal (B, E) in
        the lang scope; state_obs when the config feeds proprio. draws:
        `make_draws` of this scope. `train`
        turns the denoiser's dropout on (drawn from `draws["dropout"]`).
        Returns action_loss, img_gen_loss, cont_loss and total_loss. Under a
        profile its parts are the spans `net.towers`, `net.denoise`,
        `net.foresight` and, in the lang scope, `net.contrastive`."""
        c = self.cfg
        actions = batch["actions"].float()
        generator = draws.get("dropout") if train else None
        if generator is None and train and max(c.attn_pdrop, c.resid_pdrop,
                                               c.mlp_pdrop, c.embed_pdrob) > 0:
            raise ValueError("train mode needs draws['dropout'], a torch.Generator")

        with span("net.towers"):
            perceptual_emb, image_latent_goal, latent_goal = self.encode_towers(batch, modality)
            if c.use_proprio and "state_obs" in batch:
                perceptual_emb["state_obs"] = batch["state_obs"].float()

        # diffusion loss (JAX :312-325)
        with span("net.denoise"):
            sigmas = self.sample_density(draws["sigma"])
            c_skip, c_out, c_in = (append_dims(s, actions.ndim)
                                   for s in get_scalings(sigmas, c.sigma_data))
            noised = actions + draws["noise"] * append_dims(sigmas, actions.ndim)
            goal_masks = (None, None)
            if train and c.goal_drop > 0:
                if "goal_mask" not in draws:
                    raise ValueError("goal_drop > 0 in train mode needs draws['goal_mask']")
                goal_masks = draws["goal_mask"].unbind(1)
            context = self.encode_context(perceptual_emb, latent_goal, sigmas,
                                          modality=modality, generator=generator,
                                          goal_mask=goal_masks[0])
            model_out = self.decode_actions(context, noised * c_in, sigmas, generator)
            target = (actions - c_skip * noised) / c_out
            action_loss = ((model_out - target) ** 2).mean()

        # masked generative foresight loss (JAX :327-330)
        with span("net.foresight"):
            goal_imgs = torch.stack([batch["gen_static"], batch["gen_gripper"]], dim=1)
            recon, mask, _, _ = self.gen_img(context, goal_imgs, draws["mask"])
            img_gen_loss = self.gen_img.compute_loss(goal_imgs, recon, mask)

        # contrastive latent alignment, lang scope only (JAX :332-340)
        if modality == "lang":
            with span("net.contrastive"):
                vis_context = self.contrastive_context(perceptual_emb, image_latent_goal,
                                                       sigmas, generator, goal_masks[1])
                cont_loss = self.clip_auxiliary_loss(self.clip_proj(vis_context),
                                                     self.clip_proj(context))
        else:
            cont_loss = actions.new_zeros(())

        total = action_loss + c.masked_beta * img_gen_loss + c.cont_alpha * cont_loss
        return {"action_loss": action_loss, "img_gen_loss": img_gen_loss,
                "cont_loss": cont_loss, "total_loss": total}

    def contrastive_context(self, perceptual_emb, image_latent_goal, sigmas=None,
                            generator: Optional[torch.Generator] = None, goal_mask=None):
        """The image goal's context for the contrastive loss (JAX
        :332-340): the encode of the lang modality, as in JAX."""
        return self.encode_context(perceptual_emb, image_latent_goal, sigmas,
                                   modality="lang", generator=generator,
                                   goal_mask=goal_mask)

    def clip_auxiliary_loss(self, image_features: torch.Tensor,
                            lang_features: torch.Tensor) -> torch.Tensor:
        """Symmetric InfoNCE over the batch (JAX :350-361). With a process
        group up and `use_distributed_clip`, over the global batch: both
        feature sets gathered from every rank in rank order, with their
        gradients (`parallel.all_gather_with_grad`), what JAX's sharded jit
        computes."""
        if self.cfg.use_distributed_clip and parallel.is_initialized():
            image_features = parallel.all_gather_with_grad(image_features)
            lang_features = parallel.all_gather_with_grad(lang_features)
        img = image_features / torch.linalg.vector_norm(image_features, dim=-1,
                                                        keepdim=True)
        lang = lang_features / torch.linalg.vector_norm(lang_features, dim=-1,
                                                        keepdim=True)
        sim = self.logit_scale.exp() * img @ lang.T
        labels = torch.arange(sim.shape[0], device=sim.device)
        return (F.cross_entropy(sim, labels) + F.cross_entropy(sim.T, labels)) / 2


def make_draws(cfg: MDTVConfig, batch_size: int, generator: torch.Generator, *,
               steps: bool = False) -> Dict:
    """The random numbers of one scope of a step, from `generator` on its
    device: "sigma" (B,) the sigma density's draw (uniform for the
    production log-logistic; `densities.DRAW_KINDS` names the others'),
    "noise" (B, W, A) normal action noise, "mask" (B, n_patches) uniform
    for the foresight mask, "dropout", the generator itself, for the
    denoiser's dropout; with `goal_drop` > 0 "goal_mask" (B, 2,
    goal_seq_len, goal_dim) bool, Bernoulli(goal_drop), the main encode's
    and the contrastive encode's (JAX's "goal_mask" stream); and with
    `steps` (validation's sampling) and a stochastic sampler "step_noise"
    (B, n, W, A), its per-step draws. A train step draws no step noise, so
    its draws and dropout masks do not depend on the sampler."""
    dev = generator.device
    n_patches = (cfg.gen_img_res // cfg.gen_patch_size) ** 2
    shape = (batch_size, cfg.act_window_size, cfg.action_dim)
    draws = {
        "sigma": draw_sigma(cfg.sigma_sample_density_type, batch_size, generator),
        "noise": torch.randn(shape, generator=generator, device=dev),
        "mask": torch.rand((batch_size, n_patches), generator=generator, device=dev),
        "dropout": generator,
    }
    if cfg.goal_drop > 0:
        draws["goal_mask"] = torch.rand(
            (batch_size, 2, cfg.goal_seq_len, cfg.goal_dim), generator=generator,
            device=dev) < cfg.goal_drop
    n = n_step_draws(cfg.sampler_type, sampling_schedule(cfg)) if steps else 0
    if n:
        draws["step_noise"] = torch.randn((batch_size, n) + shape[1:],
                                          generator=generator, device=dev)
    return draws


def rank_draws(cfg: MDTVConfig, batch_sizes: Mapping[str, int],
               generator: torch.Generator) -> Dict[str, Dict]:
    """{scope: draws} of this rank's rows of a step: each scope's
    `make_draws` for the global batch (world size x its rows), in sorted
    scope order, from the same `generator` on every rank, then this rank's
    slice, so W ranks at b rows draw what one process draws at W * b. Over
    more than one rank the dropout masks come from a generator of the rank's
    own, seeded from (`generator`'s seed, rank): the masks are drawn per
    rank."""
    world, rank = parallel.world_size(), parallel.rank()
    draws = {s: make_draws(cfg, world * batch_sizes[s], generator) for s in sorted(batch_sizes)}
    if world == 1:
        return draws
    word = np.random.SeedSequence([generator.initial_seed(), rank]).generate_state(1, np.uint64)[0]
    dropout = torch.Generator(generator.device).manual_seed(int(word) >> 1)
    for s, d in draws.items():
        rows = slice(rank * batch_sizes[s], (rank + 1) * batch_sizes[s])
        draws[s] = {**{k: v[rows] for k, v in d.items() if k != "dropout"}, "dropout": dropout}
    return draws


@torch.no_grad()
def init_random_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from `generator`, in `named_parameters` order:
    biases 0, norm weights 1 (LayerNorm, GroupNorm, RMSNorm), LayerScale
    0.1, `logit_scale` log(1/0.07), latents and `ctx_dec_pe` N(0, 1),
    convolutions N(0, 1/fan_in), the CLIP
    projections N(0, 1/width), positional tables N(0, 0.01), everything else
    N(0, 0.02)."""
    for name, p in net.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = net.get_submodule(owner_name) if owner_name else net
        if leaf == "bias":
            p.zero_()
            continue
        if isinstance(owner, (nn.LayerNorm, nn.GroupNorm, RMSNorm, FrozenBatchNorm2d)):
            p.fill_(1.0)
            continue
        if isinstance(owner, LayerScale):
            p.fill_(0.1)
            continue
        if leaf == "logit_scale":
            p.fill_(math.log(1 / 0.07))
            continue
        if leaf in ("latents", "time_pos_emb", "ctx_dec_pe"):
            std = 1.0
        elif isinstance(owner, nn.Conv2d):
            std = (p[0].numel()) ** -0.5
        elif leaf in ("text_projection", "proj"):
            std = p.shape[0] ** -0.5
        elif leaf == "positional_embedding":
            std = 0.01
        else:
            std = 0.02
        draw = torch.randn(p.shape, generator=generator, device=generator.device)
        p.copy_(draw * std)
    return net


def sampling_schedule(cfg) -> np.ndarray:
    """The config's host float32 sigma schedule (num_sampling_steps + 1 values)."""
    return get_noise_schedule(cfg.num_sampling_steps, cfg.noise_scheduler,
                              cfg.sigma_min, cfg.sigma_max)


def hoists_context(cfg) -> bool:
    """Whether a replan encodes its context once: under AdaLN without the
    noise encoder the encoder never sees sigma (JAX `hoist_context`,
    mdtv_agent.py:525); the other configs re-encode at every denoiser call,
    as JAX does."""
    return cfg.use_ada_conditioning and not cfg.use_noise_encoder


def step_draws(cfg, batch: int, generator: torch.Generator) -> Optional[torch.Tensor]:
    """The config's sampler's per-step N(0, 1) draws for a (batch, W, A)
    chunk, (n, batch, W, A), from `generator`; None for a deterministic
    sampler."""
    n = n_step_draws(cfg.sampler_type, sampling_schedule(cfg))
    if not n:
        return None
    return torch.randn((n, batch, cfg.act_window_size, cfg.action_dim),
                       generator=generator, device=generator.device)


@torch.no_grad()
def denoise_actions(net: nn.Module, perceptual_emb: Dict[str, torch.Tensor],
                    latent_goal: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None,
                    step_noise: Optional[torch.Tensor] = None,
                    modality: str = "lang", return_context: bool = False,
                    stats: Optional[dict] = None):
    """Sample a (B, act_window_size, action_dim) action chunk with the
    config's sampler, schedule and number of steps, through the net's
    `encode_context` and `decode_actions` (an `MDTVAgentNet` or an
    `MDTAgentNet`; `perceptual_emb` is what its `perceive` returns).

    Under AdaLN without the noise encoder the encoder never sees sigma, so
    the context is computed once, before the sampling loop; the other
    configs encode at every denoiser call, at that call's sigma, as JAX
    does. The initial state is x = N(0, 1) * sigma_max, with the N(0, 1)
    draw taken from `generator` (on the goal's device) or passed in as
    `noise`; a stochastic sampler's per-step draws come likewise, after it,
    or as `step_noise` (n, B, W, A) (`samplers.n_step_draws`).
    `return_context` also returns the context (at sigma_max where the
    encoder sees sigma; the validation step feeds it to the foresight
    decoder). `stats` receives dpm_adaptive's step counts."""
    cfg = net.cfg
    sigmas = sampling_schedule(cfg)
    if latent_goal.ndim == 2:
        latent_goal = latent_goal[:, None, :]
    B = latent_goal.shape[0]
    hoist = hoists_context(cfg)
    full = lambda value: torch.full((B,), float(value), dtype=torch.float32,
                                    device=latent_goal.device)
    context = net.encode_context(perceptual_emb, latent_goal, full(sigmas[0]),
                                 modality=modality) if hoist or return_context else None

    def denoise_fn(x, sigma):
        sigma_b = torch.full((B,), float(sigma), dtype=x.dtype, device=x.device)
        ctx = context if hoist else net.encode_context(perceptual_emb, latent_goal,
                                                       sigma_b, modality=modality)
        return precond_denoise(lambda xin, s: net.decode_actions(ctx, xin, s),
                               x, sigma_b, cfg.sigma_data)

    shape = (B, cfg.act_window_size, cfg.action_dim)
    if noise is None:
        if generator is None:
            raise ValueError("denoise_actions needs a generator or the noise")
        noise = torch.randn(shape, generator=generator, device=latent_goal.device)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"noise must be {shape}, got {tuple(noise.shape)}")
    n = n_step_draws(cfg.sampler_type, sigmas)
    if n and step_noise is None:
        if generator is None:
            raise ValueError(f"the {cfg.sampler_type} sampler needs a generator or "
                             "its step_noise")
        step_noise = step_draws(cfg, B, generator)
    if n and tuple(step_noise.shape) != (n,) + shape:
        raise ValueError(f"step_noise must be {(n,) + shape}, got "
                         f"{tuple(step_noise.shape)}")
    x = noise.to(device=latent_goal.device, dtype=torch.float32) * cfg.sigma_max
    actions = sample_loop(cfg.sampler_type, denoise_fn, x, sigmas,
                          noise=step_noise if n else None, stats=stats)
    return (actions, context) if return_context else actions


# ---------------------------------------------------------------------------
# Train state and steps (either net: the trainables are the parameters
# outside the net's `frozen_prefixes`)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The net (an `MDTVAgentNet` or an `MDTAgentNet`), its optimizer over
    the trainables, the EMA of the trainables (the frozen towers are their
    own EMA) and the step counter."""
    net: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Dict[str, torch.Tensor]
    step: int = 0


def make_optimizer(net: nn.Module) -> torch.optim.AdamW:
    """One AdamW group over every trainable parameter (JAX make_optimizer,
    :376-386; the MDT agent's, mdt_agent.py:223-228, is the same): betas and weight decay from the config, eps 1e-8. Torch's
    decoupled decay, p <- p - lr*wd*p, is optax.adamw's term for term. The
    learning rate is set by `train_step` from the tri-stage schedule."""
    c = net.cfg.optimizer
    return torch.optim.AdamW([p for _, p in net.trainable_parameters()],
                             lr=c.learning_rate, betas=c.betas, eps=1e-8,
                             weight_decay=c.transformer_weight_decay)


def init_train_state(net: nn.Module) -> TrainState:
    """Step 0: a fresh optimizer and an EMA equal to the trainables, on the
    net's device."""
    return TrainState(net=net, optimizer=make_optimizer(net),
                      ema={n: p.detach().clone() for n, p in net.trainable_parameters()})


def _on_device(batch: Mapping[str, Batch], device) -> Dict[str, Dict[str, torch.Tensor]]:
    return {scope: {k: torch.as_tensor(v).to(device) for k, v in b.items()}
            for scope, b in batch.items()}


def _global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def train_step(state: TrainState, batch: Mapping[str, Batch], *,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Mapping[str, Mapping]] = None) -> Dict:
    """One optimizer step over the dual-modality batch {scope: batch} (JAX
    train_step, :430-476), on the net's device.

    The sorted scopes run in train mode, their total losses are averaged and
    one backward runs over the trainables (the frozen towers ran under
    no_grad). AdamW steps at the schedule's lr of the pre-increment step; the
    EMA updates with the decay of the post-increment step. The gradients stay
    in `.grad` until the next step. `draws` ({scope: make_draws(...)} of
    this batch's rows) or `generator` gives the step's random numbers.
    Returns the metrics of the JAX step under the same names.

    With a process group up (`parallel`), the batch is this rank's shard of
    the global batch: the generator's draws are this rank's rows of the
    global batch's (`rank_draws`), the contrastive loss runs over the global
    batch, and the gradients are averaged over the ranks after the zero fill
    and before the norm and AdamW, so every rank takes the same step. The
    shards must have equal rows (the averaged means are then the global
    batch's); unequal ones raise. The metrics stay this rank's (the
    contrastive loss is global): `parallel.reduce_metrics` averages them.

    Under a profile (`utils/profiling.py`) the step is the span `train.step`
    (its rid `state.step`): `train.forward` a scope, `train.backward`, and
    `train.tail` with its parts `train.grad_fill`, `train.all_reduce` (with
    a process group), `train.grad_norm`, `train.adamw`, `train.param_norm`
    and `train.ema`. They time the host's issue: the card runs behind it."""
    with span("train.step", state.step):
        net, opt = state.net, state.optimizer
        batch = _on_device(batch, net.device)
        scopes = sorted(batch)
        rows = {s: batch[s]["actions"].shape[0] for s in scopes}
        if parallel.is_initialized():
            for n in sorted(set(rows.values())):
                parallel.check_equal_rows(n)
        if draws is None:
            if generator is None:
                raise ValueError("train_step needs a generator or the draws")
            draws = rank_draws(net.cfg, rows, generator)
        opt.zero_grad(set_to_none=True)
        metrics: Dict = {}
        total = 0.0
        for scope in scopes:
            with span("train.forward"):
                out = net(batch[scope], scope, train=True, draws=draws[scope])
                total = total + out["total_loss"]
                metrics.update({f"{scope}/{k}": v.detach() for k, v in out.items()})
        total = total / len(scopes)
        metrics["train/total_loss"] = total.detach()
        with span("train.backward"):
            total.backward()

        with span("train.tail"):
            trainable = net.trainable_parameters()
            with span("train.grad_fill"):
                for _, p in trainable:
                    if p.grad is None:  # unused this step: optax still decays it
                        p.grad = torch.zeros_like(p)
            if parallel.is_initialized():
                with span("train.all_reduce"):
                    parallel.all_reduce_gradients(p for _, p in trainable)
            with span("train.grad_norm"):
                metrics["train/grad_norm"] = _global_norm(p.grad for _, p in trainable)
            lr = lr_schedule_from_cfg(net.cfg)(state.step)
            for group in opt.param_groups:
                group["lr"] = lr
            with span("train.adamw"):
                opt.step()
            with span("train.param_norm"):
                metrics["train/param_norm"] = _global_norm(p.detach() for _, p in trainable)
            metrics["train/lr"] = lr
            decay = ema_decay(state.step + 1)
            with span("train.ema"):
                ema_update(state.ema, trainable, decay)
            metrics["train/ema_rate"] = decay
            state.step += 1
        return metrics


@torch.no_grad()
def validation_step(net: nn.Module, batch: Mapping[str, Batch], *,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Mapping[str, Mapping]] = None) -> Dict:
    """Validation metrics per scope (JAX validation_step, :581-624): the
    config's sampler (DDIM-10) through `denoise_actions`, the action MSE
    against the ground truth, and the foresight loss on the context. Uses
    draws[scope]["noise"] (initial noise), ["mask"] and, for a stochastic
    sampler, ["step_noise"]. A cache batch skips the towers, as in
    `MDTVAgentNet.forward`."""
    batch = _on_device(batch, net.device)
    scopes = sorted(batch)
    if draws is None:
        if generator is None:
            raise ValueError("validation_step needs a generator or the draws")
        draws = {s: make_draws(net.cfg, batch[s]["actions"].shape[0], generator,
                               steps=True) for s in scopes}
    metrics: Dict = {}
    total = 0.0
    for scope in scopes:
        b, d = batch[scope], draws[scope]
        emb, _, goal = net.encode_towers(b, scope)
        steps = d.get("step_noise")
        pred, context = denoise_actions(
            net, emb, goal, noise=d["noise"], modality=scope, return_context=True,
            step_noise=None if steps is None else steps.transpose(0, 1))
        pred_loss = ((pred - b["actions"].float()) ** 2).mean()
        goal_imgs = torch.stack([b["gen_static"], b["gen_gripper"]], dim=1)
        recon, mask, _, _ = net.gen_img(context, goal_imgs, d["mask"])
        metrics[f"val_act/{scope}_act_loss_pp"] = pred_loss
        metrics[f"val_act/{scope}_img_gen_loss"] = net.gen_img.compute_loss(
            goal_imgs, recon, mask)
        total = total + pred_loss
    metrics["val_act/action_loss"] = total / len(scopes)
    return metrics


@torch.no_grad()
def reconstruction_forward(net: nn.Module, b: Batch, mask_noise: torch.Tensor, *,
                           modality: str = "lang"):
    """Masked-foresight reconstruction of one scope for visualization (JAX
    `reconstruction_forward`, mdtv_agent.py:545-578): the context encoded
    once at sigma_max (which only the sigma-token encoder reads), then the
    foresight decoder with the uniform draw `mask_noise`
    (B, n_patches). The goal is the text tower's in the lang scope when the
    batch carries tokens, else the image goal, as in JAX; either net and
    cache batches. Returns (goal_imgs, recon, mask) for
    `models.masked_decoder.reconstruct_images`."""
    if "voltron_tokens" in b and "image_latent_goal" in b:
        emb = net.perceive_tokens(b["voltron_tokens"])
        image_goal = b["image_latent_goal"].float()
    else:
        emb = net.perceive(b["rgb_static"][:, :-1], b["rgb_gripper"][:, :-1])
        image_goal = net.encode_visual_goal(b["rgb_static"][:, -1])
    goal = net.encode_language_goal(b["lang_tokens"]) \
        if modality == "lang" and "lang_tokens" in b else image_goal
    if goal.ndim == 2:
        goal = goal[:, None]
    sigma = torch.full((goal.shape[0],), net.cfg.sigma_max, device=goal.device)
    context = net.encode_context(emb, goal, sigma, modality=modality)
    goal_imgs = torch.stack([b["gen_static"], b["gen_gripper"]], dim=1)
    recon, mask, _, _ = net.gen_img(context, goal_imgs, mask_noise)
    return goal_imgs, recon, mask


# ---------------------------------------------------------------------------
# Closed-loop policy
# ---------------------------------------------------------------------------

class MDTVPolicy:
    """Closed-loop `reset() / step(obs, goal)` with action chunking: a replan
    every `multistep` env steps, the cached chunk replayed in between. The
    CLIP text tower runs once per goal, eagerly, as the JAX policy's
    `_encode_lang` is its own program: its embedding is cached for as long
    as the goal tokens do not change. A replan is `_predict_emb` (perceive,
    then `denoise_actions` from a goal embedding) or, for a goal image,
    `_predict_vis` (the CLIP vision tower too, in the "vis" modality), the
    counterparts of the JAX policy's jitted `_predict_emb` and
    `_predict_vis`. It serves either agent through the nets' uniform
    `perceive`, goal and `denoise_actions` entries (`MDTPolicy` is the same
    class).

    `cuda_graph` (default: whether the net is on a CUDA device) runs each
    replan as the replay of a `torch.cuda.CUDAGraph`, captured on first use
    for each (method, input shapes): the port's counterpart of `jax.jit`.
    The inputs are copied into the graph's static buffers; the initial
    noise and a stochastic sampler's per-step draws are drawn from
    `generator` outside the graph and passed in, so a graph policy and an
    eager one give the same chunk from the same seed. A graph reads the
    net's parameters where they were at capture: load new weights into
    them in place (`load_state_dict`), or `release` the graphs, or make a
    new policy. A capture that fails raises. The kernels' launch counters
    count a captured kernel at each replay, where it runs, and not at the
    capture, which runs none. The dpm_adaptive sampler accepts or rejects
    its steps on the host, which a graph cannot replay: its policy runs
    eagerly (the default), and `cuda_graph=True` raises.

    Under a profile (`utils/profiling.py`) a replan is the span
    `policy.plan`, with the text tower's run `policy.goal_encode` and the
    graph's `policy.replay` (the inputs' copies into its buffers, the
    replay, the output's clone) inside it; counters
    `policy.goal_rows_encoded`, `policy.goal_rows_changed` and
    `policy.graph_captures`."""

    def __init__(self, net: nn.Module,
                 generator: Optional[torch.Generator] = None,
                 cuda_graph: Optional[bool] = None):
        self.net, self.cfg = net, net.cfg
        if self.cfg.multistep > self.cfg.act_window_size:
            raise ValueError(f"multistep={self.cfg.multistep} exceeds "
                             f"act_window_size={self.cfg.act_window_size}")
        self.device = net.device
        on_cuda = self.device.type == "cuda"
        adaptive = self.cfg.sampler_type == "dpm_adaptive"
        self.cuda_graph = (on_cuda and not adaptive) if cuda_graph is None else cuda_graph
        if self.cuda_graph and adaptive:
            raise ValueError("cuda_graph=True cannot serve the dpm_adaptive sampler: its "
                             "step count depends on the data, decided on the host step "
                             "by step, and a CUDA graph replays a fixed sequence of "
                             "kernels; use cuda_graph=False")
        if self.cuda_graph and not on_cuda:
            raise ValueError(f"cuda_graph=True needs a net on a CUDA device, "
                             f"not {self.device}")
        self.generator = generator if generator is not None \
            else torch.Generator(self.device).manual_seed(0)
        # (method name, input shapes and dtypes) ->
        # (graph, inputs, output, kernel launches a replay)
        self._graphs: Dict[Tuple, Tuple] = {}
        self.reset()

    def reset(self):
        self.rollout_step_counter = 0
        self.pred_action_seq = None
        self._goal_tokens = None
        self._goal_emb = None

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def _draw_noise(self, batch: int) -> torch.Tensor:
        """The replan's initial N(0, 1) draw, (batch, act_window_size,
        action_dim), from `generator`, outside any graph."""
        return torch.randn((batch, self.cfg.act_window_size, self.cfg.action_dim),
                           generator=self.generator, device=self.device)

    def _draw_steps(self, batch: int) -> Tuple[torch.Tensor, ...]:
        """The sampler's per-step N(0, 1) draws of the replan, after the
        initial one: () for a deterministic sampler, else one (n, batch,
        act_window_size, action_dim) tensor."""
        steps = step_draws(self.cfg, batch, self.generator)
        return () if steps is None else (steps,)

    def _predict_emb(self, rgb_static, rgb_gripper, latent_goal, noise, *steps):
        """Replan from a goal embedding (JAX `_predict_emb_impl`): a stored
        language embedding or this policy's cached text-tower output."""
        emb = self.net.perceive(rgb_static, rgb_gripper)
        return denoise_actions(self.net, emb, latent_goal, noise=noise,
                               step_noise=steps[0] if steps else None, modality="lang")

    def _predict_vis(self, rgb_static, rgb_gripper, goal_image, noise, *steps):
        """Replan from a goal image (JAX `_predict_vis_impl`): the frozen
        CLIP vision tower embeds it, in the "vis" modality."""
        emb = self.net.perceive(rgb_static, rgb_gripper)
        latent_goal = self.net.encode_visual_goal(goal_image)
        return denoise_actions(self.net, emb, latent_goal, noise=noise,
                               step_noise=steps[0] if steps else None, modality="vis")

    WARMUP_CALLS = 2  # eager calls on a side stream before a capture

    def _capture(self, predict, inputs):
        """(graph, static inputs, static output, kernel launches a replay)
        of `predict`, after WARMUP_CALLS eager calls on a side stream
        (kernel libraries loaded, library handles and workspaces made). The
        capture is thread-local: another thread's CUDA work (the training
        loop's prefetcher) goes on during it, on its own streams."""
        static = [t.clone() for t in inputs]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP_CALLS):
                predict(*static)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with recording_launches() as launched, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = predict(*static)
        return graph, static, out, launched

    def release(self) -> None:
        """Drop the captured graphs and their memory; the next replan
        captures again. Call it before the net's parameters are swapped
        (a graph reads them where they were at capture)."""
        self._graphs.clear()

    def _run(self, predict, *inputs) -> torch.Tensor:
        """`predict(*inputs)`, eagerly or as the replay of its graph."""
        if not self.cuda_graph:
            return predict(*inputs)
        key = (predict.__name__, tuple((tuple(t.shape), t.dtype) for t in inputs))
        if key not in self._graphs:
            count("policy.graph_captures")
            self._graphs[key] = self._capture(predict, inputs)
        graph, static, out, launched = self._graphs[key]
        with span("policy.replay"):
            for buf, t in zip(static, inputs):
                buf.copy_(t)
            graph.replay()
            count_replay(launched)
            return out.clone()  # the next replay overwrites `out`

    @torch.no_grad()
    def plan(self, obs: Dict, goal: Dict) -> torch.Tensor:
        """One replan: the (B, act_window_size, action_dim) chunk for `obs`
        and `goal` (as `step` takes them), the text goal's embedding cached
        across calls for as long as its tokens do not change."""
        with span("policy.plan"):
            rgb_static = self._tensor(obs["rgb_static"], torch.float32)
            rgb_gripper = self._tensor(obs["rgb_gripper"], torch.float32)
            noise = self._draw_noise(rgb_static.shape[0])
            steps = self._draw_steps(rgb_static.shape[0])
            if "lang_tokens" in goal:
                toks = goal["lang_tokens"]
                toks = toks.cpu().numpy() if torch.is_tensor(toks) else np.asarray(toks)
                if self._goal_tokens is None or not np.array_equal(toks, self._goal_tokens):
                    if recording():
                        self._count_goal_rows(toks)
                    with span("policy.goal_encode"):
                        self._goal_emb = self.net.encode_language_goal(self._tensor(toks))
                    self._goal_tokens = toks
                goal_emb = self._goal_emb
            elif "rgb_static_goal" in goal:
                image = self._tensor(goal["rgb_static_goal"], torch.float32)
                return self._run(self._predict_vis, rgb_static, rgb_gripper,
                                 image[None] if image.ndim == 3 else image, noise, *steps)
            else:
                goal_emb = torch.atleast_2d(self._tensor(goal["lang"], torch.float32))
            return self._run(self._predict_emb, rgb_static, rgb_gripper, goal_emb, noise,
                             *steps)

    def _count_goal_rows(self, toks: np.ndarray) -> None:
        """Counters `policy.goal_rows_encoded` (the rows the text tower is
        given) and `policy.goal_rows_changed` (those whose tokens differ
        from the cached goal's; all of them when none is cached)."""
        rows = toks.reshape(-1, toks.shape[-1])
        old = self._goal_tokens
        changed = len(rows) if old is None or old.shape != toks.shape else \
            int((rows != old.reshape(rows.shape)).any(axis=1).sum())
        count("policy.goal_rows_encoded", len(rows))
        count("policy.goal_rows_changed", changed)

    @torch.no_grad()
    def step(self, obs: Dict, goal: Dict) -> torch.Tensor:
        """obs: {'rgb_static': (B,T,H,W,3), 'rgb_gripper': ...};
        goal: {'lang_tokens': (B,77)}, {'lang': (B,512) embedding} or
        {'rgb_static_goal': (B,H,W,3) CLIP-normalized goal frame}.
        Returns the current (B, action_dim) action."""
        if self.rollout_step_counter % self.cfg.multistep == 0:
            self.pred_action_seq = self.plan(obs, goal)
        action = self.pred_action_seq[:, self.rollout_step_counter % self.cfg.multistep]
        self.rollout_step_counter += 1
        if self.rollout_step_counter == self.cfg.multistep:
            self.rollout_step_counter = 0
        return action
