"""MDT-V agent (port of `mdt_policy_tpu/agents/mdtv_agent.py`): the network
bundle, its per-scope losses, the train and validation steps, and the
closed-loop replan.

`MDTVAgentNet` holds every network of the agent under the JAX package's
names: the frozen Voltron ViT (`img_encoder`), the perceiver resampler
(`perceiver`), the frozen CLIP vision and text towers (`visual_goal`,
`language_goal`), the denoiser (`inner`), the masked foresight decoder
(`gen_img`), the contrastive head (`clip_proj`) and its temperature
(`logit_scale`). It builds on the CUDA device unless the caller names
another one (`device="cpu"`).

Dtypes follow the JAX defaults: frozen towers hold bf16 weights and compute
in bf16 (`compute_dtype`) under `torch.no_grad()`, the perceiver keeps f32
weights and computes in bf16 with an f32 final LayerNorm, the denoiser is
f32, the foresight decoder keeps f32 master weights and computes in
`gen_compute_dtype`. Public layouts are the JAX package's: images NHWC
(B, T, H, W, 3), tokens (B, 77) int, actions (B, 10, 7).

Every random number of a step (the sigma density's uniform draw, the action
noise, the foresight mask's uniform draw, the denoiser's dropout) comes from
a `draws` dict per scope, made by `make_draws` from an explicit
`torch.Generator` or handed in by the caller.

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

from ..diffusion import (append_dims, get_noise_schedule, get_scalings,
                         make_sample_density, precond_denoise, sample_loop)
from ..models.blocks import ClipStyleProjection, RMSNorm
from ..models.clip import CLIPTextTower, CLIPVisionTower
from ..models.masked_decoder import MaskedTransformerImgDecoder
from ..models.mdtv_transformer import MDTVTransformer
from ..models.perceiver import PerceiverResampler
from ..models.voltron_vit import LayerScale, VoltronViT
from ..utils.ema import ema_decay, ema_update
from ..utils.schedulers import lr_schedule_from_cfg
from .config import MDTVConfig

__all__ = ["FROZEN_PREFIXES", "MDTVAgentNet", "MDTVPolicy", "TrainState",
           "denoise_actions", "init_random_", "init_train_state", "make_draws",
           "make_optimizer", "resize_nhwc", "train_step", "validation_step"]

# top-level networks that stay frozen: no gradient, no optimizer state, no
# EMA copy (JAX mdtv_agent.py:57)
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


# config values the port implements; any other value is rejected, not ignored
_PORTED = {"sampler_type": "ddim", "use_ada_conditioning": True,
           "use_noise_encoder": False, "use_modality_encoder": True,
           "use_mlp_goal": True, "denoiser_compute_dtype": "float32",
           "clip_vision_family": "vit", "freeze_img_encoder": True,
           "sigma_sample_density_type": "loglogistic", "embed_pdrob": 0.0,
           "goal_drop": 0.0}


def check_ported(cfg: MDTVConfig) -> None:
    """Raises NotImplementedError for a config value the port lacks."""
    unported = {k: getattr(cfg, k) for k, v in _PORTED.items()
                if getattr(cfg, k) != v}
    if unported:
        raise NotImplementedError(
            f"config values not ported yet: {unported} (ported: the "
            f"production values {_PORTED}; ROADMAP queue A item 18)")


def default_device(device) -> torch.device:
    """The CUDA device unless the caller names one; never a silent CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the agent nets build on the CUDA device by default "
                           "and no CUDA device is available; pass device='cpu' "
                           "to build on the CPU")
    return torch.device("cuda")


class MDTVAgentNet(nn.Module):
    """The MDT-V networks, built on `device` (default: CUDA)."""

    def __init__(self, cfg: MDTVConfig, device=None):
        super().__init__()
        check_ported(cfg)
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
        self.visual_goal = CLIPVisionTower(
            c.clip_embed_dim, c.img_size, c.clip_vision_layers,
            c.clip_vision_width, c.clip_vision_patch).to(dtype=tower_dt)
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
            mlp_pdrop=c.mlp_pdrop)
        self.gen_img = MaskedTransformerImgDecoder(
            c.gen_img_res, c.gen_patch_size, c.gen_decoder_depth,
            c.gen_decoder_dim, c.gen_decoder_heads, context_dim=c.latent_dim,
            mask_ratio=c.gen_mask_ratio,
            dtype=None if gen_dt == torch.float32 else gen_dt)
        # style 'map' over the whole context, token_dim=latent_dim (JAX :159-163)
        self.clip_proj = ClipStyleProjection(token_dim=c.latent_dim)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        for name in FROZEN_PREFIXES:
            getattr(self, name).requires_grad_(False)
        self.sample_density = make_sample_density(
            c.sigma_sample_density_type, c.sigma_data, c.sigma_min, c.sigma_max)
        self.to(device=device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.inner.tok_emb.weight.device

    def trainable_parameters(self) -> List[Tuple[str, nn.Parameter]]:
        """(name, parameter) of every network outside FROZEN_PREFIXES."""
        return [(n, p) for n, p in self.named_parameters()
                if n.split(".", 1)[0] not in FROZEN_PREFIXES]

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
        goal frame, float32."""
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

    def encode_context(self, perceptual_emb, latent_goal, *, modality: str,
                       generator: Optional[torch.Generator] = None):
        return self.inner.encode(perceptual_emb, latent_goal, modality=modality,
                                 generator=generator)

    def decode_actions(self, context, actions, sigma,
                       generator: Optional[torch.Generator] = None):
        return self.inner.decode(context, actions, sigma, generator)

    # ---- losses (one modality scope) ------------------------------------------

    def forward(self, batch: Batch, modality: str, *, train: bool = True,
                draws: Mapping) -> Dict[str, torch.Tensor]:
        """Per-scope losses (JAX `__call__`, mdtv_agent.py:259-348).

        batch: rgb_static / rgb_gripper (B, T+1, H, W, 3), the last frame
        the goal frame, or the cache's voltron_tokens (B, 2N, D) and
        image_latent_goal (B, E); gen_static / gen_gripper (B, h, w, 3);
        actions (B, W, A); lang_tokens (B, 77) or lang_latent_goal (B, E) in
        the lang scope; state_obs when the config feeds proprio. draws:
        `make_draws` of this scope. `train`
        turns the denoiser's dropout on (drawn from `draws["dropout"]`).
        Returns action_loss, img_gen_loss, cont_loss and total_loss."""
        c = self.cfg
        actions = batch["actions"].float()
        generator = draws.get("dropout") if train else None
        if generator is None and train and max(c.attn_pdrop, c.resid_pdrop,
                                               c.mlp_pdrop) > 0:
            raise ValueError("train mode needs draws['dropout'], a torch.Generator")

        perceptual_emb, image_latent_goal, latent_goal = self.encode_towers(batch, modality)
        if c.use_proprio and "state_obs" in batch:
            perceptual_emb["state_obs"] = batch["state_obs"].float()

        # diffusion loss (JAX :312-325)
        sigmas = self.sample_density(draws["sigma"])
        c_skip, c_out, c_in = (append_dims(s, actions.ndim)
                               for s in get_scalings(sigmas, c.sigma_data))
        noised = actions + draws["noise"] * append_dims(sigmas, actions.ndim)
        context = self.encode_context(perceptual_emb, latent_goal,
                                      modality=modality, generator=generator)
        model_out = self.decode_actions(context, noised * c_in, sigmas, generator)
        target = (actions - c_skip * noised) / c_out
        action_loss = ((model_out - target) ** 2).mean()

        # masked generative foresight loss (JAX :327-330)
        goal_imgs = torch.stack([batch["gen_static"], batch["gen_gripper"]], dim=1)
        recon, mask, _, _ = self.gen_img(context, goal_imgs, draws["mask"])
        img_gen_loss = self.gen_img.compute_loss(goal_imgs, recon, mask)

        # contrastive latent alignment, lang scope only (JAX :332-340): the
        # image goal goes through the language projection, as in JAX
        if modality == "lang":
            vis_context = self.encode_context(perceptual_emb, image_latent_goal,
                                              modality="lang", generator=generator)
            cont_loss = self.clip_auxiliary_loss(self.clip_proj(vis_context),
                                                 self.clip_proj(context))
        else:
            cont_loss = actions.new_zeros(())

        total = action_loss + c.masked_beta * img_gen_loss + c.cont_alpha * cont_loss
        return {"action_loss": action_loss, "img_gen_loss": img_gen_loss,
                "cont_loss": cont_loss, "total_loss": total}

    def clip_auxiliary_loss(self, image_features: torch.Tensor,
                            lang_features: torch.Tensor) -> torch.Tensor:
        """Symmetric InfoNCE over the batch (JAX :350-361)."""
        img = image_features / torch.linalg.vector_norm(image_features, dim=-1,
                                                        keepdim=True)
        lang = lang_features / torch.linalg.vector_norm(lang_features, dim=-1,
                                                        keepdim=True)
        sim = self.logit_scale.exp() * img @ lang.T
        labels = torch.arange(sim.shape[0], device=sim.device)
        return (F.cross_entropy(sim, labels) + F.cross_entropy(sim.T, labels)) / 2


def make_draws(cfg: MDTVConfig, batch_size: int,
               generator: torch.Generator) -> Dict:
    """The random numbers of one scope of a step, from `generator` on its
    device: "sigma" (B,) uniform for the sigma density, "noise" (B, W, A)
    normal action noise, "mask" (B, n_patches) uniform for the foresight
    mask, and "dropout", the generator itself, for the denoiser's dropout."""
    dev = generator.device
    n_patches = (cfg.gen_img_res // cfg.gen_patch_size) ** 2
    return {
        "sigma": torch.rand((batch_size,), generator=generator, device=dev),
        "noise": torch.randn((batch_size, cfg.act_window_size, cfg.action_dim),
                             generator=generator, device=dev),
        "mask": torch.rand((batch_size, n_patches), generator=generator, device=dev),
        "dropout": generator,
    }


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
        if isinstance(owner, (nn.LayerNorm, nn.GroupNorm, RMSNorm)):
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


@torch.no_grad()
def denoise_actions(net: nn.Module, perceptual_emb: Dict[str, torch.Tensor],
                    latent_goal: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None,
                    modality: str = "lang", return_context: bool = False):
    """Sample a (B, act_window_size, action_dim) action chunk with the
    config's sampler, schedule and number of steps, through the net's
    `encode_context` and `decode_actions` (an `MDTVAgentNet` or an
    `MDTAgentNet`; `perceptual_emb` is what its `perceive` returns).

    The encoder runs once: under AdaLN conditioning it never sees sigma, so
    the context is computed before the sampling loop. The initial state is
    x = N(0, 1) * sigma_max, with the N(0, 1) draw taken from `generator`
    (on the goal's device) or passed in as `noise`. `return_context` also
    returns that context (the validation step feeds it to the foresight
    decoder)."""
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
    actions = sample_loop(cfg.sampler_type, denoise_fn, x, sigmas)
    return (actions, context) if return_context else actions


# ---------------------------------------------------------------------------
# Train state and steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The net, its optimizer over the trainables, the EMA of the
    trainables (the frozen towers are their own EMA) and the step counter."""
    net: MDTVAgentNet
    optimizer: torch.optim.Optimizer
    ema: Dict[str, torch.Tensor]
    step: int = 0


def make_optimizer(net: MDTVAgentNet) -> torch.optim.AdamW:
    """One AdamW group over every trainable parameter (JAX make_optimizer,
    :376-386): betas and weight decay from the config, eps 1e-8. Torch's
    decoupled decay, p <- p - lr*wd*p, is optax.adamw's term for term. The
    learning rate is set by `train_step` from the tri-stage schedule."""
    c = net.cfg.optimizer
    return torch.optim.AdamW([p for _, p in net.trainable_parameters()],
                             lr=c.learning_rate, betas=c.betas, eps=1e-8,
                             weight_decay=c.transformer_weight_decay)


def init_train_state(net: MDTVAgentNet) -> TrainState:
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
    in `.grad` until the next step. `draws` ({scope: make_draws(...)}) or
    `generator` gives the step's random numbers. Returns the metrics of the
    JAX step under the same names."""
    net, opt = state.net, state.optimizer
    batch = _on_device(batch, net.device)
    scopes = sorted(batch)
    if draws is None:
        if generator is None:
            raise ValueError("train_step needs a generator or the draws")
        draws = {s: make_draws(net.cfg, batch[s]["actions"].shape[0], generator)
                 for s in scopes}
    opt.zero_grad(set_to_none=True)
    metrics: Dict = {}
    total = 0.0
    for scope in scopes:
        out = net(batch[scope], scope, train=True, draws=draws[scope])
        total = total + out["total_loss"]
        metrics.update({f"{scope}/{k}": v.detach() for k, v in out.items()})
    total = total / len(scopes)
    metrics["train/total_loss"] = total.detach()
    total.backward()

    trainable = net.trainable_parameters()
    for _, p in trainable:
        if p.grad is None:  # unused this step: optax still decays it
            p.grad = torch.zeros_like(p)
    metrics["train/grad_norm"] = _global_norm(p.grad for _, p in trainable)
    lr = lr_schedule_from_cfg(net.cfg)(state.step)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    metrics["train/param_norm"] = _global_norm(p.detach() for _, p in trainable)
    metrics["train/lr"] = lr
    decay = ema_decay(state.step + 1)
    ema_update(state.ema, trainable, decay)
    metrics["train/ema_rate"] = decay
    state.step += 1
    return metrics


@torch.no_grad()
def validation_step(net: MDTVAgentNet, batch: Mapping[str, Batch], *,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Mapping[str, Mapping]] = None) -> Dict:
    """Validation metrics per scope (JAX validation_step, :581-624): the
    config's sampler (DDIM-10) from the hoisted context, the action MSE
    against the ground truth, and the foresight loss on that context. Uses
    draws[scope]["noise"] (initial noise) and ["mask"]. A cache batch skips
    the towers, as in `MDTVAgentNet.forward`."""
    batch = _on_device(batch, net.device)
    scopes = sorted(batch)
    if draws is None:
        if generator is None:
            raise ValueError("validation_step needs a generator or the draws")
        draws = {s: make_draws(net.cfg, batch[s]["actions"].shape[0], generator)
                 for s in scopes}
    metrics: Dict = {}
    total = 0.0
    for scope in scopes:
        b, d = batch[scope], draws[scope]
        emb, _, goal = net.encode_towers(b, scope)
        pred, context = denoise_actions(net, emb, goal, noise=d["noise"],
                                        modality=scope, return_context=True)
        pred_loss = ((pred - b["actions"].float()) ** 2).mean()
        goal_imgs = torch.stack([b["gen_static"], b["gen_gripper"]], dim=1)
        recon, mask, _, _ = net.gen_img(context, goal_imgs, d["mask"])
        metrics[f"val_act/{scope}_act_loss_pp"] = pred_loss
        metrics[f"val_act/{scope}_img_gen_loss"] = net.gen_img.compute_loss(
            goal_imgs, recon, mask)
        total = total + pred_loss
    metrics["val_act/action_loss"] = total / len(scopes)
    return metrics


# ---------------------------------------------------------------------------
# Closed-loop policy
# ---------------------------------------------------------------------------

class MDTVPolicy:
    """Closed-loop `reset() / step(obs, goal)` with action chunking: a replan
    every `multistep` env steps, the cached chunk replayed in between. The
    CLIP text tower runs once per goal: its embedding is cached for as long
    as the goal tokens do not change. A goal image runs the CLIP vision
    tower at every replan, in the "vis" modality. It serves either agent
    through the nets' uniform `perceive`, goal and `denoise_actions`
    entries (`MDTPolicy` is the same class)."""

    def __init__(self, net: nn.Module,
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
    def plan(self, obs: Dict, goal: Dict) -> torch.Tensor:
        """One replan: the (B, act_window_size, action_dim) chunk for `obs`
        and `goal` (as `step` takes them), the text goal's embedding cached
        across calls for as long as its tokens do not change."""
        modality = "lang"
        if "lang_tokens" in goal:
            toks = goal["lang_tokens"]
            toks = toks.cpu().numpy() if torch.is_tensor(toks) else np.asarray(toks)
            if self._goal_tokens is None or not np.array_equal(toks, self._goal_tokens):
                self._goal_tokens = toks
                self._goal_emb = self.net.encode_language_goal(self._tensor(toks))
            goal_emb = self._goal_emb
        elif "rgb_static_goal" in goal:
            image = self._tensor(goal["rgb_static_goal"], torch.float32)
            goal_emb = self.net.encode_visual_goal(image[None] if image.ndim == 3 else image)
            modality = "vis"
        else:
            goal_emb = torch.atleast_2d(self._tensor(goal["lang"], torch.float32))
        emb = self.net.perceive(self._tensor(obs["rgb_static"], torch.float32),
                                self._tensor(obs["rgb_gripper"], torch.float32))
        return denoise_actions(self.net, emb, goal_emb, generator=self.generator,
                               modality=modality)

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
