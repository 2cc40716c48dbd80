"""Plain PyTorch reference of MDT, the ResNet-18 sibling of MDT-V (Reuss et
al., RSS 2024; intuitive-robots/mdt_policy, conf/model/mdt_agent.yaml):
two trainable ResNet-18s with GroupNorm (C/16 groups) give one token a
camera, the denoiser (4 encoder and 6 AdaLN decoder layers, 512 wide)
embeds every goal with `goal_emb` and learns a position table over the
goal and state tokens, and the contrastive head takes the context's static
camera token. The CLIP towers, the denoiser's blocks, the sampler, the
foresight decoder and the optimizer are MDT-V's (`mdtv.py`).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from . import mdtv as V
from .common import Prec, eval_frames, lin, log_logistic, scalings

TOWERS = ("visual_goal", "language_goal")
train_frames_of = V.train_frames_of


def resnet(P, pr: Prec, images, pre: str):
    """ResNet-18-GN of (B, H, W, 3) normalized frames -> (B, 512) -> the
    linear head's (B, latent)."""
    def conv(x, name, stride, pad):
        return F.conv2d(x, P[name], stride=stride, padding=pad)

    def gn(x, name):
        return F.group_norm(x, x.shape[1] // 16, P[name + ".weight"], P[name + ".bias"], 1e-5)

    b = pre + ".backbone"
    x = images.permute(0, 3, 1, 2)
    x = F.relu(gn(conv(x, b + ".0.weight", 2, 3), b + ".1"))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for stage in range(4):
        for blk in range(2):
            n = f"{b}.{4 + stage}.{blk}"
            stride = 2 if (blk == 0 and stage > 0) else 1
            out = F.relu(gn(conv(x, n + ".conv1.weight", stride, 1), n + ".bn1"))
            out = gn(conv(out, n + ".conv2.weight", 1, 1), n + ".bn2")
            if n + ".downsample.0.weight" in P:
                x = gn(conv(x, n + ".downsample.0.weight", stride, 0), n + ".downsample.1")
            x = F.relu(out + x)
    return lin(pr, P, pre + ".fc_layers.0", x.mean(dim=(2, 3)))


def perceive(cfg, P, pr: Prec, static, gripper):
    """Frames (B, H, W, 3) of both cameras -> (B, 2, latent): the static
    token, then the gripper's."""
    return torch.stack([resnet(P, pr, static, "static_resnet"),
                        resnet(P, pr, gripper, "gripper_resnet")], dim=1)


def encode(cfg, P, pr, tokens, goal, goal_net: str = "inner.goal_emb", gen=None):
    goal = goal[:, None] if goal.ndim == 2 else goal
    pos = P["inner.pos_emb"]
    g = V.goal_mlp(P, pr, goal_net, goal) + pos[:, :1]
    s = torch.stack([lin(pr, P, "inner.tok_emb", tokens[:, 0:1]),
                     lin(pr, P, "inner.incam_embed", tokens[:, 1:2])], dim=2)
    s = s.reshape(tokens.shape[0], 2, -1) + pos[:, 1:2]
    return V.encoder(cfg, P, pr, torch.cat([g, s], dim=1), gen)


def replan(cfg, P, pr: Prec, raw_static, raw_gripper, tokens, noise):
    """Action chunks (B, W, A) of raw uint8 frames of both cameras, a text
    goal and the initial N(0, 1) draw."""
    with pr.scope():
        static = eval_frames(raw_static, cfg["img_size"])
        gripper = eval_frames(raw_gripper, min(84, cfg["img_size"]))
        tok = perceive(cfg, P, pr, static, gripper)
        goal = V.clip_text(cfg, P, pr, tokens)
        return V.ddim(cfg, P, pr, encode(cfg, P, pr, tok, goal), noise)


def scope_loss(cfg, P, pr, frames: Dict, draws: Dict, modality: str, gen):
    """Total loss of one scope: MDT-V's, with the ResNet tokens (their
    gradients flow), every goal through `goal_emb`, and the InfoNCE between
    the static tokens of the image goal's context (through `lang_emb`) and
    of the main context."""
    size = cfg["img_size"]
    with torch.no_grad():
        image_goal = V.blocks_of(lambda b: V.clip_vision(cfg, P, pr, V.resize(b, size)),
                                 frames["rgb_static"][:, -1])
        lang = V.clip_text(cfg, P, pr, frames["lang_tokens"]) if modality == "lang" else None
    tok = perceive(cfg, P, pr, frames["rgb_static"][:, 0], frames["rgb_gripper"][:, 0])
    goal = lang if modality == "lang" else image_goal
    actions = frames["actions"]
    sigmas = log_logistic(draws["sigma"], math.log(cfg["sigma_data"]), 0.5,
                          cfg["sigma_min"], cfg["sigma_max"])
    c_skip, c_out, c_in = (t[:, None, None] for t in scalings(sigmas, cfg["sigma_data"]))
    noised = actions + draws["noise"] * sigmas[:, None, None]
    context = encode(cfg, P, pr, tok, goal, gen=gen)
    out = V.decode(cfg, P, pr, context, noised * c_in, sigmas, gen)
    action_loss = ((out - (actions - c_skip * noised) / c_out) ** 2).mean()
    goal_imgs = torch.stack([frames["gen_static"], frames["gen_gripper"]], dim=1)
    total = action_loss + cfg["masked_beta"] * V.foresight(cfg, P, pr, context, goal_imgs,
                                                           draws["mask"])
    if modality == "lang":
        vis_context = encode(cfg, P, pr, tok, image_goal, "inner.lang_emb", gen)
        total = total + cfg["cont_alpha"] * V.info_nce(P, vis_context[:, 1], context[:, 1])
    return total


def train_steps(cfg, P, pr: Prec, steps):
    return V.train_steps(cfg, P, pr, steps, frozen=TOWERS, loss=scope_loss)
