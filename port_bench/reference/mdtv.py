"""Plain PyTorch reference of MDT-V (Reuss et al., RSS 2024, "Multimodal
Diffusion Transformer"; intuitive-robots/mdt_policy, conf/model/mdtv_agent.yaml):
the frozen Voltron ViT-S/16 and CLIP ViT-B/16 / text towers, the perceiver
resampler, the encoder-decoder denoiser with AdaLN sigma conditioning, the
EDM preconditioner and DDIM sampler, the masked foresight decoder, the MAP
contrastive head, and the losses of a train step.

Every function takes `cfg` (the configuration's field dict), the
parameters `P` (a dict under the agent's `state_dict` keys) and a `Prec`.
Activations are float32. Modules that the configuration runs in bfloat16
are marked `lowp`, which only the control reads.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .common import (Prec, attention, dropout, eval_frames, gelu, heads, layer_norm, lin,
                     linear, ln, log_logistic, merge, mish, quick_gelu, resize, rms_norm,
                     scalings, sigmas_exponential, sincos_2d)

TOWERS = ("img_encoder", "visual_goal", "language_goal")


# ---- frozen towers ---------------------------------------------------------

def voltron(cfg, P, pr: Prec, images, pre: str = "img_encoder"):
    """Voltron ViT: (B, H, W, 3) normalized images at the tower's size ->
    (B, n_patches, D) tokens."""
    w = P[pre + ".patch2embed.proj.weight"]
    x = F.conv2d(pr.q(images.permute(0, 3, 1, 2), True), pr.q(w, True),
                 P[pre + ".patch2embed.proj.bias"], stride=w.shape[-1])
    x = x.flatten(2).transpose(1, 2)
    D = x.shape[-1]
    x = x + torch.from_numpy(sincos_2d(D, int(round(x.shape[1] ** 0.5)))).to(x.device)
    for i in range(cfg["vit_depth"]):
        x = voltron_block(P, pr, x, f"{pre}.blocks.{i}", cfg["vit_heads"], True)
    return ln(P, pre + ".encoder_norm", x, 1e-6)


def voltron_block(P, pr, x, b: str, H: int, lowp: bool):
    h = rms_norm(x, P[b + ".norm1.g"])
    q, k, v = lin(pr, P, b + ".attn.qkv", h, lowp).chunk(3, dim=-1)
    a = merge(attention(pr, heads(q, H), heads(k, H), heads(v, H), lowp=lowp))
    x = x + lin(pr, P, b + ".attn.proj", a, lowp) * P[b + ".ls1.gamma"]
    h = lin(pr, P, b + ".mlp.0.project", rms_norm(x, P[b + ".norm2.g"]), lowp)
    proj, gate = h.chunk(2, dim=-1)
    return x + lin(pr, P, b + ".mlp.1", proj * F.silu(gate), lowp) * P[b + ".ls2.gamma"]


def clip_block(P, pr, x, b: str, H: int, causal: bool, lowp: bool):
    h = ln(P, b + ".ln_1", x, 1e-5)
    qkv = linear(pr, h, P[b + ".attn.in_proj_weight"], P[b + ".attn.in_proj_bias"], lowp)
    q, k, v = qkv.chunk(3, dim=-1)
    a = merge(attention(pr, heads(q, H), heads(k, H), heads(v, H), causal=causal, lowp=lowp))
    x = x + lin(pr, P, b + ".attn.out_proj", a, lowp)
    h = quick_gelu(lin(pr, P, b + ".mlp.c_fc", ln(P, b + ".ln_2", x, 1e-5), lowp))
    return x + lin(pr, P, b + ".mlp.c_proj", h, lowp)


def clip_text(cfg, P, pr: Prec, tokens, pre: str = "language_goal"):
    """(B, 77) token ids -> (B, 512), pooled at the largest id."""
    x = P[pre + ".token_embedding.weight"][tokens.long()] + P[pre + ".positional_embedding"]
    for i in range(cfg["clip_text_layers"]):
        x = clip_block(P, pr, x, f"{pre}.transformer.resblocks.{i}", cfg["clip_text_heads"],
                       True, True)
    x = ln(P, pre + ".ln_final", x, 1e-5)
    pooled = x[torch.arange(x.shape[0], device=x.device), tokens.long().argmax(-1)]
    return torch.matmul(pr.q(pooled, True), pr.q(P[pre + ".text_projection"], True))


def clip_vision(cfg, P, pr: Prec, images, pre: str = "visual_goal"):
    """(B, H, W, 3) normalized images at 224 px -> (B, 512)."""
    w = P[pre + ".conv1.weight"]
    x = F.conv2d(pr.q(images.permute(0, 3, 1, 2), True), pr.q(w, True), stride=w.shape[-1])
    x = x.flatten(2).transpose(1, 2)
    cls = P[pre + ".class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + P[pre + ".positional_embedding"]
    x = ln(P, pre + ".ln_pre", x, 1e-5)
    for i in range(cfg["clip_vision_layers"]):
        x = clip_block(P, pr, x, f"{pre}.transformer.resblocks.{i}",
                       max(cfg["clip_vision_width"] // 64, 1), False, True)
    return torch.matmul(pr.q(ln(P, pre + ".ln_post", x[:, 0], 1e-5), True),
                        pr.q(P[pre + ".proj"], True))


def blocks_of(fn, x, rows: int = 128):
    """`fn` over blocks of `rows` rows, concatenated."""
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


# ---- perception --------------------------------------------------------------

def perceiver(cfg, P, pr: Prec, tokens, pre: str = "perceiver"):
    """(B, n_tokens, D) Voltron tokens of one frame -> (B, num_latents, D)."""
    heads_n, dim_head = cfg["perceiver_heads"], cfg["perceiver_dim_head"]
    x_f = tokens + P[pre + ".time_pos_emb"][0]
    xhat = layer_norm(x_f, eps=1e-6)
    x = P[pre + ".latents"].expand(tokens.shape[0], -1, -1)
    for i in range(cfg["perceiver_depth"]):
        a, f = f"{pre}.layers.{i}.0", f"{pre}.layers.{i}.1"
        lat = ln(P, a + ".norm_latents", x, 1e-6)
        media = xhat * P[a + ".norm_media.weight"] + P[a + ".norm_media.bias"]
        kv = torch.cat([media, lat], dim=1)
        q = lin(pr, P, a + ".to_q", lat, True, bias=False)
        k = lin(pr, P, a + ".to_k", kv, True, bias=False)
        v = lin(pr, P, a + ".to_v", kv, True, bias=False)
        o = merge(attention(pr, heads(q, heads_n), heads(k, heads_n), heads(v, heads_n),
                            lowp=True))
        x = x + lin(pr, P, a + ".to_out", o, True, bias=False)
        h = gelu(lin(pr, P, f + ".1", ln(P, f + ".0", x, 1e-6), True, bias=False))
        x = x + lin(pr, P, f + ".3", h, True, bias=False)
    return ln(P, pre + ".norm", x, 1e-6)


def perceive(cfg, P, pr: Prec, static, gripper):
    """Normalized frames (B, H, W, 3) of both cameras -> perceiver latents:
    both resized to the ViT's size, tokens concatenated camera by camera."""
    size = cfg["img_size"]
    tok = lambda imgs: blocks_of(lambda b: voltron(cfg, P, pr, resize(b, size)), imgs)
    return perceiver(cfg, P, pr, torch.cat([tok(static), tok(gripper)], dim=1))


# ---- denoiser -----------------------------------------------------------------

def _attn(P, pr, b, x, ctx, H, causal, drops, gen):
    q = lin(pr, P, b + ".query", x)
    k, v = lin(pr, P, b + ".key", ctx), lin(pr, P, b + ".value", ctx)
    y = merge(attention(pr, heads(q, H), heads(k, H), heads(v, H), causal=causal,
                        drop=drops[0], gen=gen))
    return dropout(lin(pr, P, b + ".c_proj", y, bias=False), drops[1], gen)


def _mlp(P, pr, b, x, drop, gen):
    h = gelu(lin(pr, P, b + ".c_fc", x, bias=False))
    return dropout(lin(pr, P, b + ".c_proj", h, bias=False), drop, gen)


def goal_mlp(P, pr, pre, g):
    return lin(pr, P, pre + ".2", gelu(lin(pr, P, pre + ".0", g)))


def encoder(cfg, P, pr, x, gen=None, pre="inner.encoder"):
    drops = (cfg["attn_pdrop"], cfg["resid_pdrop"]) if gen is not None else (0.0, 0.0)
    mlp_drop = cfg["mlp_pdrop"] if gen is not None else 0.0
    H = cfg["n_heads"]
    for i in range(cfg["n_enc_layers"]):
        b = f"{pre}.blocks.{i}"
        h = layer_norm(x, P[b + ".ln_1.weight"], eps=1e-5)
        x = x + _attn(P, pr, b + ".attn", h, h, H, False, drops, gen)
        x = x + _mlp(P, pr, b + ".mlp", layer_norm(x, P[b + ".ln_2.weight"], eps=1e-5),
                     mlp_drop, gen)
    return layer_norm(x, P[pre + ".ln.weight"], eps=1e-5)


def sigma_token(cfg, P, pr, sigma, pre="inner.sigma_emb"):
    """(B,) sigmas -> (B, 1, D): log(sigma) / 4 through the sinusoidal
    embedding, Linear, Mish, Linear."""
    D = cfg["embed_dim"]
    x = (torch.log(sigma.clamp_min(1e-20)) / 4.0)[:, None]
    scale = (torch.tensor(math.log(10000.0), dtype=torch.float32) / (D // 2 - 1)).item()
    freqs = torch.exp(torch.arange(D // 2, dtype=torch.float32, device=x.device) * -scale)
    e = x[..., None] * freqs
    e = torch.cat([e.sin(), e.cos()], dim=-1)
    return lin(pr, P, pre + ".3", mish(lin(pr, P, pre + ".1", e)))


def decoder(cfg, P, pr, x, c, context, gen=None, pre="inner.decoder"):
    drops = (cfg["attn_pdrop"], cfg["resid_pdrop"]) if gen is not None else (0.0, 0.0)
    mlp_drop = cfg["mlp_pdrop"] if gen is not None else 0.0
    H = cfg["n_heads"]
    for i in range(cfg["n_dec_layers"]):
        b = f"{pre}.blocks.{i}"
        mod = lin(pr, P, b + ".adaLN_zero.modulation.1", F.silu(c)).chunk(6, dim=-1)
        h = mod[0] + layer_norm(x, P[b + ".ln_1.weight"], eps=1e-5) * mod[1]
        x = x + mod[2] * _attn(P, pr, b + ".attn", h, h, H, True, drops, gen)
        h = ln(P, b + ".ln3", x, 1e-6)
        x = x + _attn(P, pr, b + ".cross_att", h, context, H, True, drops, gen)
        h = mod[3] + layer_norm(x, P[b + ".ln_2.weight"], eps=1e-5) * mod[4]
        x = x + mod[5] * _mlp(P, pr, b + ".mlp", h, mlp_drop, gen)
    return layer_norm(x, P[pre + ".ln.weight"], eps=1e-5)


def encode(cfg, P, pr, latents, goal, modality: str, gen=None):
    """Context of the encoder: [goal token, perceiver tokens]; language goals
    through `lang_emb`, image goals through `goal_emb`."""
    goal = goal[:, None] if goal.ndim == 2 else goal
    emb = "inner.lang_emb" if modality == "lang" else "inner.goal_emb"
    x = torch.cat([goal_mlp(P, pr, emb, goal), lin(pr, P, "inner.tok_emb", latents)], dim=1)
    return encoder(cfg, P, pr, x, gen)


def decode(cfg, P, pr, context, actions, sigma, gen=None):
    x = lin(pr, P, "inner.action_emb", actions)
    x = decoder(cfg, P, pr, x, sigma_token(cfg, P, pr, sigma), context, gen)
    return lin(pr, P, "inner.action_pred", x)


def ddim(cfg, P, pr, context, noise):
    """DDIM over the exponential schedule from x = noise * sigma_max, the
    context computed once (the AdaLN encoder does not see sigma)."""
    s = sigmas_exponential(cfg["num_sampling_steps"], cfg["sigma_min"], cfg["sigma_max"])
    x = noise * cfg["sigma_max"]
    import numpy as np
    with np.errstate(divide="ignore"):
        for sigma, nxt in zip(s[:-1], s[1:]):
            sb = torch.full((x.shape[0],), float(sigma), device=x.device)
            c_skip, c_out, c_in = (t[:, None, None] for t in scalings(sb, cfg["sigma_data"]))
            denoised = decode(cfg, P, pr, context, x * c_in, sb) * c_out + x * c_skip
            h = -np.log(nxt) + np.log(sigma)
            x = float(nxt / sigma) * x - float(np.expm1(-h)) * denoised
    return x


# ---- the serving path -----------------------------------------------------------

def replan(cfg, P, pr: Prec, raw_static, raw_gripper, tokens, noise):
    """Action chunks (B, W, A) of raw uint8 frames (B, H, W, 3) of both
    cameras, a text goal (B, 77) and the initial N(0, 1) draw (B, W, A):
    eval preprocessing, perception, the text tower, DDIM."""
    with pr.scope():
        static = eval_frames(raw_static, cfg["img_size"])
        gripper = eval_frames(raw_gripper, min(84, cfg["img_size"]))
        latents = perceive(cfg, P, pr, static, gripper)
        goal = clip_text(cfg, P, pr, tokens)
        context = encode(cfg, P, pr, latents, goal, "lang")
        return ddim(cfg, P, pr, context, noise)


# ---- training ---------------------------------------------------------------------

def foresight(cfg, P, pr, context, images, mask_noise):
    """Masked foresight loss of the goal frames (B, 2, h, w, 3) from the
    context, the mask from the uniform draw (B, n_patches)."""
    g = "gen_img"
    lp = cfg["gen_compute_dtype"] != "float32"
    B, t = images.shape[:2]
    p = cfg["gen_patch_size"]
    n = (cfg["gen_img_res"] // p) ** 2
    n_keep = int(n * (1 - cfg["gen_mask_ratio"]))
    ctx = lin(pr, P, g + ".encoder2decoder", context, lp)
    w = P[g + ".patch2embed.proj.weight"]
    D = w.shape[0]
    imgs = images.reshape((B * t,) + tuple(images.shape[2:])).permute(0, 3, 1, 2)
    patches = F.conv2d(pr.q(imgs, lp), pr.q(w, lp), P[g + ".patch2embed.proj.bias"], stride=p)
    pe = torch.from_numpy(sincos_2d(D, cfg["gen_img_res"] // p)).to(context.device)
    patches = (patches.flatten(2).transpose(1, 2) + pe).reshape(B, t, n, D)
    order = torch.argsort(mask_noise, dim=1, stable=True)
    keep = order[:, :n_keep]
    mask = torch.ones(B, n, device=context.device)
    mask.scatter_(1, keep, 0.0)
    tokens = P[g + ".mask_token"].reshape(1, 1, 1, D).expand(B, t, n, D).clone()
    idx = keep[:, None, :, None].expand(B, t, n_keep, D)
    tokens.scatter_(2, idx, torch.gather(patches, 2, idx))
    tokens = tokens + pe + P[g + ".ctx_dec_pe"][0, :t][None]
    x = torch.cat([ctx, tokens.reshape(B, t * n, D)], dim=1)
    for i in range(cfg["gen_decoder_depth"]):
        x = voltron_block(P, pr, x, f"{g}.decoder_blocks.{i}", cfg["gen_decoder_heads"], lp)
    x = rms_norm(x, P[g + ".decoder_norm.g"])
    recon = lin(pr, P, g + ".decoder_patch_prediction", x[:, ctx.shape[1]:], lp)
    recon = recon.reshape(B, t, n, -1)
    target = images.reshape(B, t, cfg["gen_img_res"] // p, p, cfg["gen_img_res"] // p, p, 3)
    target = target.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, t, n, p * p * 3)
    per_patch = ((recon - target) ** 2).mean(-1)
    denom = mask.sum().clamp_min(1.0)
    return ((per_patch[:, 0] * mask).sum() / denom + (per_patch[:, 1] * mask).sum() / denom) / 2


def map_head(P, pr, x, pre="clip_proj.latent_proj"):
    """MAP pooling: one latent query over the projected tokens -> (B, D)."""
    lat = P[pre + ".latents"][None].expand(x.shape[0], -1, -1)
    kv = lin(pr, P, pre + ".attn.kv", lin(pr, P, pre + ".projection", x), bias=False)
    k, v = kv.chunk(2, dim=-1)
    q = lin(pr, P, pre + ".attn.q", lat, bias=False)
    a = lin(pr, P, pre + ".attn.proj", merge(attention(pr, heads(q, 8), heads(k, 8), heads(v, 8))))
    lat = rms_norm(lat + a, P[pre + ".attn_norm.g"])
    h = lin(pr, P, pre + ".mlp.0.project", lat)
    proj, gate = h.chunk(2, dim=-1)
    lat = rms_norm(lat + lin(pr, P, pre + ".mlp.1", proj * F.silu(gate)), P[pre + ".mlp_norm.g"])
    return lat[:, 0]


def info_nce(P, img, lang):
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    lang = lang / torch.linalg.vector_norm(lang, dim=-1, keepdim=True)
    sim = P["logit_scale"].exp() * img @ lang.T
    labels = torch.arange(sim.shape[0], device=sim.device)
    return (F.cross_entropy(sim, labels) + F.cross_entropy(sim.T, labels)) / 2


def tower_outputs(cfg, P, pr, frames: Dict, modality: str):
    """Frozen towers of one scope: perceiver input tokens of the observation
    frame, the CLIP image embedding of the goal frame, and the text
    embedding in the lang scope (no gradient)."""
    size = cfg["img_size"]
    with torch.no_grad():
        tok = lambda imgs: blocks_of(lambda b: voltron(cfg, P, pr, resize(b, size)), imgs)
        tokens = torch.cat([tok(frames["rgb_static"][:, 0]), tok(frames["rgb_gripper"][:, 0])],
                           dim=1)
        image_goal = blocks_of(lambda b: clip_vision(cfg, P, pr, resize(b, size)),
                               frames["rgb_static"][:, -1])
        lang = clip_text(cfg, P, pr, frames["lang_tokens"]) if modality == "lang" else None
    return tokens, image_goal, lang


def scope_loss(cfg, P, pr, frames: Dict, draws: Dict, modality: str, gen):
    """Total loss of one scope: EDM score matching, masked foresight, and in
    the lang scope the InfoNCE between the image-goal and the text-goal
    contexts. `frames` holds the preprocessed frames, actions and tokens."""
    tokens, image_goal, lang = tower_outputs(cfg, P, pr, frames, modality)
    latents = perceiver(cfg, P, pr, tokens)
    goal = lang if modality == "lang" else image_goal
    actions = frames["actions"]
    sigmas = log_logistic(draws["sigma"], math.log(cfg["sigma_data"]), 0.5,
                          cfg["sigma_min"], cfg["sigma_max"])
    c_skip, c_out, c_in = (t[:, None, None] for t in scalings(sigmas, cfg["sigma_data"]))
    noised = actions + draws["noise"] * sigmas[:, None, None]
    context = encode(cfg, P, pr, latents, goal, modality, gen)
    out = decode(cfg, P, pr, context, noised * c_in, sigmas, gen)
    action_loss = ((out - (actions - c_skip * noised) / c_out) ** 2).mean()
    goal_imgs = torch.stack([frames["gen_static"], frames["gen_gripper"]], dim=1)
    img_loss = foresight(cfg, P, pr, context, goal_imgs, draws["mask"])
    total = action_loss + cfg["masked_beta"] * img_loss
    if modality == "lang":
        vis_context = encode(cfg, P, pr, latents, image_goal, "lang", gen)
        total = total + cfg["cont_alpha"] * info_nce(P, map_head(P, pr, vis_context),
                                                     map_head(P, pr, context))
    return total


def train_frames_of(cfg, raw: Dict, offsets: Dict):
    """One scope's raw uint8 batch -> the reference's frames: the cameras
    resized, shifted by the DrQ offsets, normalized and stored in bfloat16
    (the train pipeline's camera dtype), the foresight frames resized and
    normalized, actions as float32."""
    from .common import train_frames
    cam = lambda x: x.to(torch.bfloat16).float()
    out = {"rgb_static": cam(train_frames(raw["rgb_static"], cfg["img_size"], 10,
                                          offsets["rgb_static"])),
           "rgb_gripper": cam(train_frames(raw["rgb_gripper"], min(84, cfg["img_size"]), 4,
                                           offsets["rgb_gripper"])),
           "gen_static": eval_frames(raw["gen_static"], cfg["gen_img_res"]),
           "gen_gripper": eval_frames(raw["gen_gripper"], cfg["gen_img_res"]),
           "actions": raw["actions"].float()}
    if "lang_tokens" in raw:
        out["lang_tokens"] = raw["lang_tokens"]
    return out


def train_steps(cfg, P, pr: Prec, steps, frozen=TOWERS, loss=None):
    """The first optimizer steps from the weights `P`. `steps` is a list of
    callables, each returning ({scope: frames}, {scope: draws},
    {scope: dropout generator}) of that step. AdamW (decoupled decay, bias
    correction) at the tri-stage learning rate of the step counter before
    the update; the EMA with the decay of the counter after it.

    Returns (total losses, the first step's gradients, the parameters and
    the EMA after the last step), the last three over the trainables."""
    loss = loss or scope_loss
    opt, sched = cfg["optimizer"], cfg["lr_scheduler"]
    b1, b2 = opt["betas"]
    names = [k for k in P if k.split(".", 1)[0] not in frozen]
    params = {k: P[k].clone().requires_grad_(True) for k in names}
    fixed = {k: v for k, v in P.items() if k not in params}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    ema = {k: v.detach().clone() for k, v in params.items()}
    from .common import ema_decay, tri_stage_lr
    losses, first = [], None
    for t, make in enumerate(steps):
        frames, draws, gens = make()
        Q = {**fixed, **params}
        with pr.scope():
            total = sum(loss(cfg, Q, pr, frames[s], draws[s], s, gens[s])
                        for s in sorted(frames)) / len(frames)
            grads = torch.autograd.grad(total, [params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)}
        if t == 0:
            first = {k: g.detach().clone() for k, g in grads.items()}
        lr = tri_stage_lr(t, opt["learning_rate"], sched["init_lr_scale"], sched["final_lr_scale"],
                          sched["total_steps"], sched["phase_ratio"])
        decay = ema_decay(t + 1)
        with torch.no_grad():
            for k in names:
                p, g = params[k], grads[k]
                p.mul_(1 - lr * opt["transformer_weight_decay"])
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                denom = (v2[k] / (1 - b2 ** (t + 1))).sqrt() + 1e-8
                p.sub_(lr / (1 - b1 ** (t + 1)) * m[k] / denom)
                ema[k] = ema[k] - (1 - decay) * (ema[k] - p)
        losses.append(float(total.detach()))
        del total, grads
    return losses, first, {k: v.detach() for k, v in params.items()}, ema
