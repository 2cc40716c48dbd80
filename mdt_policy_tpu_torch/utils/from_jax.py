"""JAX parameter tree -> the port's `state_dict`.

Takes the nested dicts of numpy arrays that the JAX package's `init_agent`
returns (after `jax.device_get`) and gives float32 tensors under the port's
keys, which are the reference `state_dict` layouts. Each part function here
is the exact inverse of the matching `mdt_policy_tpu/utils/torch_port.py`
function:

    voltron_vit_from_jax      <-> port_voltron_vit
    perceiver_from_jax        <-> port_perceiver
    clip_text_from_jax        <-> port_clip_text
    clip_vision_from_jax      <-> port_clip_vision (keys without `visual.`)
    mdtv_transformer_from_jax <-> port_mdtv_transformer
    mdt_transformer_from_jax  <-> port_mdt_transformer
    resnet18_gn_from_jax      <-> port_resnet18_gn (prefixes `backbone`,
                                  `fc_layers.0`)
    masked_decoder_from_jax   <-> port_masked_decoder
    clip_proj_from_jax        <-> the `clip_proj` part of port_mdtv_agent

and `from_jax` of the whole agent tree is the inverse of port_mdtv_agent
(up to its reference module prefixes, `model.inner_model.` and so on); it
also takes the JAX `MDTAgentNet` tree (ResNet encoders, `MDTTransformer`,
the parameter-free single-token `clip_proj`).

Conventions: a flax Dense kernel (in, out) is a torch Linear weight
(out, in); a flax Conv kernel (H, W, I, O) is a torch Conv2d weight
(O, I, H, W); flax LayerNorm scale/bias are weight/bias; a biasless
LayerNorm nests its params under `LayerNorm_0`; flax GroupNorm scale/bias
are weight/bias.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["from_jax", "voltron_vit_from_jax", "perceiver_from_jax",
           "clip_text_from_jax", "clip_vision_from_jax",
           "mdtv_transformer_from_jax", "mdt_transformer_from_jax",
           "resnet18_gn_from_jax", "masked_decoder_from_jax",
           "clip_proj_from_jax"]

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["kernel"]).T.contiguous()
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _ln(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["kernel"]).permute(3, 2, 0, 1).contiguous()
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _n_numbered(params: Mapping, stem: str) -> int:
    return sum(1 for k in params if k.startswith(stem)
               and k[len(stem):].isdigit())


def _voltron_block(sd: StateDict, pre: str, p: Mapping) -> None:
    sd[f"{pre}.norm1.g"] = _t(p["norm1"]["g"])
    _dense(sd, f"{pre}.attn.qkv", p["attn"]["qkv"])
    _dense(sd, f"{pre}.attn.proj", p["attn"]["proj"])
    sd[f"{pre}.ls1.gamma"] = _t(p["ls1"]["gamma"])
    sd[f"{pre}.norm2.g"] = _t(p["norm2"]["g"])
    _dense(sd, f"{pre}.mlp.0.project", p["mlp_glu"]["project"])
    _dense(sd, f"{pre}.mlp.1", p["mlp_out"])
    sd[f"{pre}.ls2.gamma"] = _t(p["ls2"]["gamma"])


def voltron_vit_from_jax(params: Mapping) -> StateDict:
    sd: StateDict = {}
    _conv(sd, "patch2embed.proj", params["patch_embed"]["proj"])
    for i in range(_n_numbered(params, "block_")):
        _voltron_block(sd, f"blocks.{i}", params[f"block_{i}"])
    _ln(sd, "encoder_norm", params["norm"])
    return sd


def masked_decoder_from_jax(params: Mapping) -> StateDict:
    sd: StateDict = {"mask_token": _t(params["mask_token"]),
                     "ctx_dec_pe": _t(params["ctx_dec_pe"]),
                     "decoder_norm.g": _t(params["decoder_norm"]["g"])}
    _conv(sd, "patch2embed.proj", params["patch2embed"]["proj"])
    _dense(sd, "encoder2decoder", params["encoder2decoder"])
    _dense(sd, "decoder_patch_prediction", params["decoder_patch_prediction"])
    for i in range(_n_numbered(params, "block_")):
        _voltron_block(sd, f"decoder_blocks.{i}", params[f"block_{i}"])
    return sd


def perceiver_from_jax(params: Mapping) -> StateDict:
    sd: StateDict = {"latents": _t(params["latents"]),
                     "time_pos_emb": _t(params["time_pos_emb"])}
    for i in range(_n_numbered(params, "attn_")):
        a, pre = params[f"attn_{i}"], f"layers.{i}.0"
        _ln(sd, f"{pre}.norm_media", a["norm_media"])
        _ln(sd, f"{pre}.norm_latents", a["norm_latents"])
        for name in ("to_q", "to_k", "to_v", "to_out"):
            _dense(sd, f"{pre}.{name}", a[name])
        f, pre = params[f"ffw_{i}"], f"layers.{i}.1"
        _ln(sd, f"{pre}.0", f["norm"])
        _dense(sd, f"{pre}.1", f["fc1"])
        _dense(sd, f"{pre}.3", f["fc2"])
    _ln(sd, "norm", params["norm"])
    return sd


def _clip_resblocks(sd: StateDict, params: Mapping) -> None:
    for i in range(_n_numbered(params, "resblock_")):
        p, pre = params[f"resblock_{i}"], f"transformer.resblocks.{i}"
        _ln(sd, f"{pre}.ln_1", p["ln_1"])
        sd[f"{pre}.attn.in_proj_weight"] = _t(p["in_proj"]["kernel"]).T.contiguous()
        sd[f"{pre}.attn.in_proj_bias"] = _t(p["in_proj"]["bias"])
        _dense(sd, f"{pre}.attn.out_proj", p["out_proj"])
        _ln(sd, f"{pre}.ln_2", p["ln_2"])
        _dense(sd, f"{pre}.mlp.c_fc", p["c_fc"])
        _dense(sd, f"{pre}.mlp.c_proj", p["c_proj"])


def clip_text_from_jax(params: Mapping) -> StateDict:
    sd: StateDict = {
        "token_embedding.weight": _t(params["token_embedding"]["embedding"]),
        "positional_embedding": _t(params["positional_embedding"]),
        "text_projection": _t(params["text_projection"]),
    }
    _clip_resblocks(sd, params)
    _ln(sd, "ln_final", params["ln_final"])
    return sd


def clip_vision_from_jax(params: Mapping) -> StateDict:
    sd: StateDict = {
        "class_embedding": _t(params["class_embedding"]),
        "positional_embedding": _t(params["positional_embedding"]),
        "proj": _t(params["proj"]),
    }
    _conv(sd, "conv1", params["conv1"])
    _ln(sd, "ln_pre", params["ln_pre"])
    _clip_resblocks(sd, params)
    _ln(sd, "ln_post", params["ln_post"])
    return sd


def clip_proj_from_jax(params: Mapping) -> StateDict:
    """ClipStyleProjection, map style: the MAPBlock under `latent_proj`."""
    p, pre = params["latent_proj"], "latent_proj"
    sd: StateDict = {f"{pre}.latents": _t(p["latents"]),
                     f"{pre}.attn_norm.g": _t(p["attn_norm"]["g"]),
                     f"{pre}.mlp_norm.g": _t(p["mlp_norm"]["g"])}
    _dense(sd, f"{pre}.projection", p["projection"])
    for name in ("q", "kv", "proj"):
        _dense(sd, f"{pre}.attn.{name}", p["attn"][name])
    _dense(sd, f"{pre}.mlp.0.project", p["mlp_glu"]["project"])
    _dense(sd, f"{pre}.mlp.1", p["mlp_out"])
    return sd


def _goal_embed(sd: StateDict, prefix: str, p: Mapping) -> None:
    _dense(sd, f"{prefix}.0", p["fc1"])
    _dense(sd, f"{prefix}.2", p["fc2"])


def _attention(sd: StateDict, prefix: str, p: Mapping) -> None:
    for name in ("query", "key", "value", "c_proj"):
        _dense(sd, f"{prefix}.{name}", p[name])


def _block(sd: StateDict, prefix: str, p: Mapping) -> None:
    _ln(sd, f"{prefix}.ln_1", p["ln_1"]["LayerNorm_0"])
    _attention(sd, f"{prefix}.attn", p["attn"])
    _ln(sd, f"{prefix}.ln_2", p["ln_2"]["LayerNorm_0"])
    _dense(sd, f"{prefix}.mlp.c_fc", p["mlp"]["c_fc"])
    _dense(sd, f"{prefix}.mlp.c_proj", p["mlp"]["c_proj"])
    if "adaLN_zero" in p:  # decoder block: AdaLN and cross-attention
        _ln(sd, f"{prefix}.ln3", p["ln3"])
        _attention(sd, f"{prefix}.cross_att", p["cross_att"])
        _dense(sd, f"{prefix}.adaLN_zero.modulation.1",
               p["adaLN_zero"]["modulation"])


def mdtv_transformer_from_jax(params: Mapping) -> StateDict:
    sd: StateDict = {"pos_emb": _t(params["pos_emb"])}
    _dense(sd, "tok_emb", params["tok_emb"])
    _goal_embed(sd, "goal_emb", params["goal_emb"])
    _goal_embed(sd, "lang_emb", params["lang_emb"])
    if "proprio_emb" in params:
        _dense(sd, "proprio_emb.0", params["proprio_emb"]["fc1"])
        _dense(sd, "proprio_emb.2", params["proprio_emb"]["fc2"])
    _dense(sd, "sigma_emb.1", params["sigma_emb"]["fc1"])
    _dense(sd, "sigma_emb.3", params["sigma_emb"]["fc2"])
    _dense(sd, "action_emb", params["action_emb"])
    _dense(sd, "action_pred", params["action_pred"])
    for part in ("encoder", "decoder"):
        tree = params[part]
        for i in range(_n_numbered(tree, "block_")):
            _block(sd, f"{part}.blocks.{i}", tree[f"block_{i}"])
        _ln(sd, f"{part}.ln", tree["ln"]["LayerNorm_0"])
    return sd


def mdt_transformer_from_jax(params: Mapping) -> StateDict:
    """MDTTransformer: MDT-V's layout plus the gripper-camera embedding
    `incam_embed`."""
    sd = mdtv_transformer_from_jax(params)
    _dense(sd, "incam_embed", params["incam_embed"])
    return sd


def resnet18_gn_from_jax(params: Mapping) -> StateDict:
    """BesoResNetEncoder: the trunk `backbone` as torchvision's positional
    Sequential (0 conv1, 1 norm, 4-7 layer1-4) and the head `fc_layers.0`."""
    trunk = params["backbone"]
    sd: StateDict = {}
    _conv(sd, "backbone.0", trunk["conv1"])
    _ln(sd, "backbone.1", trunk["bn1"])
    for stage in range(4):
        for b in range(2):
            p, pre = trunk[f"layer{stage + 1}_{b}"], f"backbone.{4 + stage}.{b}"
            for name in ("conv1", "conv2"):
                _conv(sd, f"{pre}.{name}", p[name])
            for name in ("bn1", "bn2"):
                _ln(sd, f"{pre}.{name}", p[name])
            if "downsample_conv" in p:
                _conv(sd, f"{pre}.downsample.0", p["downsample_conv"])
                _ln(sd, f"{pre}.downsample.1", p["downsample_norm"])
    _dense(sd, "fc_layers.0", params["fc"])
    return sd


def _transformer_from_jax(params: Mapping) -> StateDict:
    return (mdt_transformer_from_jax if "incam_embed" in params
            else mdtv_transformer_from_jax)(params)


_PARTS = {
    "img_encoder": voltron_vit_from_jax,
    "perceiver": perceiver_from_jax,
    "static_resnet": resnet18_gn_from_jax,
    "gripper_resnet": resnet18_gn_from_jax,
    "visual_goal": clip_vision_from_jax,
    "language_goal": clip_text_from_jax,
    "inner": _transformer_from_jax,
    "gen_img": masked_decoder_from_jax,
    "clip_proj": clip_proj_from_jax,
}


def from_jax(params: Mapping) -> StateDict:
    """The JAX `MDTVAgentNet` or `MDTAgentNet` parameter tree (or any part
    of it, such as the gradient tree of the trainables) -> the port's
    state_dict keys of the same net. Converts every network of `_PARTS` and
    `logit_scale` that the tree holds."""
    sd: StateDict = {}
    for part, convert in _PARTS.items():
        if part in params:
            sd.update({f"{part}.{k}": v for k, v in convert(params[part]).items()})
    if "logit_scale" in params:
        sd["logit_scale"] = _t(params["logit_scale"]).reshape(())
    return sd
