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
    clip_resnet_from_jax      <-> port_clip_resnet (keys without `visual.`)
    mdtv_transformer_from_jax <-> port_mdtv_transformer (also the trees of the
                                  sigma-token, noise-encoder, linear-goal and
                                  no-`lang_emb` configs)
    mdt_transformer_from_jax  <-> port_mdt_transformer (the same configs)
    resnet18_gn_from_jax      <-> port_resnet18_gn (prefixes `backbone`,
                                  `fc_layers.0`)
    masked_decoder_from_jax   <-> port_masked_decoder
    clip_proj_from_jax        <-> the `clip_proj` part of port_mdtv_agent

and, for modules no agent config reaches (no `torch_port` inverse):

    block_stack_from_jax      every block stack of `models/blocks.py`
    module_from_jax           a module of Dense, Embed and raw parameters
                              (the time embeddings, the position biases)
    clip_vision_tokens_from_jax, vision_clip_head_from_jax,
    voltron_map_encoder_from_jax   `models/encoders_misc.py`
    minilm_from_jax           `MiniLMEncoder`, into HF BertModel's keys

and `from_jax` of the whole agent tree is the inverse of port_mdtv_agent
(up to its reference module prefixes, `model.inner_model.` and so on); it
also takes the JAX `MDTAgentNet` tree (ResNet encoders, `MDTTransformer`,
the parameter-free single-token `clip_proj`).

`state_from_jax` builds the port's whole `TrainState` (parameters, EMA,
AdamW moments and step) from the numpy trees of a JAX `TrainState`.

Conventions: a flax Dense kernel (in, out) is a torch Linear weight
(out, in); a flax Conv kernel (H, W, I, O) is a torch Conv2d weight
(O, I, H, W); flax LayerNorm scale/bias are weight/bias; a biasless
LayerNorm nests its params under `LayerNorm_0`; flax GroupNorm scale/bias
are weight/bias; the frozen BatchNorm's scale/bias/mean/var are
weight/bias/running_mean/running_var.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["from_jax", "state_from_jax", "voltron_vit_from_jax", "perceiver_from_jax",
           "clip_text_from_jax", "clip_vision_from_jax", "clip_resnet_from_jax",
           "mdtv_transformer_from_jax", "mdt_transformer_from_jax",
           "resnet18_gn_from_jax", "masked_decoder_from_jax",
           "clip_proj_from_jax", "block_stack_from_jax", "module_from_jax",
           "clip_vision_tokens_from_jax", "vision_clip_head_from_jax",
           "voltron_map_encoder_from_jax", "minilm_from_jax"]

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


def clip_resnet_from_jax(params: Mapping) -> StateDict:
    """CLIP's ModifiedResNet: the stem `conv1-3`/`bn1-3`, the Bottlenecks
    `layer{s}.{b}` (the downsample Sequential's conv `0` and norm `1`) and
    `attnpool`."""
    sd: StateDict = {}

    def bn(prefix, p):
        for name, key in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                          ("var", "running_var")):
            sd[f"{prefix}.{key}"] = _t(p[name])

    for i in (1, 2, 3):
        _conv(sd, f"conv{i}", params[f"conv{i}"])
        bn(f"bn{i}", params[f"bn{i}"])
    stages = sorted({k.split("_")[0] for k in params if k.startswith("layer")})
    for stage in stages:
        for b in range(_n_numbered(params, f"{stage}_")):
            p, pre = params[f"{stage}_{b}"], f"{stage}.{b}"
            for i in (1, 2, 3):
                _conv(sd, f"{pre}.conv{i}", p[f"conv{i}"])
                bn(f"{pre}.bn{i}", p[f"bn{i}"])
            if "downsample_conv" in p:
                _conv(sd, f"{pre}.downsample.0", p["downsample_conv"])
                bn(f"{pre}.downsample.1", p["downsample_norm"])
    ap = params["attnpool"]
    sd["attnpool.positional_embedding"] = _t(ap["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(sd, f"attnpool.{name}", ap[name])
    return sd


def _map_block(sd: StateDict, pre: str, p: Mapping) -> None:
    """MAPBlock with RMSNorms and a SwishGLU MLP."""
    sd[f"{pre}.latents"] = _t(p["latents"])
    sd[f"{pre}.attn_norm.g"] = _t(p["attn_norm"]["g"])
    sd[f"{pre}.mlp_norm.g"] = _t(p["mlp_norm"]["g"])
    _dense(sd, f"{pre}.projection", p["projection"])
    for name in ("q", "kv", "proj"):
        _dense(sd, f"{pre}.attn.{name}", p["attn"][name])
    _dense(sd, f"{pre}.mlp.0.project", p["mlp_glu"]["project"])
    _dense(sd, f"{pre}.mlp.1", p["mlp_out"])


def clip_proj_from_jax(params: Mapping) -> StateDict:
    """ClipStyleProjection: the MAPBlock under `latent_proj` (the map
    styles), the Linear `latent_proj` and LayerNorm `latent_norm` ("mlp"),
    or nothing (the parameter-free styles)."""
    sd: StateDict = {}
    p = params.get("latent_proj")
    if p is None:
        return sd
    if "kernel" in p:
        _dense(sd, "latent_proj", p)
        _ln(sd, "latent_norm", params["latent_norm"])
    else:
        _map_block(sd, "latent_proj", p)
    return sd


def _goal_embed(sd: StateDict, prefix: str, p: Mapping) -> None:
    if "linear" in p:  # use_mlp_goal=False: one Linear
        _dense(sd, prefix, p["linear"])
        return
    _dense(sd, f"{prefix}.0", p["fc1"])
    _dense(sd, f"{prefix}.2", p["fc2"])


def _attention(sd: StateDict, prefix: str, p: Mapping) -> None:
    for name in ("query", "key", "value", "c_proj"):
        _dense(sd, f"{prefix}.{name}", p[name])


def _block(sd: StateDict, prefix: str, p: Mapping) -> None:
    """An encoder block, a decoder's AdaLN block, a noise block, a plain
    causal decoder block or a cross-attention-only block: the
    self-attention, the cross-attention and the AdaLN modulation where the
    tree has them (a cross-attention-only block has no `ln3`)."""
    _ln(sd, f"{prefix}.ln_1", p["ln_1"]["LayerNorm_0"])
    if "attn" in p:
        _attention(sd, f"{prefix}.attn", p["attn"])
    _ln(sd, f"{prefix}.ln_2", p["ln_2"]["LayerNorm_0"])
    _dense(sd, f"{prefix}.mlp.c_fc", p["mlp"]["c_fc"])
    _dense(sd, f"{prefix}.mlp.c_proj", p["mlp"]["c_proj"])
    if "cross_att" in p:
        if "ln3" in p:
            _ln(sd, f"{prefix}.ln3", p["ln3"])
        _attention(sd, f"{prefix}.cross_att", p["cross_att"])
    if "adaLN_zero" in p:
        _dense(sd, f"{prefix}.adaLN_zero.modulation.1",
               p["adaLN_zero"]["modulation"])


def block_stack_from_jax(params: Mapping) -> StateDict:
    """Any block stack of `models/blocks.py` (`block_{i}` and the final
    `ln`) -> `blocks.{i}.*` and `ln.*`."""
    sd: StateDict = {}
    for i in range(_n_numbered(params, "block_")):
        _block(sd, f"blocks.{i}", params[f"block_{i}"])
    _ln(sd, "ln", params["ln"]["LayerNorm_0"])
    return sd


def module_from_jax(params: Mapping) -> StateDict:
    """A module whose tree holds Dense layers (-> `name.weight`, `name.bias`),
    Embed tables (-> `name.weight`) and raw parameters (-> `name`): the time
    embeddings of `models/encoders_misc.py`, `RelativePositionBias`,
    `DynamicPositionBias`."""
    sd: StateDict = {}
    for name, p in params.items():
        if isinstance(p, Mapping) and "kernel" in p:
            _dense(sd, name, p)
        elif isinstance(p, Mapping):
            sd[f"{name}.weight"] = _t(p["embedding"])
        else:
            sd[name] = _t(p)
    return sd


def clip_vision_tokens_from_jax(params: Mapping) -> StateDict:
    """CLIPVisionTokens: the ViT tower's keys without `ln_post` and `proj`."""
    sd: StateDict = {"class_embedding": _t(params["class_embedding"]),
                     "positional_embedding": _t(params["positional_embedding"])}
    _conv(sd, "conv1", params["conv1"])
    _ln(sd, "ln_pre", params["ln_pre"])
    _clip_resblocks(sd, params)
    return sd


def vision_clip_head_from_jax(params: Mapping) -> StateDict:
    """VisionClipHead: the tower under `clip` (ViT or RN50 family) and the
    head `fc1`, `fc2`."""
    tower = params["clip"]
    convert = clip_resnet_from_jax if "attnpool" in tower else clip_vision_from_jax
    sd: StateDict = {f"clip.{k}": v for k, v in convert(tower).items()}
    _dense(sd, "fc1", params["fc1"])
    _dense(sd, "fc2", params["fc2"])
    return sd


def voltron_map_encoder_from_jax(params: Mapping) -> StateDict:
    """VoltronMAPEncoder: `vcond` (the Voltron ViT) and `vector_extractor`
    (a MAPBlock)."""
    sd: StateDict = {f"vcond.{k}": v for k, v in voltron_vit_from_jax(params["vcond"]).items()}
    _map_block(sd, "vector_extractor", params["vector_extractor"])
    return sd


def minilm_from_jax(params: Mapping) -> StateDict:
    """The JAX `MiniLMEncoder` tree -> HF BertModel's keys (the inverse of
    JAX `port_minilm_weights`)."""
    sd: StateDict = {
        "embeddings.word_embeddings.weight": _t(params["word_embeddings"]["embedding"]),
        "embeddings.position_embeddings.weight": _t(params["position_embeddings"]),
        "embeddings.token_type_embeddings.weight": _t(params["token_type_embeddings"]),
    }
    _ln(sd, "embeddings.LayerNorm", params["emb_ln"])
    for i in range(_n_numbered(params, "layer_")):
        p, pre = params[f"layer_{i}"], f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            _dense(sd, f"{pre}.attention.self.{name}", p[name])
        _dense(sd, f"{pre}.attention.output.dense", p["attn_out"])
        _ln(sd, f"{pre}.attention.output.LayerNorm", p["attn_ln"])
        _dense(sd, f"{pre}.intermediate.dense", p["fc1"])
        _dense(sd, f"{pre}.output.dense", p["fc2"])
        _ln(sd, f"{pre}.output.LayerNorm", p["out_ln"])
    return sd


def mdtv_transformer_from_jax(params: Mapping) -> StateDict:
    sd: StateDict = {"pos_emb": _t(params["pos_emb"])}
    _dense(sd, "tok_emb", params["tok_emb"])
    _goal_embed(sd, "goal_emb", params["goal_emb"])
    if "lang_emb" in params:  # use_modality_encoder
        _goal_embed(sd, "lang_emb", params["lang_emb"])
    if "proprio_emb" in params:
        _dense(sd, "proprio_emb.0", params["proprio_emb"]["fc1"])
        _dense(sd, "proprio_emb.2", params["proprio_emb"]["fc2"])
    _dense(sd, "sigma_emb.1", params["sigma_emb"]["fc1"])
    _dense(sd, "sigma_emb.3", params["sigma_emb"]["fc2"])
    _dense(sd, "action_emb", params["action_emb"])
    _dense(sd, "action_pred", params["action_pred"])
    for part in ("encoder", "decoder"):
        sd.update({f"{part}.{k}": v for k, v in block_stack_from_jax(params[part]).items()})
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
    "visual_goal": lambda p: (clip_resnet_from_jax if "attnpool" in p
                              else clip_vision_from_jax)(p),
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


def state_from_jax(net, tree: Mapping):
    """The port's `TrainState` of `net` (an `MDTVAgentNet` or `MDTAgentNet`
    of the same config) from the numpy trees of a JAX `TrainState`, as the
    JAX `Checkpointer` restores them into a template: `params`,
    `ema_params`, `opt_state` (optax `adamw`'s tuple of states) and `step`.

    The parameters load into `net`. Over the trainables, matched by name
    through `net.trainable_parameters()`: the EMA from `ema_params` (whose
    frozen towers, their own EMA, are dropped), and AdamW's `exp_avg`,
    `exp_avg_sq` and `step` from optax's `mu`, `nu` and `count`. optax
    corrects the bias with the count after its increment and torch with
    `step` after its increment, so the next `train_step` takes optax's
    (count + 1)-th update; its learning rate is the schedule's at the
    JAX `step`."""
    from ..agents.mdtv_agent import init_train_state
    net.load_state_dict(from_jax(tree["params"]), strict=True)
    state = init_train_state(net)
    ema = from_jax(tree["ema_params"])
    for name, value in state.ema.items():
        value.copy_(ema[name])
    adam = next((s for s in tree["opt_state"] if hasattr(s, "mu")), None)
    if adam is None:
        raise ValueError("opt_state holds no optax ScaleByAdamState (count, mu, nu)")
    count, mu, nu = adam.count, from_jax(adam.mu), from_jax(adam.nu)
    trainable = dict(net.trainable_parameters())
    if set(mu) != set(trainable) or set(nu) != set(trainable):
        raise ValueError(f"the Adam moments cover {sorted(set(mu) ^ set(trainable))[:8]} "
                         "differently from the net's trainables")
    for name, p in trainable.items():
        # torch's AdamW keeps `step` as a float32 scalar on the host
        state.optimizer.state[p] = {"step": torch.tensor(float(count)),
                                    "exp_avg": mu[name].to(p), "exp_avg_sq": nu[name].to(p)}
    state.step = int(tree["step"])
    return state
