"""`mdt_policy_tpu_torch/utils/from_jax.py` is the exact inverse of the JAX
package's `utils/torch_port.py` converters, for each network of the agent
and for the whole MDT-V tree through `port_mdtv_agent`:
port_*(from_jax(params)) == params and from_jax(port_*(sd)) == sd, bit for
bit."""

import functools

import jax
import numpy as np
import pytest
import torch

from mdt_policy_tpu.models.clip import CLIPTextTower as JCLIPText
from mdt_policy_tpu.models.clip import CLIPVisionTower as JCLIPVision
from mdt_policy_tpu.models.masked_decoder import MaskedTransformerImgDecoder as JDecoder
from mdt_policy_tpu.models.mdtv_transformer import MDTVTransformer as JMDTV
from mdt_policy_tpu.models.perceiver import PerceiverResampler as JPerceiver
from mdt_policy_tpu.models.voltron_vit import VoltronViT as JVoltron
from mdt_policy_tpu.utils import torch_port
from mdt_policy_tpu_torch.agents import init_random_
from mdt_policy_tpu_torch.models import (CLIPTextTower, CLIPVisionTower,
                                         MaskedTransformerImgDecoder,
                                         MDTVTransformer, PerceiverResampler,
                                         VoltronViT)
from mdt_policy_tpu_torch.utils import from_jax


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def assert_same_state_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def _jax_params(module, *args, **kw):
    init = jax.jit(functools.partial(module.init, **kw))  # one compile, not op-by-op
    return jax.device_get(init(jax.random.PRNGKey(0), *args)["params"])


def _port_sd(module):
    init_random_(module, torch.Generator().manual_seed(0))
    return {k: v.clone() for k, v in module.state_dict().items()}


def _voltron():
    x = np.zeros((1, 32, 32, 3), np.float32)
    return (_jax_params(JVoltron(patch_size=16, embed_dim=32, depth=2,
                                 n_heads=2, img_size=32), x),
            VoltronViT(16, 32, 2, 2, img_size=32),
            from_jax.voltron_vit_from_jax, torch_port.port_voltron_vit)


def _perceiver():
    x = np.zeros((1, 1, 8, 32), np.float32)
    return (_jax_params(JPerceiver(dim=32, depth=2, dim_head=8, heads=4,
                                   num_latents=3, num_time_embeds=1,
                                   factored=True), x),
            PerceiverResampler(32, 2, 8, 4, 3, 1),
            from_jax.perceiver_from_jax,
            lambda sd: torch_port.port_perceiver(sd, depth=2))


def _clip_text():
    tokens = np.ones((1, 8), np.int32)
    return (_jax_params(JCLIPText(embed_dim=16, context_length=8, vocab_size=50,
                                  width=16, heads=2, layers=2), tokens),
            CLIPTextTower(16, 8, 50, 16, 2, 2),
            from_jax.clip_text_from_jax,
            lambda sd: torch_port.port_clip_text(sd, layers=2))


def _clip_vision():
    x = np.zeros((1, 32, 32, 3), np.float32)
    visual = lambda f: lambda sd: f({f"visual.{k}": v for k, v in sd.items()})
    return (_jax_params(JCLIPVision(embed_dim=16, image_resolution=32, layers=2,
                                    width=64, patch_size=16), x),
            CLIPVisionTower(16, 32, 2, 64, 16),
            from_jax.clip_vision_from_jax,
            visual(lambda sd: torch_port.port_clip_vision(sd, layers=2)))


def _masked_decoder():
    ctx = np.zeros((1, 4, 24), np.float32)
    imgs = np.zeros((1, 2, 32, 32, 3), np.float32)
    jm = JDecoder(resolution=32, patch_size=16, decoder_depth=2,
                  decoder_embed_dim=16, decoder_n_heads=2, context_dim=24)
    init = jax.jit(jm.init)
    params = jax.device_get(init({"params": jax.random.PRNGKey(0),
                                  "mask": jax.random.PRNGKey(1)}, ctx, imgs)["params"])
    return (params,
            MaskedTransformerImgDecoder(32, 16, 2, 16, 2, context_dim=24),
            from_jax.masked_decoder_from_jax,
            lambda sd: torch_port.port_masked_decoder(sd, depth=2))


def _mdtv_transformer():
    kw = dict(obs_dim=24, goal_dim=16, action_dim=7, proprio_dim=8,
              embed_dim=24, n_enc_layers=2, n_dec_layers=2, n_heads=2)
    states = {"state_images": np.zeros((1, 3, 24), np.float32),
              "state_obs": np.zeros((1, 1, 8), np.float32)}
    params = _jax_params(JMDTV(**kw), states, np.zeros((1, 10, 7), np.float32),
                         np.zeros((1, 1, 16), np.float32),
                         np.ones((1,), np.float32), modality="lang")
    return (params, MDTVTransformer(**kw, use_proprio=True),
            from_jax.mdtv_transformer_from_jax,
            lambda sd: torch_port.port_mdtv_transformer(sd, n_enc_layers=2,
                                                        n_dec_layers=2))


# each maker inits its JAX module once per test session
PARTS = {name: functools.cache(make) for name, make in (
    ("img_encoder", _voltron), ("perceiver", _perceiver),
    ("visual_goal", _clip_vision), ("language_goal", _clip_text),
    ("inner", _mdtv_transformer), ("gen_img", _masked_decoder))}


@pytest.mark.parametrize("part", sorted(PARTS))
def test_port_of_from_jax_is_identity(part):
    params, _, to_torch, to_jax = PARTS[part]()
    assert_same_tree(to_jax(to_torch(params)), params)


@pytest.mark.parametrize("part", sorted(PARTS))
def test_from_jax_of_port_is_identity(part):
    _, module, to_torch, to_jax = PARTS[part]()
    sd = _port_sd(module)
    assert_same_state_dict(to_torch(to_jax(sd)), sd)


def test_from_jax_agent_keys_and_ignored_parts():
    """The agent-level converter prefixes every network of the tree it is
    given and leaves out what the tree does not hold (a gradient tree has
    no frozen towers)."""
    parts = {name: make()[0] for name, make in PARTS.items()}
    sd = from_jax.from_jax({**parts, "logit_scale": np.float32(2.5)})
    assert {k.split(".", 1)[0] for k in sd} == set(PARTS) | {"logit_scale"}
    assert sd["img_encoder.patch2embed.proj.weight"].shape == (32, 3, 16, 16)
    assert sd["language_goal.transformer.resblocks.1.attn.in_proj_weight"].shape \
        == (48, 16)
    assert sd["visual_goal.conv1.weight"].shape == (64, 3, 16, 16)
    assert sd["gen_img.decoder_blocks.1.norm1.g"].shape == (16,)
    assert sd["logit_scale"].shape == () and float(sd["logit_scale"]) == 2.5
    trainable = from_jax.from_jax({"inner": parts["inner"], "gen_img": parts["gen_img"]})
    assert {k.split(".", 1)[0] for k in trainable} == {"inner", "gen_img"}


# the reference checkpoint's module prefixes, as port_mdtv_agent reads them
REF_PREFIX = {"inner": "model.inner_model.", "perceiver": "perceiver.",
              "img_encoder": "img_encoder.vcond.",
              "visual_goal": "visual_goal.clip_model.visual.",
              "language_goal": "language_goal.clip_rn50.", "gen_img": "gen_img.",
              "clip_proj": "clip_proj."}
TINY = dict(
    latent_dim=32, embed_dim=32, obs_dim=32, goal_dim=16, clip_embed_dim=16,
    n_enc_layers=1, n_dec_layers=2, n_heads=2,
    perceiver_dim=32, perceiver_depth=2, perceiver_heads=2, perceiver_dim_head=8,
    num_latents=3, img_size=32, vit_patch=16, vit_depth=2, vit_heads=2,
    clip_vision_width=32, clip_vision_layers=2, clip_vision_patch=16,
    clip_text_width=16, clip_text_layers=2, clip_text_heads=2,
    clip_context_length=8, clip_vocab_size=100,
    gen_img_res=32, gen_patch_size=16, gen_decoder_depth=2, gen_decoder_dim=16,
    gen_decoder_heads=2, use_proprio=True)


def _reference_layout(sd):
    out = {}
    for k, v in sd.items():
        part, _, rest = k.partition(".")
        out[REF_PREFIX[part] + rest if part in REF_PREFIX else k] = v
    return out


def _port_agent(sd):
    return torch_port.port_mdtv_agent(
        _reference_layout(sd), n_enc_layers=1, n_dec_layers=2,
        perceiver_depth=2, gen_depth=2, clip_vision_layers=2, clip_text_layers=2)


@functools.cache
def _jax_agent_tree():
    from mdt_policy_tpu.agents import MDTVConfig as JaxConfig
    from mdt_policy_tpu.agents import init_agent
    rng = np.random.default_rng(0)
    B = 2
    example = {
        "rgb_static": rng.uniform(size=(B, 2, 32, 32, 3)).astype(np.float32),
        "rgb_gripper": rng.uniform(size=(B, 2, 84, 84, 3)).astype(np.float32),
        "gen_static": rng.uniform(size=(B, 32, 32, 3)).astype(np.float32),
        "gen_gripper": rng.uniform(size=(B, 32, 32, 3)).astype(np.float32),
        "actions": rng.normal(size=(B, 10, 7)).astype(np.float32),
        "lang_tokens": rng.integers(1, 100, size=(B, 8)).astype(np.int32),
        "state_obs": rng.normal(size=(B, 1, 8)).astype(np.float32),
    }
    _, state = init_agent(JaxConfig(**TINY), jax.random.PRNGKey(0), example)
    # the frozen towers are bf16 in the tree; compare as float32
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(state.params))


def test_port_of_from_jax_is_identity_for_the_agent():
    """The whole MDT-V tree of `init_agent` (every network, `clip_proj` and
    `logit_scale`) -> from_jax -> port_mdtv_agent is the tree, bit for bit."""
    params = _jax_agent_tree()
    assert {"visual_goal", "gen_img", "clip_proj", "logit_scale"} <= set(params)
    assert_same_tree(_port_agent(from_jax.from_jax(params)), params)


def test_from_jax_of_port_is_identity_for_the_agent():
    from mdt_policy_tpu_torch.agents import MDTVAgentNet, MDTVConfig
    net = MDTVAgentNet(MDTVConfig(**TINY, compute_dtype="float32"), device="cpu")
    sd = _port_sd(net)
    back = from_jax.from_jax(jax.tree.map(np.asarray, _port_agent(sd)))
    assert_same_state_dict(back, sd)
    net.load_state_dict(from_jax.from_jax(_jax_agent_tree()), strict=True)
