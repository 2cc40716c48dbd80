"""`mdt_policy_tpu_torch/utils/from_jax.py` is the exact inverse of the JAX
package's `utils/torch_port.py` converters, for each of the four networks
of the slice: port_*(from_jax(params)) == params and
from_jax(port_*(sd)) == sd, bit for bit."""

import functools

import jax
import numpy as np
import pytest
import torch

from mdt_policy_tpu.models.clip import CLIPTextTower as JCLIPText
from mdt_policy_tpu.models.mdtv_transformer import MDTVTransformer as JMDTV
from mdt_policy_tpu.models.perceiver import PerceiverResampler as JPerceiver
from mdt_policy_tpu.models.voltron_vit import VoltronViT as JVoltron
from mdt_policy_tpu.utils import torch_port
from mdt_policy_tpu_torch.agents import init_random_
from mdt_policy_tpu_torch.models import (CLIPTextTower, MDTVTransformer,
                                         PerceiverResampler, VoltronViT)
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
    ("language_goal", _clip_text), ("inner", _mdtv_transformer))}


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
    """The agent-level converter prefixes the four parts and leaves out the
    towers the port has no module for yet."""
    parts = {name: make()[0] for name, make in PARTS.items()}
    tree = {**parts, "visual_goal": {"x": np.zeros(1)}, "gen_img": {},
            "clip_proj": {}, "logit_scale": np.zeros(())}
    sd = from_jax.from_jax(tree)
    assert {k.split(".", 1)[0] for k in sd} == set(PARTS)
    assert sd["img_encoder.patch2embed.proj.weight"].shape == (32, 3, 16, 16)
    assert sd["language_goal.transformer.resblocks.1.attn.in_proj_weight"].shape \
        == (48, 16)
