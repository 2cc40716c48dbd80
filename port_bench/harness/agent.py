"""The system under test, built from a configuration file: the port's agent
net of the configuration's family, with the benchmark's seeded weights."""

from __future__ import annotations

import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from . import weights as W


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one named stream of a run's `seed`."""
    words = [int(seed) & 0xFFFFFFFFFFFFFFFF, int(seed) >> 64] + [
        zlib.crc32(str(p).encode()) for p in parts]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def agent_config(doc: Dict):
    """The port's config object of a configuration file."""
    from mdt_policy_tpu_torch.agents import MDTConfig, MDTVConfig
    cls = {"mdtv": MDTVConfig, "mdt": MDTConfig}[doc["family"]]
    return cls(**doc["agent"])


def bf16_prefixes(fields: Dict) -> Tuple[str, ...]:
    """Networks whose weights the configuration (its agent fields) stores
    in bfloat16: the frozen towers, in `compute_dtype`."""
    if fields.get("compute_dtype", "bfloat16") != "bfloat16":
        return ()
    return ("img_encoder", "visual_goal", "language_goal")


def build(doc: Dict, seed: int, device, agent_cfg=None):
    """(net, layout): the port's net of `doc` on `device` with the weights
    of `seed` loaded; `layout` regenerates those weights (`weights_of`)."""
    from mdt_policy_tpu_torch.agents import make_agent_net
    net = make_agent_net(agent_cfg or agent_config(doc), device=device)
    spec = W.layout(net)
    W.load(net, W.draw(spec, sub_seed(seed, "weights"), device))
    return net, spec


def weights_of(fields: Dict, spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The reference's copy of the weights of `seed`: as drawn, towers
    rounded to the dtype the configuration (its agent fields) stores them
    in."""
    return W.stored_dtype(W.draw(spec, sub_seed(seed, "weights"), device),
                          bf16_prefixes(fields))
