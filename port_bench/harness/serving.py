"""What the kinds share: the instructions' token ids, and, for the serving
kinds, their schedule and the raw frames, from the seed."""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

from . import agent as A


def goal_tokens(traffic: Dict, home, context_length: int) -> np.ndarray:
    """(instructions, context_length) int32 CLIP token ids of the traffic's
    instructions, zero-padded: the ids stored beside each sentence in its
    file under `home`, so the inputs stay fixed whatever the program's
    tokenizer does."""
    doc = json.loads((home / "traffic" / traffic["sentences"]).read_text())
    out = np.zeros((len(doc["sentences"]), context_length), np.int32)
    for i, key in enumerate(doc["sentences"]):
        ids = doc["clip_ids"][key]
        if len(ids) > context_length:
            raise ValueError(f"{key!r} has {len(ids)} tokens, over {context_length}")
        out[i, :len(ids)] = ids
    return out


def goal_schedule(n_sentences: int, seed: int, n_segments: int) -> np.ndarray:
    """Instruction index of each segment: each differs from the one before."""
    rng = np.random.default_rng(A.sub_seed(seed, "goals"))
    out = np.empty(n_segments, np.int64)
    out[0] = rng.integers(n_sentences)
    step = rng.integers(1, n_sentences, size=n_segments)
    for i in range(1, n_segments):
        out[i] = (out[i - 1] + step[i]) % n_sentences
    return out


def frame_pool(traffic: Dict, seed: int, device, n: int):
    """(static, gripper) uint8 host arrays of `n` frames each, drawn on the
    device from the seed."""
    gen = torch.Generator(device).manual_seed(A.sub_seed(seed, "frames"))
    s, g = traffic["static_hw"], traffic["gripper_hw"]
    static = torch.randint(0, 256, (n, s, s, 3), generator=gen, device=device, dtype=torch.uint8)
    grip = torch.randint(0, 256, (n, g, g, 3), generator=gen, device=device, dtype=torch.uint8)
    return static.cpu().numpy(), grip.cpu().numpy()


def noise_draws(seed: int, device, shape, n: int) -> List[torch.Tensor]:
    """The first `n` draws of `shape` from a generator seeded `seed`, as the
    policy draws its replans' initial noise."""
    gen = torch.Generator(device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device) for _ in range(n)]


def reference_chunks(ctx, spec, x: Dict[str, torch.Tensor], rows: int, control: bool):
    """The reference's (or the control's) chunks of the inputs `x`
    (static, gripper, tokens, noise), `rows` at a time."""
    from port_bench.reference.common import Prec
    P = A.weights_of(ctx.cfg_fields, spec, ctx.seed, ctx.device)
    out = []
    with torch.no_grad():
        for i in range(0, len(x["noise"]), rows):
            sl = slice(i, i + rows)
            out.append(ctx.reference.replan(ctx.cfg_fields, P, Prec(control), x["static"][sl],
                                            x["gripper"][sl], x["tokens"][sl],
                                            x["noise"][sl]).cpu())
    return torch.cat(out).numpy()


def chunk_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """The largest gap of an action to the reference's, over the RMS of the
    reference's actions."""
    return float(np.abs(got - ref).max() / np.sqrt(np.mean(ref ** 2)))
