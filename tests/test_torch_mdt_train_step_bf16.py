"""The MDT (ResNet) train step of the PyTorch port at the production
dtypes against the JAX package, and the contrastive loss's reading of
`lang_emb` and `goal_emb` on the port alone, at the tiny config of
tests/test_torch_mdt_train_step.py, whose helpers (agents, batch, draws,
steps) these tests share. They sit in a file of their own so that
`--dist loadfile` can run them beside that file's f32 steps.
"""

import numpy as np
import torch

from mdt_policy_tpu_torch.agents import MDTAgentNet, MDTConfig, init_random_, make_draws
from test_torch_mdt_train_step import LOSSES, TINY, _agents, _batch, _steps


def test_mdt_train_step_bf16_towers_and_decoder():
    """The production dtypes (bf16 CLIP towers, bf16 foresight decoder; the
    ResNets stay f32): the MDT-V step's bound, 2e-2 relative."""
    (jm, *_), (pm, *_) = _steps("bf16")
    _, _, port = _agents("bf16")
    assert port.visual_goal.conv1.weight.dtype == torch.bfloat16
    assert port.static_resnet.backbone[0].weight.dtype == torch.float32
    keys = LOSSES + ["train/grad_norm", "train/param_norm"]
    rel = {k: abs(pm[k] - jm[k]) / abs(jm[k]) for k in keys if jm[k] != 0}
    worst = max(rel, key=rel.get)
    print(f"MDT bf16 train step: max relative |port - jax| = {rel[worst]:.3g} ({worst})")
    for k in keys:
        assert np.isfinite(pm[k]), k
        np.testing.assert_allclose(pm[k], jm[k], rtol=2e-2, err_msg=k)


def test_mdt_contrastive_loss_reads_lang_emb_and_the_main_path_goal_emb():
    """The rule of JAX :195-203 on the port alone: a change of `lang_emb`
    moves only the lang scope's contrastive loss; a change of `goal_emb`
    moves both scopes' action losses."""
    cfg = MDTConfig(**TINY, compute_dtype="float32")
    net = init_random_(MDTAgentNet(cfg, device="cpu"), torch.Generator().manual_seed(0))
    batch = {s: {k: torch.as_tensor(v) for k, v in b.items()} for s, b in _batch().items()}

    def losses():
        out = {}
        for scope in ("lang", "vis"):
            draws = make_draws(cfg, 4, torch.Generator().manual_seed(1))
            with torch.no_grad():
                out.update({f"{scope}/{k}": float(v) for k, v in
                            net(batch[scope], scope, train=False, draws=draws).items()})
        return out

    base = losses()
    with torch.no_grad():
        net.inner.lang_emb[0].weight.mul_(1.5)
    lang = losses()
    with torch.no_grad():
        net.inner.goal_emb[0].weight.mul_(1.5)
    goal = losses()
    assert lang["lang/cont_loss"] != base["lang/cont_loss"]
    assert {k: v for k, v in lang.items() if k not in ("lang/cont_loss", "lang/total_loss")} \
        == {k: v for k, v in base.items() if k not in ("lang/cont_loss", "lang/total_loss")}
    assert goal["lang/action_loss"] != lang["lang/action_loss"]
    assert goal["vis/action_loss"] != lang["vis/action_loss"]
