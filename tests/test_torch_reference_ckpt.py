"""`mdt_policy_tpu_torch/utils/from_reference.py`, the port's converter of
the reference's Lightning checkpoints (the published `mdtv-*` weights),
against the JAX package's `utils/torch_port.py` on one file.

The file is written from a seeded port net in the reference's format: the
raw `state_dict` (perturbed), the EMA callback's weight list in the file's
key order with buffers in between, keys neither converter reads, the
`proprio_emb` head and Lightning's pickled `hyper_parameters`, whose class
lives in a module made for the test. The JAX side reads the file while that
module is importable; the port reads it after the module is gone, and
imports it never.

The JAX `convert_checkpoint` runs whole but for two stand-ins: its orbax
`Checkpointer` (the merged tree is taken where it would be saved) and
`init_agent`, whose parameter tree is given by `jax.eval_shape` of the same
init (no compile). Its own example batch holds no `state_obs`, so its init
never builds `proprio_emb`, and it drops the head even for a `use_proprio`
config, against its `deep_merge`'s docstring; the stand-in adds `state_obs`
where the config uses proprio, which gives the tree of the config."""

import functools
import logging
import pathlib
import sys
import types
from collections import OrderedDict
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from mdt_policy_tpu.utils import torch_port
from mdt_policy_tpu_torch import evaluate, training
from mdt_policy_tpu_torch.agents import MDTVAgentNet, MDTVConfig, init_random_
from mdt_policy_tpu_torch.evaluation.policy_adapter import make_rollout_policy
from mdt_policy_tpu_torch.utils import from_jax, from_reference
from test_torch_from_jax import TINY
from test_torch_imports import run_blocked

# the reference agent's module prefixes (mdt/models/mdtv_agent.py:81-143)
REF_PREFIX = {"inner": "model.inner_model.", "perceiver": "perceiver.",
              "img_encoder": "img_encoder.vcond.",
              "visual_goal": "visual_goal.clip_model.visual.",
              "language_goal": "language_goal.clip_rn50.", "gen_img": "gen_img.",
              "clip_proj": "clip_proj."}
DEPTHS = dict(n_enc_layers=1, n_dec_layers=2, perceiver_depth=2, gen_depth=2,
              clip_vision_layers=2, clip_text_layers=2)  # TINY's, as port_mdtv_agent takes them
HPARAMS_MODULE = "reference_ckpt_test_hparams"
# keys of a reference file that neither converter reads: the text goal's CLIP
# image tower, fixed sin-cos buffers (recomputed), a Voltron language model
STAND_INS = {"language_goal.clip_rn50.visual.conv1.weight": (4, 3, 2, 2),
             "gen_img.decoder_pe": (1, 4, 16), "img_encoder.vcond.encoder_pe": (1, 4, 32),
             "img_encoder.vcond.lm.embeddings.weight": (6, 32)}
TOWERS = ("img_encoder", "visual_goal", "language_goal")


def _ref_key(key):
    part, _, rest = key.partition(".")
    return REF_PREFIX[part] + rest if part in REF_PREFIX else key


class _Logged(dict):
    """The JAX state_dict whose values log their key when converted
    (`torch_port._np` detaches each tensor it reads): the keys
    `port_mdtv_agent` reads, through its sub-dicts too."""

    def __init__(self, sd, log):
        super().__init__({k: _Value(k, v, log) for k, v in sd.items()})


class _Value:
    def __init__(self, key, array, log):
        self.key, self.array, self.log = key, array, log

    def detach(self):
        self.log.append(self.key)
        return torch.from_numpy(self.array)


class _ShapeState:
    def __init__(self, params):
        self.params = params

    def replace(self, **kw):
        return types.SimpleNamespace(**kw)


_SHAPES = {}


def _shape_params(cfg):
    """The JAX net of `cfg` and its init's parameter tree of shapes."""
    if repr(cfg) in _SHAPES:
        return _SHAPES[repr(cfg)]
    from mdt_policy_tpu.agents import MDTVAgentNet as JaxNet
    s, B = cfg.img_size, 1
    example = {"rgb_static": np.zeros((B, 2, s, s, 3), np.float32),
               "rgb_gripper": np.zeros((B, 2, 84, 84, 3), np.float32),
               "gen_static": np.zeros((B, cfg.gen_img_res, cfg.gen_img_res, 3), np.float32),
               "gen_gripper": np.zeros((B, cfg.gen_img_res, cfg.gen_img_res, 3), np.float32),
               "actions": np.zeros((B, cfg.act_window_size, cfg.action_dim), np.float32),
               "lang_tokens": np.zeros((B, cfg.clip_context_length), np.int32)}
    if cfg.use_proprio:
        example["state_obs"] = np.zeros((B, 1, cfg.proprio_dim), np.float32)
    rngs = dict(zip(("params", "dropout", "sigma", "noise", "mask", "goal_mask"),
                    jax.random.split(jax.random.PRNGKey(0), 6)))
    net = JaxNet(cfg)
    init = functools.partial(net.init, modality="lang", train=True)
    _SHAPES[repr(cfg)] = net, dict(jax.eval_shape(init, rngs, example)["params"])
    return _SHAPES[repr(cfg)]


def _shape_init(cfg, rng, example):
    net, params = _shape_params(cfg)
    return net, _ShapeState(params)


class _Drops(logging.Handler):
    def __init__(self):
        super().__init__()
        self.paths = []

    def emit(self, record):
        if "dropped" in record.msg:
            self.paths += record.args[0]


def _jax_side(path, out, prefer_ema, use_proprio):
    """The JAX converter on the file: the keys `port_mdtv_agent` reads, its
    tree through `from_jax`, and `convert_checkpoint`'s merged tree through
    `from_jax` with the subtrees `deep_merge` dropped."""
    reads = []
    ported = torch_port.port_mdtv_agent(
        _Logged(torch_port.load_reference_state_dict(path, prefer_ema=prefer_ema), reads),
        **DEPTHS)
    saved, drops = {}, _Drops()

    class Saver:  # the orbax Checkpointer's place
        def __init__(self, ckpt_dir):
            pass

        def save(self, state, wait=False):
            saved["state"] = state
    torch_port.logger.addHandler(drops)
    level = torch_port.logger.level
    torch_port.logger.setLevel(logging.INFO)
    try:
        with mock.patch("mdt_policy_tpu.agents.init_agent", _shape_init), \
                mock.patch("mdt_policy_tpu.utils.checkpoint.Checkpointer", Saver):
            torch_port.convert_checkpoint(str(path), out, prefer_ema=prefer_ema,
                                          agent_overrides={**TINY, "use_proprio": use_proprio})
    finally:
        torch_port.logger.removeHandler(drops)
        torch_port.logger.setLevel(level)
    merged = saved["state"].params
    leaves = jax.tree.leaves(merged)
    assert not any(isinstance(x, jax.ShapeDtypeStruct) for x in leaves)  # nothing kept its init
    return types.SimpleNamespace(reads=reads, ported=from_jax.from_jax(ported),
                                 merged=from_jax.from_jax(merged), dropped=drops.paths)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference_ckpt")
    source = init_random_(MDTVAgentNet(MDTVConfig(**TINY, compute_dtype="float32"),
                                       device="cpu"), torch.Generator().manual_seed(3))
    assert any(k.startswith("inner.proprio_emb.") for k in source.state_dict())
    gen = torch.Generator().manual_seed(4)
    ema = OrderedDict()
    for key, value in source.state_dict().items():
        ema[_ref_key(key)] = value.clone()
        for extra, shape in STAND_INS.items():  # each after its network's first key
            if extra.startswith(_ref_key(key).split(".")[0] + ".") and extra not in ema:
                ema[extra] = torch.randn(shape, generator=gen)
    raw = OrderedDict((k, v + 0.5) for k, v in ema.items())

    hparams = types.ModuleType(HPARAMS_MODULE)
    AttributeDict = type("AttributeDict", (dict,), {"__module__": HPARAMS_MODULE})
    Milestones = type("Milestones", (list,), {"__module__": HPARAMS_MODULE})
    hparams.AttributeDict, hparams.Milestones = AttributeDict, Milestones
    path = root / "mdtv.ckpt"
    sys.modules[HPARAMS_MODULE] = hparams
    try:
        torch.save({"epoch": 19, "global_step": 24000, "pytorch-lightning_version": "1.8.6",
                    "state_dict": raw,
                    "callbacks": {"EMA": {"ema_weights": list(ema.values())},
                                  "ModelCheckpoint": {"best_model_path":
                                                      pathlib.PurePosixPath("/runs/x.ckpt")}},
                    "optimizer_states": [{"state": {}, "param_groups": [{"lr": 1e-4}]}],
                    "loops": {"fit_loop": {"epoch_progress": {"current": np.int64(19)}}},
                    "hparams_name": "kwargs",
                    "hyper_parameters": AttributeDict(lr=np.float64(1e-4), use_proprio=True,
                                                      milestones=Milestones([10, 20]))},
                   path)
        jax_side = {(pe, up): _jax_side(path, str(root / f"jax_{pe}_{up}"), pe, up)
                    for pe in (True, False) for up in (True, False)}
    finally:
        del sys.modules[HPARAMS_MODULE]
    return types.SimpleNamespace(path=path, ema=ema, raw=raw, jax=jax_side)


@pytest.fixture
def never_imported():
    """The test module's hparams module cannot be imported."""
    class Finder:
        def find_spec(self, name, path=None, target=None):
            if name == HPARAMS_MODULE:
                raise AssertionError(f"{name} was imported")
    sys.meta_path.insert(0, Finder())
    yield
    sys.meta_path.pop(0)
    assert HPARAMS_MODULE not in sys.modules


def test_reads_lightning_pickles_without_their_modules(ckpt, never_imported):
    """The restricted unpickler: tensors and the containers on torch's
    `weights_only` allowlist resolve; the pickled `hyper_parameters` (a
    dict subclass holding a list subclass), numpy's scalars and a `pathlib`
    path become inert stand-ins that name their class and hold what the
    file gave."""
    data = torch.load(ckpt.path, weights_only=False,
                      pickle_module=from_reference._restricted_pickle())
    hp = data["hyper_parameters"]
    assert isinstance(hp, from_reference.Inert)
    assert hp.dotted == f"{HPARAMS_MODULE}.AttributeDict"
    assert sorted(hp) == ["lr", "milestones", "use_proprio"]
    assert hp["use_proprio"] is True
    assert hp["milestones"].dotted == f"{HPARAMS_MODULE}.Milestones"
    assert hp["milestones"].listed == [10, 20]
    for scalar, want in ((hp["lr"], np.float64(1e-4)),
                         (data["loops"]["fit_loop"]["epoch_progress"]["current"], np.int64(19))):
        assert isinstance(scalar, from_reference.Inert)
        assert scalar.dotted.endswith("multiarray.scalar")
        assert scalar.args[1] == want.tobytes()
    best = data["callbacks"]["ModelCheckpoint"]["best_model_path"]
    assert isinstance(best, from_reference.Inert) and best.dotted.endswith("PurePosixPath")
    assert pathlib.PurePosixPath(*best.args) == pathlib.PurePosixPath("/runs/x.ckpt")
    assert isinstance(data["state_dict"], OrderedDict)
    assert list(data["state_dict"]) == list(ckpt.raw)
    sd = from_reference.load_reference_state_dict(ckpt.path)
    assert list(sd) == list(ckpt.ema)  # the file's order, buffers included
    assert all(torch.equal(sd[k], ckpt.ema[k]) for k in sd)


@pytest.mark.parametrize("use_proprio", [True, False])
@pytest.mark.parametrize("prefer_ema", [True, False])
def test_conversion_matches_jax(ckpt, never_imported, prefer_ema, use_proprio):
    """The port's conversion of the file equals the JAX converter's through
    `from_jax`, bit for bit in float32 and, on the net, after the same cast
    for the bf16 towers; the keys read are `port_mdtv_agent`'s, the drops
    `deep_merge`'s; EMA lands by default, the raw weights with
    prefer_ema=False."""
    want = ckpt.jax[(prefer_ema, use_proprio)]
    cfg = MDTVConfig(**{**TINY, "use_proprio": use_proprio})
    net = MDTVAgentNet(cfg, device="cpu")
    sd = from_reference.load_reference_state_dict(ckpt.path, prefer_ema=prefer_ema)
    got, report = from_reference.reference_to_port(sd, cfg, net.state_dict())

    assert sorted(report.read) == sorted(want.reads)
    assert len(set(report.read)) == len(report.read)
    assert report.ignored == [k for k in sd if k not in set(want.reads)]
    assert set(report.ignored) == set(STAND_INS)
    assert set(report.dropped) == set(want.ported) - set(want.merged)
    assert want.dropped == ([] if use_proprio else ["/inner/proprio_emb"])
    assert bool(report.dropped) != use_proprio
    assert all(k.startswith("inner.proprio_emb.") for k in report.dropped)
    assert report.missing == []
    assert sorted(got) == sorted(want.merged) == sorted(net.state_dict())
    for k, v in got.items():
        assert v.dtype == torch.float32 and torch.equal(v, want.ported[k]), k
        source = (ckpt.ema if prefer_ema else ckpt.raw)[_ref_key(k)]
        assert torch.equal(v, source.reshape(v.shape)), k
    assert not torch.equal(got["inner.tok_emb.weight"],
                           (ckpt.raw if prefer_ema else ckpt.ema)["model.inner_model.tok_emb.weight"])

    net.load_state_dict(got, strict=False)
    for k, v in net.state_dict().items():
        assert v.dtype == (torch.bfloat16 if k.split(".")[0] in TOWERS else torch.float32), k
        assert torch.equal(v, want.merged[k].to(v.dtype)), k


def _edit_ls_spelling(sd):
    return {k.replace(".ls1.gamma", ".lambda1").replace(".ls2.gamma", ".layer_scale2.gamma")
            if k.startswith("img_encoder.vcond.") else k: v for k, v in sd.items()}


EDITS = {
    "layer_scale_spellings": _edit_ls_spelling,
    "voltron_unmapped": lambda sd: {k: v for k, v in sd.items()
                                    if k != "img_encoder.vcond.blocks.1.ls2.gamma"},
    "no_clip_proj": lambda sd: {k: v for k, v in sd.items() if not k.startswith("clip_proj.")},
    "no_voltron": lambda sd: {k: v for k, v in sd.items()
                              if not k.startswith("img_encoder.vcond.")},
    "perceiver_key_missing": lambda sd: {k: v for k, v in sd.items()
                                         if k != "perceiver.layers.1.0.to_k.weight"},
    "text_tower_key_missing": lambda sd: {
        k: v for k, v in sd.items()
        if k != "language_goal.clip_rn50.transformer.resblocks.0.attn.in_proj_bias"},
}


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_edited_files_match_jax(ckpt, never_imported, edit, caplog):
    """Files the converters treat apart, as both treat them: other
    LayerScale spellings map to the port's `ls{i}.gamma`; a Voltron backbone
    that does not map (a LayerScale missing) warns and keeps its init, as do
    an absent backbone and an absent `clip_proj`; a key missing inside
    another network raises KeyError naming it."""
    sd = EDITS[edit](from_reference.load_reference_state_dict(ckpt.path))
    jsd = {k: v.numpy() for k, v in sd.items()}
    net = MDTVAgentNet(MDTVConfig(**TINY), device="cpu")
    if edit.endswith("key_missing"):
        with pytest.raises(KeyError) as port_err:
            from_reference.reference_to_port(sd, net.cfg)
        with pytest.raises(KeyError) as jax_err:
            torch_port.port_mdtv_agent(jsd, **DEPTHS)
        (gone,) = set(from_reference.load_reference_state_dict(ckpt.path)) - set(sd)
        assert port_err.value.args == (gone,)
        assert gone.endswith(jax_err.value.args[0])
        return
    with caplog.at_level(logging.WARNING):
        got, report = from_reference.reference_to_port(sd, net.cfg, net.state_dict())
        want = from_jax.from_jax(torch_port.port_mdtv_agent(jsd, **DEPTHS))
    warned = [r for r in caplog.records if "voltron backbone port failed" in r.getMessage()]
    assert len(warned) == 2 * (edit == "voltron_unmapped")  # the port's and JAX's
    assert set(got) | set(report.dropped) == set(want) and not report.dropped
    assert all(torch.equal(got[k], want[k]) for k in got)
    kept = {"no_clip_proj": "clip_proj.", "no_voltron": "img_encoder.",
            "voltron_unmapped": "img_encoder."}.get(edit)
    assert report.missing == [k for k in net.state_dict() if kept and k.startswith(kept)]
    assert set(report.ignored) == set(sd) - set(report.read)
    if edit == "voltron_unmapped":
        assert {k for k in sd if k.startswith("img_encoder.vcond.")} <= set(report.ignored)


def _replan(policy, generator_seed=5):
    rng = np.random.default_rng(8)
    obs = {"rgb_obs": {"rgb_static": rng.integers(0, 255, (1, 1, 64, 64, 3), dtype=np.uint8),
                       "rgb_gripper": rng.integers(0, 255, (1, 1, 32, 32, 3), dtype=np.uint8)}}
    goal = {"lang_tokens": np.array([[98, 5, 17, 40, 99, 0, 0, 0]])}
    policy.inner.generator = torch.Generator().manual_seed(generator_seed)
    policy.reset()
    action = policy.step(obs, goal)
    return policy.inner.pred_action_seq, action


def test_main_writes_a_run_directory(ckpt, never_imported, tmp_path):
    """`main([ckpt, out])` hands the file to `convert_checkpoint` at the
    production sizes, EMA first, raw with `--raw`. The run directory it
    writes (here at TINY sizes) is one that `evaluate.load_run_agent`
    restores to the JAX converter's weights, whose checkpoint
    `_load_pretrain_params` reads for a warm start, and whose
    `build_policy` replans as a net loaded from the JAX-ported tree does,
    with the same draws."""
    with mock.patch.object(from_reference, "convert_checkpoint") as convert:
        from_reference.main([str(ckpt.path), "out"])
        from_reference.main([str(ckpt.path), "out", "--raw"])
    assert convert.call_args_list == [mock.call(str(ckpt.path), "out", prefer_ema=True),
                                      mock.call(str(ckpt.path), "out", prefer_ema=False)]
    with pytest.raises(SystemExit):
        from_reference.main([str(ckpt.path), "out", "--agent-overrides", "{}"])

    out = tmp_path / "run"
    report = from_reference.convert_checkpoint(ckpt.path, out, agent_overrides=TINY)
    assert report.counts()["missing"] == 0 and report.counts()["dropped"] == 0
    want = ckpt.jax[(True, True)]
    net, cfg, run_cfg = evaluate.load_run_agent(out, device="cpu")
    assert run_cfg.agent == "mdtv" and cfg == MDTVConfig(**TINY)
    restored = net.state_dict()
    assert sorted(restored) == sorted(want.merged)
    for k, v in restored.items():
        assert torch.equal(v, want.merged[k].to(v.dtype)), k
    warm = training._load_pretrain_params(str(out / "checkpoints"))
    assert sorted(warm) == sorted(restored)
    assert all(v.dtype == restored[k].dtype and torch.equal(v, restored[k])
               for k, v in warm.items())

    policy, _, _ = evaluate.build_policy(out, device="cpu")
    direct = MDTVAgentNet(MDTVConfig(**TINY), device="cpu")
    direct.load_state_dict(want.ported, strict=True)
    chunk, action = _replan(policy)
    want_chunk, want_action = _replan(make_rollout_policy(direct))
    assert torch.equal(chunk, want_chunk) and np.array_equal(action, want_action)
    assert bool(torch.isfinite(chunk).all())


def test_cli_converts_without_jax_lightning_or_omegaconf(ckpt, tmp_path):
    """The converter in a process where JAX, flax, optax, orbax, the JAX
    package, Lightning and omegaconf cannot be imported (at TINY sizes: the
    CLI's are the production ones); the run directory restores the same
    weights as the in-process conversion."""
    out = tmp_path / "run"
    code = ("from mdt_policy_tpu_torch.utils import from_reference\n"
            f"from_reference.convert_checkpoint({str(ckpt.path)!r}, {str(out)!r}, "
            f"agent_overrides={TINY!r})\n"
            "loaded = [m for m in sys.modules if m.partition('.')[0] in BLOCKED]\n"
            f"assert not loaded and {HPARAMS_MODULE!r} not in sys.modules, loaded\n")
    proc = run_blocked(code)
    assert proc.returncode == 0, proc.stderr
    net, _, _ = evaluate.load_run_agent(out, device="cpu")
    want = ckpt.jax[(True, True)].merged
    assert all(torch.equal(v, want[k].to(v.dtype)) for k, v in net.state_dict().items())
