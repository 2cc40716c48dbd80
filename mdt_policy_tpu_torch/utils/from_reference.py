"""Reference Lightning checkpoints -> a port run directory (port of
`mdt_policy_tpu/utils/torch_port.py`, `:456-586`): what a user calls to run
the paper's published `mdtv-*` weights.

    python -m mdt_policy_tpu_torch.utils.from_reference CKPT OUT [--raw]

writes `OUT/config.yaml` and `OUT/checkpoints/`, which
`python -m mdt_policy_tpu_torch.evaluate --train-folder OUT` evaluates and
`trainer.pretrain_checkpoint=OUT/checkpoints` warm-starts a run from.

* `load_reference_state_dict` reads the file with a restricted unpickler:
  the globals on torch's own `weights_only` allowlist resolve; any other
  (Lightning's `AttributeDict`, omegaconf's `DictConfig`, `pathlib` paths,
  numpy's scalars) becomes an inert stand-in that records its class's
  dotted name. No module named in the file is imported, so Lightning and
  omegaconf need not be installed and no pickled code runs. The EMA
  callback's weight list is zipped back onto the file's `state_dict` keys,
  in the file's order (buffers included).
* `reference_to_port` renames the reference agent's module prefixes
  (`REF_PREFIX`) to the port's, since the port's modules keep the
  reference `state_dict` layouts, and reads the keys the config's net
  has: the keys `port_mdtv_agent` (`torch_port.py:383-438`) reads at the
  config's depths. It reports the keys read, the keys ignored, the
  converted keys the config lacks (dropped, as `deep_merge` drops them)
  and the port keys the file lacks (they keep their init).
* `convert_checkpoint` loads the converted keys over a seeded init of
  `MDTVConfig(**agent_overrides)` and writes a run directory at step 0
  whose EMA is the converted weights.

Host-only by design, like `checkpoint.convert_run_dir`: it moves arrays
between files and does no device work. `evaluate.load_run_agent` restores
the run directory onto the card. The JAX side's `--scan` layout (the
stacked towers of `models/layer_stack.py`) has no counterpart: the port's
towers are not scanned.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import pickle
import types
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import yaml
from torch import _weights_only_unpickler

logger = logging.getLogger(__name__)

__all__ = ["REF_PREFIX", "ConversionReport", "Inert", "convert_checkpoint",
           "load_reference_state_dict", "main", "reference_to_port"]

StateDict = Dict[str, torch.Tensor]

# the reference agent's module prefixes (mdt/models/mdtv_agent.py:81-143) ->
# the port's; `logit_scale` is a whole key
REF_PREFIX = {
    "model.inner_model.": "inner.",
    "perceiver.": "perceiver.",
    "img_encoder.vcond.": "img_encoder.",
    "visual_goal.clip_model.visual.": "visual_goal.",
    "language_goal.clip_rn50.": "language_goal.",
    "gen_img.": "gen_img.",
    "clip_proj.": "clip_proj.",
    "logit_scale": "logit_scale",
}

# ---------------------------------------------------------------------------
# Reading a Lightning file without Lightning
# ---------------------------------------------------------------------------

class Inert(dict):
    """An object of a class the restricted unpickler does not resolve. It
    keeps what the file gives it and does nothing with it: constructor
    arguments (`args`), state (`state`), a dict subclass's items (its own)
    and a list subclass's (`listed`); `dotted` names the class."""

    dotted = ""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.args = args

    def __setstate__(self, state):
        self.state = state

    def append(self, item):
        self.__dict__.setdefault("listed", []).append(item)

    def extend(self, items):
        for item in items:
            self.append(item)

    def __repr__(self):
        return f"<inert {self.dotted}>"


_INERT: Dict[str, type] = {}


def _inert_class(dotted: str) -> type:
    if dotted not in _INERT:
        _INERT[dotted] = type(dotted.rpartition(".")[2] or "Inert", (Inert,),
                              {"dotted": dotted, "__module__": __name__})
    return _INERT[dotted]


class _RestrictedUnpickler(pickle.Unpickler):
    """Globals on torch's own `weights_only` allowlist resolve (its tensor
    rebuilds, dtypes, `OrderedDict`, `_codecs.encode`, ...); every other one
    becomes an inert stand-in. torch's `weights_only` load itself, even with
    such stand-ins allowlisted, refuses the file: it fills only exact
    `dict`s, `OrderedDict`s and `list`s, and Lightning's `AttributeDict` is a
    dict subclass."""

    def find_class(self, module, name):
        dotted = f"{module}.{name}"
        found = _weights_only_unpickler._get_allowed_globals().get(dotted)
        return found if found is not None else _inert_class(dotted)


def _restricted_pickle() -> types.ModuleType:
    """What `torch.load(pickle_module=...)` needs of a pickle module."""
    mod = types.ModuleType("restricted_pickle")
    mod.Unpickler = _RestrictedUnpickler
    mod.load = lambda f, **kw: _RestrictedUnpickler(f, **kw).load()
    return mod


def _tensor(key: str, value) -> torch.Tensor:
    if not torch.is_tensor(value):
        raise TypeError(f"{key}: the file holds {value!r}, not a tensor")
    return value.detach()


def load_reference_state_dict(ckpt_path, *, prefer_ema: bool = True) -> StateDict:
    """A reference Lightning checkpoint (or a bare state_dict file) -> a flat
    `{key: tensor}` on the CPU, in the file's key order and dtypes.

    The published `mdtv-*` checkpoints keep the EMA weights as a LIST in
    the EMA callback's state, built from `state_dict().values()` (ref
    mdt/callbacks/ema.py:96-99, buffers included); with `prefer_ema` and
    such a list, it is zipped back onto the `state_dict` keys in the file's
    order, as the JAX side's `load_reference_state_dict` does."""
    data = torch.load(ckpt_path, map_location="cpu", weights_only=False,
                      pickle_module=_restricted_pickle())
    if not isinstance(data, Mapping):
        raise TypeError(f"{ckpt_path}: the file holds {data!r}, not a checkpoint")
    sd = data["state_dict"] if "state_dict" in data else data
    if not isinstance(sd, Mapping) or isinstance(sd, Inert):
        raise TypeError(f"{ckpt_path}: state_dict is {sd!r}, not a mapping of tensors")
    ema = None
    try:
        ema = data["callbacks"]["EMA"]["ema_weights"]
    except (KeyError, TypeError):
        pass
    if prefer_ema and ema is not None:
        if not isinstance(ema, (list, tuple)):
            raise TypeError(f"{ckpt_path}: ema_weights is {ema!r}, not a list of tensors")
        sd = dict(zip(sd.keys(), ema))
    return {k: _tensor(k, v) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# The reference layout -> the port's keys
# ---------------------------------------------------------------------------

# LayerScale spellings of voltron's and timm's vintages -> the port's
_LAYER_SCALE = {f".{old}": f".ls{i}.gamma" for i in (1, 2)
                for old in (f"layer_scale{i}.gamma", f"lambda{i}")}
# the head the reference always stores and the port builds only with `use_proprio`
_PROPRIO_HEAD = "inner.proprio_emb."
# networks a file may lack: they keep their init
_OPTIONAL = ("clip_proj.", "img_encoder.")


def _port_key(key: str) -> Optional[str]:
    """The port's key of a reference key, or None outside `REF_PREFIX`."""
    for ref, port in REF_PREFIX.items():
        if key.startswith(ref) and (ref.endswith(".") or key == ref):
            new = port + key[len(ref):]
            for old, ls in _LAYER_SCALE.items():
                if new.endswith(old):
                    return new[:-len(old)] + ls
            return new
    return None


@dataclasses.dataclass
class ConversionReport:
    """What `reference_to_port` did with a file's keys."""
    read: List[str]      # reference keys converted
    ignored: List[str]   # reference keys not read (other towers, buffers, ...)
    dropped: List[str]   # converted port keys the target config lacks
    missing: List[str]   # port keys of the target the file does not give: they keep their init

    def counts(self) -> Dict[str, int]:
        return {f.name: len(getattr(self, f.name)) for f in dataclasses.fields(self)}


def reference_to_port(sd: Mapping[str, torch.Tensor], cfg,
                      target: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> Tuple[StateDict, ConversionReport]:
    """A reference MDT-V agent's flat state_dict -> (the port's float32
    state_dict over the keys of `target`, the report). `target` is the
    `state_dict()` of `cfg`'s net (default: one built on the CPU).

    Each key is renamed through `REF_PREFIX` (and the LayerScale
    spellings) and read where `target` has it, so the depths read are the
    config's; `proprio_emb`, which the reference always stores, is read and
    dropped where the config has no proprio head, as the JAX side's
    `deep_merge` drops it. Every network but `clip_proj` and the Voltron
    backbone must be in the file, whole: a key it lacks raises KeyError
    naming the reference key, a shape other than the target's ValueError.
    A `clip_proj` the file holds must be whole too; a Voltron backbone
    that does not map logs a warning and keeps its init; either network
    absent from the file keeps its init."""
    if target is None:
        from ..agents import make_agent_net
        target = make_agent_net(cfg, device="cpu").state_dict()
    port_of: Dict[str, str] = {}  # port key -> reference key, in the file's order
    for key in sd:
        port = _port_key(key)
        if port is not None and (port in target or port.startswith(_PROPRIO_HEAD)):
            port_of.setdefault(port, key)

    def take(ref: str, port: str) -> StateDict:
        out = {}
        for k in target:
            if k.startswith(port):
                if k not in port_of:
                    raise KeyError(ref + k[len(port):])
                v = sd[port_of[k]].reshape(target[k].shape) if k == "logit_scale" \
                    else sd[port_of[k]]
                if v.shape != target[k].shape:
                    raise ValueError(f"{port_of[k]}: the file's shape {tuple(v.shape)} is "
                                     f"not the config's {tuple(target[k].shape)}")
                out[k] = v.to(torch.float32)
        return out

    ported: StateDict = {}
    for ref, port in REF_PREFIX.items():
        if port in _OPTIONAL and not any(k.startswith(ref) for k in sd):
            continue
        try:
            ported.update(take(ref, port))
        except (KeyError, ValueError) as e:
            if port != "img_encoder.":
                raise
            logger.warning("voltron backbone port failed (%s); leaving random-init", e)
    dropped = [k for k in port_of if k not in target]
    if dropped:
        logger.info("checkpoint keys absent from the target config, dropped: %s", dropped)
    read = {port_of[k] for k in [*ported, *dropped]}
    return ported, ConversionReport(
        read=[k for k in sd if k in read], ignored=[k for k in sd if k not in read],
        dropped=dropped, missing=[k for k in target if k not in ported])


# ---------------------------------------------------------------------------
# The run directory and the CLI
# ---------------------------------------------------------------------------

def convert_checkpoint(ckpt_path, out_dir, *, prefer_ema: bool = True,
                       agent_overrides: Optional[Mapping] = None) -> ConversionReport:
    """A reference MDT-V `.ckpt` -> a ready-to-evaluate run directory:
    `out_dir/checkpoints/` (the port's `Checkpointer` format, step 0, the
    EMA of the trainables equal to the converted weights) and
    `out_dir/config.yaml` (the port's `RunConfig`, `agent: mdtv` and the
    `agent_overrides` that size `MDTVConfig`: production sizes by default).
    The converted keys load over a seeded init of the net, so keys the file
    lacks keep that init; the frozen towers take the file's float32 through
    a cast on copy. Returns the conversion's report."""
    from ..agents import MDTVConfig, init_random_, init_train_state, make_agent_net
    from ..training import RunConfig
    from .checkpoint import Checkpointer

    overrides = dict(agent_overrides or {})
    cfg = MDTVConfig(**overrides)
    sd = load_reference_state_dict(ckpt_path, prefer_ema=prefer_ema)
    net = init_random_(make_agent_net(cfg, device="cpu"), torch.Generator().manual_seed(0))
    ported, report = reference_to_port(sd, cfg, net.state_dict())
    del sd
    net.load_state_dict(ported, strict=False)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    run_cfg = RunConfig(agent="mdtv", run_name=out.name, log_dir=str(out.parent),
                        agent_overrides=overrides)
    (out / "config.yaml").write_text(yaml.safe_dump(dataclasses.asdict(run_cfg)))
    Checkpointer(out / "checkpoints").save(init_train_state(net), wait=True)
    logger.info("converted %s into %s: %s", ckpt_path, out, report.counts())
    return report


def main(argv=None) -> ConversionReport:
    ap = argparse.ArgumentParser(
        description="Convert a reference MDT-V Lightning checkpoint (the published "
                    "mdtv-* weights) into a run directory of the port, for "
                    "`evaluate --train-folder OUT` or `trainer.pretrain_checkpoint="
                    "OUT/checkpoints`. The JAX converter's --scan layout has no "
                    "counterpart: the port's towers are not scanned.")
    ap.add_argument("ckpt", help="reference .ckpt path")
    ap.add_argument("out", help="output run directory")
    ap.add_argument("--raw", action="store_true", help="use raw weights instead of EMA")
    args = ap.parse_args(argv)
    return convert_checkpoint(args.ckpt, args.out, prefer_ema=not args.raw)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
