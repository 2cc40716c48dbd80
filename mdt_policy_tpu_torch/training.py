"""Training entry point of the port (port of `mdt_policy_tpu/training.py`):

    python -m mdt_policy_tpu_torch.training --config conf.yaml \
        data.root_data_dir=/data/task_D_D trainer.max_epochs=20 [--device cpu]

The run config (the dataclasses, `load_config`: YAML plus dotted key=value
overrides, `_make_agent`) is copied, so that a `config.yaml` written by
either package loads in the other unchanged. `train(cfg, device=None)` is
the JAX loop (default device CUDA): a dual-stream CALVIN loader (or
synthetic batches when `data.root_data_dir` is None) feeding a side-stream
prefetcher, `train_step` and `validation_step` of either family, the EMA,
per-epoch checkpoints with auto-resume, `metrics.csv`, a recon grid a
validation, the training-time rollouts (`rollout`: CALVIN's chains, whose
`eval_lh/avg_seq_len` picks `best.json`; `task_rollout`: per-task success),
the divergence guard and a `torch.profiler` window. It runs float32 matmuls
and convolutions in full float32, not TF32 (`utils.misc.full_f32`), and
cuDNN's deterministic algorithms, and records the flags in
`system_info.json`.

Data parallel, one process a device, over NCCL (gloo on the CPU;
`parallel/`):

    torchrun --nproc-per-node=N -m mdt_policy_tpu_torch.training ...
    python -m mdt_policy_tpu_torch.training trainer.devices=N ...

Under torchrun (or `distributed.enabled` with its address, world size and
rank) `trainer.batch_size` is each process's batch, as it is each host's in
JAX; `trainer.devices=N` starts N processes on this node and splits
`trainer.batch_size`, the global batch, over them, as the JAX loop splits it
over N devices. Rank 0 alone writes the run directory.
`trainer.aot_step_cache` is the TPU's compile cache and changes nothing
here. The dotted factory paths of `task_rollout` (`env_target`,
`oracle_target`) name the JAX package by default (the snapshot is shared);
`_resolve_target` maps them onto the port.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import parallel

logger = logging.getLogger(__name__)

__all__ = ["CACHE_MODE_AGENT_DEFAULTS", "DataConfig", "DistributedConfig", "RolloutConfig",
           "RunConfig", "TaskRolloutConfig", "TrainerConfig", "TrainingDivergedError",
           "cache_mode_config", "ema_weights",
           "load_config", "main", "stream_generator", "stream_seed", "train"]


@dataclasses.dataclass
class DataConfig:
    root_data_dir: Optional[str] = None   # CALVIN split root (training/ + validation/)
    lang_folder: str = "lang_clip_resnet50"
    min_window_size: int = 21
    max_window_size: int = 50
    obs_seq_len: int = 1
    action_seq_len: int = 10
    img_gen_frame_diff: int = 3
    window_sampling_strategy: str = "geometric"
    use_extracted_rel_actions: bool = True
    use_extracted_frames: bool = True   # contiguous-image fast path if present
    # train from OFFLINE frozen-tower embeddings (data/extract_embeddings.py
    # must have been run on both splits): batches carry voltron_tokens +
    # image_latent_goal instead of camera frames and the train step never
    # executes the camera towers (~60 of ~75 TFLOP/step). mdtv only. The
    # cache is tied to the tower weights it was extracted with — warm-start
    # the run (trainer.pretrain_checkpoint) from the same towers so training-
    # time rollouts/conversions stay coherent.
    use_extracted_embeddings: bool = False
    # >0: cache-mode training samples one of K cached DrQ-shift-augmented
    # embedding variants per draw (extract_embeddings --aug-variants K must
    # have produced them) — restores the reference's RandomShiftsAug to the
    # fast path; 0 trains on clean eval-pipeline embeddings (no aug).
    # Validation always uses the clean arrays.
    embedding_aug_variants: int = 0
    num_workers: Optional[int] = None   # decode threads (None = min(8, cpus))
    proprio: bool = False               # 8-d state_obs via statistics.yaml
    # depth observation keys loaded from the episode files (e.g.
    # ['depth_static', 'depth_gripper']); train-time noise per the production
    # transform pipeline (gamma on depth_static, gaussian on both —
    # calvin_transforms.yaml, ref episode_utils.py:97-125)
    depth_keys: list = dataclasses.field(default_factory=list)
    # synthetic-data shapes (smoke mode)
    synthetic_static_hw: int = 200
    synthetic_gripper_hw: int = 84


@dataclasses.dataclass
class TrainerConfig:
    batch_size: int = 128          # per modality stream (conf/config.yaml:27)
    max_epochs: int = 20
    steps_per_epoch: int = 1000    # limit_train_batches (conf/config.yaml:50)
    limit_val_batches: int = 4     # (conf/config.yaml:51)
    seed: int = 242
    log_every: int = 50
    keep_checkpoints: int = 1
    # data-parallel devices on this node: N > 1 starts N processes, one a
    # device, and splits batch_size over them (ignored under torchrun or
    # distributed.enabled, where batch_size is each process's)
    devices: Optional[int] = None
    # "START:STOP" step range traced with torch.profiler into
    # <run_dir>/profile (trace.json for Perfetto, summary.json with the
    # device's busy share); None disables
    profile_steps: Optional[str] = None
    # warm-start: a port checkpoint (a step dir or a run's checkpoints/
    # dir) whose params partially initialize a FRESH run — every tensor with
    # a matching name+shape is copied, the rest keep their random init (the
    # reference's pretrain_chk + load_state_dict(strict=False),
    # mdt/training.py:53-54, utils.py:32-42). Ignored when auto-resuming.
    pretrain_checkpoint: Optional[str] = None
    # divergence guard: raise TrainingDivergedError when the logged loss
    # goes non-finite (checked at log points only — no extra host syncs).
    # The poisoned state is never checkpointed; auto-resume restores the
    # last good save.
    halt_on_nonfinite: bool = True
    # save a masked-foresight reconstruction grid per validation epoch under
    # <run_dir>/media (+ wandb.Image when active) — the reference's store_img
    # validation branch (mdt/models/mdt_agent.py:398-417)
    log_recon_images: bool = True
    # the JAX package's serialized-executable cache of its compiled step
    # (a TPU compile-service workaround); read as data, no effect here
    aot_step_cache: Optional[str] = None


@dataclasses.dataclass
class RolloutConfig:
    """Training-time closed-loop CALVIN rollouts (the RolloutLongHorizon
    callback, conf/callbacks/rollout_lh/default.yaml)."""
    enabled: bool = False
    num_sequences: int = 1000
    ep_len: int = 360
    rollout_freq: int = 5          # epochs between rollouts
    skip_epochs: int = 19          # conf/config.yaml rollout_lh_skip_epochs
    val_dataset_path: Optional[str] = None   # calvin_env scene source


@dataclasses.dataclass
class TaskRolloutConfig:
    """Validation-time single-task rollouts — the reference's `Rollout`
    callback (mdt/rollout/rollout.py:58-118, conf/callbacks/rollout/
    default.yaml): discover solvable (start_state, task) demos from
    validation batches via the oracle, persist the task dictionary beside
    the run (the reference stores it in the Lightning ckpt,
    rollout.py:404-415), then roll the policy out per task and log
    `tasks/{task}_sr`."""
    enabled: bool = False
    skip_epochs: int = 10          # ref default.yaml:7
    rollout_freq: int = 5          # ref default.yaml:8
    rollouts_per_task: int = 10    # ref num_rollouts_per_task
    ep_len: int = 120              # ref default.yaml:13
    id_selection_strategy: str = "select_longest"  # ref default.yaml:21
    # dual goal modalities like the reference (lang sentence + demo end
    # frame as goal image, rollout.py:324-330)
    modalities: list = dataclasses.field(default_factory=lambda: ["vis", "lang"])
    discovery_batches: int = 4     # val batches scanned for solvable demos
    val_dataset_path: Optional[str] = None   # calvin_env scene source
    # dotted-path factories (the hydra `_target_` equivalent,
    # conf/callbacks/rollout/default.yaml env_cfg/tasks); tests point these
    # at the FakeEnv harness
    env_target: str = "mdt_policy_tpu.evaluation.env_adapter.make_calvin_env"
    oracle_target: str = "mdt_policy_tpu.evaluation.annotations.make_task_oracle"


@dataclasses.dataclass
class DistributedConfig:
    """Multi-process data parallelism, one process a device (JAX: one
    process a host over a mesh spanning hosts). trainer.batch_size is PER
    PROCESS: the loader shards the dataset per rank and the gradients and
    the contrastive loss's features are exchanged over NCCL
    (`parallel.init_distributed`)."""
    enabled: bool = False
    coordinator_address: Optional[str] = None  # host:port; None = torchrun's
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


@dataclasses.dataclass
class RunConfig:
    agent: str = "mdtv"            # 'mdtv' | 'mdt'
    log_dir: str = "runs"
    run_name: Optional[str] = None
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    rollout: RolloutConfig = dataclasses.field(default_factory=RolloutConfig)
    task_rollout: TaskRolloutConfig = dataclasses.field(
        default_factory=TaskRolloutConfig)
    distributed: DistributedConfig = dataclasses.field(
        default_factory=DistributedConfig)
    agent_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)


def load_config(path: Optional[str], overrides) -> RunConfig:
    """YAML + dotted key=value overrides (the Hydra-style CLI surface)."""
    import yaml

    raw: Dict[str, Any] = {}
    if path:
        raw = yaml.safe_load(Path(path).read_text()) or {}
    for ov in overrides:
        key, _, val = ov.partition("=")
        node = raw
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        parsed = yaml.safe_load(val)
        if isinstance(parsed, int) and ":" in val:
            # YAML 1.1 reads "1:2" as sexagesimal 62 — keep range strings
            # (e.g. trainer.profile_steps=50:60) verbatim
            parsed = val
        node[parts[-1]] = parsed

    cfg = RunConfig()
    for section, cls in (("data", DataConfig), ("trainer", TrainerConfig),
                         ("rollout", RolloutConfig),
                         ("task_rollout", TaskRolloutConfig),
                         ("distributed", DistributedConfig)):
        if section in raw:
            setattr(cfg, section, cls(**{**dataclasses.asdict(getattr(cfg, section)),
                                         **raw[section]}))
    cfg.agent = raw.get("agent", cfg.agent)
    cfg.log_dir = raw.get("log_dir", cfg.log_dir)
    cfg.run_name = raw.get("run_name", cfg.run_name)
    cfg.agent_overrides = raw.get("agent_overrides", {})
    return cfg


def _make_agent(cfg: RunConfig):
    """The agent config the run names: the port's `MDTVConfig` or
    `MDTConfig` with the snapshot's overrides, retired keys dropped."""
    from .agents import MDTConfig, MDTVConfig
    from .agents.config import filter_retired_overrides
    overrides = filter_retired_overrides(cfg.agent_overrides)
    if cfg.agent == "mdtv":
        return MDTVConfig(**overrides)
    if cfg.agent == "mdt":
        return MDTConfig(**overrides)
    raise ValueError(f"unknown agent {cfg.agent!r}")


# Agent-config fields whose default differs in embedding-cache mode
# (`data.use_extracted_embeddings`), as the JAX package keeps them: empty
# since both of its former members became `MDTVConfig` defaults.
CACHE_MODE_AGENT_DEFAULTS: Dict[str, Any] = {}


def cache_mode_config(**overrides):
    """The `MDTVConfig` a cache-mode run has with these `agent_overrides`
    (JAX training.py:243-248); an explicit override wins."""
    from .agents import MDTVConfig
    return MDTVConfig(**{**CACHE_MODE_AGENT_DEFAULTS, **overrides})


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------

class TrainingDivergedError(RuntimeError):
    """Loss went NaN/inf; the run halted without checkpointing the
    poisoned state."""


# the random streams of a run (see `stream_seed`)
STREAMS = {"init": 0, "aug": 1, "step": 2, "val": 3, "recon": 4, "rollout": 5,
           "task_rollout": 6}


def stream_seed(seed: int, stream: str, index: int) -> int:
    """The seed of one generator of a run: a fixed pure function of
    (`trainer.seed`, stream, index), the 63 high bits of
    `numpy.random.SeedSequence([seed, STREAMS[stream], index])`'s first
    64-bit word. `seed` and `index` must be non-negative."""
    word = np.random.SeedSequence([seed, STREAMS[stream], index]).generate_state(1, np.uint64)[0]
    return int(word) >> 1


def stream_generator(seed: int, stream: str, index: int, device) -> torch.Generator:
    """A fresh `torch.Generator` on `device` seeded with `stream_seed`."""
    return torch.Generator(device).manual_seed(stream_seed(seed, stream, index))


def _synthetic_batch(rng: np.random.Generator, B: int, data_cfg: DataConfig,
                     agent_cfg):
    hs, hg = data_cfg.synthetic_static_hw, data_cfg.synthetic_gripper_hw
    ctx, vocab = agent_cfg.clip_context_length, agent_cfg.clip_vocab_size
    def scope():
        return {
            "rgb_static": rng.integers(0, 255, (B, 2, hs, hs, 3)).astype(np.uint8),
            "rgb_gripper": rng.integers(0, 255, (B, 2, hg, hg, 3)).astype(np.uint8),
            "gen_static": rng.integers(0, 255, (B, hs, hs, 3)).astype(np.uint8),
            "gen_gripper": rng.integers(0, 255, (B, hg, hg, 3)).astype(np.uint8),
            "actions": rng.normal(size=(B, 10, 7)).astype(np.float32),
            "lang_tokens": rng.integers(1, vocab, (B, ctx)).astype(np.int32),
        }
    return {"vis": scope(), "lang": scope()}


def _real_loaders(cfg: RunConfig, split: str = "training", context_length: int = 77,
                  vocab_size: Optional[int] = None, start_batch: int = 0,
                  include_scene_obs: bool = False, batch_size: Optional[int] = None,
                  sharded: bool = True):
    """The {'vis', 'lang'} loaders of a split (JAX `_real_loaders`,
    training.py:267-314) at `batch_size` (default `trainer.batch_size`):
    this rank's shard of the data when `sharded`, else the whole."""
    from .data.dataset import CalvinDataset
    from .data.loader import BatchLoader, DualStreamLoader
    from .utils.clip_tokenizer import tokenize as _tokenize

    def tokenize(texts, n):
        ids = _tokenize(texts, n)
        # an out-of-range id would index past the embedding table: fail
        # loudly at the host seam instead
        if vocab_size is not None and ids.max() >= vocab_size:
            raise ValueError(
                f"tokenized id {int(ids.max())} >= agent clip_vocab_size "
                f"{vocab_size}; the agent's text tower is too small for real "
                "CLIP-BPE text")
        return ids

    root = Path(cfg.data.root_data_dir) / split
    kw = dict(lang_folder=cfg.data.lang_folder,
              obs_seq_len=cfg.data.obs_seq_len,
              action_seq_len=cfg.data.action_seq_len,
              min_window_size=cfg.data.min_window_size,
              max_window_size=cfg.data.max_window_size,
              img_gen_frame_diff=cfg.data.img_gen_frame_diff,
              window_sampling_strategy=cfg.data.window_sampling_strategy,
              use_extracted_rel_actions=cfg.data.use_extracted_rel_actions,
              use_extracted_frames=cfg.data.use_extracted_frames,
              use_extracted_embeddings=cfg.data.use_extracted_embeddings,
              # validation keeps clean embeddings (CalvinDataset also guards
              # on its own `validation` flag; this keeps the intent explicit)
              embedding_aug_variants=(cfg.data.embedding_aug_variants
                                      if split == "training" else 0),
              proprio=cfg.data.proprio,
              depth_keys=tuple(cfg.data.depth_keys),
              include_scene_obs=include_scene_obs,
              seed=cfg.trainer.seed)
    batch_size = cfg.trainer.batch_size if batch_size is None else batch_size
    shard = dict(shard_index=parallel.rank() if sharded else 0,
                 num_shards=parallel.world_size() if sharded else 1,
                 num_workers=cfg.data.num_workers, start_batch=start_batch)
    vis = BatchLoader(CalvinDataset(root, key="vis", **kw), batch_size,
                      seed=cfg.trainer.seed, **shard)
    lang = BatchLoader(CalvinDataset(root, key="lang", **kw), batch_size,
                       seed=cfg.trainer.seed + 1, tokenizer=tokenize,
                       context_length=context_length, **shard)
    return DualStreamLoader(vis, lang)


def _load_pretrain_params(path: str) -> Dict[str, torch.Tensor]:
    """The net's `state_dict` of a port checkpoint, on the host: `path` is a
    step dir or a run's checkpoints/ dir (newest step used)."""
    from .utils.checkpoint import STATE_FILE, latest_checkpoint

    p = Path(path)
    if not (p / STATE_FILE).exists():
        newest = latest_checkpoint(p)
        if newest is None:
            raise FileNotFoundError(f"no checkpoint under {p}")
        p = newest
    tree = torch.load(p / STATE_FILE, map_location="cpu", weights_only=True)
    if "params" not in tree:
        raise ValueError(f"checkpoint {p} has no 'params'")
    return tree["params"]


def _write_system_info(run_dir: Path, device: torch.device) -> None:
    """Software/hardware snapshot into <run_dir>/system_info.json (the
    reference's startup system-info dump, mdt/training.py:58): Python, torch,
    CUDA, the training device, the cards' names and count, the number of
    training processes and the two TF32 flags."""
    import platform
    import socket

    from .utils.misc import print_system_env_info
    info = {**print_system_env_info(), "hostname": socket.gethostname(),
            "training_device": str(device), "platform": platform.platform(),
            "process_count": parallel.world_size()}
    (run_dir / "system_info.json").write_text(json.dumps(info, indent=2))


@contextlib.contextmanager
def ema_weights(state):
    """The net's trainables swapped for the EMA tensors inside the block (the
    JAX loop passes `state.ema_params` to validation); the live tensors are
    swapped back, the same objects, bit for bit, on leaving it. Nothing
    may step the optimizer inside."""
    swapped = []
    try:
        for name, p in state.net.trainable_parameters():
            swapped.append((p, p.data))
            p.data = state.ema[name]
        yield
    finally:
        for p, live in swapped:
            p.data = live


def _log_recon_images(agent_cfg, net, vbatch, run_dir: Path, mlog, step: int,
                      generator: torch.Generator) -> None:
    """One masked-foresight reconstruction grid (first validation batch, lang
    scope) under <run_dir>/media (JAX `_log_recon_images`,
    training.py:754-785), from the weights the caller has swapped in.
    Best-effort: a missing PIL or a batch without foresight frames logs a
    warning and the run goes on."""
    try:
        from .agents.mdtv_agent import reconstruction_forward
        from .models.masked_decoder import reconstruct_images
        scope = "lang" if "lang" in vbatch else sorted(vbatch)[0]
        b = vbatch[scope]
        if "gen_static" not in b:
            return
        n_patches = (agent_cfg.gen_img_res // agent_cfg.gen_patch_size) ** 2
        mask_noise = torch.rand((b["actions"].shape[0], n_patches), generator=generator,
                                device=generator.device)
        goal_imgs, recon, mask = reconstruction_forward(net, b, mask_noise)
        media = run_dir / "media"
        media.mkdir(parents=True, exist_ok=True)
        path = media / f"img_gen_pred_step{step}.png"
        reconstruct_images(net.gen_img, recon, goal_imgs, mask, file_path=path)
        mlog.log_image("generated_img", path, step)
    except Exception as e:  # a broken grid must not kill the run
        logger.warning("recon image logging skipped: %s", e)


class _NullLogger:
    """The metrics sink of a rank other than the lead."""

    def log(self, metrics, step):
        pass

    def log_image(self, name, file_path, step):
        pass

    def finish(self):
        pass


def train(cfg: RunConfig, device=None):
    """Train per `cfg` on `device` (default CUDA; raises without one unless
    the CPU is named) and return the final `TrainState`. The runtime
    guarantees of the JAX loop (training.py:370-720):

    * Signals: SIGTERM/SIGINT handlers are installed first; the first signal
      finishes the step, saves with `wait=True` and returns; a second falls
      through to the previous handler. They are restored on return.
    * The run directory `<log_dir>/<run_name>` gets `config.yaml` (which
      both packages' `load_config` read back unchanged), `system_info.json`
      and `metrics.csv`; checkpoints go under `checkpoints/` every epoch
      (none with `keep_checkpoints=0`), and the run resumes from the newest
      one: the training loader fast-forwards to batch `step`, the validation
      loader past the batches the run had already consumed.
    * Random numbers: each draw comes from a generator of its own, seeded by
      `stream_seed(trainer.seed, stream, index)`, never one carried across
      steps: "init" 0 (the random weights, on the host), "aug" i (the train
      pipeline's shifts and noise of the i-th training batch, every scope
      in sorted order), "step" s (the draws of step s), "val" s *
      limit_val_batches + v (validation batch v after step s: its
      preprocessing, then its step's draws), "recon" s (the recon grid's
      mask), "rollout" e and "task_rollout" e (the rollouts' policies after
      epoch e, so a run with rollouts trains exactly as one without). The
      data's numpy RNG is `trainer.seed + rank`. So a resumed run draws what
      an uninterrupted one draws.
    * At each epoch's end, on the EMA weights (`ema_weights`): the chain
      rollout (`rollout`: shards of CALVIN's chains on every rank, the
      results gathered; its `eval_lh/avg_seq_len` goes to `best.json`
      through the epoch's save), the single-task rollouts (`task_rollout`),
      validation and the recon grid. A rollout's policy is made fresh for
      the epoch and its CUDA graphs released before the live weights come
      back. A missing env or oracle is a warning and no rollout.
    * Metrics reach the host only every `log_every` steps; there a
      non-finite loss raises `TrainingDivergedError` (`halt_on_nonfinite`),
      before any save of that state. `profile_steps` "START:STOP" traces
      those steps with torch.profiler into `<run_dir>/profile`.
    * Synthetic batches when `data.root_data_dir` is None; a warm start from
      `trainer.pretrain_checkpoint` on a fresh run; cache mode
      (`data.use_extracted_embeddings`) for the `mdtv` agent only.
    * Data parallel (`parallel`), when a process group is up, or
      `distributed.enabled` or torchrun's variables ask for one (this call
      joins it and leaves it at its end): each rank loads its shard of the
      data at `trainer.batch_size`, rank 0's weights are broadcast, the
      step averages the gradients over the ranks, the metrics are averaged
      at log points, and rank 0 alone writes the run directory (a barrier
      after each save); every rank restores the same checkpoint.
      `trainer.devices=N` (N > 1) instead starts N processes on this node,
      one a device, each with `trainer.batch_size / N` rows, and returns
      None once they have ended: the state is in the run's checkpoints.
      Fewer devices than N, or a batch that does not split, raise.
    """
    env = os.environ
    torchrun = "RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env
    joins = cfg.distributed.enabled or torchrun
    n = cfg.trainer.devices or 1
    if n > 1 and not joins and not parallel.is_initialized():
        _launch_local(cfg, device, n)
        return None
    return _run(cfg, device, cfg.distributed if joins else None, cfg.trainer.batch_size)


def _run(cfg: RunConfig, device, dist_cfg: Optional[DistributedConfig], rank_batch: int):
    """`_train` with the signal handlers of `train` around it."""
    import signal
    stop_requested = threading.Event()
    prev_handlers = {}

    def _on_signal(signum, frame):
        logger.warning("signal %d: checkpointing after the current step", signum)
        stop_requested.set()
        signal.signal(signum, prev_handlers.get(signum, signal.SIG_DFL))

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:  # not the main thread (in-process tests)
            break
    try:
        return _train(cfg, device, stop_requested, dist_cfg, rank_batch)
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)


def _launch_local(cfg: RunConfig, device, n: int) -> None:
    """`trainer.devices=n`: n ranks on this node (`torch.multiprocessing`,
    spawned), rendezvous on a free localhost port, each on its device
    (`cuda:{rank}`; every rank on the CPU when the CPU is named) with
    `batch_size / n` rows. Returns when all have ended; raises if one
    failed. A SIGTERM to this process is passed on to the ranks (Ctrl-C
    reaches them from the terminal)."""
    import signal

    import torch.multiprocessing as mp
    from .agents.mdtv_agent import default_device
    device = default_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(f"trainer.devices={n} but only {torch.cuda.device_count()} "
                         "CUDA devices present")
    if cfg.trainer.batch_size % n:
        raise ValueError(f"batch_size {cfg.trainer.batch_size} not divisible by "
                         f"trainer.devices={n}")
    ctx = mp.start_processes(_local_rank, args=(cfg, device.type, n, parallel.free_port()),
                             nprocs=n, join=False, start_method="spawn")

    def forward(signum, frame):
        for proc in ctx.processes:
            if proc.is_alive():
                os.kill(proc.pid, signum)

    handlers = {}
    try:
        handlers[signal.SIGTERM] = signal.signal(signal.SIGTERM, forward)
        handlers[signal.SIGINT] = signal.signal(signal.SIGINT, signal.SIG_IGN)
    except ValueError:  # not the main thread
        pass
    try:
        while not ctx.join():
            pass
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)


def _local_rank(index: int, cfg: RunConfig, device_type: str, world: int, port: int):
    """One rank of `_launch_local`, in its own process."""
    os.environ["LOCAL_RANK"] = str(index)
    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s rank {index} %(levelname)s %(name)s: %(message)s")
    dist_cfg = DistributedConfig(enabled=True, coordinator_address=f"localhost:{port}",
                                 num_processes=world, process_id=index)
    _run(cfg, device_type, dist_cfg, cfg.trainer.batch_size // world)


def _train(cfg: RunConfig, device, stop_requested: threading.Event,
           dist_cfg: Optional[DistributedConfig], rank_batch: int):
    from .agents.mdtv_agent import default_device

    if cfg.data.use_extracted_embeddings and cfg.agent != "mdtv":
        raise ValueError(
            "data.use_extracted_embeddings requires agent=mdtv: only its "
            "camera towers are frozen constants whose outputs can be cached "
            "(the mdt agent TRAINS its ResNet encoders)")
    if dist_cfg is not None and not parallel.is_initialized():
        device = parallel.init_distributed(dist_cfg, device)
        try:
            return _train_ranks(cfg, device, stop_requested, rank_batch)
        finally:
            parallel.shutdown()
    return _train_ranks(cfg, default_device(device), stop_requested, rank_batch)


def _train_ranks(cfg: RunConfig, device: torch.device, stop_requested: threading.Event,
                 rank_batch: int):
    """The loop of `train`, on this rank's `device`, `rank_batch` rows a
    stream."""
    from . import agents
    from .agents import init_random_, init_train_state, make_agent_net
    from .data.loader import DevicePrefetcher, Preprocessor
    from .utils.checkpoint import Checkpointer, latest_checkpoint
    from .utils.logging_utils import MetricsLogger
    from .utils.misc import full_f32, initialize_pretrained_weights
    from .utils.profiling import trace

    full_f32()
    # deterministic convolution algorithms: free to choose, cuDNN made an
    # MDT run and its resumption differ in the ResNets' gradients' last
    # bits on the card, which AdamW turns into different updates
    torch.backends.cudnn.deterministic = True
    if cfg.trainer.aot_step_cache:
        logger.info("trainer.aot_step_cache=%r has no effect: that cache holds the JAX "
                    "package's compiled TPU step", cfg.trainer.aot_step_cache)
    world, lead = parallel.world_size(), parallel.is_lead()

    import yaml
    run_name = cfg.run_name or time.strftime("%Y-%m-%d_%H-%M-%S")
    run_dir = Path(cfg.log_dir) / run_name
    if lead:
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "config.yaml").write_text(yaml.safe_dump(dataclasses.asdict(cfg)))
        _write_system_info(run_dir, device)
    logger.info("run dir: %s | device %s | rank %d of %d", run_dir, device,
                parallel.rank(), world)

    agent_cfg = _make_agent(cfg)
    seed, tcfg = cfg.trainer.seed, cfg.trainer
    np_rng = np.random.default_rng(seed + parallel.rank())

    # the resume point comes before the loaders: the data stream
    # fast-forwards to exactly the batch the preempted run would see next
    checkpointing = tcfg.keep_checkpoints > 0
    resume_step, resuming = 0, False
    if checkpointing:
        last = latest_checkpoint(run_dir / "checkpoints")
        if last is not None:
            resume_step, resuming = int(last.name), True

    pp = Preprocessor(static_size=agent_cfg.img_size,
                      gripper_size=min(84, agent_cfg.img_size),
                      gen_size=agent_cfg.gen_img_res, device=device)

    def device_batch(generator, raw):
        return {scope: pp.train_batch(raw[scope], generator=generator)
                for scope in sorted(raw)}

    with contextlib.ExitStack() as stack:
        mlog = MetricsLogger(run_dir, config=dataclasses.asdict(cfg)) if lead \
            else _NullLogger()
        stack.callback(mlog.finish)
        val_iter = None
        if cfg.data.root_data_dir is None:
            logger.warning("no root_data_dir configured: SYNTHETIC data mode")
            raw_iter = itertools.repeat(_synthetic_batch(np_rng, rank_batch, cfg.data,
                                                         agent_cfg))
        else:
            loader = _real_loaders(cfg, "training", agent_cfg.clip_context_length,
                                   agent_cfg.clip_vocab_size, start_batch=resume_step,
                                   batch_size=rank_batch)
            stack.callback(loader.close)
            raw_iter = iter(loader)
            if (Path(cfg.data.root_data_dir) / "validation").exists():
                # by step s the run has consumed limit_val_batches per epoch
                val_consumed = resume_step // tcfg.steps_per_epoch * tcfg.limit_val_batches
                val_loader = _real_loaders(cfg, "validation", agent_cfg.clip_context_length,
                                           agent_cfg.clip_vocab_size,
                                           start_batch=val_consumed, batch_size=rank_batch)
                stack.callback(val_loader.close)
                val_iter = iter(val_loader)

        net = make_agent_net(agent_cfg, device=device)
        init_random_(net, stream_generator(seed, "init", 0, "cpu"))
        if tcfg.pretrain_checkpoint and not resuming:
            pre = _load_pretrain_params(tcfg.pretrain_checkpoint)
            net.load_state_dict(initialize_pretrained_weights(net.state_dict(), pre))
            logger.info("warm-started from %s", tcfg.pretrain_checkpoint)
        state = init_train_state(net)  # the EMA starts at the (warm-started) weights
        parallel.broadcast_trainables(net, state.ema)
        ckpt = None
        if checkpointing and (lead or resuming):
            ckpt = Checkpointer(run_dir / "checkpoints", keep=tcfg.keep_checkpoints)
            stack.callback(ckpt.wait)  # settle an in-flight save before returning
        if resuming:  # a step-0 checkpoint counts too
            ckpt.restore(state)
            logger.info("auto-resumed from step %d", state.step)

        def save(**kw):
            """The lead saves; every rank waits for it at a barrier."""
            if lead and checkpointing:
                ckpt.save(state, **kw)
            parallel.barrier()

        prefetcher = DevicePrefetcher(
            raw_iter, lambda i, raw: device_batch(stream_generator(seed, "aug", i, device), raw),
            device=device, depth=2, start_index=resume_step)
        stack.callback(prefetcher.close)

        profile_range, profiling = None, False
        profiler = stack.enter_context(contextlib.ExitStack())
        if tcfg.profile_steps and lead:
            lo, _, hi = str(tcfg.profile_steps).partition(":")
            if not hi:
                raise ValueError(f"trainer.profile_steps={tcfg.profile_steps!r}"
                                 " must be 'START:STOP' (quote it in YAML)")
            profile_range = (int(lo), int(hi))
            if profile_range[1] <= profile_range[0]:
                raise ValueError(f"trainer.profile_steps={tcfg.profile_steps!r}"
                                 " must be START:STOP with STOP > START")

        total_steps = tcfg.max_epochs * tcfg.steps_per_epoch
        stop_votes = None  # the ranks' stop flags summed a step ago
        t_last = time.perf_counter()
        while state.step < total_steps:
            step = state.step
            # a resume inside the range still traces the remaining steps
            if (profile_range is not None and not profiling
                    and profile_range[0] <= step < profile_range[1]):
                profiler.enter_context(trace(run_dir / "profile", device=device))
                profiling = True
            batch = next(prefetcher)
            metrics = agents.train_step(state, batch,
                                        generator=stream_generator(seed, "step", step, device))
            if profiling and step + 1 >= profile_range[1]:
                profiler.close()
                profile_range, profiling = None, False

            if (step + 1) % tcfg.log_every == 0:
                dt = (time.perf_counter() - t_last) / tcfg.log_every
                t_last = time.perf_counter()
                metrics = parallel.reduce_metrics(metrics)
                metrics["perf/steps_per_sec"] = 1.0 / dt
                metrics["perf/chunks_per_sec"] = 2 * rank_batch * world / dt
                mlog.log(metrics, step + 1)
                logger.info("step %d | loss %.4f | %.1f chunks/s", step + 1,
                            metrics["train/total_loss"], metrics["perf/chunks_per_sec"])
                if tcfg.halt_on_nonfinite and not np.isfinite(metrics["train/total_loss"]):
                    raise TrainingDivergedError(
                        f"non-finite loss {metrics['train/total_loss']} at step "
                        f"{step + 1}; last checkpoint precedes this step — "
                        "lower the lr or inspect the data shard")

            if (step + 1) % tcfg.steps_per_epoch == 0:
                epoch = (step + 1) // tcfg.steps_per_epoch
                best = None
                if cfg.rollout.enabled:
                    rollout_metrics = _maybe_rollout(cfg, state, epoch, device)
                    if rollout_metrics:
                        mlog.log(rollout_metrics, step + 1)
                        best = rollout_metrics["eval_lh/avg_seq_len"]
                if cfg.task_rollout.enabled:
                    task_metrics = _maybe_task_rollout(cfg, state, epoch, run_dir, device)
                    if task_metrics:
                        mlog.log(task_metrics, step + 1)
                # validation on the validation split when there is one, else
                # on the current train batch (synthetic smoke mode), on the
                # EMA weights like the reference's limit_val_batches=4
                val_metrics: Dict[str, float] = {}
                first_vbatch = None
                with ema_weights(state):
                    for vb in range(tcfg.limit_val_batches):
                        gen = stream_generator(seed, "val", step * tcfg.limit_val_batches + vb,
                                               device)
                        vbatch = device_batch(gen, next(val_iter)) if val_iter is not None \
                            else batch
                        if first_vbatch is None:
                            first_vbatch = vbatch
                        for k, v in agents.validation_step(net, vbatch, generator=gen).items():
                            val_metrics[k] = val_metrics.get(k, 0.0) + float(v)
                    if tcfg.log_recon_images and lead:
                        _log_recon_images(agent_cfg, net, first_vbatch, run_dir, mlog, step + 1,
                                          stream_generator(seed, "recon", step, device))
                val_metrics = parallel.reduce_metrics(val_metrics)
                mlog.log({k: v / tcfg.limit_val_batches for k, v in val_metrics.items()},
                         step + 1)
                # with a rollout's metric the save waits and updates best.json
                save(metric=best)
                if checkpointing:
                    logger.info("epoch %d checkpointed at step %d", epoch, step + 1)

            if world > 1:
                # every rank stops at the same step: each step's flags are
                # summed over the ranks and read a step later
                stop = stop_votes is not None and stop_votes.item() > 0
                stop_votes = parallel.vote(stop_requested.is_set())
            else:
                stop = stop_requested.is_set()
            if stop:
                save(wait=True)  # durable before returning
                if checkpointing:
                    logger.warning("preemption checkpoint saved at step %d; "
                                   "resume by rerunning with the same run_name", state.step)
                break
    return state


def _eligible(epoch: int, skip_epochs: int, rollout_freq: int) -> bool:
    """The rollouts' cadence: after `skip_epochs`, every `rollout_freq`."""
    return epoch > skip_epochs and (epoch - skip_epochs) % rollout_freq == 0


@contextlib.contextmanager
def _rollout_policy(state, generator: torch.Generator):
    """A fresh rollout policy on the EMA weights (the reference's
    evaluate_ema_weights_instead, ema.py:182-211), its noise drawn from
    `generator`; its CUDA graphs, captured inside, are released before the
    live weights come back."""
    from .evaluation.policy_adapter import make_rollout_policy
    with ema_weights(state):
        policy = make_rollout_policy(state.net, generator=generator)
        try:
            yield policy
        finally:
            policy.inner.release()


def _maybe_rollout(cfg: RunConfig, state, epoch: int, device):
    """Training-time long-horizon CALVIN rollout (RolloutLongHorizon
    equivalent, JAX `_maybe_rollout`, training.py:788-817): this rank's
    shard of the chains, the results gathered over the ranks. Needs
    calvin_env; without it (or the oracle) a warning and None."""
    from .evaluation import annotations, env_adapter
    from .evaluation.training_callbacks import RolloutLongHorizonCallback
    r = cfg.rollout
    if not _eligible(epoch, r.skip_epochs, r.rollout_freq):
        return None
    # a mis-configured rollout degrades to a warning, not a dead run (the
    # env's construction touches the external calvin_env); the rollout
    # itself is not caught
    try:
        env = env_adapter.make_calvin_env(r.val_dataset_path)
        oracle = annotations.make_task_oracle()
    except Exception as e:
        logger.warning("rollout skipped (env/oracle unavailable): %s", e)
        return None
    # the reference evaluates with the per-task VALIDATION sentence
    # (rollout_long_horizon.py:129-138), never synthesized task-name text
    goal_fn = annotations.make_goal_fn(state.net.cfg.clip_context_length)
    cb = RolloutLongHorizonCallback(
        env, oracle, goal_fn, num_sequences=r.num_sequences, ep_len=r.ep_len,
        rollout_freq=r.rollout_freq, skip_epochs=r.skip_epochs)
    with _rollout_policy(state, stream_generator(cfg.trainer.seed, "rollout", epoch,
                                                 device)) as policy:
        return cb(policy, epoch)


def _resolve_target(path: str):
    """Dotted-path import (the hydra `_target_` equivalent). A path into the
    JAX package (`mdt_policy_tpu.…`, the config's defaults) resolves to the
    same path in the port (`mdt_policy_tpu_torch.…`); any other path is
    imported as given."""
    import importlib
    prefix = "mdt_policy_tpu."
    if path.startswith(prefix):
        path = "mdt_policy_tpu_torch." + path[len(prefix):]
    mod, _, fn = path.rpartition(".")
    return getattr(importlib.import_module(mod), fn)


def _maybe_task_rollout(cfg: RunConfig, state, epoch: int, run_dir: Path, device):
    """Validation-time single-task rollouts (the reference `Rollout` callback,
    mdt/rollout/rollout.py:58-118; JAX `_maybe_task_rollout`,
    training.py:827-891): the first eligible epoch discovers solvable demos
    from validation batches (env reset to the window's first and last
    state, then the oracle, ref :374-421) and the lead persists the task
    dictionary beside the checkpoints (ref :404-415 stores it in the ckpt);
    later epochs reuse it. Every eligible epoch logs `tasks/{task}_sr` per
    goal modality. Every rank discovers from the whole validation split and
    runs the same rollouts, so the ranks agree."""
    tr = cfg.task_rollout
    if not _eligible(epoch, tr.skip_epochs, tr.rollout_freq):
        return None
    try:
        env = _resolve_target(tr.env_target)(tr.val_dataset_path)
        oracle = _resolve_target(tr.oracle_target)()
    except Exception as e:
        logger.warning("task rollout skipped (env/oracle unavailable): %s", e)
        return None

    from .evaluation.annotations import make_goal_fn
    from .evaluation.single_task_rollout import (SingleTaskRollout, discover_tasks,
                                                 load_task_dict, save_task_dict,
                                                 state_pairs_from_batch)

    task_dict_path = run_dir / "task_dict.npy"
    if task_dict_path.exists():
        task_to_states = load_task_dict(task_dict_path)
    else:
        if cfg.data.root_data_dir is None:
            logger.warning("task rollout skipped: discovery needs a real "
                           "validation split (data.root_data_dir unset)")
            return None
        # discovery pulls raw host batches (robot_obs + scene_obs) from a
        # loader of its own, so the training and validation streams are
        # untouched
        agent_cfg = state.net.cfg
        disc = _real_loaders(cfg, "validation", agent_cfg.clip_context_length,
                             agent_cfg.clip_vocab_size, include_scene_obs=True,
                             sharded=False)
        try:
            it = iter(disc)
            pairs = []
            for _ in range(tr.discovery_batches):
                pairs += state_pairs_from_batch(next(it)["vis"])
        finally:
            disc.close()
        task_to_ids = discover_tasks(env, oracle, pairs)
        task_to_states = {t: [pairs[i] for i in ids] for t, ids in task_to_ids.items()}
        if parallel.is_lead():
            save_task_dict(task_dict_path, task_to_states)
        parallel.barrier()
        logger.info("task discovery: %s", {t: len(v) for t, v in task_to_states.items()})
    if not task_to_states:
        logger.warning("task rollout: no solvable tasks discovered")
        return None

    goal_fn = make_goal_fn(state.net.cfg.clip_context_length)
    cb = SingleTaskRollout(
        env, oracle, goal_fn, ep_len=tr.ep_len,
        rollouts_per_task=tr.rollouts_per_task,
        id_selection_strategy=tr.id_selection_strategy,
        min_window_size=cfg.data.min_window_size,
        max_window_size=cfg.data.max_window_size,
        modalities=tuple(tr.modalities))
    with _rollout_policy(state, stream_generator(cfg.trainer.seed, "task_rollout", epoch,
                                                 device)) as policy:
        return cb(policy, task_to_states)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None, help="YAML config path")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one unless "
                         "the CPU is named)")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    train(load_config(args.config, args.overrides), device=args.device)


if __name__ == "__main__":
    main()
