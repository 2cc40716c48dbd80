"""The run config of the training entry point (port of the config part of
`mdt_policy_tpu/training.py`, `:35-228`): the dataclasses, `load_config`
(YAML plus dotted key=value overrides) and `_make_agent`, copied so that a
`config.yaml` written by either package loads in the other unchanged.

Fields that only the JAX runtime reads (`trainer.devices`,
`trainer.profile_steps`, `trainer.aot_step_cache`, `distributed.*`) load as
data and change nothing here. The dotted factory paths of `task_rollout`
(`env_target`, `oracle_target`) are carried as data and never imported.
`train()` and `main()` are not ported yet (ROADMAP queue A item 4, "Data
pipeline and training runtime").
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional

__all__ = ["DataConfig", "DistributedConfig", "RolloutConfig", "RunConfig",
           "TaskRolloutConfig", "TrainerConfig", "load_config"]


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
    # data-mesh size; None = every device that divides batch_size evenly
    # (with a warning when some are dropped); set explicitly for strictness —
    # a batch/device mismatch then errors instead of silently shrinking
    devices: Optional[int] = None
    # "START:STOP" step range traced with jax.profiler into
    # <run_dir>/profile (view in TensorBoard/Perfetto); None disables
    profile_steps: Optional[str] = None
    # warm-start: orbax checkpoint dir (a step dir or a run's checkpoints/
    # dir) whose params partially initialize a FRESH run — every leaf with a
    # matching path+shape is copied, the rest keep their random init (the
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
    # Serialized-executable cache dir for the train-step program (opt-in;
    # None = off). On backends whose compile service costs minutes per fresh
    # process (and ignores the persistent XLA cache), a warm restart
    # deserializes the step executable in ~19 s instead of recompiling
    # 140-560 s (measured, docs/BENCHMARKING.md). Any stale/foreign blob
    # falls back to a normal compile. Relative paths resolve under the run
    # dir; "auto" uses <run_dir>/aot_cache.
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
    """Multi-host data parallelism (SURVEY §2.10: jax.distributed + one mesh
    spanning hosts; grad psum + contrastive all-gather ride ICI/DCN inside
    the same compiled program). trainer.batch_size is PER HOST — the loader
    shards the dataset per process and the global batch is assembled from
    per-process shards (parallel/mesh.py shard_batch)."""
    enabled: bool = False
    coordinator_address: Optional[str] = None  # host:port; None = TPU autodetect
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
