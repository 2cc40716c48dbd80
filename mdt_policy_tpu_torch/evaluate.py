"""Standalone evaluation entry point of the port, the `mdt_evaluate` CLI
(port of `mdt_policy_tpu/evaluate.py`, `:38-232`):

    python -m mdt_policy_tpu_torch.evaluate --train-folder runs/<name> \\
        --dataset-path /data/task_D_D/validation \\
        --sampler ddim --steps 10 --sigma-min 0.001 --sigma-max 80

* re-reads the run's config snapshot (`config.yaml`, written by either
  package's training, or by `utils/checkpoint.py::convert_run_dir` from a
  JAX run) and builds the agent it names (`mdt` or `mdtv`) on `--device`
  (default `cuda`; the CPU only when named), with float32 matmuls and
  convolutions in full float32 (`utils.misc.full_f32`), not TF32;
* restores the best checkpoint's EMA weights (`--no-ema`: the raw ones) and
  applies the eval-time sampler overrides: `--sampler` and
  `--sweep-sampler` take every name of the JAX package's suite
  (`diffusion.samplers.SAMPLER_NAMES`);
* evaluates every subtask with its validation annotation sentence, tokenized
  for the CLIP text tower or, with `--use-embeddings`, looked up in the
  dataset's `embeddings.npy`;
* runs the chains through `MDTVPolicy` (one CUDA graph a replan on the card)
  against calvin_env, or `--fake-env` for a sim-free smoke run, and writes
  `results.json` under `<train_folder>/evaluation`;
* `--num-videos N` records the first N chains (GIF, and mp4 where an
  encoder is importable) under `<train_folder>/evaluation/videos`; that
  needs PIL, and raises ImportError without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from pathlib import Path

import numpy as np
import torch

from .diffusion.samplers import SAMPLER_NAMES

logger = logging.getLogger(__name__)

__all__ = ["build_policy", "load_run_agent", "load_run_config", "main"]


def load_run_config(train_folder):
    """The training run's config snapshot; the defaults when the run has
    none."""
    from .training import load_config

    cfg_file = Path(train_folder) / "config.yaml"
    return load_config(str(cfg_file) if cfg_file.exists() else None, [])


def load_run_agent(train_folder, *, use_ema: bool = True,
                   cfg_replace: dict | None = None, device="cuda"):
    """The run's agent net on `device` with the best checkpoint's weights
    (the newest without a `best.json`): the EMA of the trainables, or the
    raw ones without `use_ema`. Returns (net, agent_cfg, run_cfg)."""
    from .agents import init_train_state, make_agent_net
    from .training import _make_agent
    from .utils.checkpoint import Checkpointer

    train_folder = Path(train_folder)
    run_cfg = load_run_config(train_folder)
    agent_cfg = dataclasses.replace(_make_agent(run_cfg), **(cfg_replace or {}))
    net = make_agent_net(agent_cfg, device=device)
    ck = Checkpointer(train_folder / "checkpoints")
    state = ck.restore(init_train_state(net), step=ck.best_step())
    if use_ema:
        with torch.no_grad():
            for name, p in net.trainable_parameters():
                p.copy_(state.ema[name])
    logger.info("restored %s agent, %s weights from step %s", run_cfg.agent,
                "EMA" if use_ema else "raw", state.step)
    return net, agent_cfg, run_cfg


def build_policy(train_folder, *, sampler_type=None, num_sampling_steps=None,
                 sigma_min=None, sigma_max=None, noise_scheduler=None,
                 multistep=None, use_ema: bool = True, device="cuda"):
    """The run's agent (mdt or mdtv, per its config snapshot) with the
    sampler overrides, wrapped as a rollout policy. Returns (policy,
    agent_cfg, run_cfg)."""
    replace = {}
    if sampler_type:
        replace["sampler_type"] = sampler_type
    if num_sampling_steps:
        replace["num_sampling_steps"] = num_sampling_steps
    if sigma_min is not None:
        replace["sigma_min"] = sigma_min
    if sigma_max is not None:
        replace["sigma_max"] = sigma_max
    if noise_scheduler:
        replace["noise_scheduler"] = noise_scheduler
    if multistep:
        replace["multistep"] = multistep

    net, agent_cfg, run_cfg = load_run_agent(train_folder, use_ema=use_ema,
                                             cfg_replace=replace, device=device)
    from .evaluation.policy_adapter import make_rollout_policy
    return make_rollout_policy(net), agent_cfg, run_cfg


def _env_and_oracle(args):
    if args.fake_env:
        from .evaluation.fake_env import FakeEnv, ScriptedOracle
        return FakeEnv(img_hw=64), ScriptedOracle(default=10 ** 9)
    from .evaluation.annotations import make_task_oracle
    from .evaluation.env_adapter import make_calvin_env
    return make_calvin_env(args.dataset_path), make_task_oracle()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train-folder", required=True)
    ap.add_argument("--dataset-path", default=None, help="CALVIN validation dir")
    ap.add_argument("--num-sequences", type=int, default=1000)
    ap.add_argument("--ep-len", type=int, default=360)
    ap.add_argument("--sampler", default=None, choices=SAMPLER_NAMES)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--sigma-min", type=float, default=None)
    ap.add_argument("--sigma-max", type=float, default=None)
    ap.add_argument("--noise-scheduler", default=None)
    ap.add_argument("--multistep", type=int, default=None)
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--num-videos", type=int, default=0,
                    help="record the first N chains as GIF/mp4 under "
                         "<train_folder>/evaluation/videos (ref "
                         "conf/mdt_evaluate.yaml num_videos)")
    ap.add_argument("--use-embeddings", action="store_true",
                    help="goal = precomputed embeddings.npy lookup instead of "
                         "the CLIP text tower (the reference's "
                         "use_text_not_embedding=False path)")
    ap.add_argument("--fake-env", action="store_true",
                    help="protocol smoke run without PyBullet")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the agent (default cuda; raises "
                         "without one unless the CPU is named)")
    ap.add_argument("--debug", action="store_true",
                    help="per-chain subtask/goal logging")
    # sweep mode (the reference's sweep.yaml surface: sampler x steps x
    # sigma_min grid, each combo a full benchmark)
    ap.add_argument("--sweep-sampler", nargs="+", default=None, choices=SAMPLER_NAMES)
    ap.add_argument("--sweep-steps", nargs="+", type=int, default=None)
    ap.add_argument("--sweep-sigma-min", nargs="+", type=float, default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    from .utils.misc import full_f32
    full_f32()

    if args.sweep_sampler or args.sweep_steps or args.sweep_sigma_min:
        return _sweep(args)

    from .evaluation import evaluate_policy, print_and_save
    from .evaluation.annotations import make_goal_fn

    policy, agent_cfg, run_cfg = build_policy(
        args.train_folder, sampler_type=args.sampler,
        num_sampling_steps=args.steps, sigma_min=args.sigma_min,
        sigma_max=args.sigma_max, noise_scheduler=args.noise_scheduler,
        multistep=args.multistep, use_ema=not args.no_ema, device=args.device)
    env, oracle = _env_and_oracle(args)

    lang_embeddings = None
    if args.use_embeddings:
        from .evaluation.rollout import LangEmbeddings
        if args.dataset_path is None:
            raise SystemExit("--use-embeddings needs --dataset-path "
                             "(embeddings.npy lives in the dataset)")
        lang_embeddings = LangEmbeddings(args.dataset_path,
                                         lang_folder=run_cfg.data.lang_folder)
    goal_fn = make_goal_fn(agent_cfg.clip_context_length,
                           lang_embeddings=lang_embeddings)

    results = evaluate_policy(policy, env, oracle, goal_fn,
                              num_sequences=args.num_sequences, ep_len=args.ep_len,
                              num_videos=args.num_videos,
                              video_dir=Path(args.train_folder) / "evaluation" / "videos")
    data = print_and_save(results, args.num_sequences,
                          Path(args.train_folder) / "evaluation")
    print(json.dumps({"avg_seq_len": data["avg_seq_len"],
                      "chain_sr": data["chain_sr"]}, indent=2))


def _sweep(args):
    """Grid over sampler x steps x sigma_min, one benchmark per combo (the
    reference's wandb sweep surface, sweep.yaml:9-22): one row a
    combination, written to sweep_results.json under
    <train_folder>/evaluation after each."""
    import itertools

    from .evaluation import evaluate_policy
    from .evaluation.annotations import make_goal_fn

    samplers = args.sweep_sampler or [args.sampler or "ddim"]
    steps_grid = args.sweep_steps or [args.steps or 10]
    sigma_mins = args.sweep_sigma_min or [args.sigma_min]
    env, oracle = _env_and_oracle(args)

    out = Path(args.train_folder) / "evaluation"
    out.mkdir(parents=True, exist_ok=True)
    table = []
    for sampler, steps, smin in itertools.product(samplers, steps_grid, sigma_mins):
        policy, agent_cfg, _ = build_policy(
            args.train_folder, sampler_type=sampler, num_sampling_steps=steps,
            sigma_min=smin, sigma_max=args.sigma_max,
            noise_scheduler=args.noise_scheduler, use_ema=not args.no_ema,
            device=args.device)
        goal_fn = make_goal_fn(agent_cfg.clip_context_length)
        results = evaluate_policy(policy, env, oracle, goal_fn,
                                  num_sequences=args.num_sequences,
                                  ep_len=args.ep_len, progress=False)
        avg = float(np.mean(results))
        row = {"sampler": sampler, "steps": steps, "sigma_min": smin,
               "avg_seq_len": avg}
        table.append(row)
        logger.info("sweep %s", row)
        # incremental write: a failing later combo never loses finished rows
        (out / "sweep_results.json").write_text(json.dumps(table, indent=2))
    best = max(table, key=lambda r: r["avg_seq_len"])
    print(json.dumps({"sweep": table, "best": best}, indent=2))


if __name__ == "__main__":
    main()
