"""Data parallel of the port (`mdt_policy_tpu_torch/parallel/`) over gloo on
the CPU, each rank a subprocess with a timeout of its own:

* `all_gather_with_grad`: forward and backward against one process;
* the tiny MDT-V and MDT train steps at 2 ranks x 2 rows against the port's
  one-process step at 4 rows and the JAX `train_step` at 4 rows (the draws
  patched as in tests/test_torch_train_step.py, that file's tolerances),
  the replicas bit-identical after each step, the InfoNCE over the global
  batch.

The MDT step's case is in tests/test_torch_ddp_mdt.py and `train()` at 2
ranks in tests/test_torch_ddp_train.py (each file alone stays well under
the suite's per-file budget). Run as a script, this file is one rank (see
`_rank_main`).
"""

import datetime
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
# a rank's whole run, and its rendezvous and collectives, may take this long;
# a hung rank fails its test instead of the suite's time limit
RANK_TIMEOUT_S = 240
RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=120)
WORLD = 2
ROWS = 4  # the global batch; 2 a rank


def _kill_group(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def _run(cmds, tmp_path, timeout=RANK_TIMEOUT_S):
    """Run the commands at once, each in a session of its own, with the repo
    on the path; kill every one's process group at the deadline. Returns
    the stderr of each; fails on a timeout or a non-zero exit."""
    # two threads a process: the ranks share the machine with the suite
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": os.pathsep.join(
        [str(REPO), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")])}
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(cmd, cwd=tmp_path, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True, start_new_session=True)
             for cmd in cmds]
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    errs = []
    try:
        for proc in procs:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                errs.append(proc.communicate(timeout=max(left, 1))[1])
            except subprocess.TimeoutExpired:
                pytest.fail(f"{proc.args} ran past {timeout} s")
    finally:
        for proc in procs:
            _kill_group(proc)
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err[-4000:]
    return errs


def _ranks(mode, inputs, tmp_path):
    """`mode` on WORLD gloo ranks over `inputs`; each rank's output."""
    from mdt_policy_tpu_torch.parallel import free_port
    inp = tmp_path / f"{mode}.in.pt"
    torch.save(inputs, inp)
    port = free_port()
    outs = [tmp_path / f"{mode}.{r}.pt" for r in range(WORLD)]
    _run([[sys.executable, __file__, mode, str(r), str(port), str(inp), str(outs[r])]
          for r in range(WORLD)], tmp_path)
    return [torch.load(o, weights_only=False) for o in outs]


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _gather_rank(inputs, rank):
    """y = all_gather_with_grad(x_rank); loss_rank = f_rank(y); backward."""
    from mdt_policy_tpu_torch.parallel import all_gather_with_grad
    x = inputs["x"][rank].clone().requires_grad_(True)
    y = all_gather_with_grad(x)
    _loss(y, inputs["w"][rank]).backward()
    return {"y": y.detach(), "grad": x.grad}


def _loss(y, w):
    return (((y * w).sum(-1)) ** 2).sum() + (y ** 3).mean()


def _step_rank(inputs, rank):
    """Two train steps on this rank's rows: the first from the given draws
    (this rank's rows of the global ones), the second from a generator
    (`rank_draws`). After each: the metrics averaged over the ranks, the
    gradients, the trainables and the EMA."""
    from mdt_policy_tpu_torch import parallel
    from mdt_policy_tpu_torch.agents import (MDTConfig, MDTVConfig, init_train_state,
                                             make_agent_net, train_step)
    cls = MDTVConfig if inputs["family"] == "mdtv" else MDTConfig
    net = make_agent_net(cls(**inputs["config"]), device="cpu")
    net.load_state_dict(inputs["params"], strict=True)
    state = init_train_state(net)
    parallel.broadcast_trainables(net, state.ema)
    rows = slice(rank * ROWS // WORLD, (rank + 1) * ROWS // WORLD)
    batch = {s: {k: v[rows] for k, v in b.items()} for s, b in inputs["batch"].items()}
    draws = {s: {k: torch.from_numpy(v[rows]) for k, v in d.items()}
             for s, d in inputs["draws"].items()}
    out = []
    for kw in ({"draws": draws}, {"generator": torch.Generator().manual_seed(11)}):
        metrics = parallel.reduce_metrics(train_step(state, batch, **kw))
        out.append({"metrics": metrics,
                    "grads": {n: p.grad.clone() for n, p in net.trainable_parameters()},
                    "params": {n: p.detach().clone() for n, p in net.trainable_parameters()},
                    "ema": {n: v.clone() for n, v in state.ema.items()}})
    return out


def _rank_main(mode, rank, port, inp, out):
    from mdt_policy_tpu_torch import parallel
    from mdt_policy_tpu_torch.training import DistributedConfig
    torch.manual_seed(1234 + rank)  # nothing may depend on the global generator
    parallel.init_distributed(DistributedConfig(enabled=True,
                                                coordinator_address=f"localhost:{port}",
                                                num_processes=WORLD, process_id=rank),
                              "cpu", timeout=RENDEZVOUS_TIMEOUT)
    try:
        assert (parallel.rank(), parallel.world_size()) == (rank, WORLD)
        inputs = torch.load(inp, weights_only=False)
        fn = {"gather": _gather_rank, "step": _step_rank}[mode]
        torch.save(fn(inputs, rank), out)
    finally:
        parallel.shutdown()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_all_gather_with_grad_equals_one_process(tmp_path):
    """Forward: the ranks' rows in rank order. Backward: each rank's
    gradient is its rows of the gradient of the sum of the ranks' losses,
    as one process computes it over the gathered tensor."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(WORLD, 3, 5))).float()
    w = torch.from_numpy(rng.normal(size=(WORLD, 5))).float()
    outs = _ranks("gather", {"x": x, "w": w}, tmp_path)
    full = x.reshape(WORLD * 3, 5).clone().requires_grad_(True)
    sum(_loss(full, w[r]) for r in range(WORLD)).backward()
    for r, out in enumerate(outs):
        torch.testing.assert_close(out["y"], full.detach(), rtol=0, atol=0)
        torch.testing.assert_close(out["grad"], full.grad[3 * r:3 * (r + 1)],
                                   rtol=1e-5, atol=1e-6)
    from mdt_policy_tpu_torch.parallel import all_gather_with_grad
    alone = x[0]
    assert all_gather_with_grad(alone) is alone  # no group: the identity


def _family(name):
    """(parity test module, tiny config, gradient atol, update floor) of a
    family, from its train-step parity file."""
    from test_torch_train_step import DTYPES
    if name == "mdtv":
        import test_torch_train_step as mod
        return mod, {**mod.TINY, **DTYPES["f32"]}, lambda g: 1e-6, lambda g: 1e-6
    import test_torch_mdt_train_step as mod
    return mod, {**mod.TINY, **DTYPES["f32"]}, mod._grad_atol, mod._update_floor


def _one_process(family, config, params, batch, draws):
    """The port's one-process two steps at the global batch, as `_step_rank`
    takes them."""
    from mdt_policy_tpu_torch.agents import (MDTConfig, MDTVConfig, init_train_state,
                                             make_agent_net, train_step)
    cls = MDTVConfig if family == "mdtv" else MDTConfig
    net = make_agent_net(cls(**config), device="cpu")
    net.load_state_dict(params, strict=True)
    state = init_train_state(net)
    out = []
    for kw in ({"draws": {s: {k: torch.from_numpy(v) for k, v in d.items()}
                          for s, d in draws.items()}},
               {"generator": torch.Generator().manual_seed(11)}):
        metrics = {k: float(v) for k, v in train_step(state, batch, **kw).items()}
        out.append({"metrics": metrics,
                    "grads": {n: p.grad.clone() for n, p in net.trainable_parameters()},
                    "params": {n: p.detach().clone() for n, p in net.trainable_parameters()},
                    "ema": {n: v.clone() for n, v in state.ema.items()}})
    return out


def _same_step(mine, ref, before, grad_atol, floor, helpers, keys):
    """`mine` took `ref`'s step: losses and norms at 1e-4; from the same
    `before` (None: the losses only), gradients at rtol 1e-3 and the
    family's atol, the AdamW update and the EMA by the parity file's
    `_assert_same_update`."""
    for k in keys:
        np.testing.assert_allclose(mine["metrics"][k], ref["metrics"][k], rtol=1e-4, err_msg=k)
    if before is None:
        return
    assert sorted(mine["grads"]) == sorted(ref["grads"])
    for k, g in ref["grads"].items():
        np.testing.assert_allclose(mine["grads"][k].numpy(), np.asarray(g), rtol=1e-3,
                                   atol=grad_atol(g), err_msg=k)
        helpers._assert_same_update(k, mine["params"][k], ref["params"][k], before[k], g,
                                    1e-5, floor(g))
        helpers._assert_same_update(k, mine["ema"][k], ref["ema"][k], before[k], g,
                                    1e-5, floor(g))


def two_rank_step_equals_one_process_and_jax(family, tmp_path):
    """The family's tiny step at 2 ranks x 2 rows, twice: the replicas
    bit-identical after each step; the first step's losses, gradients,
    AdamW update and EMA against the port's one-process step at 4 rows and
    against the JAX `train_step` at 4 rows from the same draws; the second
    step's (draws from a generator, `rank_draws`) losses against the one
    process's."""
    import jax

    from mdt_policy_tpu_torch.utils.from_jax import from_jax
    helpers, config, grad_atol, floor = _family(family)
    import test_torch_train_step as base
    _, state0, _ = helpers._agents("f32")
    params = from_jax(jax.device_get(state0.params))
    batch, draws = base._batch(), base._draws()
    assert all(b["actions"].shape[0] == ROWS for b in batch.values())
    ranks = _ranks("step", {"family": family, "config": config, "params": params,
                            "batch": batch, "draws": draws}, tmp_path)
    one = _one_process(family, config, params, batch, draws)
    keys = base.LOSSES + ["train/grad_norm", "train/param_norm", "train/lr"]
    for i in range(2):
        # the replicas are identical after each step
        for part in ("grads", "params", "ema"):
            for k, v in ranks[0][i][part].items():
                assert torch.equal(v, ranks[1][i][part][k]), (i, part, k)
        assert ranks[0][i]["metrics"] == ranks[1][i]["metrics"]
        # the second step (its draws from the generator: `rank_draws`)
        # starts where each side's first left off, which differ by rounding
        # (Adam's first update is lr * sign(g) where g is rounding): its
        # losses are compared
        _same_step(ranks[0][i], one[i], params if i == 0 else None, grad_atol, floor, base,
                   keys)
    # the contrastive loss is the global batch's: at one rank's 2 rows it differs
    cont = ranks[0][0]["metrics"]["lang/cont_loss"]
    np.testing.assert_allclose(cont, one[0]["metrics"]["lang/cont_loss"], rtol=1e-5)
    # and against the JAX step at the global batch, from the same draws
    (jm, jgrads, jparams, jema), _ = helpers._steps("f32")
    ref = {"metrics": jm, "grads": jgrads,
           "params": {k: jparams[k] for k in jgrads}, "ema": {k: jema[k] for k in jgrads}}
    _same_step(ranks[0][0], ref, params, grad_atol, floor, base,
               base.LOSSES + ["train/grad_norm", "train/param_norm"])


def test_two_rank_mdtv_step_equals_one_process_and_jax(tmp_path):
    two_rank_step_equals_one_process_and_jax("mdtv", tmp_path)


if __name__ == "__main__":
    mode, rank, port, inp, out = sys.argv[1:]
    _rank_main(mode, int(rank), int(port), inp, out)
