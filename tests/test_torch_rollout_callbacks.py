"""The port's training-time evaluation against the JAX package's on the same
inputs: `shard_indices`, the long-horizon callback's cadence and metrics
under a scripted oracle, the single-task selectors, `discover_tasks`,
`state_pairs_from_batch` and `SingleTaskRollout`'s metrics for each goal
modality, `task_dict.npy` across the packages, `RolloutVideo`'s frames and
files, and `evaluate_policy` with a recorded video. Everything here is
host-side numpy and PIL; the policies are the packages' `RandomPolicy` and
a recording double, so the comparisons are exact."""

import importlib
import sys

import numpy as np
import pytest
from PIL import Image

from mdt_policy_tpu.evaluation import fake_env as jfake
from mdt_policy_tpu.evaluation import single_task_rollout as jstr
from mdt_policy_tpu.evaluation import training_callbacks as jcb
from mdt_policy_tpu.evaluation import video as jvideo
from mdt_policy_tpu.evaluation.sequences import get_sequences as jget_sequences
from mdt_policy_tpu_torch.evaluation import fake_env, single_task_rollout, training_callbacks
from mdt_policy_tpu_torch.evaluation import video
from mdt_policy_tpu_torch.evaluation.sequences import get_sequences

# the modules, which the packages' `rollout` functions shadow
rollout = importlib.import_module("mdt_policy_tpu_torch.evaluation.rollout")
jrollout = importlib.import_module("mdt_policy_tpu.evaluation.rollout")

TASKS = ["open_drawer", "close_drawer", "push_red_block_left", "turn_on_led",
         "rotate_blue_block_right"]


@pytest.mark.parametrize("n,world", [(1000, 1), (1000, 4), (1000, 3), (7, 2), (5, 8), (4, 2)])
def test_shard_indices_equal_jax(n, world):
    parts = [training_callbacks.shard_indices(n, r, world) for r in range(world)]
    assert parts == [jcb.shard_indices(n, r, world) for r in range(world)]
    assert [i for p in parts for i in p] == list(range(n))


def _solve_at():
    """A scripted oracle's rule: each task solved after its own number of
    steps, one never, so the chains end at different lengths."""
    rule = {t: 1 + i for i, t in enumerate(TASKS)}
    rule["rotate_blue_block_right"] = 10 ** 9
    return rule


@pytest.mark.parametrize("epochs", [(3, 21, 24), (1, 2, 3)])
def test_long_horizon_callback_cadence_and_metrics_equal_jax(epochs):
    """The JAX template (tests/test_eval_extras.py): before skip_epochs and
    off the cadence nothing runs; on it both packages give the same
    `eval_lh/*` metrics over the same chains, env frames and policy draws."""
    skip, freq = (19, 5) if epochs[0] == 3 else (0, 1)
    out = []
    for pkg, fake in ((training_callbacks, fake_env), (jcb, jfake)):
        cb = pkg.RolloutLongHorizonCallback(
            fake.FakeEnv(img_hw=8, gripper_hw=8, seed=1), fake.ScriptedOracle(_solve_at()),
            goal_fn=lambda s: {"lang_text": s}, num_sequences=8, ep_len=6,
            rollout_freq=freq, skip_epochs=skip)
        out.append([cb(fake.RandomPolicy(seed=2), epoch=e) for e in epochs])
    assert out[0] == out[1]
    mine = out[0]
    if skip:
        assert mine[0] is None and mine[1] is None and mine[2] is not None
    else:
        assert all(m is not None for m in mine)
    m = mine[-1]
    assert sorted(m) == ["eval_lh/avg_seq_len"] + [f"eval_lh/sr_chain_{i}" for i in range(1, 6)]
    assert 0 < m["eval_lh/avg_seq_len"] < 5
    assert m["eval_lh/avg_seq_len"] == pytest.approx(sum(m[f"eval_lh/sr_chain_{i}"]
                                                         for i in range(1, 6)))


@pytest.mark.parametrize("name", ["select_first", "select_balanced", "select_longest"])
@pytest.mark.parametrize("n,num", [(10, 3), (5, 10), (17, 4), (1, 1)])
def test_selectors_equal_jax(name, n, num):
    ids = list(range(100, 100 + n))
    mine = single_task_rollout.SELECTORS[name](ids, num, 21, 50)
    assert mine == jstr.SELECTORS[name](ids, num, 21, 50)
    assert len(mine) == min(n, num)


def _state_batch(seed=0, B=5, T=4):
    rng = np.random.default_rng(seed)
    return {"robot_obs": rng.normal(size=(B, T, 15)).astype(np.float32),
            "scene_obs": rng.normal(size=(B, T, 24)).astype(np.float32)}


def test_state_pairs_from_batch_equal_jax():
    batch = _state_batch()
    mine, ref = (pkg.state_pairs_from_batch(batch) for pkg in (single_task_rollout, jstr))
    assert len(mine) == len(ref) == 5
    for (a0, a1), (b0, b1) in zip(mine, ref):
        for a, b in ((a0, b0), (a1, b1)):
            for k in ("robot_obs", "scene_obs"):
                np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(mine[2][1]["scene_obs"], batch["scene_obs"][2, -1])


class _StateOracle:
    """Discovery double: the task a demo completes is read off its end
    state's first scene value (none, one or two tasks)."""

    def get_task_info(self, start_info, end_info):
        k = int(abs(end_info["scene_obs"][0]) * 3)
        return set(TASKS[k:k + (1 if k < 3 else 2)]) if k < 5 else set()


def test_discover_tasks_equal_jax():
    pairs = jstr.state_pairs_from_batch(_state_batch(seed=3, B=24))
    mine = single_task_rollout.discover_tasks(fake_env.FakeEnv(img_hw=8), _StateOracle(), pairs)
    ref = jstr.discover_tasks(jfake.FakeEnv(img_hw=8), _StateOracle(), pairs)
    assert mine == ref and len(mine) >= 2
    assert sum(map(len, mine.values())) < len(pairs)  # the ambiguous demos are left out


class _RecordingPolicy:
    """Records the goal kinds it is driven with; a constant action."""

    def __init__(self):
        self.goal_kinds = []

    def reset(self):
        pass

    def step(self, obs, goal):
        self.goal_kinds.append("vis" if "rgb_static_goal" in goal else "lang")
        if "rgb_static_goal" in goal:
            assert np.asarray(goal["rgb_static_goal"]).dtype == np.uint8
        return np.zeros(7)


@pytest.mark.parametrize("modalities", [("lang",), ("vis",), ("lang", "vis")])
def test_single_task_rollout_metrics_equal_jax(modalities):
    pairs = jstr.state_pairs_from_batch(_state_batch(seed=4, B=6))
    task_to_states = {"open_drawer": pairs[:4], "close_drawer": pairs[4:],
                      "turn_on_led": pairs[1:3]}
    rule = {"open_drawer": 2, "close_drawer": 10 ** 9, "turn_on_led": 3}
    out, kinds = [], []
    for pkg, fake in ((single_task_rollout, fake_env), (jstr, jfake)):
        policy = _RecordingPolicy()
        cb = pkg.SingleTaskRollout(fake.FakeEnv(img_hw=8), fake.ScriptedOracle(rule),
                                   goal_fn=lambda t: {"lang_text": f"do {t}"}, ep_len=4,
                                   rollouts_per_task=3, id_selection_strategy="select_longest",
                                   modalities=modalities)
        out.append(cb(policy, task_to_states))
        kinds.append(policy.goal_kinds)
    assert out[0] == out[1] and kinds[0] == kinds[1]
    assert set(kinds[0]) == set(modalities)
    m = out[0]
    # open_drawer 3 of 3 rollouts, close_drawer 0 of 2, turn_on_led 2 of 2
    assert m["tasks/average_sr"] == pytest.approx(5 / 7)
    key = "tasks/open_drawer_sr" if len(modalities) == 1 else "tasks/open_drawer_lang_sr"
    assert m[key] == 1.0
    with pytest.raises(ValueError, match="modality"):
        single_task_rollout.SingleTaskRollout(None, None, None, modalities=("audio",))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_task_dict_reads_across_the_packages(tmp_path, writer):
    pairs = jstr.state_pairs_from_batch(_state_batch(seed=5, B=3))
    saved = {"open_drawer": pairs[:2], "turn_on_led": pairs[2:]}
    save, load = ((single_task_rollout.save_task_dict, jstr.load_task_dict) if writer == "port"
                  else (jstr.save_task_dict, single_task_rollout.load_task_dict))
    path = save(tmp_path / "sub" / "task_dict.npy", saved)
    loaded = load(path)
    assert sorted(loaded) == sorted(saved)
    for t in saved:
        for (a0, a1), (b0, b1) in zip(loaded[t], saved[t]):
            for a, b in ((a0, b0), (a1, b1)):
                np.testing.assert_array_equal(a["robot_obs"], b["robot_obs"])
                np.testing.assert_array_equal(a["scene_obs"], b["scene_obs"])


def _gif_frames(path):
    with Image.open(path) as im:
        frames = []
        for i in range(im.n_frames):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGB")))
    return frames


def _record(pkg, root):
    """One video of two subtasks (a success and a failure) through `pkg`'s
    RolloutVideo: its frames after each stage and the written file."""
    rv = pkg.RolloutVideo(root, fps=10, border=3)
    rv.new_video("chain_0", caption="open | close")
    rng = np.random.default_rng(7)
    stages = []
    for ok, text in ((True, "open the drawer"), (False, "close the drawer")):
        rv.new_subtask()
        for _ in range(3):
            rv.update(rng.integers(0, 255, (1, 1, 24, 32, 3), dtype=np.uint8))
        rv.draw_outcome(ok)
        stages.append([f.copy() for f in rv._frames])
        rv.add_language_instruction(text)
        stages.append([f.copy() for f in rv._frames])
    return stages, rv.write()


def test_rollout_video_frames_and_gif_equal_jax(tmp_path):
    mine, path = _record(video, tmp_path / "port")
    ref, jpath = _record(jvideo, tmp_path / "jax")
    for a, b in zip(mine, ref):
        assert len(a) == len(b)
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(fa, fb)
    assert path.name == jpath.name == "chain_0.gif"
    assert path.read_bytes() == jpath.read_bytes()
    frames = _gif_frames(path)
    assert len(frames) == 6 and frames[0].shape == (24, 32, 3)
    np.testing.assert_array_equal(mine[-1][0][0, 0], video.GREEN)
    np.testing.assert_array_equal(mine[-1][-1][0, 0], video.RED)
    # the caption changed pixels inside the border
    assert not np.array_equal(mine[0][0], mine[1][0])


def test_rollout_video_without_pil_raises(tmp_path, monkeypatch):
    """PIL is imported where it is used: frames and borders work without
    it, a caption or a file raises an ImportError that names PIL."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    rv = video.RolloutVideo(tmp_path)
    rv.new_video("t")
    rv.update(np.zeros((8, 8, 3), np.uint8))
    rv.draw_outcome(True)
    with pytest.raises(ImportError, match="PIL"):
        rv.add_language_instruction("open the drawer")
    with pytest.raises(ImportError, match="PIL"):
        rv.write()
    assert not list(tmp_path.iterdir())


def test_evaluate_policy_with_a_video_equals_jax(tmp_path):
    """`evaluate_policy(num_videos=1)`: the same results and the same GIF
    (the first chain's static frames, borders and captions) as JAX's."""
    get_sequences.cache_clear()
    jget_sequences.cache_clear()
    outs = []
    for pkg, fake, name in ((rollout, fake_env, "port"), (jrollout, jfake, "jax")):
        results = pkg.evaluate_policy(
            fake.RandomPolicy(seed=3), fake.FakeEnv(img_hw=16, gripper_hw=8, seed=5),
            fake.ScriptedOracle(_solve_at()), lambda s: {"lang_text": f"please {s}"},
            num_sequences=3, ep_len=5, num_videos=1, video_dir=tmp_path / name)
        outs.append((results, sorted(p.name for p in (tmp_path / name).iterdir())))
    assert outs[0] == outs[1]
    # (an mp4 beside it where imageio or cv2 can write one)
    assert outs[0][1][0] == "lh-sequence_0.gif"
    mine, ref = (tmp_path / n / "lh-sequence_0.gif" for n in ("port", "jax"))
    assert mine.read_bytes() == ref.read_bytes()
    steps = len(_gif_frames(mine))
    first = get_sequences(3)[0][1]
    rule = _solve_at()
    # one frame an env step: each solved subtask's steps, then the failing one's
    want = 0
    for task in first:
        if rule.get(task, 10 ** 9) > 5:
            want += 5
            break
        want += rule[task]
    assert steps == want
