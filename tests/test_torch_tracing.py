"""The port's own spans and counters (`utils/profiling.py`), on the CPU: off
with no profile running, recorded under one (names, parents, rids,
threads, the prefetcher's worker), the goal-row counters of the batched
evaluator, the profile summary's union of device intervals and self
times, and the benchmark's placement of the spans
(`port_bench/harness/program_spans.py`) in a tiny traced run of each
traffic kind, with the readers of the metrics it feeds."""

import json
import math
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mdt_policy_tpu_torch.agents import MDTConfig, MDTVConfig, MDTVAgentNet
from mdt_policy_tpu_torch.data.loader import DevicePrefetcher
from mdt_policy_tpu_torch.evaluation.policy_adapter import make_batched_predict
from mdt_policy_tpu_torch.utils import profiling as P

ROOT = Path(__file__).resolve().parents[1]

TINY = dict(latent_dim=32, embed_dim=32, obs_dim=32, goal_dim=16, clip_embed_dim=16,
            n_enc_layers=1, n_dec_layers=1, n_heads=2, perceiver_dim=32, perceiver_depth=1,
            perceiver_heads=2, perceiver_dim_head=8, num_latents=3, img_size=32, vit_patch=16,
            vit_depth=1, vit_heads=2, clip_vision_width=64, clip_vision_layers=1,
            clip_vision_patch=16, clip_text_width=16, clip_text_layers=1, clip_text_heads=2,
            gen_img_res=32, gen_patch_size=16, gen_decoder_depth=1, gen_decoder_dim=16,
            gen_decoder_heads=2, compute_dtype="float32", gen_compute_dtype="float32")


def _since(t0: int):
    return [r for r in P.recorded() if (r.t_ns if isinstance(r, P.Count) else r.start_ns) >= t0]


def test_off_without_a_profile():
    assert not P.recording()
    t0 = time.time_ns()
    with P.span("test.outer", 7) as sp:
        P.count("test.counter", 3)
    assert sp is P.NO_SPAN and P.span("test.other") is P.NO_SPAN
    assert _since(t0) == []


def test_records_under_a_cpu_profile():
    t0 = time.time_ns()
    raws = [{"s": {"v": np.asarray([i])}} for i in range(3)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert P.recording()
        with P.span("test.outer", 7):
            with P.span("test.inner"):
                P.count("test.counter", 3)
        pf = DevicePrefetcher(iter(raws), lambda i, b: b, device="cpu", depth=1,
                              start_index=5)
        [next(pf) for _ in range(3)]
        pf.close()
        pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()
    with P.span("test.after"):
        pass
    recs = _since(t0)
    spans = {r.name: r for r in recs if isinstance(r, P.Span)}
    main = threading.get_ident()
    assert spans["test.outer"].parent is None and spans["test.outer"].rid == 7
    assert spans["test.inner"].parent == "test.outer" and spans["test.inner"].rid == 7
    assert spans["test.outer"].start_ns <= spans["test.inner"].start_ns \
        <= spans["test.inner"].end_ns <= spans["test.outer"].end_ns
    assert [(r.name, r.n) for r in recs if isinstance(r, P.Count)] == [("test.counter", 3)]
    assert "test.after" not in spans
    # the prefetcher: the consumer's wait on this thread, the copies and the
    # preprocessing on its worker, each batch's index as the rid
    worker = [r for r in recs if isinstance(r, P.Span) and r.name in ("data.copy",
                                                                       "data.preprocess")]
    assert sorted((r.name, r.rid) for r in worker) == \
        [("data.copy", 5), ("data.copy", 6), ("data.copy", 7),
         ("data.preprocess", 5), ("data.preprocess", 6), ("data.preprocess", 7)]
    assert all(r.thread != main and r.parent is None for r in worker)
    nexts = [r for r in recs if isinstance(r, P.Span) and r.name == "data.next"]
    assert len(nexts) == 3 and all(r.thread == main for r in nexts)
    # outside `trace()` a span opens no record_function range
    assert not {"test.outer", "test.inner", "data.next"} & {e.name for e in prof.events()}


def test_trace_shows_spans_as_ranges(tmp_path):
    """Inside `trace()` each span is a record_function range of the
    Chrome trace too, and `summary.json` counts it."""
    with P.trace(tmp_path, device="cpu"):
        with P.span("test.outer", 3):
            with P.span("test.inner"):
                P.count("test.counter", 2)
    with P.span("test.after_trace"):
        pass
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())
             ["traceEvents"]}
    assert {"test.outer", "test.inner"} <= names
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["spans"]["test.outer"]["count"] == 1
    assert summary["counters"] == {"test.counter": 2}
    assert not P._ranges


def test_the_profiler_flag_is_there():
    """The recorder reads torch's process-wide profiler flag on every span
    and counter; a torch without it would leave the spans off for good."""
    from torch.autograd import profiler
    assert isinstance(getattr(profiler, "_is_profiler_enabled", None), bool), \
        "torch.autograd.profiler._is_profiler_enabled is gone: utils/profiling.py " \
        "needs another way to tell that a profile runs"
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled and P.recording()
    assert not profiler._is_profiler_enabled


def test_goal_rows_counters_of_the_batched_evaluator():
    """Four envs whose goals change for one row in four: the text tower is
    given every row, one of which carries a changed goal."""
    net = MDTVAgentNet(MDTVConfig(**TINY), device="cpu")
    predict = make_batched_predict(net, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    obs = {k: rng.integers(0, 256, (4, 1, 40, 40, 3), dtype=np.uint8)
           for k in ("rgb_static", "rgb_gripper")}
    toks = rng.integers(1, 100, (4, 77)).astype(np.int32)
    goals = lambda t: [{"lang_tokens": row} for row in t]  # noqa: E731
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        predict(obs, goals(toks))          # nothing cached: every row is new
        predict(obs, goals(toks))          # the same goals: no encode
        toks = toks.copy()
        toks[2, :3] += 1
        predict(obs, goals(toks))          # one row in four changed
    recs = _since(t0)
    counts = {}
    for r in recs:
        if isinstance(r, P.Count):
            counts.setdefault(r.name, []).append(r.n)
    assert counts == {"policy.goal_rows_encoded": [4, 4], "policy.goal_rows_changed": [4, 1]}
    spans = [r for r in recs if isinstance(r, P.Span)]
    ticks = [r for r in spans if r.name == "eval.tick"]
    assert [r.rid for r in ticks] == [0, 1, 2] and all(r.parent is None for r in ticks)
    by_parent = {(r.name, r.parent) for r in spans}
    assert {("eval.preprocess", "eval.tick"), ("policy.plan", "eval.tick"),
            ("eval.fetch", "eval.tick"), ("policy.goal_encode", "policy.plan")} <= by_parent
    assert sum(r.name == "policy.goal_encode" for r in spans) == 2


def _event(s, e):
    return SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA,
                           time_range=SimpleNamespace(start=s, end=e),
                           is_user_annotation=False)


def test_device_summary_counts_overlapping_work_once():
    prof = SimpleNamespace(events=lambda: [_event(0.0, 100.0), _event(50.0, 150.0),
                                           _event(400.0, 500.0)])
    out = P.device_summary(prof, wall_ms=1.0)
    assert out["device_ms"] == pytest.approx(0.25) and out["device_events"] == 3
    assert out["busy_share"] == pytest.approx(0.25)
    assert P.union_us([]) == 0.0 and P.union_us([(3.0, 4.0), (0.0, 5.0)]) == 5.0


def test_span_summary_self_times():
    recs = [P.Span("a", 0, 10_000_000, None, 1, 0), P.Span("b", 1_000_000, 4_000_000, "a", 1, 0),
            P.Span("b", 5_000_000, 6_000_000, "a", 1, 0), P.Count("c", 2, 3), P.Count("c", 3, 1)]
    out = P.span_summary(recs)
    assert out["spans"] == {"a": {"count": 1, "total_ms": 10.0, "self_ms": 6.0},
                            "b": {"count": 2, "total_ms": 4.0, "self_ms": 4.0}}
    assert out["counters"] == {"c": 4}


# ---- the benchmark's placement, in a tiny traced run of each traffic kind ------

KINDS = {
    "mdtv-controller-b1": (MDTVConfig, {"warmup_replans": 2, "goal_every_replans": 2,
                                        "frame_pool": 8, "check_replans": 2,
                                        "check_slowest": 1, "check_rows": 2},
                           ("pb.replan_plain", "pb.replan_switch", "pb.step")),
    "mdt-eval-b32": (MDTConfig, {"envs": 4, "warmup_ticks": 2, "tick_pool": 2,
                                 "check_ticks": 1, "check_slowest": 1, "check_rows": 4},
                     ("pb.tick",)),
    "mdtv-train-b512": (MDTVConfig, {"batch_per_stream": 2, "static_hw": 40, "gripper_hw": 20,
                                     "pool": 2, "warmup_steps": 0},
                        ("pb.train_step", "pb.next_batch")),
}


@pytest.mark.parametrize("cell", sorted(KINDS))
def test_program_spans_pair_with_the_harness_spans(cell, monkeypatch):
    """Every program root of the traced window pairs with the harness span
    around its call and is placed inside it, and each reader of the
    program's spans reads a finite value where the window holds what it
    reads (a loaded host may fit one tick in the window), nothing where it
    does not."""
    from port_bench.harness import program_spans
    from port_bench.harness.bench import Bench
    from port_bench.harness.runner import run_cell
    cls, traffic, harness = KINDS[cell]
    seen = []
    reader = Bench.reader
    monkeypatch.setattr(Bench, "reader", lambda self, name: SimpleNamespace(
        read=lambda obs: seen.append(obs) or reader(self, name).read(obs)))
    line = run_cell(Bench(ROOT), cell, 9_876_543_210, 0.3, True, "cpu", time.perf_counter(),
                    agent_cfg=cls(**TINY), traffic=traffic,
                    limits={k: 1e9 for k in ("chunk_gap", "loss_gap", "grad_gap", "step_gap",
                                             "ema_gap")})
    obs = seen[0]
    ps = program_spans.place(obs)
    assert ps is not None
    # a root a harness span, placed inside it
    wrapped = sorted((h for h in obs["trace"].host if h[0] in harness), key=lambda h: h[1])
    assert len(ps) == len(wrapped)
    tol = program_spans.TOLERANCE_US
    for u, h in zip(ps, wrapped):
        assert u.harness == h[0] and h[1] - tol <= u.root[1] <= u.root[2] <= h[2] + tol
        assert all(u.root[1] <= s[1] <= s[2] <= u.root[2] + tol for s in u.spans)
    readable = {
        "goal_rows_useful.eval": any(u.counts.get("policy.goal_rows_encoded") for u in ps),
        **{n: bool(program_spans.units(obs, "pb.train_step"))
           for n in ("forward_issue_ms.train", "backward_issue_ms.train",
                     "step_tail_ms.train")}}
    mine = {m["name"] for m in Bench(ROOT).metrics_of(cell, "per_layer")} & set(readable)
    assert mine == {"mdtv-controller-b1": set(), "mdt-eval-b32": {"goal_rows_useful.eval"},
                    "mdtv-train-b512": set(readable) - {"goal_rows_useful.eval"}}[cell]
    for name in mine:
        if readable[name]:
            assert math.isfinite(line["metrics"][name]["value"]), name
        else:
            assert name not in line["metrics"], name
