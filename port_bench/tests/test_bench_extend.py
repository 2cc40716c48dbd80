"""A new cell, traffic mix and per-layer metric are new files and new
entries in BENCHMARK.json, with no edit to a file already there: shown on
a temporary copy of the benchmark."""

import hashlib
import json
import shutil

from port_bench.tests.conftest import ROOT, run_tiny


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "port_bench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_mix_and_metric_are_files_and_entries(tmp_path, monkeypatch):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    home = tmp_path / "port_bench"

    mix = json.loads((home / "traffic" / "controller-b1.json").read_text())
    mix["goal_every_replans"] = 2
    (home / "traffic" / "controller-b1-fast-goals.json").write_text(json.dumps(mix))
    (home / "metrics" / "replans.fast.py").write_text(
        '"""Replans in the traced window."""\n\n\ndef read(obs):\n    return obs["attempted"]\n')
    (home / "limits" / "mdtv-controller-fast.json").write_text(
        json.dumps({"limits": {"chunk_gap": 1e-4}}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "mdtv-controller-fast", "config": "mdtv",
                              "traffic": "controller-b1-fast-goals", "chips": 1,
                              "why": "goal switch every 2 replans"})
    for m in spec["end_to_end"]:
        if m["name"] in ("replan_p50_ms", "replan_p95_ms"):
            m["workloads"].append("mdtv-controller-fast")
    spec["per_layer"].append({"name": "replans.fast", "unit": "replans", "better": "higher",
                              "source": "host_clock", "layer": "policy",
                              "moves": "replan_p50_ms", "workloads": ["mdtv-controller-fast"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())  # nothing edited

    line = run_tiny("mdtv-controller-fast", root=tmp_path, trace=True)
    assert line["correct"] and line["metrics"]["replans.fast"]["value"] > 0
    line = run_tiny("mdtv-controller-fast", root=tmp_path)
    assert set(line["metrics"]) == {"replan_p50_ms", "replan_p95_ms", "setup_s"}
